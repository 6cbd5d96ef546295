"""The port's benchmark: one run of one cell is `python3 benchmark/run.py`."""
