"""Share of the profiled slice in which the device was idle while a program
span was open on the host (the program's own dispatch): spans.idle_by_span."""

from benchmark import spans


def read(rec: dict):
    return spans.idle_pct(rec, program=True)
