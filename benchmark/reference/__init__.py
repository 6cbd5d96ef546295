"""The plain PyTorch reference that decides `correct`: no kernel, no JAX,
nothing of the program."""
