"""The plain reference the benchmark judges the program by: float32
PyTorch and numpy, importing nothing of the program."""
