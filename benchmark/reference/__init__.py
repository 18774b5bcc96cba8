"""The plain reference decoder the benchmark checks the program against:
NumPy and plain Python, importing nothing of the program."""
