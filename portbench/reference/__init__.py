"""The plain reference the benchmark holds the program to: frozen copies
of the port's twins, importing nothing of the program."""
