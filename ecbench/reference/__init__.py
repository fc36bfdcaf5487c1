"""The plain reference the benchmark holds the program to. It imports
nothing of the program."""
