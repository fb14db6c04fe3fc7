"""The plain reference: numpy over the tables the benchmark drew. It
imports nothing of the program and reads nothing the program made."""
