"""The serving vocabulary of the port. Only the error classes that the join
engine raises are here so far; the runtime, its requests and results come
with the port of ``serve/``."""
