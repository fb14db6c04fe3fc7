"""Frozen copies of the generators the cells' graphs come from."""
