"""Atom utilities: subgraphs and declared subsumption."""
