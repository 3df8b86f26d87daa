"""Datasets of the port (NumPy containers, no framework arrays)."""
