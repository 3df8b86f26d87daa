"""Applications of the port (crowd counting so far)."""
