"""Models of the port (NCHW, ``channels_last`` memory)."""
