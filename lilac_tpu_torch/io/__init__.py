"""Matrix file I/O of the port (host side)."""
