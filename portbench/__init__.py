"""The benchmark of the port on one H100 (see README.md)."""
