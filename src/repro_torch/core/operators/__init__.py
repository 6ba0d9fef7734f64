"""Operator circuits of the port (the expansion circuit so far)."""
