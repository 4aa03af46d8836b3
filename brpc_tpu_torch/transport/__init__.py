"""Byte transports of the port (blocking TCP)."""
