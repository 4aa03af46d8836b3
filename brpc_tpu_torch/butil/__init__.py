"""Base utilities of the port: device selection (``device.py``, which
imports torch). Nothing is imported here, so that the RPC layers load
without torch."""
