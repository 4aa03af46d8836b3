"""Base utilities of the port: runtime flags (``flags.py``), a
per-thread random generator (``fast_rand.py``) and device selection
(``device.py``, which imports torch). Nothing is imported here, so that
the RPC layers load without torch."""
