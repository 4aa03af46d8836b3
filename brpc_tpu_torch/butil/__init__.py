"""Base utilities of the port: device selection (``device.py``, which
imports torch) and the thread-backed ExecutionQueue
(``execution_queue.py``). Nothing is imported here, so that the RPC
layers load without torch."""
