"""Base utilities of the port: runtime flags (``flags.py``), a
per-thread random generator (``fast_rand.py``), device selection
(``device.py``, which imports torch), and the transport's value types:
``EndPoint`` (``endpoint.py``), the versioned-id ``ResourcePool``
(``resource_pool.py``) and the host-block ``IOBuf`` (``iobuf.py``).
Nothing is imported here, so that the RPC layers load without torch."""
