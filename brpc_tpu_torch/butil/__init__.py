"""Base utilities of the port: runtime flags (``flags.py``), a
per-thread random generator (``fast_rand.py``), device selection
(``device.py``, which imports torch), and the transport's value types:
``EndPoint`` (``endpoint.py``), the versioned-id ``ResourcePool``
(``resource_pool.py``) and the host-block ``IOBuf`` (``iobuf.py``).
Nothing else is imported here, so that the RPC layers load without
torch. Importing the package tunes glibc's malloc for large payloads
(``malloc_tune.py``), as ``brpc_tpu.butil`` does."""

from brpc_tpu_torch.butil.malloc_tune import tune_malloc

tune_malloc()
