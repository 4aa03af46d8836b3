"""Wire protocols of the port: tpu_std and HTTP/1.1, and the registry
the InputMessenger tries them from (``registry.py``)."""
