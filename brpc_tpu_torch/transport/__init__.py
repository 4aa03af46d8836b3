"""Transports of the port: the Conn/Transport interface (``base.py``),
TCP on the process's event dispatcher (``tcp.py``,
``event_dispatcher.py``), the Socket with its write queue and in-place
input (``socket.py``) and the InputMessenger (``input_messenger.py``)."""
