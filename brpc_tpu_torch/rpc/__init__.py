"""RPC over tpu_std and HTTP/1.1 on TCP: Server (with ServerOptions),
Channel, Controller, Service, streams set up on a call (Stream,
StreamOptions, stream_accept) and rpcz spans (``span.py``)."""

from . import errno_codes
from .channel import Channel, ChannelOptions
from .controller import Controller
from .server import EndPoint, Server, ServerOptions
from .service import Method, Service
from .stream import Stream, StreamOptions, stream_accept

__all__ = ["errno_codes", "Channel", "ChannelOptions", "Controller",
           "EndPoint", "Server", "ServerOptions", "Method", "Service", "Stream",
           "StreamOptions", "stream_accept"]
