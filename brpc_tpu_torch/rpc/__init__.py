"""RPC over tpu_std and HTTP/1.1 on TCP: Server, Channel, Controller,
Service, and streams set up on a call (Stream, StreamOptions,
stream_accept)."""

from . import errno_codes
from .channel import Channel, ChannelOptions
from .controller import Controller
from .server import EndPoint, Server
from .service import Method, Service
from .stream import Stream, StreamOptions, stream_accept

__all__ = ["errno_codes", "Channel", "ChannelOptions", "Controller",
           "EndPoint", "Server", "Method", "Service", "Stream",
           "StreamOptions", "stream_accept"]
