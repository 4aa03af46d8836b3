"""Unary RPC over tpu_std/TCP: Server, Channel, Controller, Service."""

from . import errno_codes
from .channel import Channel, ChannelOptions
from .controller import Controller
from .server import EndPoint, Server
from .service import Method, Service

__all__ = ["errno_codes", "Channel", "ChannelOptions", "Controller",
           "EndPoint", "Server", "Method", "Service"]
