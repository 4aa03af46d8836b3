"""RPC over tpu_std and HTTP/1.1: Server (with ServerOptions), Channel,
Controller, Service, streams set up on a call (Stream, StreamOptions,
stream_accept) and rpcz spans (``span.py``), on tcp://, mem://, and the
device lanes cuda:// and cudad://, where a call and a stream frame
carry tensors (``request_device_arrays``, ``response_device_arrays``)."""

from . import errno_codes
from .channel import Channel, ChannelOptions
from .controller import Controller
from brpc_tpu_torch.butil.endpoint import EndPoint

from .server import Server, ServerOptions
from .service import Method, Service
from .stream import Stream, StreamOptions, stream_accept

__all__ = ["errno_codes", "Channel", "ChannelOptions", "Controller",
           "EndPoint", "Server", "ServerOptions", "Method", "Service", "Stream",
           "StreamOptions", "stream_accept"]
