"""RPC over tpu_std and HTTP/1.1: Server (with ServerOptions), Channel
(``call`` with ``done``, ``call_sync``, ``call_async``), Controller,
Service, streams set up on a call (Stream, StreamOptions,
stream_accept), rpcz spans (``span.py``) and the combo channels
(ParallelChannel, SelectiveChannel, PartitionChannel), on tcp://, mem://,
and the device lanes cuda://, cudad:// and ici://, where a call and a
stream frame carry tensors (``request_device_arrays``,
``response_device_arrays``)."""

from . import errno_codes
from .channel import Channel, ChannelOptions
from .combo_channels import (CallMapper, ParallelChannel, PartitionChannel,
                             PartitionParser, ResponseMerger,
                             SelectiveChannel, SubCall)
from .controller import Controller
from brpc_tpu_torch.butil.endpoint import EndPoint

from .load_balancer import LoadBalancer, new_load_balancer
from .server import Server, ServerOptions
from .server_dispatch import current_serving_controller
from .service import Method, Service
from .stream import Stream, StreamOptions, stream_accept

__all__ = ["errno_codes", "Channel", "ChannelOptions", "Controller",
           "EndPoint", "Server", "ServerOptions", "Method", "Service", "Stream",
           "StreamOptions", "stream_accept", "current_serving_controller",
           "CallMapper", "ParallelChannel", "PartitionChannel",
           "PartitionParser", "ResponseMerger", "SelectiveChannel",
           "SubCall", "LoadBalancer", "new_load_balancer"]
