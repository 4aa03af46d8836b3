"""RPC over tpu_std and HTTP/1.1: Server (with ServerOptions and its
overload gates), Channel (``call`` with ``done``, ``call_sync``,
``call_async``, retries and backup requests), ClusterChannel (naming,
load balancers, breakers, health checks), Controller, Service, streams
set up on a call (Stream, StreamOptions, stream_accept), rpcz spans
(``span.py``), the combo channels (ParallelChannel, SelectiveChannel,
PartitionChannel, DynamicPartitionChannel), auth (Authenticator,
TokenAuthenticator, the interceptor), compression (``compress.py``),
SimpleDataPool and PeriodicTask, on tcp://, mem://, and the
device lanes cuda://, cudad:// and ici://, where a call and a stream
frame carry tensors (``request_device_arrays``,
``response_device_arrays``)."""

from . import errno_codes
from .auth import (AuthContext, AuthError, Authenticator, InterceptorError,
                   TokenAuthenticator)
from .channel import Channel, ChannelOptions
from .cluster_channel import ClusterChannel
from .combo_channels import (CallMapper, DynamicPartitionChannel,
                             ParallelChannel, PartitionChannel,
                             PartitionParser, ResponseMerger,
                             SelectiveChannel, SubCall)
from .controller import Controller
from .data_pool import SimpleDataPool
from brpc_tpu_torch.butil.endpoint import EndPoint

from .load_balancer import (LoadBalancer, new_load_balancer,
                            register_load_balancer)
from .periodic_task import PeriodicTask
from .retry_policy import (RetryBackoffPolicy, RetryBudget, RetryPolicy,
                           RpcRetryPolicy)
from .server import Server, ServerOptions
from .server_dispatch import current_serving_controller
from .service import Method, Service
from .stream import Stream, StreamOptions, stream_accept

__all__ = ["errno_codes", "Channel", "ChannelOptions", "ClusterChannel",
           "Controller", "EndPoint", "Server", "ServerOptions", "Method",
           "Service", "Stream", "StreamOptions", "stream_accept",
           "current_serving_controller", "CallMapper",
           "DynamicPartitionChannel", "ParallelChannel", "PartitionChannel",
           "PartitionParser", "ResponseMerger", "SelectiveChannel",
           "SubCall", "LoadBalancer", "new_load_balancer",
           "register_load_balancer", "RetryPolicy", "RpcRetryPolicy",
           "RetryBackoffPolicy", "RetryBudget", "AuthContext", "AuthError",
           "Authenticator", "InterceptorError", "TokenAuthenticator",
           "PeriodicTask", "SimpleDataPool"]
