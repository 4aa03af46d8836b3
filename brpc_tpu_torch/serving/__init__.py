"""Inference serving lane of the port: continuous batching over a
device-resident KV cache, behind GenerateService (tpu_std streams,
HTTP chunked transfer and unary calls on one port).

    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import add_generate_service
    server = Server()
    add_generate_service(server)              # cuda:0 unless device="cpu"
    server.start("tcp://127.0.0.1:0")
"""

from brpc_tpu_torch.rpc.stream import Stream, StreamOptions, stream_accept

from .batcher import (CANCELED, COMPLETED, EVICTED, SHED,
                      ContinuousBatcher, GenRequest, RequestTooLong)
from .engine import ServingEngine
from .model import DEFAULT_SEED, TinyDecoder, TinyDecoderConfig
from .service import GenerateService, add_generate_service

__all__ = [
    "CANCELED", "COMPLETED", "EVICTED", "SHED",
    "ContinuousBatcher", "GenRequest", "RequestTooLong",
    "ServingEngine", "DEFAULT_SEED", "TinyDecoder", "TinyDecoderConfig",
    "GenerateService", "add_generate_service",
    "Stream", "StreamOptions", "stream_accept",
]
