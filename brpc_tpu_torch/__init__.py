"""brpc_tpu_torch: the PyTorch/CUDA port of brpc_tpu's serving lane.

``GenerateService.Generate`` over tpu_std streams, HTTP chunked transfer
and unary calls on one TCP port, whose decode step runs a hand-written
CUDA decode-attention kernel (``ops/csrc/flash_decode.cu``) on an NVIDIA
Hopper card.

    from brpc_tpu_torch.rpc import Channel, Server
    from brpc_tpu_torch.serving import add_generate_service

    server = Server()
    add_generate_service(server)              # cuda:0 unless device="cpu"
    ep = server.start("tcp://127.0.0.1:0")
    ch = Channel(f"tcp://127.0.0.1:{ep.port}")
    cntl = ch.call_sync("GenerateService", "Generate",
                        b'{"prompt": "hi", "max_tokens": 8}')
    # tokens as they decode: stream_options=StreamOptions(on_received=..)
    # or: curl -N -d '{"prompt":"hi"}' http://HOST:PORT/GenerateService/Generate

The same port answers the builtin pages (``/status``, ``/vars``,
``/rpcz``, ``/serving``, ``/brpc_metrics``, ...); the ``rpcz_enabled``
flag (``butil/flags.py``, or ``POST /flags/rpcz_enabled?setvalue=true``)
traces every call across client and server, down to the serving lane's
queue, prefill, decode and emit stages.

The package imports torch and numpy only: nothing of JAX, nothing of
``brpc_tpu`` and not ``google.protobuf`` (the tpu_std meta codec is
written by hand, wire-identical to the reference's).
"""

__version__ = "0.1.0"
