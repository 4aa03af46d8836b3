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

# BRPC_TPU_TORCH_LOCK_DEBUG=1 (or =strict) arms the racelane BEFORE any
# submodule creates its locks: threading.Lock/RLock are replaced with
# instrumented twins that inject seeded deterministic yield points and
# assert the declared lock order (analysis/racelane.py:LOCK_ORDER) at
# every acquire; BRPC_TPU_TORCH_LOCK_SEED picks the schedule. With the
# variable unset this imports only the standard library.
import os as _os

if _os.environ.get("BRPC_TPU_TORCH_LOCK_DEBUG") in ("1", "strict"):
    from brpc_tpu_torch.analysis import racelane as _racelane

    _racelane.maybe_install_from_env()
