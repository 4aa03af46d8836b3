"""GenerateService: the front end of the serving lane (the port of
brpc_tpu/serving/service.py).

One registered method, three transports on one server port, one batcher
behind them all:

- **tpu_std streaming**: the client attaches a Stream to the call; the
  handler admits the request and returns ``b"accepted"`` at once. Tokens
  go back as credit-controlled stream frames as they decode, tagged
  ``t<byte>`` (one token), ``d<json>`` (done: ``{"n": .., "status":
  "completed"}``) or ``e<errno>`` (deadline eviction sends ``e1008``);
- **HTTP**: ``POST /GenerateService/Generate`` streams the token bytes
  as chunked transfer, then a ``\\n#<state> n=<k>[ err=<code>]`` footer
  (a chunked body cannot carry a late status code). A dead peer turns
  ``pa.write()`` False, which cancels the sequence and frees its slot;
- **unary**: a plain tpu_std call, and a call whose Controller is
  marked ``unary`` (gRPC, and plain HTTP over h2: ``protocol/h2.py``),
  parks its handler fiber on a FiberEvent until the sequence retires
  (its worker thread goes on serving) and returns every token in one
  JSON response, ``{"status": "completed", "n": ..., "tokens": [...],
  "text": ...}``. The reference sends a gRPC call down the HTTP path,
  whose body nobody reads, and answers an empty OK (ROADMAP section 3).

Deadline eviction fails a unary call with ``ERPCTIMEDOUT`` (gRPC's
DEADLINE_EXCEEDED), a full queue any call with ``ELIMIT`` (UNAVAILABLE),
a prompt that cannot fit a slot with ``EREQUEST``.

Token callbacks run inside a decode step, on a fiber worker, which must
never wait on a client: both senders only queue writes (``write_nowait``
on a stream, chunk writes on a connection whose sends never block). A
stream's tail that the credit window held back is sent by a fiber that
awaits credits.

Request body: JSON ``{"prompt": str, "max_tokens": int, "stop_token":
int?}``, or a bare byte string taken as the prompt with the default
budget. Prompt bytes are the tokens (byte-level vocab).

``add_generate_service(server)`` registers the service and arms the
engine lifecycle: ``Server.start`` builds a fresh model, batcher and
engine on the chosen device, warms the engine and registers it as a
WorkerModule, so the server's fiber workers run its decode steps;
``Server.stop`` unregisters it, retires what is in flight and waits
out the decode slice in flight (``ServingEngine.quiesce``).

Observability: every submitted request opens a flight-deck tracker
(``serving_stats.open_generation``; a ``side="serving"`` child span of
the call under rpcz), and the ``Stats`` method and the ``/serving``
page carry ``serving_obs_pane()`` under ``"stats"``.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import List, Optional, Tuple

from brpc_tpu_torch.butil.device import DeviceLike, parse_device
from brpc_tpu_torch.fiber import FiberEvent
from brpc_tpu_torch.fiber.worker_module import (register_module,
                                                unregister_module)
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.rpc.service import Service
from brpc_tpu_torch.rpc.stream import StreamOptions, stream_accept

from . import serving_stats as _sstats
from .batcher import (CANCELED, COMPLETED, EVICTED, ContinuousBatcher,
                      GenRequest, RequestTooLong, expose_serving_vars)
from .engine import ServingEngine
from .model import TinyDecoder, TinyDecoderConfig

# the reference's flag defaults (brpc_tpu/serving/service.py:56-68)
DEFAULT_MAX_BATCH = 8
DEFAULT_CACHE_LEN = 160
DEFAULT_MAX_WAITING = 32
DEFAULT_MAX_TOKENS = 32
SERVICE_NAME = "GenerateService"
_TTFT_WINDOW = 1024
# frames a stream consumer may leave unsent (out of credits) before its
# sequence is cancelled: a slow reader must not pin a KV slot forever
_MAX_PENDING_FRAMES = 512


def _parse_request(body) -> Tuple[List[int], int, Optional[int]]:
    raw = bytes(body)
    max_tokens = DEFAULT_MAX_TOKENS
    stop_token = None
    if raw[:1] == b"{":
        try:
            doc = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise ValueError(f"bad request json: {e}")
        prompt = doc.get("prompt", "")
        if not isinstance(prompt, str) or not prompt:
            raise ValueError("request needs a non-empty 'prompt' string")
        tokens = list(prompt.encode("utf-8"))
        if "max_tokens" in doc:
            max_tokens = int(doc["max_tokens"])
        if doc.get("stop_token") is not None:
            stop_token = int(doc["stop_token"])
    else:
        if not raw:
            raise ValueError("empty prompt")
        tokens = list(raw)
    if max_tokens < 1:
        raise ValueError("max_tokens must be >= 1")
    return tokens, max_tokens, stop_token


def _percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    s = sorted(values)
    return s[min(len(s) - 1, int(q * len(s)))]


class _StreamSender:
    """Token emitter of the stream path, inside the decode step:
    ``write_nowait`` only, so a decode step never waits for credits.
    Frames the window refuses queue up and go out before the next frame;
    a consumer that stops draining past the cap cancels the sequence."""

    def __init__(self, stream, batcher: ContinuousBatcher, control):
        self.stream = stream
        self.batcher = batcher
        self.control = control          # runs the tail's drain fiber
        self._pending: deque = deque()
        self._lock = threading.Lock()

    def _dead(self) -> bool:
        return self.stream.closed or self.stream.remote_closed

    def _push(self, payload: bytes) -> bool:
        """Queue and flush under one lock (token order must survive a
        finish racing the drain); False once the stream is unwritable
        or the backlog passed the cap."""
        with self._lock:
            self._pending.append(payload)
            while self._pending:
                if self._dead():
                    return False
                # graftlint: disable=callback-under-lock -- _lock keeps
                # token order when a finish races the drain. write_nowait
                # never waits (a credit check, then a send that never
                # parks); a failed send runs the server socket's subscribers
                # here (the stream's close, the server's _forget), none of
                # which takes this lock; batcher.cancel runs after _push
                # returns.
                if not self.stream.write_nowait(self._pending[0]):
                    break               # out of credits
                self._pending.popleft()
            return len(self._pending) <= _MAX_PENDING_FRAMES

    def token(self, req: GenRequest, tok: int) -> None:
        if not self._push(b"t" + bytes([tok & 0xFF])):
            self.batcher.cancel(req)

    def finish(self, req: GenRequest, state: str) -> None:
        if state == COMPLETED:
            self._push(b"d" + json.dumps(
                {"n": req.ntokens, "status": "completed"}).encode())
        elif state == EVICTED:
            self._push(b"e%d" % req.error_code)
        # CANCELED: the peer is gone, nothing to tell it
        with self._lock:
            leftover = bool(self._pending) and not self._dead()
        if not leftover:
            self.stream.close()
            return
        # the credit window closed on the stream's tail, and nothing will
        # push again: a fiber parks on the credit butex (never the decode
        # step), sends the tail, the verdict included, and closes
        self.control.spawn(self._drain_then_close, name="stream-drain")

    async def _drain_then_close(self) -> None:
        while True:
            with self._lock:
                if not self._pending or self._dead():
                    break
                frame = self._pending[0]
            if not await self.stream.write(frame, timeout_s=10.0):
                break
            with self._lock:
                if self._pending and self._pending[0] is frame:
                    self._pending.popleft()
        self.stream.close()


class _HttpSender:
    """Token emitter of the HTTP path: raw token bytes, then the
    ``\\n#<state>`` footer. A dead peer turns ``pa.write()`` False and
    cancels the sequence: freeing the KV slot is why the disconnect is
    watched at all."""

    def __init__(self, pa, batcher: ContinuousBatcher):
        self.pa = pa
        self.batcher = batcher

    def token(self, req: GenRequest, tok: int) -> None:
        if not self.pa.write(bytes([tok & 0xFF])):
            self.batcher.cancel(req)

    def finish(self, req: GenRequest, state: str) -> None:
        if state != CANCELED:
            footer = f"\n#{state} n={req.ntokens}"
            if req.error_code:
                footer += f" err={req.error_code}"
            self.pa.write(footer.encode())
        self.pa.close()


class GenerateService:
    """Owner of the serving stack on one server: builds the Service to
    register and a fresh model/batcher/engine per server start."""

    def __init__(self, max_batch: int = DEFAULT_MAX_BATCH,
                 cache_len: int = DEFAULT_CACHE_LEN,
                 max_waiting: int = DEFAULT_MAX_WAITING,
                 device: DeviceLike = None):
        # named here, checked where the model is built (on_server_start):
        # a shard group's supervisor must reach its forks with no CUDA call
        self.device = parse_device(device)
        self._max_batch = int(max_batch)
        self._cache_len = int(cache_len)
        self._max_waiting = int(max_waiting)
        self.batcher: Optional[ContinuousBatcher] = None
        self.engine: Optional[ServingEngine] = None
        self._control = None            # the server's TaskControl
        self._ttft_lock = threading.Lock()
        self._ttft_ms: deque = deque(maxlen=_TTFT_WINDOW)

    # ----------------------------------------------------------- lifecycle
    def on_server_start(self, server) -> None:
        self._control = server.control
        self.batcher = ContinuousBatcher(
            TinyDecoder(TinyDecoderConfig(cache_len=self._cache_len),
                        device=self.device),
            max_batch=self._max_batch, max_waiting=self._max_waiting,
            wake=server.control.parking_lot.signal)
        self.engine = ServingEngine(self.batcher,
                                    label=f"{SERVICE_NAME}.Generate")
        expose_serving_vars()
        from brpc_tpu_torch.ops.flash_attention import expose_kernel_vars
        expose_kernel_vars()
        self.engine.warm_up()
        register_module(self.engine)

    def build_kernels(self) -> None:
        """Compile the decode kernel's library without loading it (nvcc
        is a subprocess: no CUDA call here). A shard group's supervisor
        runs this before it forks, so that the shards' warm-ups load a
        built library instead of all compiling it at once against the
        group's hang check."""
        if self.device.type == "cuda":
            from brpc_tpu_torch.ops import _build
            _build.build("flash_decode")

    def on_server_stop(self, server) -> None:
        if self.engine is not None:
            unregister_module(self.engine)
        if self.batcher is not None:
            self.batcher.stop()
        if self.engine is not None:
            self.engine.quiesce()

    # ------------------------------------------------------------- service
    def build_service(self) -> Service:
        svc = Service(SERVICE_NAME)
        svc.register_method("Generate", self._generate)
        svc.register_method("Stats", self._stats)
        return svc

    def _stats(self, cntl, request) -> bytes:
        if self.batcher is None:
            return json.dumps({"enabled": False}).encode()
        return json.dumps(self._payload(), default=str).encode()

    def _payload(self) -> dict:
        out = {"enabled": True, "service": SERVICE_NAME}
        out.update(self.batcher.stats_snapshot())
        out["engine"] = self.engine.snapshot() if self.engine else {}
        ttft = self.ttft_samples()
        out["ttft_ms"] = {"count": len(ttft),
                          "p50": _percentile(ttft, 0.50),
                          "p99": _percentile(ttft, 0.99)}
        # the flight deck's panes: one function for the Stats method and
        # the /serving page, so the two views cannot diverge
        out["stats"] = _sstats.serving_obs_pane()
        return out

    def ttft_samples(self) -> List[float]:
        """Time to first token (ms) of the recent completed calls, oldest
        first: every call of the last ``_TTFT_WINDOW``, where the flight
        deck's reservoir samples once it is full."""
        with self._ttft_lock:
            return list(self._ttft_ms)

    def _submit(self, cntl, batcher: ContinuousBatcher,
                req: GenRequest) -> bool:
        """Shared shed/too-long handling; True when queued. The flight
        deck's tracker attaches here (one flag check a request); a
        request refused at the door settles at once with its cause."""
        req.tracker = _sstats.open_generation(
            SERVICE_NAME, "Generate", cntl, created_ns=req.created_ns)
        try:
            ok = batcher.submit(req)
        except RequestTooLong as e:
            cntl.set_failed(berr.EREQUEST, str(e))
            if req.tracker is not None:
                req.tracker.gen_settled("rejected",
                                        cause="prompt_too_long",
                                        error_code=berr.EREQUEST)
            return False
        if not ok:
            cntl.set_failed(berr.ELIMIT, "serving queue full (shed)")
            if req.tracker is not None:
                req.tracker.gen_settled(
                    "shed", cause="queue_full",
                    finished_ns=req.finished_ns,
                    error_code=req.error_code or berr.ELIMIT)
            return False
        return True

    async def _generate(self, cntl, request: bytes) -> bytes:
        batcher = self.batcher
        if batcher is None or batcher.stopped:
            cntl.set_failed(berr.ELOGOFF, "serving engine not running")
            return b""
        try:
            prompt, max_tokens, stop_token = _parse_request(request)
        except ValueError as e:
            cntl.set_failed(berr.EREQUEST, str(e))
            return b""
        if cntl._peer_stream_id:
            return self._generate_stream(cntl, batcher, prompt, max_tokens,
                                         stop_token)
        if cntl._server_socket is None and not cntl.unary:
            return self._generate_http(cntl, batcher, prompt, max_tokens,
                                       stop_token)
        return await self._generate_unary(cntl, batcher, prompt,
                                          max_tokens, stop_token)

    def _record_ttft(self, req: GenRequest, state: str) -> None:
        ttft = req.ttft_ms()
        if state == COMPLETED and ttft is not None:
            with self._ttft_lock:
                self._ttft_ms.append(ttft)

    def _generate_stream(self, cntl, batcher, prompt, max_tokens,
                         stop_token) -> bytes:
        st = stream_accept(cntl, StreamOptions())
        sender = _StreamSender(st, batcher, self._control)

        def on_finish(req_, state):
            self._record_ttft(req_, state)
            sender.finish(req_, state)

        req = GenRequest(prompt, max_tokens, cntl=cntl,
                         on_token=sender.token, on_finish=on_finish,
                         stop_token=stop_token)
        # the client went away (close frame or the connection's end):
        # the next step boundary frees the KV slot
        st.on_close(lambda _s: batcher.cancel(req))
        if not self._submit(cntl, batcher, req):
            st.close()
            return b""
        return b"accepted"

    def _generate_http(self, cntl, batcher, prompt, max_tokens,
                       stop_token) -> Optional[bytes]:
        pa = cntl.create_progressive_attachment("application/octet-stream")
        sender = _HttpSender(pa, batcher)

        def on_finish(req_, state):
            self._record_ttft(req_, state)
            sender.finish(req_, state)

        req = GenRequest(prompt, max_tokens, cntl=cntl,
                         on_token=sender.token, on_finish=on_finish,
                         stop_token=stop_token)
        if not self._submit(cntl, batcher, req):
            return b""                  # failed: a plain HTTP error answers
        return None                     # the body streams through pa

    async def _generate_unary(self, cntl, batcher, prompt, max_tokens,
                              stop_token) -> bytes:
        ev = FiberEvent()
        outcome = {}

        def on_finish(req_, state):
            outcome["state"] = state
            ev.set()

        req = GenRequest(prompt, max_tokens, cntl=cntl,
                         on_finish=on_finish, stop_token=stop_token)
        if not self._submit(cntl, batcher, req):
            return b""
        # the batcher's eviction sweep owns the deadline; the extra 30 s
        # is a backstop against a wedged engine, not a budget
        rem = cntl.remaining_ms()
        budget = 30.0 if rem is None else rem / 1e3 + 30.0
        if not await ev.wait(budget):
            batcher.cancel(req)
            cntl.set_failed(berr.EINTERNAL, "serving engine wedged")
            return b""
        state = outcome.get("state")
        if state == EVICTED:
            cntl.set_failed(berr.ERPCTIMEDOUT,
                            "evicted mid-generation (deadline)")
            return b""
        if state != COMPLETED:
            cntl.set_failed(berr.EINTERNAL, f"generation {state}")
            return b""
        self._record_ttft(req, state)
        return json.dumps({"status": "completed", "n": req.ntokens,
                           "tokens": req.tokens,
                           "text": bytes(req.tokens).decode(
                               "utf-8", "replace")}).encode()


def add_generate_service(server, device: DeviceLike = None,
                         **kwargs) -> GenerateService:
    """Register a GenerateService on ``server`` (defaults as the
    reference's: 8 slots of 160 tokens, 32 waiting, 32 tokens a request)
    and arm its lifecycle. ``device`` defaults to ``cuda:0``."""
    gs = GenerateService(device=device, **kwargs)
    server.add_service(gs.build_service())
    server._serving = gs
    return gs


def serving_page_payload(server) -> dict:
    """The /serving payload: this server's batcher, engine and flight
    deck. One function for the builtin RPC and the HTTP page."""
    gs = getattr(server, "_serving", None)
    if gs is None or gs.batcher is None:
        return {"enabled": False}
    return gs._payload()
