"""GenerateService: the unary front end of the serving lane (the port of
brpc_tpu/serving/service.py, unary path only).

A ``Generate`` call parks its handler thread until the sequence retires
and returns every token in one JSON response,
``{"status": "completed", "n": ..., "tokens": [...], "text": ...}``;
deadline eviction fails the call with ``ERPCTIMEDOUT``, a full queue with
``ELIMIT``, a prompt that cannot fit a slot with ``EREQUEST``.

Request body: JSON ``{"prompt": str, "max_tokens": int, "stop_token":
int?}``, or a bare byte string taken as the prompt with the default
budget. Prompt bytes are the tokens (byte-level vocab).

``add_generate_service(server)`` registers the service and arms the
engine lifecycle: ``Server.start`` builds a fresh model, batcher and
engine on the chosen device and starts the decode thread;
``Server.stop`` stops it and retires what is in flight.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import List, Optional, Tuple

from brpc_tpu_torch.butil.device import DeviceLike, resolve_device
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.rpc.service import Service

from .batcher import (COMPLETED, EVICTED, ContinuousBatcher, GenRequest,
                      RequestTooLong)
from .engine import ServingEngine
from .model import TinyDecoder, TinyDecoderConfig

# the reference's flag defaults (brpc_tpu/serving/service.py:56-68)
DEFAULT_MAX_BATCH = 8
DEFAULT_CACHE_LEN = 160
DEFAULT_MAX_WAITING = 32
DEFAULT_MAX_TOKENS = 32
SERVICE_NAME = "GenerateService"
_TTFT_WINDOW = 1024


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


class GenerateService:
    """Owner of the serving stack on one server: builds the Service to
    register and a fresh model/batcher/engine per server start."""

    def __init__(self, max_batch: int = DEFAULT_MAX_BATCH,
                 cache_len: int = DEFAULT_CACHE_LEN,
                 max_waiting: int = DEFAULT_MAX_WAITING,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._max_batch = int(max_batch)
        self._cache_len = int(cache_len)
        self._max_waiting = int(max_waiting)
        self.batcher: Optional[ContinuousBatcher] = None
        self.engine: Optional[ServingEngine] = None
        self._ttft_lock = threading.Lock()
        self._ttft_ms: deque = deque(maxlen=_TTFT_WINDOW)

    # ----------------------------------------------------------- lifecycle
    def on_server_start(self, server) -> None:
        engine_box = []
        self.batcher = ContinuousBatcher(
            TinyDecoder(TinyDecoderConfig(cache_len=self._cache_len),
                        device=self.device),
            max_batch=self._max_batch, max_waiting=self._max_waiting,
            wake=lambda: engine_box[0].wake())
        self.engine = ServingEngine(self.batcher)
        engine_box.append(self.engine)
        self.engine.start()

    def on_server_stop(self, server) -> None:
        if self.engine is not None:
            self.engine.stop()
        if self.batcher is not None:
            self.batcher.stop()

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
        return out

    def ttft_samples(self) -> List[float]:
        """Time to first token (ms) of the recent completed calls, oldest
        first."""
        with self._ttft_lock:
            return list(self._ttft_ms)

    def _submit(self, cntl, batcher: ContinuousBatcher,
                req: GenRequest) -> bool:
        """Shared shed/too-long handling; True when queued."""
        try:
            ok = batcher.submit(req)
        except RequestTooLong as e:
            cntl.set_failed(berr.EREQUEST, str(e))
            return False
        if not ok:
            cntl.set_failed(berr.ELIMIT, "serving queue full (shed)")
            return False
        return True

    def _generate(self, cntl, request: bytes) -> bytes:
        batcher = self.batcher
        if batcher is None or batcher.stopped:
            cntl.set_failed(berr.ELOGOFF, "serving engine not running")
            return b""
        try:
            prompt, max_tokens, stop_token = _parse_request(request)
        except ValueError as e:
            cntl.set_failed(berr.EREQUEST, str(e))
            return b""
        return self._generate_unary(cntl, batcher, prompt, max_tokens,
                                    stop_token)

    def _generate_unary(self, cntl, batcher, prompt, max_tokens,
                        stop_token) -> bytes:
        ev = threading.Event()
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
        if not ev.wait(budget):
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
        ttft = req.ttft_ms()
        if ttft is not None:
            with self._ttft_lock:
                self._ttft_ms.append(ttft)
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
