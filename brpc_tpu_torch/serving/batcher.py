"""Continuous batcher: iteration-level scheduling over fixed KV slots
(the port of brpc_tpu/serving/batcher.py).

Each ``step()`` sweeps out cancelled and deadline-dead requests, admits
waiting requests into free slots, runs ONE decode step for the live
batch, emits the new tokens and retires finished sequences at the end of
the step they finished in. The wait queue is bounded (``max_waiting``):
a submit past it sheds at once with ``ELIMIT``.

One change from the reference: the KV slots ``[max_batch, cache_len,
dim]`` live on the model's device. A prompt's rows are written there at
admission, and each step writes its new rows in place; only the ``[B]``
next tokens come back to the host. (The reference keeps the slots in
host numpy and hands the whole cache to every step.)

Thread model: ``step()`` runs on the engine's decode thread and steps are
serialized by the engine; ``_lock`` guards only the queue and the slot
table, so ``submit``/``cancel`` from handler threads stay cheap. The
decode itself and the user callbacks run outside the lock.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import Counter, deque
from typing import Callable, List, Optional, Tuple

import torch

from brpc_tpu_torch.rpc import errno_codes as berr

from .model import TinyDecoder

log = logging.getLogger("brpc_tpu_torch.serving")

# request states
WAITING = "waiting"
RUNNING = "running"
COMPLETED = "completed"
EVICTED = "evicted"        # deadline expired mid-flight -> ERPCTIMEDOUT
SHED = "shed"              # wait queue full at submit
CANCELED = "canceled"      # client gone

_TERMINAL = frozenset((COMPLETED, EVICTED, SHED, CANCELED))


class RequestTooLong(ValueError):
    """The prompt alone would overflow a KV slot: unservable anywhere,
    unlike a shed."""


class GenRequest:
    """One generation request: prompt, token budget, the controller whose
    deadline drives eviction, and the emit callbacks (called outside the
    batcher's lock, on the decode thread)."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, prompt_tokens: List[int], max_new_tokens: int,
                 cntl=None,
                 on_token: Optional[Callable[["GenRequest", int], None]] = None,
                 on_finish: Optional[Callable[["GenRequest", str], None]] = None,
                 stop_token: Optional[int] = None):
        with GenRequest._seq_lock:
            GenRequest._seq += 1
            self.req_id = GenRequest._seq
        self.prompt = list(prompt_tokens)
        self.max_new_tokens = int(max_new_tokens)
        self.cntl = cntl
        self.on_token = on_token
        self.on_finish = on_finish
        self.stop_token = stop_token
        self.state = WAITING
        self.slot: Optional[int] = None
        self.tokens: List[int] = []
        self.created_ns = time.monotonic_ns()
        self.first_token_ns = 0
        self.error_code = 0
        self._cancel = False         # set by cancel(); swept by step()

    @property
    def ntokens(self) -> int:
        return len(self.tokens)

    def ttft_ms(self) -> Optional[float]:
        if not self.first_token_ns:
            return None
        return (self.first_token_ns - self.created_ns) / 1e6


class ContinuousBatcher:
    def __init__(self, model: TinyDecoder, max_batch: int = 8,
                 max_waiting: int = 32,
                 wake: Optional[Callable[[], None]] = None):
        self.model = model
        self._wake = wake            # kicks the decode thread on submit
        cfg = model.config
        dev = model.device
        self.max_batch = int(max_batch)
        self.max_waiting = int(max_waiting)
        self.cache_len = cfg.cache_len
        self._lock = threading.Lock()
        self._k = torch.zeros((self.max_batch, cfg.cache_len, cfg.dim),
                              dtype=torch.float32, device=dev)
        self._v = torch.zeros_like(self._k)
        self._h = torch.zeros((self.max_batch, cfg.dim),
                              dtype=torch.float32, device=dev)
        self._slot_index = torch.arange(self.max_batch, device=dev)
        self._lens = [1] * self.max_batch        # 1 = idle-safe
        self._slots: List[Optional[GenRequest]] = [None] * self.max_batch
        self._free = list(range(self.max_batch))
        self._waiting: deque = deque()
        self._nrunning = 0           # racy-read counter for has_work
        self.stopped = False
        self.batch_hist: Counter = Counter()     # batch size -> steps
        self.decode_steps = 0
        self.completed = 0
        self.evicted = 0
        self.shed = 0
        self.canceled = 0
        self.tokens_out = 0

    # ------------------------------------------------------------- intake
    def submit(self, req: GenRequest) -> bool:
        """Queue a request for the next step boundary. False = shed
        (queue full, or stopped); raises RequestTooLong when the prompt
        cannot fit a KV slot."""
        if len(req.prompt) + 1 > self.cache_len:
            raise RequestTooLong(
                f"prompt of {len(req.prompt)} tokens cannot fit a "
                f"{self.cache_len}-token KV slot")
        # a budget larger than the slot generates what fits
        req.max_new_tokens = min(req.max_new_tokens,
                                 self.cache_len - len(req.prompt))
        with self._lock:
            if self.stopped or len(self._waiting) >= self.max_waiting:
                req.state = SHED
                req.error_code = berr.ELIMIT
                self.shed += 1
                return False
            self._waiting.append(req)
        if self._wake is not None:
            self._wake()
        return True

    def cancel(self, req: GenRequest) -> None:
        """Client gone: the next step retires the request and frees its
        slot. Safe from any thread."""
        req._cancel = True

    # ------------------------------------------------------------ queries
    def has_work(self) -> bool:
        return (self._nrunning > 0 or bool(self._waiting)) \
            and not self.stopped

    def running_count(self) -> int:
        return self._nrunning

    def waiting_count(self) -> int:
        return len(self._waiting)

    def _used_locked(self) -> int:
        return sum(self._lens[i] for i, r in enumerate(self._slots)
                   if r is not None)

    def kv_occupancy(self) -> float:
        """Fraction of all slots x cache_len holding live sequence state."""
        with self._lock:
            used = self._used_locked()
        return used / float(self.max_batch * self.cache_len)

    # ------------------------------------------------------------ stepping
    def _retire_locked(self, req: GenRequest, state: str,
                       done: List[Tuple[GenRequest, str]]) -> None:
        req.state = state
        if state == EVICTED:
            req.error_code = berr.ERPCTIMEDOUT
            self.evicted += 1
        elif state == COMPLETED:
            self.completed += 1
        elif state == CANCELED:
            self.canceled += 1
        if req.slot is not None:
            i = req.slot
            self._slots[i] = None
            self._lens[i] = 1
            self._free.append(i)
            self._nrunning -= 1
            req.slot = None
        done.append((req, state))

    def _sweep_locked(self, done: List[Tuple[GenRequest, str]]) -> None:
        """Retire cancelled and deadline-dead requests, running or
        waiting: a dead entry must not pin wait-queue capacity."""
        for req in [r for r in self._slots if r is not None]:
            if req._cancel:
                self._retire_locked(req, CANCELED, done)
            elif req.cntl is not None and req.cntl.deadline_expired():
                self._retire_locked(req, EVICTED, done)
        if self._waiting:
            survivors = deque()
            for req in self._waiting:
                if req._cancel:
                    self._retire_locked(req, CANCELED, done)
                elif req.cntl is not None and req.cntl.deadline_expired():
                    self._retire_locked(req, EVICTED, done)
                else:
                    survivors.append(req)
            self._waiting = survivors

    def step(self) -> bool:
        """One scheduling iteration: sweep, admit, decode once, emit,
        retire. Returns False when there was nothing to do."""
        emits: List[Tuple[GenRequest, int]] = []
        done: List[Tuple[GenRequest, str]] = []
        admitted: List[GenRequest] = []
        with self._lock:
            self._sweep_locked(done)
            while self._free and self._waiting:
                req = self._waiting.popleft()
                i = self._free.pop()
                self._slots[i] = req
                req.slot = i
                req.state = RUNNING
                self._nrunning += 1
                admitted.append(req)
            active = [(i, r) for i, r in enumerate(self._slots)
                      if r is not None]
            if active:
                self.decode_steps += 1
                self.batch_hist[len(active)] += 1
        if not active:
            self._fire(emits, done)
            return bool(done)
        # prefill outside the lock: only step() writes the caches and the
        # lengths, and steps are serialized by the engine
        for req in admitted:
            i = req.slot
            kp, vp, hl = self.model.prefill(req.prompt)
            n = len(req.prompt)
            self._k[i, :n] = kp
            self._v[i, :n] = vp
            self._h[i] = hl
            self._lens[i] = n
        lens = list(self._lens)
        lens_dev = torch.tensor(lens, dtype=torch.int32).to(self._k.device)
        nxt, k_new, v_new, h_new = self.model.decode_step(
            self._k, self._v, self._h, lens_dev)
        # every slot writes its new row in place at its current length:
        # a live slot's next row, an idle one's garbage row 1, which its
        # next admission overwrites (rows past a length are never read)
        self._k[self._slot_index, lens_dev.long()] = k_new
        self._v[self._slot_index, lens_dev.long()] = v_new
        self._h.copy_(h_new)
        tokens = nxt.tolist()                    # the only device->host copy
        with self._lock:
            for i, req in active:
                if self._slots[i] is not req:
                    continue        # cancelled and retired during the step
                tok = int(tokens[i])
                self._lens[i] = lens[i] + 1
                req.tokens.append(tok)
                self.tokens_out += 1
                if not req.first_token_ns:
                    req.first_token_ns = time.monotonic_ns()
                emits.append((req, tok))
                if (req.stop_token is not None and tok == req.stop_token) \
                        or req.ntokens >= req.max_new_tokens \
                        or self._lens[i] >= self.cache_len:
                    self._retire_locked(req, COMPLETED, done)
        self._fire(emits, done)
        return True

    @staticmethod
    def _fire(emits, done) -> None:
        """User callbacks, outside the lock: their failure paths may call
        back into cancel()."""
        for req, tok in emits:
            if req.on_token is not None:
                try:
                    req.on_token(req, tok)
                except Exception:
                    log.exception("on_token failed")
        for req, state in done:
            if req.on_finish is not None:
                try:
                    req.on_finish(req, state)
                except Exception:
                    log.exception("on_finish failed")

    # ----------------------------------------------------------- shutdown
    def stop(self) -> List[GenRequest]:
        """Refuse new work and retire everything in flight (CANCELED).
        Returns the retired requests."""
        done: List[Tuple[GenRequest, str]] = []
        with self._lock:
            self.stopped = True
            victims = [r for r in self._slots if r is not None]
            victims += list(self._waiting)
            self._waiting.clear()
            for r in victims:
                if r.state not in _TERMINAL:
                    self._retire_locked(r, CANCELED, done)
        self._fire([], done)
        return [r for r, _ in done]

    # ------------------------------------------------------ observability
    def stats_snapshot(self) -> dict:
        with self._lock:
            running = [{
                "req_id": r.req_id,
                "tokens": r.ntokens,
                "budget": r.max_new_tokens,
                "remaining_ms": (None if r.cntl is None
                                 else r.cntl.remaining_ms()),
            } for r in self._slots if r is not None]
            waiting = len(self._waiting)
            hist = dict(sorted(self.batch_hist.items()))
            used = self._used_locked()
        return {
            "max_batch": self.max_batch,
            "cache_len": self.cache_len,
            "max_waiting": self.max_waiting,
            "device": str(self.model.device),
            "running": running,
            "waiting": waiting,
            "completed": self.completed,
            "evicted": self.evicted,
            "shed": self.shed,
            "canceled": self.canceled,
            "tokens_out": self.tokens_out,
            "decode_steps": self.decode_steps,
            "batch_size_hist": hist,
            "kv_occupancy": round(
                used / float(self.max_batch * self.cache_len), 4),
            "stopped": self.stopped,
        }
