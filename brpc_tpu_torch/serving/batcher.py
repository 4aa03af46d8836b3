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

Thread model: ``step()`` runs on whichever fiber worker holds the
engine's decode lock (``engine.py``), so steps are serialized; ``_lock``
guards only the queue and the slot table, so ``submit``/``cancel`` from
handler fibers stay cheap. The decode itself and the user callbacks run
outside the lock. ``steps_by_group`` counts the steps each worker group
ran.

Observability, as the reference's: the module's Adders are the lane's
``serving_*`` bvars (``expose_serving_vars``); a request's
``GenTracker`` (``serving_stats.py``) is stamped at admission, prefill,
each token and its settle; and each step leaves one record in the
flight deck's step ring. All of it costs one flag check per step when
``serving_stats_enabled`` is off.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import Counter, deque
from typing import Callable, List, Optional, Tuple

import torch

from brpc_tpu_torch.bvar.reducer import Adder, PassiveStatus
from brpc_tpu_torch.bvar.window import PerSecond
from brpc_tpu_torch.rpc import errno_codes as berr

from . import serving_stats as _sstats
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

nsubmitted = Adder()
ncompleted = Adder()
nevicted = Adder()
nshed = Adder()
ncanceled = Adder()
ntokens = Adder()
_tokens_ps = None           # PerSecond over ntokens, built on expose
_live_batchers: "weakref.WeakSet[ContinuousBatcher]" = weakref.WeakSet()


def _sum_live(attr: str) -> float:
    return sum(getattr(b, attr)() for b in list(_live_batchers))


def expose_serving_vars() -> None:
    """The lane's bvars (brpc_tpu/serving/batcher.py:79-98), exposed at
    each server start so that they outlive an ``unexpose_all``."""
    global _tokens_ps
    nsubmitted.expose("serving_requests")
    ncompleted.expose("serving_completed")
    nevicted.expose("serving_evicted")
    nshed.expose("serving_shed")
    ncanceled.expose("serving_canceled")
    ntokens.expose("serving_tokens")
    if _tokens_ps is None:
        _tokens_ps = PerSecond(ntokens, 10)
    _tokens_ps.expose("serving_tokens_per_second_10s")
    PassiveStatus(lambda: int(_sum_live("running_count"))).expose(
        "serving_running")
    PassiveStatus(lambda: int(_sum_live("waiting_count"))).expose(
        "serving_waiting")
    PassiveStatus(lambda: round(_sum_live("kv_occupancy"), 4)).expose(
        "serving_kv_occupancy")
    # the flight deck (per-method cells, TTFT/TPOT recorders) shares
    # the lane's expose lifecycle
    _sstats.expose_serving_stats_vars()


def _postfork_reset() -> None:
    """A forked shard inherits the parent's batchers through the weak
    set; its lane counters count its own requests only, and the rate
    window is made anew on its next expose (brpc_tpu/serving/batcher.py:
    101-112)."""
    global _live_batchers, _tokens_ps
    _live_batchers = weakref.WeakSet()
    _tokens_ps = None
    for c in (nsubmitted, ncompleted, nevicted, nshed, ncanceled, ntokens):
        c.postfork_clear()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("serving.batcher", _postfork_reset)


class RequestTooLong(ValueError):
    """The prompt alone would overflow a KV slot: unservable anywhere,
    unlike a shed."""


class GenRequest:
    """One generation request: prompt, token budget, the controller whose
    deadline drives eviction, and the emit callbacks (called outside the
    batcher's lock, on the fiber worker that ran the step)."""

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
        self.admitted_ns = 0
        self.first_token_ns = 0
        self.finished_ns = 0
        self.error_code = 0
        self._cancel = False         # set by cancel(); swept by step()
        # the flight deck's stage tracker (serving_stats.GenTracker),
        # attached by the service when serving_stats is on
        self.tracker = None

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
        # wakes a parked fiber worker on submit (the server control's
        # parking_lot.signal), so a request to an idle server does not
        # wait out a worker's park
        self._wake = wake
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
        self.steps_by_group: Counter = Counter()  # worker group -> steps
        self.decode_steps = 0
        self.completed = 0
        self.evicted = 0
        self.shed = 0
        self.canceled = 0
        self.tokens_out = 0
        _live_batchers.add(self)

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
                req.finished_ns = time.monotonic_ns()
                self.shed += 1
                nshed.add(1)
                return False
            nsubmitted.add(1)
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
        req.finished_ns = time.monotonic_ns()
        if state == EVICTED:
            req.error_code = berr.ERPCTIMEDOUT
            self.evicted += 1
            nevicted.add(1)
        elif state == COMPLETED:
            self.completed += 1
            ncompleted.add(1)
        elif state == CANCELED:
            self.canceled += 1
            ncanceled.add(1)
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

    def step(self, group_index: Optional[int] = None) -> bool:
        """One scheduling iteration: sweep, admit, decode once, emit,
        retire. Returns False when there was nothing to do.
        ``group_index`` names the fiber worker group running it."""
        emits: List[Tuple[GenRequest, int]] = []
        done: List[Tuple[GenRequest, str]] = []
        admitted: List[GenRequest] = []
        # the flight deck: one flag check per step; the stamps below are
        # attribute writes on the request's tracker, and the step record
        # lands in the ring after the callbacks, outside this lock
        stats_on = _sstats.enabled()
        t0 = time.monotonic_ns() if stats_on else 0
        t_sweep = 0
        n_evicted = n_canceled = 0
        waiting_after = free_after = kv_used = 0
        with self._lock:
            self._sweep_locked(done)
            if stats_on:
                t_sweep = time.monotonic_ns()
                n_evicted = sum(1 for _, s in done if s == EVICTED)
                n_canceled = len(done) - n_evicted
            while self._free and self._waiting:
                req = self._waiting.popleft()
                i = self._free.pop()
                self._slots[i] = req
                req.slot = i
                req.state = RUNNING
                req.admitted_ns = time.monotonic_ns()
                if req.tracker is not None:
                    req.tracker.gen_admitted(req.admitted_ns)
                self._nrunning += 1
                admitted.append(req)
            active = [(i, r) for i, r in enumerate(self._slots)
                      if r is not None]
            if active:
                self.decode_steps += 1
                self.batch_hist[len(active)] += 1
                if group_index is not None:
                    self.steps_by_group[group_index] += 1
        if not active:
            self._fire(emits, done)
            if stats_on and done:
                self._record_step(t0, t_sweep, t_sweep, t_sweep,
                                  group_index, 0, len(admitted),
                                  n_evicted, n_canceled, 0,
                                  len(self._waiting), len(self._free), 0)
            return bool(done)
        # prefill outside the lock: only step() writes the caches, and
        # steps are serialized by the engine. stop() may retire an
        # admitted request meanwhile (a server going down): its slot is
        # then free and keeps its idle-safe length
        for req in admitted:
            i = req.slot
            if i is None:
                continue
            kp, vp, hl = self.model.prefill(req.prompt)
            n = len(req.prompt)
            self._k[i, :n] = kp
            self._v[i, :n] = vp
            self._h[i] = hl
            with self._lock:
                if self._slots[i] is req:
                    self._lens[i] = n
            if req.tracker is not None:
                req.tracker.gen_prefilled(time.monotonic_ns())
        t_admit = time.monotonic_ns() if stats_on else 0
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
        t_decode = time.monotonic_ns() if stats_on else 0
        with self._lock:
            for i, req in active:
                if self._slots[i] is not req:
                    continue        # cancelled and retired during the step
                tok = int(tokens[i])
                self._lens[i] = lens[i] + 1
                req.tokens.append(tok)
                self.tokens_out += 1
                ntokens.add(1)
                if not req.first_token_ns:
                    req.first_token_ns = time.monotonic_ns()
                if req.tracker is not None:
                    req.tracker.gen_token(time.monotonic_ns())
                emits.append((req, tok))
                if (req.stop_token is not None and tok == req.stop_token) \
                        or req.ntokens >= req.max_new_tokens \
                        or self._lens[i] >= self.cache_len:
                    self._retire_locked(req, COMPLETED, done)
            if stats_on:
                waiting_after = len(self._waiting)
                free_after = len(self._free)
                kv_used = self._used_locked()
        self._fire(emits, done)
        if stats_on:
            self._record_step(t0, t_sweep, t_admit, t_decode,
                              group_index, len(active), len(admitted),
                              n_evicted, n_canceled, len(emits),
                              waiting_after, free_after, kv_used)
        return True

    def _record_step(self, t0: int, t_sweep: int, t_admit: int,
                     t_decode: int, group_index, batch: int,
                     admitted: int, evicted: int, canceled: int,
                     tokens: int, waiting: int, free_slots: int,
                     kv_used: int) -> None:
        """One iteration record into the flight deck's step ring (a leaf
        lock, outside every batcher lock): a positional tuple in
        ``serving_stats.STEP_FIELDS`` order, integer microseconds."""
        t_end = time.monotonic_ns()
        reg = _sstats._registry
        if reg is None:
            reg = _sstats.global_serving_stats()
        reg.note_step_record((
            time.time_ns() // 1_000_000,
            group_index,
            batch,
            admitted,
            evicted,
            canceled,
            tokens,
            waiting,
            free_slots,
            round(kv_used / float(self.max_batch * self.cache_len), 4),
            max(0, t_sweep - t0) // 1000,
            max(0, t_admit - t_sweep) // 1000,
            max(0, t_decode - t_admit) // 1000,
            max(0, t_end - t_decode) // 1000,
            max(0, t_end - t0) // 1000,
        ))

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
            # settle the tracker after the finish callback: emit_us then
            # covers the delivery of the verdict, and the span ends when
            # the client could know its outcome
            if req.tracker is not None:
                cause = None
                if state == EVICTED:
                    cause = "deadline_expired"
                elif state == CANCELED:
                    cause = "client_gone"
                req.tracker.gen_settled(
                    state, cause=cause, finished_ns=req.finished_ns,
                    error_code=req.error_code)

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
            groups = dict(sorted(self.steps_by_group.items()))
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
            "steps_by_group": groups,
            "kv_occupancy": round(
                used / float(self.max_batch * self.cache_len), 4),
            "stopped": self.stopped,
        }
