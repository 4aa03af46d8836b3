"""Per-backend client telemetry (the port of
brpc_tpu/rpc/backend_stats.py): the client's view of its cluster, under
the locality-aware balancer, the retries and the backup requests.

Each (channel, backend endpoint) pair owns a stat cell: a decayed qps,
a latency EWMA and a bounded reservoir for percentiles, an in-flight
gauge, errors by errno, bytes in and out. The channel's attempt path
updates it:

  attempt_start   an attempt was issued at a backend (inflight + 1)
  attempt_error   an attempt failed there and the call went on (its
                  latency observed, its error classed; a shed counts as
                  a reject, with no latency)
  call_complete   the call's verdict: the backend that answered gets
                  the last observation, every other open attempt (a
                  backup that lost the race) is abandoned

so every ``attempts`` increment is matched by one ``completed`` or one
``abandoned``. The cells live in a MultiDimension labelled (channel,
backend): Prometheus gets ``backend_stats_*{channel=..,backend=..}``.
``backends_page_payload`` (``/backends``) and ``lb_trace_payload``
(``/lb_trace``, a bounded ring a channel of select, feedback, abandon,
health and naming events: why each backend was chosen or skipped) feed
the HTTP pages and the builtin methods alike.

``BRPC_TPU_BACKEND_STATS=0`` (read at import) or the flag
``backend_stats_enabled`` turns the layer into one flag check a call.
``_postfork_reset`` is registered with the postfork registry.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.fast_rand import fast_rand_less_than
from brpc_tpu_torch.butil.flags import define_flag, flag as _flag
from brpc_tpu_torch.bvar.multi_dimension import MultiDimension
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.bvar.variable import Variable
from brpc_tpu_torch.bvar.window import PerSecond

from . import errno_codes as berr
from .retry_policy import budget_group_snapshot

define_flag("backend_stats_enabled",
            os.environ.get("BRPC_TPU_BACKEND_STATS", "1") != "0",
            "per-backend client stat cells + LB decision ring "
            "(/backends, /lb_trace); BRPC_TPU_BACKEND_STATS=0 sets the "
            "default off for overhead A/B runs")
define_flag("lb_trace_ring", 256,
            "events kept per channel in the LB decision ring "
            "(/lb_trace)", validator=lambda v: v >= 16)

# a channel made per request must not grow the table without bound: past
# this many cells, new pairs land on one catch-all cell
MAX_CELLS = 4096
_OVERFLOW_KEY = ("_overflow", "_overflow")

EWMA_ALPHA = 0.2

# the sheds: the backend answered "I am shedding" in microseconds. A
# reject neither enters latency telemetry nor counts as breakage (the la
# penalty, the breaker) nor drains retry tokens. ERPCTIMEDOUT is one
# only when a server answered with it (its deadline gate); a timeout on
# the client has no responder and stays a failure.
REJECT_CODES = frozenset({berr.ELIMIT, berr.EOVERCROWDED,
                          berr.EPRIORITYSHED})


def is_reject(code: int, responded_server=None) -> bool:
    return code in REJECT_CODES or (
        code == berr.ERPCTIMEDOUT and responded_server is not None)


def enabled() -> bool:
    return _flag("backend_stats_enabled")


def ep_key(ep) -> str:
    """A backend's row key, ``scheme://host:port`` without extras: the
    naming entry ``tcp://a:1#w=3`` and the socket's ``tcp://a:1`` land on
    one row."""
    if isinstance(ep, EndPoint):
        port = f":{ep.port}" if ep.port else ""
        return f"{ep.scheme}://{ep.host}{port}"
    return str(ep)


class BackendCell(Variable):
    """One (channel, backend) cell, its counters and reservoir under one
    lock (it is updated on every attempt); qps through one Adder and a
    PerSecond window. ``connect_errors`` count selections that were
    never issued and stand outside the attempts balance."""

    SAMPLE_CAP = 512

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._count_var = Adder(0)
        self._qps = PerSecond(self._count_var)
        self.ewma_us = 0.0
        self.inflight = 0
        self.attempts = 0
        self.completed = 0
        self.abandoned = 0
        self.connect_errors = 0
        self.rejects = 0
        self.errors: Dict[str, int] = {}
        self.bytes_in = 0
        self.bytes_out = 0
        self._samples: List[float] = []
        self._nsampled = 0
        self._sum_us = 0.0
        self._max_us = 0.0

    def _count_error_locked(self, code: int) -> None:
        cls = berr.errno_name(code)
        self.errors[cls] = self.errors.get(cls, 0) + 1

    def on_start(self, nbytes_out: int) -> None:
        with self._lock:
            self.inflight += 1
            self.attempts += 1
            self.bytes_out += nbytes_out

    def on_feedback(self, latency_us: float, failed: bool, code: int,
                    nbytes_in: int = 0) -> None:
        with self._lock:
            if self.inflight > 0:
                self.inflight -= 1
            self.completed += 1
            self.bytes_in += nbytes_in
            self._sum_us += latency_us
            self._max_us = max(self._max_us, latency_us)
            # a bounded reservoir: pooled for percentiles, shipped raw on
            # /backends for pooling across nodes
            n = self._nsampled
            self._nsampled = n + 1
            s = self._samples
            if len(s) < self.SAMPLE_CAP:
                s.append(latency_us)
            else:
                i = fast_rand_less_than(n + 1)
                if i < self.SAMPLE_CAP:
                    s[i] = latency_us
            ewma = self.ewma_us
            self.ewma_us = ((1 - EWMA_ALPHA) * ewma + EWMA_ALPHA * latency_us
                            if ewma else latency_us)
            if failed:
                self._count_error_locked(code)
        self._count_var.add(1)

    def on_reject(self, code: int, nbytes_in: int = 0) -> None:
        """The backend shed the attempt: its error class counts, its
        latency does not (a shedding node must not look fast)."""
        with self._lock:
            if self.inflight > 0:
                self.inflight -= 1
            self.completed += 1
            self.rejects += 1
            self.bytes_in += nbytes_in
            self._count_error_locked(code)
        self._count_var.add(1)

    def on_abandon(self) -> None:
        with self._lock:
            if self.inflight > 0:
                self.inflight -= 1
            self.abandoned += 1

    def on_connect_error(self, code: int) -> None:
        with self._lock:
            self.connect_errors += 1
            self._count_error_locked(code)

    def samples(self, limit: int = 256) -> List[float]:
        with self._lock:
            return self._samples[:limit]

    def recent_p50_us(self) -> float:
        """The reservoir's median (0.0 when empty): the bar a backup
        request must clear to be armed."""
        with self._lock:
            s = sorted(self._samples)
        return self._pick(s, 0.5)

    @staticmethod
    def _pick(sorted_samples: List[float], ratio: float) -> float:
        if not sorted_samples:
            return 0.0
        idx = min(len(sorted_samples) - 1, int(ratio * len(sorted_samples)))
        return sorted_samples[idx]

    def get_value(self) -> dict:
        with self._lock:
            nerr = sum(self.errors.values())
            observed = self.completed + self.connect_errors
            s = sorted(self._samples)
            out = {
                "attempts": self.attempts,
                "completed": self.completed,
                "abandoned": self.abandoned,
                "connect_errors": self.connect_errors,
                "rejects": self.rejects,
                "inflight": self.inflight,
                "errors": nerr,
                "error_ratio": round(nerr / observed, 4) if observed
                else 0.0,
                "latency_ewma_us": round(self.ewma_us, 1),
                "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
                "count": self.completed,
                # rejects complete with no latency: the average divides
                # by the observed completions only
                "latency_avg_us": round(
                    self._sum_us / (self.completed - self.rejects), 1)
                if self.completed > self.rejects else 0.0,
                "max_latency_us": self._max_us,
            }
            for cls, n in self.errors.items():
                out[f"errors_{cls}"] = n
        out["qps"] = self._qps.get_value()
        out["latency_p50_us"] = self._pick(s, 0.5)
        out["latency_p90_us"] = self._pick(s, 0.9)
        out["latency_p99_us"] = self._pick(s, 0.99)
        return out


class _BackendDim(MultiDimension):
    """The labelled family with a JSON-safe value for /vars (tuple keys
    would not dump); Prometheus reads the labels through
    ``labeled_items``."""

    def get_value(self) -> Dict[str, object]:
        with self._lock:
            items = list(self._stats.items())
        return {"|".join(k): v.get_value() for k, v in items}


class BackendStats:
    """The process's registry: the cells, the channels' decision rings
    and weak references to the channels (their breaker, health and
    naming state on the page)."""

    def __init__(self):
        self._dim = _BackendDim(("channel", "backend"), BackendCell)
        self._rings: Dict[str, deque] = {}
        self._ring_lock = threading.Lock()
        self._channels: "weakref.WeakValueDictionary[str, object]" = \
            weakref.WeakValueDictionary()
        self.unattributed = 0           # verdicts with no row to land on

    def cell(self, channel: str, backend: str) -> BackendCell:
        key = (channel, backend)
        if not self._dim.has_stats(key) \
                and self._dim.count_stats() >= MAX_CELLS:
            key = _OVERFLOW_KEY
        return self._dim.get_stats(key)

    def rows(self) -> List[Tuple[Tuple[str, str], BackendCell]]:
        return [(k, self._dim.get_stats(k)) for k in self._dim.list_stats()]

    def ring(self, channel: str) -> deque:
        want = _flag("lb_trace_ring")
        with self._ring_lock:
            r = self._rings.get(channel)
            if r is None or r.maxlen != want:
                r = deque(r or (), maxlen=want)
                self._rings[channel] = r
            return r

    def ring_names(self) -> Dict[str, int]:
        with self._ring_lock:
            return {n: len(r) for n, r in self._rings.items()}

    def register_channel(self, name: str, owner) -> None:
        self._channels[name] = owner

    def channel_owner(self, name: str):
        return self._channels.get(name)


_registry: Optional[BackendStats] = None
_registry_lock = threading.Lock()


def global_stats() -> BackendStats:
    global _registry
    reg = _registry
    if reg is None:
        with _registry_lock:
            if _registry is None:
                _registry = BackendStats()
                _registry._dim.expose("backend_stats")
            reg = _registry
    return reg


def expose_backend_vars() -> None:
    """Expose the family again (``Server.start``): a test's
    ``unexpose_all`` must not drop it from /vars."""
    global_stats()._dim.expose("backend_stats")


def _postfork_reset() -> None:
    """A forked child starts its cluster view from zero: the cells
    describe the parent's traffic on sockets the child does not own."""
    global _registry, _registry_lock
    _registry = None
    _registry_lock = threading.Lock()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("rpc.backend_stats", _postfork_reset)


def _backend_census() -> dict:
    """Census: cells and buffered ring events, the reservoirs' samples
    as the bytes (a channel made per request shows as runaway cells)."""
    reg = _registry
    if reg is None:
        return {"count": 0, "events": 0, "bytes": 0}
    nbytes = 0
    for _, cell in reg.rows():
        nbytes += len(cell.samples(1024)) * 8
    events = sum(reg.ring_names().values())
    return {"count": reg._dim.count_stats(), "events": events,
            "bytes": nbytes + events * 200}


from brpc_tpu_torch.butil import resource_census as _census  # noqa: E402
#   (the census registration ships with the registry it measures)

_census.register("backend_stats", _backend_census)


# ------------------------------------------------- attempt accounting
#
# A call's open attempts ride its controller (``cntl._bs_attempts``:
# [backend key, start ns, cell]) under the controller's ``_arb_lock``, a
# re-entrant lock the failure paths may already hold.

def attempt_start(cntl, rec: list, hook=None) -> None:
    """Record an issued attempt; ``hook`` (the channel's completion
    sweep) is registered under the same lock hold, and runs at once if
    the call has already completed, so no record can leak."""
    run_now = False
    with cntl._arb_lock:
        cntl._bs_attempts.append(rec)
        if hook is not None:
            if not cntl._completed:
                if hook not in cntl._complete_hooks:
                    cntl._complete_hooks.append(hook)
            else:
                run_now = True
    if run_now:
        try:
            hook(cntl)
        except Exception:
            pass


def attempt_error(channel: str, cntl, code: int, ep=None) -> None:
    """An attempt failed and the call goes on: its record (by endpoint
    when the path knows it; with a backup in flight the newest record
    may be another, healthy backend's) takes the error. A failure with
    no open record (a connect that never issued) is a connect error."""
    key = ep_key(ep) if ep is not None else None
    rec = None
    with cntl._arb_lock:
        recs = cntl._bs_attempts
        if recs:
            if key is not None:
                for r in reversed(recs):
                    if r[0] == key:
                        rec = r
                        break
            if rec is None:
                rec = recs[-1]
            recs.remove(rec)
    if rec is None:
        reg = global_stats()
        if key is not None:
            reg.cell(channel, key).on_connect_error(code)
        else:
            reg.unattributed += 1
        return
    if code in REJECT_CODES:
        rec[2].on_reject(code)
        return
    rec[2].on_feedback((time.monotonic_ns() - rec[1]) / 1e3, True, code)


def call_complete(cntl) -> None:
    """The call's verdict: the record of the backend that answered (or
    the last attempt's, when none did) takes the final observation, and
    every other open record is abandoned. A cancellation is the
    client's own: every record is abandoned."""
    with cntl._arb_lock:
        recs, cntl._bs_attempts = cntl._bs_attempts, []
    if not recs:
        return
    if cntl.error_code == berr.ECANCELED:
        for rec in recs:
            rec[2].on_abandon()
        return
    winner = recs[-1]
    ep = cntl.responded_server
    if len(recs) > 1 and ep is not None:
        key = ep_key(ep)
        for r in reversed(recs):
            if r[0] == key:
                winner = r
                break
    code = cntl.error_code
    if is_reject(code, ep):
        winner[2].on_reject(code, cntl._bs_resp_bytes)
    else:
        winner[2].on_feedback((time.monotonic_ns() - winner[1]) / 1e3,
                              cntl.failed(), code, cntl._bs_resp_bytes)
    for rec in recs:
        if rec is not winner:
            rec[2].on_abandon()


# ------------------------------------------------ the LB decision ring

def _ep_list(eps, limit: int = 8) -> List[str]:
    out = [ep_key(e) for e in list(eps)[:limit]]
    more = len(eps) - len(out)
    if more > 0:
        out.append(f"+{more} more")
    return out


def ring_event(channel: str, kind: str, ring: Optional[deque] = None,
               **fields) -> None:
    """Append one decision event; a channel on its hot path passes its
    cached ``ring`` (deque.append is thread-safe)."""
    if not enabled():
        return
    fields["t"] = round(time.time(), 3)
    fields["kind"] = kind
    if ring is None:
        ring = global_stats().ring(channel)
    ring.append(fields)


def lb_trace_payload(channel: Optional[str],
                     n: int = 100) -> Optional[dict]:
    """/lb_trace: one channel's latest ``n`` events, oldest first, or,
    with no channel named, the directory of channels. None: no such
    channel."""
    reg = global_stats()
    if not channel:
        return {"channels": reg.ring_names(),
                "hint": "/lb_trace?channel=<name>&n=<events>"}
    with reg._ring_lock:
        r = reg._rings.get(channel)
        events = list(r)[-n:] if r is not None else None
    if events is None:
        return None
    return {"channel": channel, "events": events}


def backends_page_payload(samples: int = 256) -> dict:
    """/backends: rows by channel, each the cell's counters, the
    breaker, health and naming state its channel reports (a closed
    channel's rows stay, with no state), and a bounded raw latency
    reservoir."""
    reg = global_stats()
    channels: Dict[str, dict] = {}
    totals = {"attempts": 0, "completed": 0, "errors": 0, "inflight": 0,
              "abandoned": 0, "connect_errors": 0, "rejects": 0}
    for (ch_name, backend), cell in reg.rows():
        owner = reg.channel_owner(ch_name)
        entry = channels.get(ch_name)
        if entry is None:
            rb = getattr(owner, "_retry_budget", None)
            entry = channels[ch_name] = {
                "lb": getattr(owner, "lb_name", None)
                if owner is not None else None,
                "naming": owner.naming_info()
                if hasattr(owner, "naming_info") else None,
                "retry_budget": rb.snapshot() if rb is not None else None,
                "backends": {},
            }
        row = cell.get_value()
        row["latency_samples"] = cell.samples(samples)
        if owner is not None and hasattr(owner, "backend_state"):
            try:
                row["state"] = owner.backend_state(backend)
            except Exception:
                row["state"] = {"error": "state provider failed"}
        entry["backends"][backend] = row
        for k in totals:
            totals[k] += row.get(k, 0)
    return {
        "enabled": enabled(),
        "channels": channels,
        "totals": totals,
        "budget_groups": budget_group_snapshot(),
        "unattributed_errors": reg.unattributed,
    }
