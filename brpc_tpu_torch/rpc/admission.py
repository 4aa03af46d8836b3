"""Priority admission (the port of brpc_tpu/rpc/admission.py, after
WeChat's DAGOR, Zhou et al., SoCC'18): weighted limiter slots, and
shedding by a two-level priority with the threshold sent back to the
callers.

- The level: ``priority << 7 | user_slot``, the business priority from
  ``RpcRequestMeta.priority`` and the user slot a stable hash (crc32) of
  the caller: the connection's client address (the reference also takes
  an auth token, which the port does not carry). A threshold can cut
  part of a class, and one caller is kept or shed consistently.
- The threshold: while the limiter or the queue-delay gate signals
  overload, each window raises the share of the window's levels to shed
  and puts the threshold at that quantile; calm windows relax it. It
  never reaches into the highest class seen, so traffic of one priority
  (untagged traffic) is never shed by priority.
- The cost: with ``ServerOptions(request_costs=True)`` a request takes
  ``1 + its method's latency bucket + a slot a 64 KiB`` of the limit.

The threshold rides ``RpcResponseMeta.admission_threshold`` (field 3);
clients keep it and fail doomed sends themselves (``rpc/channel.py``).
``BRPC_TPU_ADMISSION=0`` (read at import) or the flag
``admission_enabled`` turns it off.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
import zlib
from typing import Optional

from brpc_tpu_torch.butil.flags import define_flag, flag as _flag

from .backend_stats import ep_key

define_flag("admission_enabled",
            os.environ.get("BRPC_TPU_ADMISSION", "1") != "0",
            "DAGOR priority-admission layer (two-level threshold "
            "shedding + response piggyback); BRPC_TPU_ADMISSION=0 sets "
            "the default off for overhead A/B runs")

USER_SLOTS = 128            # user slots a business class
LEVEL_SHIFT = 7             # level = priority << 7 | user_slot
MAX_PRIORITY = 127


def admission_enabled() -> bool:
    return _flag("admission_enabled")


def user_slot(identity) -> int:
    """A stable slot in [0, 127] for a caller identity: crc32, not
    ``hash``, which is salted per process, since client and server must
    compute the same slot."""
    if not identity:
        return 0
    if isinstance(identity, str):
        identity = identity.encode("utf-8", "surrogatepass")
    return zlib.crc32(identity) & (USER_SLOTS - 1)


def cached_socket_slot(socket, ep) -> int:
    """The user slot of a connection, cached on the socket. ``ep`` is the
    endpoint that names the client (the server's ``remote_endpoint``,
    the client's ``local_endpoint``: the same address), so both sides
    compute the same slot."""
    slot = socket.user_data.get("adm_user_slot")
    if slot is None:
        slot = user_slot(ep_key(ep)) if ep is not None else 0
        socket.user_data["adm_user_slot"] = slot
    return slot


def compose_level(priority: int, slot: int) -> int:
    """One admission integer; higher is more important, the class
    first."""
    priority = min(max(priority, 0), MAX_PRIORITY)
    return (priority << LEVEL_SHIFT) | (slot & (USER_SLOTS - 1))


class CostModel:
    """A request's weight in the limiter: its method's latency bucket
    (the reservoir p50, refreshed at most once a second) plus one slot
    a 64 KiB, capped."""

    UNIT_BYTES = 64 * 1024
    MAX_COST = 64.0
    REFRESH_S = 1.0
    # method p50 (us) -> extra weight
    LAT_BUCKETS = ((1_000.0, 0.0), (10_000.0, 1.0),
                   (100_000.0, 3.0), (float("inf"), 7.0))

    def __init__(self, server):
        # weak: the server owns the model
        self._server_ref = weakref.ref(server)
        self._method_weights: dict = {}
        self._next_refresh = 0.0

    def request_cost(self, method_key: Optional[str], nbytes: int) -> float:
        now = time.monotonic()
        if now >= self._next_refresh:
            self._refresh_weights(now)
        cost = 1.0 + self._method_weights.get(method_key, 0.0)
        if nbytes > self.UNIT_BYTES:
            cost += nbytes / self.UNIT_BYTES
        return min(cost, self.MAX_COST)

    def _refresh_weights(self, now: float) -> None:
        """Racy by design: refreshers compute the same table and the swap
        is atomic; a lock would sit on the admission path for a
        once-a-second event."""
        self._next_refresh = now + self.REFRESH_S
        server = self._server_ref()
        if server is None:
            return
        weights = {}
        for key, lr in list(server.method_status.items()):
            p50 = lr.latency_percentile(0.5)
            if not p50:
                continue
            for bound, w in self.LAT_BUCKETS:
                if p50 <= bound:
                    if w:
                        weights[key] = w
                    break
        self._method_weights = weights


class AdmissionController:
    """The windowed threshold over (business, user) levels. Calm and with
    no threshold, ``threshold_engaged`` is one attribute read. Overload
    signals (limiter rejects, queue-delay sheds) arm it; from then each
    request's level enters the window's histogram and each window moves
    the shed share: up while signals come, down while calm."""

    WINDOW_S = 0.5
    MAX_SHED_FRAC = 0.95
    STEP_UP_MIN = 0.05
    STEP_DOWN = 0.10
    HIST_CAP = 2048             # distinct levels a window

    def __init__(self, window_s: Optional[float] = None):
        self._lock = threading.Lock()
        self._armed = False
        self._threshold = 0
        self._shed_frac = 0.0
        self._hist: dict = {}
        self._win_total = 0
        self._win_over = 0
        self._win_start = time.monotonic()
        self._shed_count = 0
        if window_s:
            self.WINDOW_S = float(window_s)

    def threshold_engaged(self) -> bool:
        """True while admission has something to say; a racy read, so a
        calm server pays no lock."""
        return self._armed

    def admit_level(self, level: int) -> bool:
        """Count the level into the window and judge it (called while
        engaged); False: shed with EPRIORITYSHED."""
        with self._lock:
            self._tally_locked(level)
            self._maybe_adapt_locked()
            shed = level < self._threshold
            if shed:
                self._shed_count += 1
        return not shed

    def signal_overload(self, level: int = 0,
                        counted: bool = False) -> None:
        """An overload gate rejected work: arm, and count the evidence.
        ``counted``: ``admit_level`` already tallied this request."""
        with self._lock:
            self._armed = True
            self._win_over += 1
            if not counted:
                self._tally_locked(level)
            self._maybe_adapt_locked()

    def _tally_locked(self, level: int) -> None:
        self._win_total += 1
        h = self._hist
        n = h.get(level)
        if n is None and len(h) >= self.HIST_CAP:
            return
        h[level] = (n or 0) + 1

    def _maybe_adapt_locked(self) -> None:
        now = time.monotonic()
        if now - self._win_start < self.WINDOW_S:
            return
        total = self._win_total
        over = self._win_over
        if over > 0 and total > 0:
            # half the observed overflow, at least STEP_UP_MIN: chasing
            # it whole oscillates against the load the shed removes
            step = max(self.STEP_UP_MIN, 0.5 * over / total)
            self._shed_frac = min(self.MAX_SHED_FRAC,
                                  self._shed_frac + step)
        else:
            self._shed_frac = max(0.0, self._shed_frac - self.STEP_DOWN)
        self._threshold = self._quantile_threshold_locked(total)
        if self._threshold == 0 and self._shed_frac == 0.0 and over == 0:
            self._armed = False
        self._hist = {}
        self._win_total = 0
        self._win_over = 0
        self._win_start = now

    def _quantile_threshold_locked(self, total: int) -> int:
        """The least T with count(levels < T) >= shed share x total,
        clamped to the floor of the highest class seen (never shed)."""
        if self._shed_frac <= 0.0 or not total or not self._hist:
            return 0
        levels = sorted(self._hist)
        top_band_floor = (levels[-1] >> LEVEL_SHIFT) << LEVEL_SHIFT
        if top_band_floor <= 0:
            return 0
        target = self._shed_frac * total
        cum = 0
        threshold = 0
        for lvl in levels:
            if cum >= target:
                break
            threshold = lvl + 1
            cum += self._hist[lvl]
        return min(threshold, top_band_floor)

    def wire_threshold(self) -> int:
        """The value for ``RpcResponseMeta.admission_threshold`` (racy
        read; 0 is calm, and the field stays off the wire)."""
        return self._threshold

    def admission_snapshot(self) -> dict:
        with self._lock:
            return {"threshold": self._threshold,
                    "armed": self._armed,
                    "shed_frac": round(self._shed_frac, 3),
                    "priority_sheds": self._shed_count}
