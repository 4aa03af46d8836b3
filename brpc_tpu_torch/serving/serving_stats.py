"""Serving flight deck (the port of brpc_tpu/serving/serving_stats.py):
token-granular telemetry under the inference lane.

  * **per-method stat cells** — one :class:`ServingCell` per Generate
    method (a MultiDimension family exposed as ``serving_stats``, so
    prometheus reads ``serving_stats_*{method=}``): request/terminal
    counters, summed queue/prefill/decode/emit microseconds, bounded
    TTFT and per-token TPOT reservoirs (pooled on merge, never
    averaged), and eviction/shed cause counts;
  * **a generation tracker** — one :class:`GenTracker` rides each
    GenRequest through the batcher, stamped at the step waypoints
    (submit -> admit -> prefill-done -> decode-done -> emitted).
    Derived: ``queue_us = admit - submit``, ``prefill_us``,
    ``decode_us``, ``emit_us`` — summing to the stream latency by
    construction. Under rpcz the tracker carries a ``side="serving"``
    child span of the owning RPC span (trace inherited through the
    serving controller), annotated with the eviction/shed cause;
  * **iteration telemetry** — one bounded ring of per-step records
    (batch occupancy, admit/evict counts, sweep/admit/decode/emit
    breakdown, wait-queue depth) behind one leaf lock
    (``ServingStats._ring_lock``): the step is the scheduling unit, so
    the step is what the flight deck replays.

The thread-label hooks (``stamp_serving_thread`` /
``serving_thread_label``) name the serving work a thread does outside
any fiber (warm-up, decode slices), for a sampler to read.

Cost gating: ``BRPC_TPU_SERVING_STATS=0`` (env, read at import) or the
runtime flag ``serving_stats_enabled`` turns the layer into one flag
check per request.

The module stays light: stdlib, butil, bvar and rpc/span, never torch.
The batcher is read through ``sys.modules``, never imported.
``serving_ttft_p99_us`` is declared a max trend series
(``bvar/series.py``), and ``_serving_census`` is the ``serving_lane``
provider of ``/census``; ``_postfork_reset`` is registered with the
postfork registry of shard groups.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from brpc_tpu_torch.butil.fast_rand import fast_rand_less_than
from brpc_tpu_torch.butil.flags import define_flag, flag as _flag
from brpc_tpu_torch.bvar.latency_recorder import LatencyRecorder
from brpc_tpu_torch.bvar.multi_dimension import MultiDimension
from brpc_tpu_torch.bvar.reducer import PassiveStatus
from brpc_tpu_torch.bvar.series import KIND_MAX, declare_series_kind
from brpc_tpu_torch.bvar.variable import Variable
from brpc_tpu_torch.rpc import span as _span_mod

define_flag("serving_stats_enabled",
            os.environ.get("BRPC_TPU_SERVING_STATS", "1") != "0",
            "per-method serving stat cells + generation trackers + the "
            "step ring (/serving panes); BRPC_TPU_SERVING_STATS=0 sets "
            "the default off for overhead A/B runs")
define_flag("serving_step_ring_cap", 256,
            "per-step iteration records kept in the bounded step ring "
            "(/serving 'steps' pane)")

# a runaway caller (a method label per request) must degrade to a
# bounded table, not an unbounded registry — overflow lands on one cell
MAX_CELLS = 64
_OVERFLOW_KEY = ("_overflow",)

# bounded cause table per cell: evictions/sheds annotate WHY a request
# left; an attacker-controlled cause string must not grow the cell
_MAX_CAUSES = 16


def enabled() -> bool:
    return _flag("serving_stats_enabled")


class ServingCell(Variable):
    """One per-method stat cell. Counter discipline: every
    ``requests`` increment is matched by exactly one terminal increment
    (``completed``/``evicted``/``shed``/``canceled``/``rejected``) at
    settle. Single lock + bounded reservoirs (the DeviceCell
    discipline — a composed LatencyRecorder costs ~4x on a per-request
    path); the settle path takes the lock ONCE per request lifetime."""

    SAMPLE_CAP = 256

    __slots__ = ("_cell_lock", "requests", "admitted", "completed",
                 "evicted", "shed", "canceled", "rejected", "tokens_out",
                 "queue_us_sum", "prefill_us_sum", "decode_us_sum",
                 "emit_us_sum", "_ttft_samples", "_nttft",
                 "_tpot_samples", "_ntpot", "_max_ttft_us", "causes")

    def __init__(self):
        super().__init__()
        self._cell_lock = threading.Lock()
        self.requests = 0
        self.admitted = 0
        self.completed = 0
        self.evicted = 0
        self.shed = 0
        self.canceled = 0
        self.rejected = 0           # unservable (prompt too long)
        self.tokens_out = 0
        self.queue_us_sum = 0.0
        self.prefill_us_sum = 0.0
        self.decode_us_sum = 0.0
        self.emit_us_sum = 0.0
        self._ttft_samples: List[float] = []
        self._nttft = 0
        self._tpot_samples: List[float] = []
        self._ntpot = 0
        self._max_ttft_us = 0.0
        self.causes: Dict[str, int] = {}

    # ------------------------------------------------------------ updates
    def note_gen_open(self) -> None:
        with self._cell_lock:
            self.requests += 1

    @staticmethod
    def _reservoir_add(samples: List[float], n: int, x: float) -> int:
        """Bounded uniform reservoir (returns the new population n)."""
        if len(samples) < ServingCell.SAMPLE_CAP:
            samples.append(x)
        else:
            i = fast_rand_less_than(n + 1)
            if i < ServingCell.SAMPLE_CAP:
                samples[i] = x
        return n + 1

    def _settle_locked(self, state: str, queue_us: float,
                       prefill_us: float, decode_us: float,
                       emit_us: float, ntokens: int, was_admitted: bool,
                       ttft_us: Optional[float], tpots: List[float],
                       cause: Optional[str]) -> None:
        # caller (GenTracker.gen_settled) already holds _cell_lock —
        # the settle latch and the counter writes share one acquisition
        if state == "completed":
            self.completed += 1
        elif state == "evicted":
            self.evicted += 1
        elif state == "shed":
            self.shed += 1
        elif state == "rejected":
            self.rejected += 1
        else:
            self.canceled += 1
        if was_admitted:
            self.admitted += 1
        self.tokens_out += ntokens
        self.queue_us_sum += queue_us
        self.prefill_us_sum += prefill_us
        self.decode_us_sum += decode_us
        self.emit_us_sum += emit_us
        if ttft_us is not None:
            self._nttft = self._reservoir_add(
                self._ttft_samples, self._nttft, ttft_us)
            if ttft_us > self._max_ttft_us:
                self._max_ttft_us = ttft_us
        for t in tpots:
            self._ntpot = self._reservoir_add(
                self._tpot_samples, self._ntpot, t)
        if cause:
            if cause in self.causes or len(self.causes) < _MAX_CAUSES:
                self.causes[cause] = self.causes.get(cause, 0) + 1
            else:
                self.causes["_other"] = self.causes.get("_other", 0) + 1

    # ------------------------------------------------------------- reads
    def ttft_samples(self, limit: int = 256) -> List[float]:
        with self._cell_lock:
            return self._ttft_samples[:limit]

    def tpot_samples(self, limit: int = 256) -> List[float]:
        with self._cell_lock:
            return self._tpot_samples[:limit]

    @staticmethod
    def _pick(sorted_samples: List[float], ratio: float) -> float:
        if not sorted_samples:
            return 0.0
        idx = min(len(sorted_samples) - 1,
                  int(ratio * len(sorted_samples)))
        return sorted_samples[idx]

    def get_value(self) -> dict:
        with self._cell_lock:
            st = sorted(self._ttft_samples)
            sp = sorted(self._tpot_samples)
            settled = (self.completed + self.evicted + self.shed
                       + self.canceled + self.rejected)
            out = {
                "requests": self.requests,
                "admitted": self.admitted,
                "completed": self.completed,
                "evicted": self.evicted,
                "shed": self.shed,
                "canceled": self.canceled,
                "rejected": self.rejected,
                "settled": settled,
                "tokens_out": self.tokens_out,
                "queue_us_sum": round(self.queue_us_sum, 1),
                "prefill_us_sum": round(self.prefill_us_sum, 1),
                "decode_us_sum": round(self.decode_us_sum, 1),
                "emit_us_sum": round(self.emit_us_sum, 1),
                "max_ttft_us": self._max_ttft_us,
                "causes": dict(self.causes),
            }
        out["ttft_p50_us"] = self._pick(st, 0.5)
        out["ttft_p99_us"] = self._pick(st, 0.99)
        out["tpot_p50_us"] = self._pick(sp, 0.5)
        out["tpot_p99_us"] = self._pick(sp, 0.99)
        return out


class _ServingDim(MultiDimension):
    """The labeled family with a JSON-safe get_value (the /vars dump
    json.dumps's the value; tuple keys would raise) — prometheus reads
    labels through ``labeled_items()`` so ``serving_stats_*{method=}``
    series stay properly labeled."""

    def get_value(self) -> Dict[str, object]:
        with self._lock:
            items = list(self._stats.items())
        return {"|".join(k): v.get_value() for k, v in items}


class GenTracker:
    """One generation's stage timeline, riding the GenRequest through
    the batcher (the cell rides the record: step() never touches the
    registry). Stamps are plain attribute writes by
    design: every waypoint fires on the single stepping thread (the
    engine decode lock serializes steps), so only the settle needs the
    cell lock — and a settle can race between the batcher's on_finish
    path and the service's shed path, hence the ``_done`` latch under
    it."""

    __slots__ = ("cell", "span", "t_created", "t_admitted",
                 "t_prefilled", "t_first_token", "_last_token_ns",
                 "_tpots", "ntokens", "_done")

    def __init__(self, cell: ServingCell, span, created_ns: int):
        self.cell = cell
        self.span = span
        self.t_created = created_ns
        self.t_admitted = 0
        self.t_prefilled = 0
        self.t_first_token = 0
        self._last_token_ns = 0
        self._tpots: List[float] = []
        self.ntokens = 0
        self._done = False

    # stamp verbs are deliberately unique across the tree (lock-model
    # unique-method fallback: a shared name would mint false call edges)
    def gen_admitted(self, t_ns: int) -> None:
        self.t_admitted = t_ns

    def gen_prefilled(self, t_ns: int) -> None:
        self.t_prefilled = t_ns

    def gen_token(self, t_ns: int) -> None:
        self.ntokens += 1
        if not self.t_first_token:
            self.t_first_token = t_ns
        else:
            self._tpots.append((t_ns - self._last_token_ns) / 1e3)
        self._last_token_ns = t_ns

    def gen_settled(self, state: str, cause: Optional[str] = None,
                    finished_ns: int = 0, error_code: int = 0) -> None:
        """Terminal stamp: derive the four stages (telescoping
        fallbacks — a stage never reached contributes 0 and its time
        lands in the previous stage, so the sum ALWAYS equals the
        stream latency), settle the cell under ONE lock, then stamp and
        submit the span outside it."""
        now = time.monotonic_ns()
        fin = finished_ns or now
        adm = self.t_admitted or fin       # never admitted: all queue
        pre = self.t_prefilled or adm
        queue_us = max(0.0, (adm - self.t_created) / 1e3)
        prefill_us = max(0.0, (pre - adm) / 1e3)
        decode_us = max(0.0, (fin - pre) / 1e3)
        emit_us = max(0.0, (now - fin) / 1e3)
        ttft_us = None
        if self.t_first_token:
            ttft_us = max(0.0, (self.t_first_token - self.t_created)
                          / 1e3)
        cell = self.cell
        with cell._cell_lock:
            if self._done:
                return
            self._done = True
            cell._settle_locked(state, queue_us, prefill_us, decode_us,
                                emit_us, self.ntokens,
                                bool(self.t_admitted), ttft_us,
                                self._tpots, cause)
        reg = _registry
        if reg is not None:
            if ttft_us is not None:
                reg._ttft.record(ttft_us)
            if self._tpots:
                # record_batch, the native serving-loop idiom: the
                # request's decode train lands as avg x count (one
                # percentile sample). Per-record would cost ~8us x
                # max_new_tokens at settle; the RAW per-token
                # distribution lives in the cell reservoirs and pools
                # at merge, so nothing is lost to the batch form.
                reg._tpot.record_batch(
                    sum(self._tpots) / len(self._tpots),
                    len(self._tpots))
        span = self.span
        if span is not None:
            span.write_done_us = adm // 1000
            span.first_byte_us = pre // 1000
            span.serialized_us = fin // 1000
            span.end_us = now // 1000
            span.error_code = span.error_code or error_code
            if cause:
                span.annotate(f"{state}: {cause}")
            span.annotate(
                f"queue_us={queue_us:.0f} prefill_us={prefill_us:.0f} "
                f"decode_us={decode_us:.0f} emit_us={emit_us:.0f} "
                f"tokens={self.ntokens}")
            _span_mod.submit_span(span)


# the step ring's record schema: the batcher writes positional tuples
# in THIS order (cheap on the per-iteration path), step_records() zips
# them back into dicts for every reader
STEP_FIELDS = ("t_ms", "group", "batch", "admitted", "evicted",
               "canceled", "tokens", "waiting", "free_slots",
               "kv_occupancy", "sweep_us", "admit_us", "decode_us",
               "emit_us", "step_us")


class ServingStats:
    """Process-wide registry: the labeled cell family, the pooled
    TTFT/TPOT LatencyRecorders (the timeline's quantile tracks), and
    the bounded step ring. ``_ring_lock`` is a leaf: it guards the ring only and is never held across a callback
    or another lock."""

    def __init__(self):
        self._dim = _ServingDim(("method",), ServingCell)
        self._ttft = LatencyRecorder()
        self._tpot = LatencyRecorder()
        self._ring_lock = threading.Lock()
        self._steps: deque = deque(
            maxlen=int(_flag("serving_step_ring_cap")))
        self._nsteps = 0

    def serving_cell(self, method: str) -> ServingCell:
        key = (method,)
        if not self._dim.has_stats(key) \
                and self._dim.count_stats() >= MAX_CELLS:
            key = _OVERFLOW_KEY
        return self._dim.get_stats(key)

    def rows(self) -> List:
        return [(k, self._dim.get_stats(k))
                for k in self._dim.list_stats()]

    # ------------------------------------------------------- step ring
    # Records travel as POSITIONAL TUPLES matching STEP_FIELDS and
    # become dicts only at read time: the writer runs once per engine
    # iteration from cold caches (a 14-key dict build measured ~3x a
    # tuple there), readers run when an operator looks.
    def note_step_record(self, rec: tuple) -> None:
        with self._ring_lock:
            self._steps.append(rec)
            self._nsteps += 1

    def step_records(self, n: int = 64) -> List[dict]:
        with self._ring_lock:
            tail = list(self._steps)[-n:]
        return [dict(zip(STEP_FIELDS, r)) for r in tail]

    def steps_recorded(self) -> int:
        with self._ring_lock:
            return self._nsteps


_registry: Optional[ServingStats] = None
_registry_lock = threading.Lock()


def global_serving_stats() -> ServingStats:
    global _registry
    reg = _registry
    if reg is None:
        with _registry_lock:
            if _registry is None:
                _registry = ServingStats()
                _registry._dim.expose("serving_stats")
            reg = _registry
    return reg


def expose_serving_stats_vars() -> None:
    """(Re-)expose the labeled family + the pooled recorders — called
    from expose_serving_vars (Server.start), surviving a test
    fixture's unexpose_all. ``serving_ttft_us``/``serving_tpot_us``
    give ``.p99`` quantile tracks on /timeline (watchdog keys);
    ``serving_ttft_p99_us`` is the instant p99 gauge, a max series."""
    reg = global_serving_stats()
    reg._dim.expose("serving_stats")
    reg._ttft.expose("serving_ttft_us")
    reg._tpot.expose("serving_tpot_us")
    PassiveStatus(lambda: float(
        global_serving_stats()._ttft.latency_percentile(0.99))).expose(
        "serving_ttft_p99_us")
    declare_series_kind("serving_ttft_p99_us", KIND_MAX)


# ---------------------------------------------------- generation hooks

def open_generation(service: str, method: str, cntl=None,
                    created_ns: Optional[int] = None) -> \
        Optional[GenTracker]:
    """One tracker per GenRequest; None when the layer is disabled (the
    single flag check the request path pays). Under rpcz the tracker
    carries a ``side="serving"`` child of the owning RPC span — trace
    inherited through the serving controller, whose
    trace_id/span_id start_server_span stamped."""
    if not enabled():
        return None
    label = f"{service}.{method}" if service else method
    cell = global_serving_stats().serving_cell(label)
    cell.note_gen_open()
    span = None
    if cntl is not None and _flag("rpcz_enabled"):
        span = _span_mod.start_serving_span(cntl, service, method)
    tr = GenTracker(cell, span,
                    created_ns if created_ns is not None
                    else time.monotonic_ns())
    if span is not None:
        span.start_us = tr.t_created // 1000
    return tr


# ----------------------------------------------- flight-recorder labels
#
# Threads doing serving work outside any fiber or worker-module slice
# (engine warm-up on the start thread, decode slices once the module
# label clears) stamp a label here; the flight recorder's sampler
# resolves this module through sys.modules (never an import on the
# sampler tick) and reads
# ``serving_thread_label``. Plain dict + GIL-atomic ops: the sampler
# only reads.

_thread_labels: Dict[int, str] = {}


def stamp_serving_thread(label: str, tid: Optional[int] = None) -> None:
    _thread_labels[tid if tid is not None
                   else threading.get_ident()] = label


def unstamp_serving_thread(tid: Optional[int] = None) -> None:
    _thread_labels.pop(tid if tid is not None
                       else threading.get_ident(), None)


def serving_thread_label(tid: int) -> Optional[str]:
    return _thread_labels.get(tid)


# --------------------------------------------------------------- pages

def serving_obs_pane(samples: int = 128, steps: int = 64) -> dict:
    """The flight-deck pane of the /serving payload (one function:
    serving_page_payload embeds it for the HTTP route and the builtin
    RPC alike). Cells carry bounded raw TTFT/TPOT reservoirs for
    cross-node pooling (merge_serving_panes): pooled, never averaged."""
    out: dict = {"enabled": enabled()}
    reg = _registry
    if reg is None:
        out["methods"] = {}
        out["steps"] = []
        out["steps_total"] = 0
        return out
    methods: Dict[str, dict] = {}
    for key, cell in reg.rows():
        row = cell.get_value()
        row["ttft_samples"] = cell.ttft_samples(samples)
        row["tpot_samples"] = cell.tpot_samples(samples)
        methods["|".join(key)] = row
    out["methods"] = methods
    # the lane's live rate, read (never imported) off the batcher
    # module's PerSecond window, so the pane needs no second endpoint
    bm = sys.modules.get("brpc_tpu_torch.serving.batcher")
    tps = getattr(bm, "_tokens_ps", None) if bm is not None else None
    out["tokens_per_second_10s"] = round(float(tps.get_value()), 2) \
        if tps is not None else 0.0
    out["ttft"] = {
        "count": reg._ttft.count(),
        "p50_us": reg._ttft.latency_percentile(0.5),
        "p99_us": reg._ttft.latency_percentile(0.99),
        "max_us": reg._ttft.max_latency(),
    }
    out["tpot"] = {
        "count": reg._tpot.count(),
        "p50_us": reg._tpot.latency_percentile(0.5),
        "p99_us": reg._tpot.latency_percentile(0.99),
    }
    out["steps"] = reg.step_records(steps)
    out["steps_total"] = reg.steps_recorded()
    return out


def merge_serving_panes(panes: List[dict]) -> dict:
    """The supervisor's group-wide flight-deck pane: per-shard panes
    merged — counters sum, TTFT/TPOT samples POOL with percentiles
    recomputed (never averaged), cause tables sum, step rings concat
    bounded (newest last, tagged with the reporting index)."""
    out: dict = {"enabled": any(p.get("enabled") for p in panes)}
    methods: Dict[str, dict] = {}
    pooled_t: Dict[str, List[float]] = {}
    pooled_p: Dict[str, List[float]] = {}
    for idx, p in enumerate(panes):
        for key, row in (p.get("methods") or {}).items():
            m = methods.setdefault(key, {"causes": {}})
            for k, v in row.items():
                if k == "ttft_samples":
                    pooled_t.setdefault(key, []).extend(v or ())
                elif k == "tpot_samples":
                    pooled_p.setdefault(key, []).extend(v or ())
                elif k == "causes":
                    for c, n in (v or {}).items():
                        m["causes"][c] = m["causes"].get(c, 0) + n
                elif k.startswith("max"):
                    if isinstance(v, (int, float)):
                        m[k] = max(m.get(k, 0), v)
                elif isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    m[k] = m.get(k, 0) + v
    all_t: List[float] = []
    all_p: List[float] = []
    for key, m in methods.items():
        st = sorted(pooled_t.get(key, ()))
        sp = sorted(pooled_p.get(key, ()))
        all_t.extend(st)
        all_p.extend(sp)
        m["ttft_p50_us"] = ServingCell._pick(st, 0.5)
        m["ttft_p99_us"] = ServingCell._pick(st, 0.99)
        m["tpot_p50_us"] = ServingCell._pick(sp, 0.5)
        m["tpot_p99_us"] = ServingCell._pick(sp, 0.99)
        # bound the re-exported reservoirs by EVEN STRIDE over the
        # sorted pool — keeping the head would hand a downstream
        # pooler a tail-less set whose "p99" is really ~p12
        for nm, s in (("ttft_samples", st), ("tpot_samples", sp)):
            if len(s) > ServingCell.SAMPLE_CAP:
                step = len(s) / float(ServingCell.SAMPLE_CAP)
                m[nm] = [s[int(i * step)]
                         for i in range(ServingCell.SAMPLE_CAP)]
            else:
                m[nm] = s
    out["methods"] = methods
    out["tokens_per_second_10s"] = round(
        sum(p.get("tokens_per_second_10s", 0) or 0 for p in panes), 2)
    all_t.sort()
    all_p.sort()
    out["ttft"] = {"count": len(all_t),
                   "p50_us": ServingCell._pick(all_t, 0.5),
                   "p99_us": ServingCell._pick(all_t, 0.99),
                   "max_us": max([0.0] + [m.get("max_ttft_us", 0) or 0
                                          for m in methods.values()])}
    out["tpot"] = {"count": len(all_p),
                   "p50_us": ServingCell._pick(all_p, 0.5),
                   "p99_us": ServingCell._pick(all_p, 0.99)}
    cap = int(_flag("serving_step_ring_cap"))
    steps: List[dict] = []
    for idx, p in enumerate(panes):
        for rec in (p.get("steps") or ()):
            r = dict(rec)
            r["shard"] = idx
            steps.append(r)
    out["steps"] = steps[-cap:]
    out["steps_total"] = sum(p.get("steps_total", 0) or 0
                             for p in panes)
    return out


# -------------------------------------------------------- fork hygiene

def _postfork_reset() -> None:
    """Fork hygiene: every cell describes PARENT-side generations on a
    batcher the child rebuilds at its own start, and the step ring
    replays the parent's iterations; a forked shard starts its flight
    deck from zero."""
    global _registry, _registry_lock, _thread_labels
    _registry = None
    _registry_lock = threading.Lock()
    _thread_labels = {}


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("serving.serving_stats", _postfork_reset)


# --------------------------------------------------------------- census

def _serving_census() -> dict:
    """Resource census: the KV-slot bytes every live batcher pins (the
    [max_batch, cache_len, dim] k/v/h arrays) plus what the flight
    deck itself holds (reservoirs + step ring) — so /census totals
    include the serving lane's working set."""
    count = 0
    nbytes = 0
    bm = sys.modules.get("brpc_tpu_torch.serving.batcher")
    if bm is not None:
        for b in list(bm._live_batchers):
            count += 1
            for arr in (b._k, b._v, b._h, b._lens):
                nbytes += getattr(arr, "nbytes", 0)
    reg = _registry
    if reg is not None:
        for _, cell in reg.rows():
            nbytes += (len(cell.ttft_samples(1024))
                       + len(cell.tpot_samples(1024))) * 8
        nbytes += len(reg.step_records(4096)) * 96
    return {"count": count, "bytes": nbytes}


from brpc_tpu_torch.butil import resource_census as _census  # noqa: E402
#   (the census registration ships with the registry it measures)

_census.register("serving_lane", _serving_census)
