"""Per-lane device telemetry (the port of
brpc_tpu/transport/device_stats.py): the measurement under the
``mem://``, ``cuda://``, ``cudad://`` and ``ici://`` device lanes.

Each (peer, lane-kind) pair owns a stat cell (:class:`DeviceCell`):

  transfers / completed / failed, balanced on every cell
  (``transfers == completed + failed``), staged-fallback count (the
  pull lane degraded to host staging), bytes out and in with a decayed
  bytes-per-second window, a bounded transfer-latency reservoir (pooled
  on read, never averaged), and summed stage, wire and ack microseconds.

A transfer's life is carried by a :class:`BatchTracker` stamped at four
waypoints:

  t_submit   Socket.write_device_payload entered
  t_encoded  descriptor encoded / tensors registered for the peer's
             pull (or the staged fallback serialized): host stage done
  t_flushed  the frame's bytes fully handed to the TCP socket
  t_done     the peer's cumulative ACK covered this batch, or the
             loopback delivery

Derived: ``stage_us = t_encoded - t_submit``, ``wire_us = t_flushed -
t_encoded``, ``ack_us = t_done - t_flushed``; they sum to the transfer's
latency by construction. When rpcz is on, the tracker also carries a
child span of the owning RPC span (``rpc/span.py``
``start_device_span``), so /rpcz shows the device legs inside the call
tree. The receive side is timed by ``Socket.take_device_payload``
(``DeviceCell.note_recv``, and with rpcz the socket's
``last_device_take`` record, which dispatch turns into a
``device-recv`` child span).

The thread labels at the bottom (``stamp_device_thread``) name the
threads that do device work outside any fiber: the device poller's pump
and waiter threads.

Cost gating: ``BRPC_TPU_DEVICE_STATS=0`` (read at import) or the flag
``device_stats_enabled`` turns the layer into one flag check a transfer.

Two pieces of the reference wait for shard groups (ROADMAP section 1):
``merge_device_payloads`` (the supervisor's merged view) and the
``device_probe_path`` pane; the census row waits for the resource
census, and ``_postfork_reset`` waits, unregistered, for the postfork
registry.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.butil.fast_rand import fast_rand_less_than
from brpc_tpu_torch.butil.flags import define_flag, flag as _flag
from brpc_tpu_torch.bvar.multi_dimension import MultiDimension
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.bvar.variable import Variable
from brpc_tpu_torch.bvar.window import PerSecond

define_flag("device_stats_enabled",
            os.environ.get("BRPC_TPU_DEVICE_STATS", "1") != "0",
            "per-(peer, lane) device transfer stat cells + stage "
            "trackers (/device); BRPC_TPU_DEVICE_STATS=0 sets the "
            "default off for overhead A/B runs")

# a runaway caller (a conn per request) degrades to a bounded table:
# overflow lands on one cell
MAX_CELLS = 1024
_OVERFLOW_KEY = ("_overflow", "_overflow")

_ICI_MODULE = "brpc_tpu_torch.transport.ici"


def enabled() -> bool:
    return _flag("device_stats_enabled")


def peer_key(ep) -> str:
    """Canonical peer label: scheme://host:port with extras stripped
    (``#device=K`` variants of one peer land on one row)."""
    scheme = getattr(ep, "scheme", None)
    if scheme is not None:
        port = getattr(ep, "port", 0)
        return f"{scheme}://{getattr(ep, 'host', '')}" + \
            (f":{port}" if port else "")
    return str(ep)


class DeviceCell(Variable):
    """One (peer, lane-kind) stat cell. Every ``transfers`` increment is
    matched by exactly one ``completed`` or ``failed``; the receive-side
    counters (``recv_transfers``, ``bytes_in``) sit outside that
    balance. One lock and a bounded reservoir; bytes/s rides one Adder
    and a PerSecond window."""

    SAMPLE_CAP = 256

    __slots__ = ("_lock", "_bytes_var", "_bps", "transfers", "completed",
                 "failed", "staged_fallbacks", "recv_transfers",
                 "bytes_out", "bytes_in", "leaked_batches", "leaked_bytes",
                 "stage_us_sum", "wire_us_sum", "ack_us_sum",
                 "recv_us_sum", "_samples", "_nsampled", "_max_us")

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._bytes_var = Adder(0)
        self._bps = PerSecond(self._bytes_var)
        self.transfers = 0
        self.completed = 0
        self.failed = 0
        self.staged_fallbacks = 0
        self.recv_transfers = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.leaked_batches = 0
        self.leaked_bytes = 0
        self.stage_us_sum = 0.0
        self.wire_us_sum = 0.0
        self.ack_us_sum = 0.0
        self.recv_us_sum = 0.0
        self._samples: List[float] = []
        self._nsampled = 0
        self._max_us = 0.0

    # ------------------------------------------------------------ updates
    def note_open(self, nbytes: int) -> None:
        with self._lock:
            self.transfers += 1
            self.bytes_out += nbytes

    def note_done(self, stage_us: float, wire_us: float, ack_us: float,
                  nbytes: int, failed: bool, leaked: bool = False) -> None:
        total = stage_us + wire_us + ack_us
        with self._lock:
            if failed:
                self.failed += 1
                if leaked:
                    self.leaked_batches += 1
                    self.leaked_bytes += nbytes
            else:
                self.completed += 1
            self.stage_us_sum += stage_us
            self.wire_us_sum += wire_us
            self.ack_us_sum += ack_us
            if total > self._max_us:
                self._max_us = total
            n = self._nsampled
            self._nsampled = n + 1
            s = self._samples
            if len(s) < self.SAMPLE_CAP:
                s.append(total)
            else:
                i = fast_rand_less_than(n + 1)
                if i < self.SAMPLE_CAP:
                    s[i] = total
        if not failed:
            self._bytes_var.add(nbytes)   # thread-local; outside the lock

    def note_recv(self, dur_us: float, nbytes: int) -> None:
        with self._lock:
            self.recv_transfers += 1
            self.bytes_in += nbytes
            self.recv_us_sum += dur_us
        self._bytes_var.add(nbytes)

    # -------------------------------------------------------------- reads
    def samples(self, limit: int = 256) -> List[float]:
        with self._lock:
            return self._samples[:limit]

    @staticmethod
    def _pick(sorted_samples: List[float], ratio: float) -> float:
        if not sorted_samples:
            return 0.0
        idx = min(len(sorted_samples) - 1,
                  int(ratio * len(sorted_samples)))
        return sorted_samples[idx]

    def get_value(self) -> dict:
        with self._lock:
            s = sorted(self._samples)
            done = self.completed + self.failed
            total_us = self.stage_us_sum + self.wire_us_sum \
                + self.ack_us_sum
            out = {
                "transfers": self.transfers,
                "completed": self.completed,
                "failed": self.failed,
                "staged_fallbacks": self.staged_fallbacks,
                "recv_transfers": self.recv_transfers,
                "bytes_out": self.bytes_out,
                "bytes_in": self.bytes_in,
                "leaked_batches": self.leaked_batches,
                "leaked_bytes": self.leaked_bytes,
                "count": done,
                "stage_us_sum": round(self.stage_us_sum, 1),
                "wire_us_sum": round(self.wire_us_sum, 1),
                "ack_us_sum": round(self.ack_us_sum, 1),
                "recv_us_sum": round(self.recv_us_sum, 1),
                "latency_avg_us": round(total_us / done, 1) if done
                else 0.0,
                "max_latency_us": self._max_us,
            }
        out["bytes_per_second"] = self._bps.get_value()
        out["latency_p50_us"] = self._pick(s, 0.5)
        out["latency_p99_us"] = self._pick(s, 0.99)
        return out


class _DeviceDim(MultiDimension):
    """The labeled family with a JSON-safe get_value (/vars dumps the
    value as JSON, where tuple keys would raise); the Prometheus dump
    reads labels through ``labeled_items()``, so the
    ``device_stats_*{peer=,lane=}`` series keep their labels."""

    def get_value(self) -> Dict[str, object]:
        with self._lock:
            items = list(self._stats.items())
        return {"|".join(k): v.get_value() for k, v in items}


class BatchTracker:
    """One device batch's stage timeline, riding the lane queue item
    through the conn (the completion paths never touch the registry).
    The stamps follow the pipeline (submit -> encode -> flush -> ack);
    only the finish races (ack against a close's leak report), and it
    settles under the cell lock."""

    __slots__ = ("cell", "span", "nbytes", "t_submit", "t_encoded",
                 "t_flushed", "staged", "_finished")

    def __init__(self, cell: DeviceCell, span, nbytes: int):
        self.cell = cell
        self.span = span
        self.nbytes = nbytes
        self.t_submit = time.monotonic_ns()
        self.t_encoded = 0
        self.t_flushed = 0
        self.staged = False
        self._finished = False

    # A stamp runs its whole body under the cell lock, where _settle's
    # latch lives, so a stamp and a settle serialize: once the settle
    # has won the latch (the peer's ack can land between the TCP write
    # returning and the flush mark firing), no stamp touches the span it
    # submitted.
    def lane_encoded(self, staged: bool = False) -> None:
        if self.span is None and not staged:
            # rpcz off and nothing to count: a plain int store; a
            # settle racing it at worst books these microseconds to
            # the neighbouring stage
            self.t_encoded = time.monotonic_ns()
            return
        with self.cell._lock:
            if self._finished:
                return
            self.t_encoded = time.monotonic_ns()
            if staged:
                self.staged = True
                self.cell.staged_fallbacks += 1   # lock already held
                if self.span is not None:
                    self.span.annotate("staged_fallback (pull lane "
                                       "unavailable or breaker-tripped)")
            if self.span is not None:
                self.span.write_done_us = self.t_encoded // 1000

    def lane_flushed(self) -> None:
        if self.span is None:
            self.t_flushed = time.monotonic_ns()
            return
        with self.cell._lock:
            if self._finished:
                return
            self.t_flushed = time.monotonic_ns()
            self.span.first_byte_us = self.t_flushed // 1000
            self.span.annotate("pump-flush: frame handed to transport")

    def lane_acked(self) -> None:
        self._settle(failed=False)

    def lane_failed(self, reason: str, leaked: bool = False) -> None:
        self._settle(failed=True, leaked=leaked, reason=reason)

    def _settle(self, failed: bool, leaked: bool = False,
                reason: Optional[str] = None) -> None:
        cell = self.cell
        with cell._lock:
            if self._finished:
                return
            self._finished = True
        # annotated after winning the latch: a second failure report
        # must not touch a span already submitted
        if reason is not None and self.span is not None:
            self.span.annotate(("leak-reclaim: " if leaked else "") +
                               str(reason)[:200])
        now = time.monotonic_ns()
        enc = self.t_encoded or now
        flu = self.t_flushed or enc
        stage_us = max(0.0, (enc - self.t_submit) / 1e3)
        wire_us = max(0.0, (flu - enc) / 1e3)
        ack_us = max(0.0, (now - flu) / 1e3)
        cell.note_done(stage_us, wire_us, ack_us, self.nbytes, failed,
                       leaked=leaked)
        span = self.span
        if span is not None:
            from brpc_tpu_torch.rpc import span as _span_mod
            span.end_us = now // 1000
            if failed:
                span.error_code = span.error_code or 1009  # EFAILEDSOCKET
            span.annotate(f"stage_us={stage_us:.0f} wire_us={wire_us:.0f} "
                          f"ack_us={ack_us:.0f}"
                          + (" staged" if self.staged else ""))
            _span_mod.submit_span(span)


class DeviceStats:
    """Process-wide registry: the labeled cell family and a weak set of
    live device-lane conns (window and queue rows for /device)."""

    def __init__(self):
        self._dim = _DeviceDim(("peer", "lane"), DeviceCell)
        self._conns: "weakref.WeakSet" = weakref.WeakSet()
        self._conn_lock = threading.Lock()

    def device_cell(self, peer: str, lane: str) -> DeviceCell:
        key = (peer, lane)
        if not self._dim.has_stats(key) \
                and self._dim.count_stats() >= MAX_CELLS:
            key = _OVERFLOW_KEY
        return self._dim.get_stats(key)

    def rows(self) -> List[Tuple[Tuple[str, str], DeviceCell]]:
        return [(k, self._dim.get_stats(k))
                for k in self._dim.list_stats()]

    def track_device_conn(self, conn) -> None:
        # under the lock the walk takes: a WeakSet that changes while
        # it is iterated raises
        with self._conn_lock:
            self._conns.add(conn)

    def device_conn_rows(self) -> List[dict]:
        with self._conn_lock:
            conns = list(self._conns)
        rows = []
        for c in conns:
            try:
                rows.append(c.lane_introspection())
            except Exception:       # boundary: one bad row, the page lives
                continue
        return rows


_registry: Optional[DeviceStats] = None
_registry_lock = threading.Lock()


def global_device_stats() -> DeviceStats:
    global _registry
    reg = _registry
    if reg is None:
        with _registry_lock:
            if _registry is None:
                _registry = DeviceStats()
                _registry._dim.expose("device_stats")
            reg = _registry
    return reg


def expose_device_vars() -> None:
    """(Re-)expose the labeled family; Server.start calls it, so a
    test's ``unexpose_all`` does not drop it for good."""
    global_device_stats()._dim.expose("device_stats")


# ------------------------------------------------------- transfer hooks

def open_transfer(peer: str, lane: str, nbytes: int,
                  parent_span=None,
                  cell: Optional[DeviceCell] = None) -> \
        Optional[BatchTracker]:
    """One tracker per outbound device batch; None when the layer is off
    (the one flag check the hot path pays). Callers on the hot path
    pass their cached ``cell`` (``Socket._dev_send``)."""
    if not enabled():
        return None
    if cell is None:
        cell = global_device_stats().device_cell(peer, lane)
    cell.note_open(nbytes)
    span = None
    if parent_span is not None:
        from brpc_tpu_torch.rpc.span import start_device_span
        span = start_device_span(parent_span, peer, lane)
        span.request_size = nbytes
    return BatchTracker(cell, span, nbytes)


# --------------------------------------------------------- thread labels
#
# Threads that do device work outside any fiber (the device poller's
# pump and waiter threads) stamp a label here. A plain dict: the GIL
# makes each single operation atomic and readers only read.

_thread_labels: Dict[int, str] = {}


def stamp_device_thread(label: str, tid: Optional[int] = None) -> None:
    _thread_labels[tid if tid is not None
                   else threading.get_ident()] = label


def unstamp_device_thread(tid: Optional[int] = None) -> None:
    _thread_labels.pop(tid if tid is not None
                       else threading.get_ident(), None)


def device_thread_label(tid: int) -> Optional[str]:
    return _thread_labels.get(tid)


# ---------------------------------------------------------------- page

def device_page_payload(server=None, samples: int = 128) -> dict:
    """The /device payload, shared by the HTTP route and the builtin
    service (one function, two views). The page is process-wide
    (``server`` is accepted for the other pages' signature and unused:
    transfers are not owned by one server). The lane state, the recv
    pool and the leak counters come from ``transport/ici.py`` when that
    lane is loaded."""
    reg = global_device_stats()
    cells: Dict[str, dict] = {}
    totals = {"transfers": 0, "completed": 0, "failed": 0,
              "staged_fallbacks": 0, "recv_transfers": 0,
              "bytes_out": 0, "bytes_in": 0, "leaked_bytes": 0}
    for (peer, lane), cell in reg.rows():
        row = cell.get_value()
        row["latency_samples"] = cell.samples(samples)
        cells[f"{peer}|{lane}"] = row
        for k in totals:
            totals[k] += row.get(k, 0)
    out: dict = {
        "enabled": enabled(),
        "cells": cells,
        "totals": totals,
        "conns": reg.device_conn_rows(),
    }
    ici = sys.modules.get(_ICI_MODULE)
    if ici is not None:
        out["transfer_lane"] = ici.transfer_lane_status()
        pool = ici._default_pool
        out["recv_pool"] = {"capacity": pool.capacity, "used": pool.used,
                            "reserved_blocks": list(pool.reserved_blocks)}
        out["leaks"] = ici.leak_snapshot()
    else:
        out["transfer_lane"] = "not loaded"
    return out


# ------------------------------------------------------ fork hygiene

def _postfork_reset() -> None:
    """Fork hygiene: every cell describes the parent's transfers on
    conns the child does not own; a forked shard starts from zero. Not
    registered, as the port's other resets are not (ROADMAP section 1,
    shard groups)."""
    global _registry, _registry_lock, _thread_labels
    _registry = None
    _registry_lock = threading.Lock()
    _thread_labels = {}


def _device_census() -> dict:
    """Census: the device receive pool in use, the lanes' buffered
    bytes and the cells' reservoirs."""
    count = 0
    nbytes = 0
    reg = _registry
    if reg is not None:
        for _, cell in reg.rows():
            nbytes += len(cell.samples(1024)) * 8
        for row in reg.device_conn_rows():
            count += 1
            nbytes += row.get("buffered_bytes", 0) or 0
    ici = sys.modules.get("brpc_tpu_torch.transport.ici")
    if ici is not None:
        pool = ici._default_pool
        nbytes += pool.used
        count += sum(pool.reserved_blocks)
    return {"count": count, "bytes": nbytes}


from brpc_tpu_torch.butil import resource_census as _census  # noqa: E402
#   (the census registration ships with the registry it measures)

_census.register("device_lane", _device_census)
