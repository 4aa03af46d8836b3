"""rpcz tracing: per-RPC spans through a bounded collector (the port of
brpc_tpu/rpc/span.py; brpc/span.h:47, bvar/collector.*).

Spans are cheap dataclass records annotated at each stage and kept in a
ring buffer, dumped by /rpcz. Setting the ``rpcz_dir`` flag additionally
persists finished spans to a bounded on-disk store (the reference's
leveldb SpanDB, span.cpp:308, as rotating JSON-lines files):
/rpcz?history=1 reads back spans that have aged out of the ring. Trace
ids propagate in RpcMeta (trace_id/span_id/parent_span_id fields), so
multi-hop call trees link up.

The port has the server, client and serving spans, the device transfer
children (``start_device_span``, ``submit_device_recv_span``;
``transport/device_stats.py`` stamps them) and one child of a client
span an attempt (``start_attempt_span``), which ``settle_attempt_spans``
submits only for a call that made more than one. ``_span_census`` is
the ``span_store`` provider of ``/census``; ``_postfork_reset`` waits,
unregistered, for the postfork registry that comes with shard groups.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple

from brpc_tpu_torch.butil.fast_rand import fast_rand
from brpc_tpu_torch.butil.flags import flag


# monotonic->wall-clock anchor, computed once per process: stage stamps
# use the monotonic clock (immune to NTP steps mid-RPC), but cross-process
# trace assembly needs a shared timeline — to_dict emits base_real_us =
# start_us + this offset (the reference's span.h base_real_us plays the
# same role for its cpuwide stamps)
_REAL_OFFSET_US = time.time_ns() // 1000 - time.monotonic_ns() // 1000


@dataclass
class Span:
    trace_id: int
    span_id: int
    parent_span_id: int = 0
    side: str = "server"            # server | client | device | serving
    service: str = ""
    method: str = ""
    remote_side: str = ""
    start_us: int = 0
    end_us: int = 0
    error_code: int = 0
    log_id: int = 0
    request_size: int = 0
    response_size: int = 0
    # ---- stage timeline (monotonic us; 0 = stage never reached). The
    # reference records the same waypoints in span.h (received_us,
    # start_parse_us, start_callback_us, sent_us): they are what turns
    # "this RPC was slow" into "it queued / it computed / it flushed".
    # Server side:
    received_us: int = 0        # frame cut (RpcMessage.arrival_ns)
    dispatch_us: int = 0        # dispatch context entered (queue exit)
    parse_done_us: int = 0      # request payload decoded (server) /
    #                             response payload decoded (client)
    handler_start_us: int = 0   # user handler entered
    handler_end_us: int = 0     # user handler returned/raised
    serialized_us: int = 0      # response frame packed
    flushed_us: int = 0         # response write completed (on_done)
    # Client side:
    write_done_us: int = 0      # request write completed (on_done)
    first_byte_us: int = 0      # response frame seen by the client
    annotations: List[Tuple[int, str]] = field(default_factory=list)
    # response-flush delegation latch (server side): when the response
    # write's completion callback owns the flush stamp, finish_span may
    # run before OR after it — exactly one of them submits the span
    _flush_lock: threading.Lock = field(default_factory=threading.Lock,
                                        repr=False, compare=False)
    _await_flush: bool = field(default=False, repr=False, compare=False)
    _finish_ready: bool = field(default=False, repr=False, compare=False)

    def annotate(self, text: str) -> None:
        self.annotations.append((time.monotonic_ns() // 1000, text))

    @property
    def latency_us(self) -> int:
        return max(0, self.end_us - self.start_us)

    def stage_breakdown(self) -> Tuple[int, int, int]:
        """(queue_us, handle_us, write_us) — the three-way attribution
        tail debugging needs. Server: arrival->handler (queueing +
        parse), handler, handler->flush (serialize + write). Client:
        issue->write-done, write-done->first-response-byte (network +
        server residence), first-byte->completion. Sums to
        ~latency_us; a span that never reached its handler puts
        everything in queue_us."""
        if self.side == "server":
            base = self.received_us or self.start_us
            mid0, mid1 = self.handler_start_us, self.handler_end_us
            tail = self.flushed_us or self.end_us
        else:
            base = self.start_us
            mid0, mid1 = self.write_done_us, self.first_byte_us
            tail = self.end_us
        if mid0 and mid1:
            return (max(0, mid0 - base), max(0, mid1 - mid0),
                    max(0, tail - mid1))
        return (max(0, tail - base), 0, 0)

    def to_dict(self) -> dict:
        queue_us, handle_us, write_us = self.stage_breakdown()
        d = {
            "trace_id": f"{self.trace_id:016x}",
            "span_id": f"{self.span_id:016x}",
            "parent_span_id": f"{self.parent_span_id:016x}",
            "side": self.side,
            "service": self.service,
            "method": self.method,
            "remote_side": self.remote_side,
            "latency_us": self.latency_us,
            "error_code": self.error_code,
            "log_id": self.log_id,
            "request_size": self.request_size,
            "response_size": self.response_size,
            # timeline: start_us is process-monotonic (stage stamps share
            # its clock); base_real_us anchors it on the wall clock so
            # stores from different processes assemble onto one axis
            "pid": os.getpid(),
            "start_us": self.start_us,
            "end_us": self.end_us,
            "base_real_us": self.start_us + _REAL_OFFSET_US,
            "received_us": self.received_us,
            "dispatch_us": self.dispatch_us,
            "parse_done_us": self.parse_done_us,
            "handler_start_us": self.handler_start_us,
            "handler_end_us": self.handler_end_us,
            "serialized_us": self.serialized_us,
            "flushed_us": self.flushed_us,
            "write_done_us": self.write_done_us,
            "first_byte_us": self.first_byte_us,
            "queue_us": queue_us,
            "handle_us": handle_us,
            "write_us": write_us,
            "annotations": [
                {"us": us, "text": t} for us, t in self.annotations],
        }
        if self.side == "device":
            # the device lane's waypoint names (transport/device_stats):
            # host stage + descriptor encode, lane enqueue and credit
            # wait + flush, wire + peer recv + ack return; they sum to
            # latency_us by construction
            d["stage_us"] = queue_us
            d["wire_us"] = handle_us
            d["ack_us"] = write_us
        elif self.side == "serving":
            # the serving lane's waypoint names (serving/serving_stats):
            # submit->admit (write_done_us), admit->prefill-done
            # (first_byte_us), prefill-done->decode-done (serialized_us),
            # decode-done->emitted (end_us). Telescoping fallbacks: a
            # stage never reached contributes 0 and its time lands in
            # the previous stage, so the four ALWAYS sum to latency_us.
            a = self.write_done_us or self.end_us
            p = self.first_byte_us or a
            f = self.serialized_us or p
            d["queue_us"] = max(0, a - self.start_us)
            d["prefill_us"] = max(0, p - a)
            d["decode_us"] = max(0, f - p)
            d["emit_us"] = max(0, self.end_us - f)
        return d


class SpanCollector:
    """Bounded ring; submission is O(1) and never blocks the RPC path
    (the reference bounds collection cost via bvar::Collector's
    per-second budget — a ring buffer gives the same property)."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._ring: Deque[Span] = deque(maxlen=capacity or flag("rpcz_max_spans"))

    def submit(self, span: Span) -> None:
        if not flag("rpcz_enabled"):
            return
        with self._lock:
            # honor runtime /flags mutation of rpcz_max_spans: resize the
            # ring when the flag moved (constructor-captured maxlen would
            # make the advertised knob a no-op)
            want = self._capacity or flag("rpcz_max_spans")
            if want != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=want)
            self._ring.append(span)

    def recent(self, n: int = 100) -> List[Span]:
        with self._lock:
            return list(self._ring)[-n:]

    def find_trace(self, trace_id) -> List[Span]:
        """``trace_id``: an int, or a collection of candidate ints (the
        /rpcz handler accepts both hex and decimal spellings of an id
        and matches either reading)."""
        ids = {trace_id} if isinstance(trace_id, int) else set(trace_id)
        with self._lock:
            return [s for s in self._ring if s.trace_id in ids]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


class SpanStore:
    """Bounded on-disk persistence: JSON-lines, rotated once at
    rpcz_db_max_bytes (current + one aged file ≈ the leveldb SpanDB's
    bounded footprint). finish_span runs for EVERY rpc, so writes buffer
    in memory and hit disk in batches (every _FLUSH_EVERY lines or
    _FLUSH_S seconds), never a per-RPC syscall."""

    FILE = "rpcz_spans.jsonl"
    _FLUSH_EVERY = 32
    _FLUSH_S = 0.5

    def __init__(self):
        self._lock = threading.Lock()
        self._fh = None
        self._dir = None
        self._buf: List[str] = []
        self._last_flush = 0.0

    def _path(self, old: bool = False) -> str:
        return os.path.join(self._dir, self.FILE + (".1" if old else ""))

    def _ensure_open(self, dirpath: str):
        if self._fh is not None and self._dir == dirpath:
            return
        if self._fh is not None:
            self._fh.close()
        self._dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self._fh = open(self._path(), "a", encoding="utf-8")

    def _flush_locked(self, dirpath: str) -> None:
        self._ensure_open(dirpath)
        self._fh.write("".join(self._buf))
        self._fh.flush()
        self._buf.clear()
        self._last_flush = time.monotonic()
        if self._fh.tell() >= int(flag("rpcz_db_max_bytes")):
            self._fh.close()
            self._fh = None
            os.replace(self._path(), self._path(old=True))

    def write(self, span: "Span") -> None:
        dirpath = flag("rpcz_dir")
        with self._lock:
            if not dirpath:
                # flag cleared at runtime: drop buffered lines and the
                # handle (an open fd would pin the old directory)
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                    self._fh = None
                self._buf.clear()
                return
            self._buf.append(json.dumps(span.to_dict()) + "\n")
            if (len(self._buf) < self._FLUSH_EVERY
                    and time.monotonic() - self._last_flush < self._FLUSH_S):
                return
            try:
                self._flush_locked(dirpath)
            except OSError:
                self._buf.clear()   # persistence must never fail the RPC

    def read(self, n: int = 100, trace_id=None) -> List[dict]:
        """``trace_id``: None (all spans), an int, or a collection of
        candidate ints (matched against any)."""
        dirpath = flag("rpcz_dir")
        if not dirpath or n <= 0:
            return []
        # flush pending lines under the lock so history is current, but
        # SCAN outside it — parsing up to 2x rpcz_db_max_bytes of JSON
        # under the write lock would stall every RPC's finish_span. A
        # concurrent rotation mid-scan costs at most a transient miss on
        # this diagnostic page (os.replace is atomic; open fds survive).
        with self._lock:
            if self._buf:
                try:
                    self._flush_locked(dirpath)
                except OSError:
                    self._buf.clear()
        ids = None
        if trace_id is not None:
            ids = {trace_id} if isinstance(trace_id, int) else set(trace_id)
        # bounded ring while scanning — never materialize all lines
        rows: Deque[dict] = deque(maxlen=n)
        for old in (True, False):       # aged file first: oldest→newest
            try:
                with open(os.path.join(dirpath,
                                       self.FILE + (".1" if old else "")),
                          encoding="utf-8") as f:
                    for line in f:
                        try:
                            d = json.loads(line)
                        except ValueError:
                            continue
                        if ids is None or \
                                int(d.get("trace_id", "0"), 16) in ids:
                            rows.append(d)
            except OSError:
                continue
        return list(rows)


    def flush(self) -> None:
        """Force buffered lines to disk (server stop / process exit —
        the last spans before a shutdown are usually the interesting
        ones)."""
        dirpath = flag("rpcz_dir")
        if not dirpath:
            return
        with self._lock:
            if self._buf:
                try:
                    self._flush_locked(dirpath)
                except OSError:
                    self._buf.clear()


global_store = SpanStore()
global_collector = SpanCollector()

import atexit  # noqa: E402  (registration belongs with the store)

atexit.register(global_store.flush)


def _postfork_reset() -> None:
    """Fork hygiene: the store's open fh shares one file offset with
    the parent (interleaved writes would shred the JSONL), its lock
    may be held by a dead thread, and buffered/ringed spans describe
    parent-side RPCs. A shard starts with an empty rpcz state and its
    own store, opened lazily at its own rpcz_dir."""
    global_store._lock = threading.Lock()
    fh, global_store._fh = global_store._fh, None
    global_store._dir = None
    global_store._buf = []
    if fh is not None:
        try:
            fh.close()     # only the child's dup of the descriptor
        except Exception:
            pass
    global_collector._lock = threading.Lock()
    global_collector._ring.clear()


def _span_census() -> dict:
    """Resource census: what rpcz holds in memory — the bounded ring
    plus the store's not-yet-flushed line buffer."""
    with global_store._lock:
        buffered = sum(len(s) for s in global_store._buf)
    with global_collector._lock:
        ring = len(global_collector._ring)
    return {"count": ring, "bytes": buffered,
            "ring_capacity": global_collector._ring.maxlen}


from brpc_tpu_torch.butil import resource_census as _census  # noqa: E402
#   (the census registration ships with the store it measures)

_census.register("span_store", _span_census)


def new_trace_id() -> int:
    return fast_rand() or 1


def start_server_span(cntl, service: str, method: str) -> Span:
    """CreateServerSpan (span.cpp:149): trace context from the request
    meta, or a fresh trace."""
    trace_id = cntl.trace_id or new_trace_id()
    span = Span(
        trace_id=trace_id,
        span_id=new_trace_id(),
        parent_span_id=cntl.span_id,
        side="server",
        service=service,
        method=method,
        remote_side=str(cntl.remote_side) if cntl.remote_side else "",
        start_us=time.monotonic_ns() // 1000,
        log_id=cntl.log_id,
    )
    cntl.trace_id = trace_id       # propagate to downstream client calls
    cntl.span_id = span.span_id
    return span


def start_client_span(cntl, service: str, method: str) -> Span:
    trace_id = cntl.trace_id or new_trace_id()
    span = Span(
        trace_id=trace_id,
        span_id=new_trace_id(),
        parent_span_id=cntl.span_id,
        side="client",
        service=service,
        method=method,
        start_us=time.monotonic_ns() // 1000,
        log_id=cntl.log_id,
    )
    cntl.trace_id = trace_id
    cntl.span_id = span.span_id
    return span


def start_attempt_span(parent: Span, service: str, method: str,
                       attempt: int, backend: str,
                       backup: bool = False) -> Span:
    """A child of a client span for one attempt: retries and backup
    requests spread one call over several backends, which one client
    span would blur. It carries the attempt's 1-based index and its
    backend (``remote_side`` and an annotation)."""
    span = Span(
        trace_id=parent.trace_id,
        span_id=new_trace_id(),
        parent_span_id=parent.span_id,
        side="client",
        service=service,
        method=method,
        remote_side=backend,
        start_us=time.monotonic_ns() // 1000,
        log_id=parent.log_id,
    )
    span.annotate(f"attempt={attempt} backend={backend}"
                  + (" backup" if backup else ""))
    return span


def settle_attempt_spans(cntl) -> None:
    """After the client span: the attempts still open (the last one, a
    backup that lost) close with the call's verdict, and the set is
    submitted only when the call made more than one attempt, so a call
    of one attempt keeps one client span (brpc_tpu/rpc/channel.py:1313)."""
    with cntl._arb_lock:
        spans, cntl._attempt_spans = cntl._attempt_spans, []
    if not spans:
        return
    now = time.monotonic_ns() // 1000
    for sp in spans:
        if not sp.end_us:
            sp.end_us = now
            sp.error_code = cntl.error_code
    if len(spans) > 1:
        for sp in spans:
            _submit_span(sp)


def start_device_span(parent: Span, peer: str, lane: str) -> Span:
    """A device-transfer child of the owning RPC span: the lane's
    waypoints ride the client-shaped stamp slots (write_done_us =
    encoded, first_byte_us = flushed, end_us = acked), so
    stage_breakdown yields (stage_us, wire_us, ack_us) summing to the
    transfer's latency. The tracker (``transport/device_stats``
    ``BatchTracker``) stamps and submits it."""
    span = Span(
        trace_id=parent.trace_id,
        span_id=new_trace_id(),
        parent_span_id=parent.span_id,
        side="device",
        service="device",
        method=lane,
        remote_side=peer,
        start_us=time.monotonic_ns() // 1000,
        log_id=parent.log_id,
    )
    span.annotate(f"device transfer peer={peer} lane={lane}")
    return span


def submit_device_recv_span(parent: Span, dr: dict) -> None:
    """The receiving half of a device transfer (the lane take: the
    copy's issue, the landing, the recv pool's admission) as a finished
    child of the owning RPC span. ``dr`` is the socket's
    ``last_device_take`` record (peer, lane, recv_us, nbytes, t_us); one
    helper, so the server's and the client's parse paths cannot
    drift."""
    span = start_device_span(parent, dr.get("peer", ""),
                             dr.get("lane", ""))
    span.start_us = dr.get("t_us") or span.start_us
    span.end_us = span.start_us + int(dr.get("recv_us", 0))
    span.request_size = dr.get("nbytes", 0)
    span.annotate(f"device-recv recv_us={dr.get('recv_us')} "
                  f"nbytes={dr.get('nbytes')}")
    _submit_span(span)


def start_serving_span(cntl, service: str, method: str) -> Span:
    """A token-generation child of the owning RPC span: the serving
    lane's stage-resolved waypoints (queue, prefill, decode, emit) ride
    the client-shaped stamp slots — write_done_us = admitted,
    first_byte_us = prefill done, serialized_us = decode done, end_us =
    emitted — so to_dict yields (queue_us, prefill_us, decode_us,
    emit_us) summing to the stream latency (see the serving aliases).
    The tracker (serving/serving_stats.GenTracker) stamps and submits;
    trace/parent inheritance through the serving controller (whose
    trace_id/span_id start_server_span set) keeps the generation inside
    the call tree."""
    span = Span(
        trace_id=getattr(cntl, "trace_id", 0) or new_trace_id(),
        span_id=new_trace_id(),
        parent_span_id=getattr(cntl, "span_id", 0) or 0,
        side="serving",
        service=service,
        method=method,
        remote_side=str(cntl.remote_side)
        if getattr(cntl, "remote_side", None) else "",
        start_us=time.monotonic_ns() // 1000,
        log_id=getattr(cntl, "log_id", 0) or 0,
    )
    span.annotate(f"generation {service}.{method}")
    return span


def submit_span(span: Span) -> None:
    """Submit a span its owner finished itself (the serving tracker
    stamps end_us and error_code on its own)."""
    _submit_span(span)


def expect_flush(span: Span) -> None:
    """Arm the flush-delegation latch: the response write's completion
    callback (mark_flushed) owns the flushed_us stamp, and whichever of
    finish_span / mark_flushed runs LAST submits the span — so the
    stored timeline includes the real write completion even when the
    conn blocks (a chaos ``delay`` fault, a saturated peer) and the
    dispatch context moves on."""
    span._await_flush = True


def mark_flushed(span: Span, err=None) -> None:
    """The write on_done half of the latch (stamps only on success —
    a failed write has no flush time)."""
    submit = False
    with span._flush_lock:
        if err is None and not span.flushed_us:
            span.flushed_us = time.monotonic_ns() // 1000
        span._await_flush = False
        if span._finish_ready:
            span._finish_ready = False
            submit = True
            if span.end_us < span.flushed_us:
                span.end_us = span.flushed_us
    if submit:
        _submit_span(span)


def finish_span(span: Span, cntl) -> None:
    span.end_us = time.monotonic_ns() // 1000
    span.error_code = cntl.error_code
    if cntl.remote_side and not span.remote_side:
        span.remote_side = str(cntl.remote_side)
    if span._await_flush:
        with span._flush_lock:
            if span._await_flush:
                # the response write hasn't completed: mark_flushed
                # submits when it does (end_us then covers the flush)
                span._finish_ready = True
                return
    _submit_span(span)


def _submit_span(span: Span) -> None:
    global_collector.submit(span)
    if flag("rpcz_enabled"):
        global_store.write(span)
