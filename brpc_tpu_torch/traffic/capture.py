"""Request capture (the port of brpc_tpu/traffic/capture.py; the
reference's rpc_dump sampler, rpc_dump.h:50-95, with the disk, rotation
and run-time control a production recorder needs).

The server's dispatch (``rpc/server_dispatch.py``) calls

    rec = recorder.sample_request(method_key, service, method,
                                  payload, attachment, arrival_ns,
                                  timeout_ms, log_id, priority)
    ... handler runs ...                   # rec None = not sampled
    recorder.record_complete(rec, error_code, latency_us)

``sample_request`` decides (per-method rates over a default rate, and a
per-second budget) at the cost of a dict lookup and, for a fractional
rate, one random draw; the record rides the request and is queued at
completion, so it carries status and latency. A writer thread of its own
writes the queue to disk; the dispatch path never waits on the disk, and
the recorder's lock guards the queue and counters only.

Files are per process (``capture-<pid>-<seq>.brpccap``). Rotation bounds
one file (``capture_rotate_mb``), the disk budget the whole directory
(``capture_disk_budget_mb``: the oldest closed file goes first). The
incident manager (``incident/manager.py``) borrows the recorder for an
incident's window and gives back the session it found.

The reference's legacy ``rpc_dump_dir`` flags, which start the recorder
there, come with ``rpc/rpc_dump.py`` (ROADMAP section 1); until then the
snapshot's ``legacy`` is always false.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.reducer import Adder, PassiveStatus
from brpc_tpu_torch.traffic.corpus import SUFFIX, CorpusWriter

define_flag("capture_dir", "", "directory for captured request corpora "
            "(empty = capture off unless started via /capture)")
define_flag("capture_sample_rate", 1.0,
            "default per-request sampling probability",
            validator=lambda v: 0.0 <= v <= 1.0)
define_flag("capture_method_rates", "",
            "per-method sampling overrides, 'Svc.M=0.1,Other.N=1.0'")
# default budget 2000/s: production capture is sampled (the reference
# ships rpc_dump at 100/s), and the budget bounds the recorder's share
# of the interpreter whatever the server's rate; full capture
# (max_per_second=0) is what corpus-recording sessions use. The budget
# counter is lock-free and approximate: a sampler's budget tolerates a
# few records either way far better than the hot path tolerates a lock.
define_flag("capture_max_per_second", 2000,
            "global sampled-records-per-second budget (0 = unlimited)",
            validator=lambda v: v >= 0)
define_flag("capture_rotate_mb", 64,
            "rotate the active corpus file past this size",
            validator=lambda v: v >= 1)
define_flag("capture_disk_budget_mb", 256,
            "delete oldest closed corpus files past this total",
            validator=lambda v: v >= 1)

# /vars counters: what capture wrote and what it dropped must be
# observable without reading the page. Passive reads of the recorder's
# own counters — per-request Adder.add on the sampled path costs a
# thread-local agent lookup each call, and "sampled" is exactly
# written + dropped + pending anyway.
nwritten = Adder().expose("capture_written")
ndropped_queue = Adder().expose("capture_dropped_queue")
PassiveStatus(lambda: _recorder.dropped_budget).expose(
    "capture_dropped_budget")
PassiveStatus(
    lambda: _recorder.written + _recorder.dropped_queue
    + len(_recorder._q)).expose("capture_sampled")

# pending-record queue bounds: records queue at completion and drain
# on the writer's 100ms tick, so the bound only matters when the
# writer is GIL-starved behind a hot dispatch path — size it so a
# multi-second starvation absorbs without drops (records are cheap;
# the BYTE budget is the real memory guard for big payloads)
_QUEUE_CAP = 32768
_QUEUE_BYTES_CAP = 32 << 20
_WRITE_BATCH = 256         # records drained per writer-lock hold


class CaptureConfig:
    def __init__(self, dir: str, default_rate: float = 1.0,
                 method_rates: Optional[Dict[str, float]] = None,
                 max_per_second: int = 0, rotate_bytes: int = 64 << 20,
                 disk_budget_bytes: int = 256 << 20,
                 seed: Optional[int] = None):
        # normalized: the writer compares file dirnames against this
        # (a trailing slash would make every comparison miss and the
        # writer would rotate to a fresh file per drain tick)
        self.dir = os.path.normpath(dir) if dir else dir
        self.default_rate = default_rate
        self.method_rates = dict(method_rates or {})
        self.max_per_second = max_per_second
        self.rotate_bytes = rotate_bytes
        self.disk_budget_bytes = disk_budget_bytes
        self.seed = seed

    @classmethod
    def from_flags(cls, dir: Optional[str] = None, **overrides):
        rates: Dict[str, float] = {}
        for part in flag("capture_method_rates").split(","):
            part = part.strip()
            if not part or "=" not in part:
                continue
            k, _, v = part.partition("=")
            try:
                rates[k.strip()] = max(0.0, min(1.0, float(v)))
            except ValueError:
                pass
        cfg = cls(dir if dir is not None else flag("capture_dir"),
                  default_rate=flag("capture_sample_rate"),
                  method_rates=rates,
                  max_per_second=flag("capture_max_per_second"),
                  rotate_bytes=flag("capture_rotate_mb") << 20,
                  disk_budget_bytes=flag("capture_disk_budget_mb") << 20)
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)
        return cfg

    def to_dict(self) -> dict:
        return {"dir": self.dir, "default_rate": self.default_rate,
                "method_rates": dict(self.method_rates),
                "max_per_second": self.max_per_second,
                "rotate_mb": self.rotate_bytes >> 20,
                "disk_budget_mb": self.disk_budget_bytes >> 20}


# the per-request carrier between sample_request and record_complete:
# PLAIN TUPLE — one cheap allocation on the sampled path:
#   (method_key, service, method, payload, attachment_bytes,
#    arrival_mono_ns, timeout_ms, log_id, priority)
# (wall-clock stamps are derived by the writer from the recorder's
# clock anchor; index names below for the writer side)
_K, _S, _N, _PAY, _ATT, _T, _O, _L, _P = range(9)


class Recorder:
    """Process-wide capture singleton (global_recorder()). The lock
    guards queue + counters + lifecycle state ONLY — file handles are
    touched exclusively by the writer thread, and the dispatch path
    never blocks on disk."""

    def __init__(self):
        self._lock = threading.Lock()
        self._q: deque = deque()
        self._q_bytes = 0
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cfg: Optional[CaptureConfig] = None
        self._active = False
        self._stopping = False
        self._rng = random.Random()
        self._second = 0
        self._taken = 0
        # (wall_ns, mono_ns) pair from start(): the writer derives
        # every record's wall stamp from it instead of the hot path
        # paying a time.time_ns() per sample
        self._clock_anchor = (time.time_ns(), time.monotonic_ns())
        # incident-window state (incident/manager.py): while True the
        # recorder runs a corpus-recording session the anomaly watchdog
        # opened, and _pre_incident holds (cfg, active) from
        # before the window so end_incident_capture restores the
        # operator's session — not flag defaults
        self._incident_mode = False
        self._pre_incident: Optional[tuple] = None
        # writer-thread-only state (no lock needed: one owner)
        self._writer: Optional[CorpusWriter] = None
        self._file_seq = 0
        self._closed_files: List[str] = []
        # lifetime counters (the bvars read them passively; these
        # survive unexpose_all and feed the /capture page)
        self.written = 0
        self.written_bytes = 0
        self.dropped_queue = 0
        self.dropped_budget = 0
        self.rotations = 0
        self.deleted_files = 0

    # ----------------------------------------------------------- control
    def start(self, cfg: CaptureConfig, _incident: bool = False) -> None:
        """Begin a capture SESSION: counters restart at zero (the
        /capture page reports this session, the corpus files report
        history), the clock anchor re-pins, sampling state resets."""
        os.makedirs(cfg.dir, exist_ok=True)
        # a previous session's writer may still be draining (a stop()
        # whose flush budget expired leaves it running — see stop):
        # settle it first, so exactly ONE writer ever owns the file
        # state. start() is control-plane; a short wait here is fine.
        with self._lock:
            t = self._thread if self._stopping else None
        if t is not None:
            self._wake.set()
            t.join(5.0)
        with self._lock:
            if self._thread is not None \
                    and not self._thread.is_alive():
                self._thread = None
                self._stopping = False
            if not _incident and self._incident_mode:
                # an operator reconfigure that lands MID-incident-window
                # wins: this config becomes the session truth and the
                # window's eventual end_incident_capture restore
                # dissolves into a no-op
                self._incident_mode = False
                self._pre_incident = None
            self._cfg = cfg
            if cfg.seed is not None:
                self._rng.seed(cfg.seed)
            self._clock_anchor = (time.time_ns(), time.monotonic_ns())
            if not self._active:
                self.written = self.written_bytes = 0
                self.dropped_queue = 0
                # dropped_budget's bump in sample_request is lock-free
                # (a racy int, observability only); this only restarts
                # the gauge
                self.dropped_budget = 0
                self.rotations = self.deleted_files = 0
            self._active = True
            self._stopping = False
            self._ensure_thread_locked()

    def stop(self, flush_s: float = 5.0) -> None:
        """Stop sampling and flush the queue: pending records drain to
        disk, the active file closes (index written) so the corpus is
        immediately downloadable. If the writer cannot finish inside
        ``flush_s`` (stalled disk, flush_s=0 from a dispatch-path
        caller), the stopping state is LEFT IN PLACE — the writer
        exits on its own once drained, and the next start() settles
        it. Resetting the flags while the old thread still runs would
        let a restart spawn a SECOND writer over the same file
        state."""
        with self._lock:
            if not self._active and self._thread is None:
                return
            self._active = False
            self._stopping = True
            t = self._thread
        self._wake.set()
        if t is not None:
            t.join(flush_s)
            if t.is_alive():
                return
        with self._lock:
            self._thread = None
            self._stopping = False

    def begin_incident_capture(self, cfg: CaptureConfig) -> bool:
        """Enter corpus-recording mode for an anomaly's bounded window
        (incident/manager.py). Saves the live session state — config
        and active — so the window's close RESTORES it: an
        operator capturing at sampled rates before the incident is
        capturing at the same rates, budget and dir after it, not at
        flag defaults. Returns False when a window is already in
        progress (one incident records at a time) or the spool dir is
        unusable."""
        with self._lock:
            if self._incident_mode:
                return False
            self._pre_incident = (self._cfg, self._active)
            self._incident_mode = True
        try:
            self.start(cfg, _incident=True)
        except OSError:
            with self._lock:
                self._incident_mode = False
                self._pre_incident = None
            return False
        return True

    def end_incident_capture(self, flush_s: float = 3.0) -> bool:
        """Close the incident window: flush/stop the corpus-recording
        session, then restore whatever the operator had running before
        the window. Returns False when no window is active (including
        the operator-reconfigured-mid-window case, where the operator's
        session keeps running untouched)."""
        with self._lock:
            if not self._incident_mode:
                return False
            prior, self._pre_incident = self._pre_incident, None
            self._incident_mode = False
        self.stop(flush_s=flush_s)
        prior_cfg, was_active = prior or (None, False)
        if was_active and prior_cfg is not None:
            try:
                self.start(prior_cfg)
            except OSError:
                pass
        else:
            with self._lock:
                # idle before the window: leave idle, but point the
                # config surfaces (corpus_paths, /capture page) back at
                # the pre-window session instead of the deleted spool
                self._cfg = prior_cfg
        return True

    def incident_capturing(self) -> bool:
        return self._incident_mode

    def capture_enabled(self) -> bool:
        """The dispatch path's gate: one attribute read."""
        return self._active

    def capturing(self) -> bool:
        return self._active

    # ---------------------------------------------------------- sampling
    def sample_request(self, method_key: str, service: str, method: str,
                   payload: bytes, attachment, arrival_ns: int,
                   timeout_ms: float = 0.0, log_id: int = 0,
                   priority: int = 0) -> Optional[tuple]:
        cfg = self._cfg
        if cfg is None or not self._active:
            return None
        rate = cfg.method_rates.get(method_key, cfg.default_rate)
        if rate <= 0.0:
            return None
        if rate < 1.0 and self._rng.random() >= rate:
            return None
        if cfg.max_per_second:
            # LOCK-FREE per-second budget: racing threads may reset the
            # window twice or lose a few increments — a sampling budget
            # is approximate by definition, and a lock here would sit
            # on every request of every dispatch thread
            now = int(time.monotonic())
            if now != self._second:
                self._second = now
                self._taken = 0
            if self._taken >= cfg.max_per_second:
                self.dropped_budget += 1   # racy int, observability-only
                return None
            self._taken += 1
        # attachment snapshot NOW: the handler/response path may alias
        # and consume the request buffers after completion (to_bytes is
        # identity — no copy — for the single-block common case)
        att = b""
        if attachment is not None:
            att = attachment if attachment.__class__ is bytes \
                else attachment.to_bytes()
        return (method_key, service, method, payload, att,
                arrival_ns, timeout_ms or 0.0, log_id, priority)

    def record_complete(self, rec: Optional[tuple], error_code: int,
                    latency_us: float) -> None:
        if rec is None:
            return
        nbytes = len(rec[_PAY]) + len(rec[_ATT])
        with self._lock:
            if not self._active:
                return
            depth = len(self._q)
            if depth >= _QUEUE_CAP or \
                    self._q_bytes + nbytes > _QUEUE_BYTES_CAP:
                self.dropped_queue += 1
                ndropped_queue.add(1)
                return
            self._q.append((rec, error_code, latency_us))
            self._q_bytes += nbytes
            if self._thread is None:
                # postfork left no writer; normal operation never
                # re-checks thread liveness per request
                self._ensure_thread_locked()
        if depth >= _QUEUE_CAP // 2 or \
                self._q_bytes > _QUEUE_BYTES_CAP // 2:
            # wake ELISION is the hot-path discipline: the writer polls
            # every 100ms and a per-enqueue Event.set() (futex) was the
            # single biggest capture cost under pipelined load. The
            # explicit wake exists only for backpressure (queue half
            # full — drain NOW, before the cap drops records) and for
            # stop()'s flush.
            self._wake.set()

    def _ensure_thread_locked(self) -> None:
        # caller holds self._lock
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._record_writer_loop, name="capture_writer",
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------ writer thread
    def _record_writer_loop(self) -> None:
        """Drains the completed-record queue to the corpus file.
        Single owner of every file handle; queue pops under the lock,
        disk writes outside it. All imports are module-level — this is
        recorder-thread code (sampler-no-lazy-import rule)."""
        while True:
            self._wake.wait(0.1)
            self._wake.clear()
            # drain by SWAPPING the whole deque under one O(1) lock
            # hold: popping records one-by-one under the lock held it
            # for tens of microseconds per batch, and every request
            # completing on the dispatch side blocked behind it —
            # measured as the bigger half of the enqueue leg's cost
            with self._lock:
                batch, self._q = self._q, deque()
                self._q_bytes = 0
                stopping = self._stopping
            if batch:
                try:
                    self._write_batch(batch)
                except Exception:
                    # a full/broken disk (or any writer bug) must
                    # never take serving down; the records are lost,
                    # the counter says so
                    with self._lock:
                        self.dropped_queue += len(batch)
                    ndropped_queue.add(len(batch))
            if stopping:
                w, self._writer = self._writer, None
                if w is not None:
                    try:
                        w.close()
                        self._closed_files.append(w.path)
                    except OSError:
                        pass
                return

    def _write_batch(self, batch) -> None:
        with self._lock:
            # start() swaps cfg and the clock anchor under _lock on a
            # runtime reconfigure while this thread is still draining:
            # snapshot both together or the wall stamps mix anchors
            cfg = self._cfg
            wall0, mono0 = self._clock_anchor
        w = self._writer
        if w is None or os.path.dirname(w.path) != cfg.dir:
            if w is not None:
                # a runtime reconfigure moved the capture dir: close
                # the old session's file (index written) — dropping
                # the object unclosed would leak its fd
                try:
                    w.close()
                except OSError:
                    pass
            w = self._open_writer(cfg)
        batch_bytes = 0
        for i, (rec, code, lat_us) in enumerate(batch):
            # wall stamp derived here, off the hot path, from the
            # start-time anchor (one clock pair per recorder start)
            t = rec[_T]
            batch_bytes += w.write_fields(
                rec[_K], rec[_S], rec[_N], rec[_PAY], rec[_ATT], t,
                wall0 + (t - mono0) if t else wall0,
                rec[_O], rec[_P], rec[_L], code, lat_us)
            if w.bytes >= cfg.rotate_bytes:
                # rotation checked per RECORD: a burst drained in one
                # swap must not blow a single file far past the bound
                w.close()
                self._closed_files.append(w.path)
                with self._lock:
                    self.rotations += 1
                self._enforce_disk_budget(cfg)
                w = self._open_writer(cfg)
            if not (i + 1) % 64:
                # yield inside a long burst: an uninterrupted
                # multi-millisecond write loop convoys the event
                # thread behind the GIL switch interval
                time.sleep(0)
        w.flush()
        with self._lock:
            # these increments race start()'s counter reset when a
            # restart lands while the old writer is still draining:
            # unguarded they can resurrect a zeroed counter
            self.written += len(batch)
            # session total, not the active file's size — rotation
            # must not make the page's byte counter fall back to zero
            self.written_bytes += batch_bytes
        nwritten.add(len(batch))

    def _open_writer(self, cfg: CaptureConfig) -> CorpusWriter:
        self._file_seq += 1
        path = os.path.join(
            cfg.dir, f"capture-{os.getpid()}-{self._file_seq}{SUFFIX}")
        self._writer = CorpusWriter(path)
        return self._writer

    def _enforce_disk_budget(self, cfg: CaptureConfig) -> None:
        """Oldest CLOSED files go first; the active file is never
        deleted. Budget covers the whole capture dir (shard siblings
        included — one budget per operator intent, not per pid)."""
        try:
            entries = []
            active = self._writer.path if self._writer is not None else ""
            for name in os.listdir(cfg.dir):
                if not name.endswith(SUFFIX):
                    continue
                p = os.path.join(cfg.dir, name)
                if p == active:
                    continue
                st = os.stat(p)
                entries.append((st.st_mtime_ns, p, st.st_size))
            total = sum(sz for _, _, sz in entries)
            entries.sort()
            while total > cfg.disk_budget_bytes and entries:
                _, p, sz = entries.pop(0)
                os.remove(p)
                try:
                    os.remove(p + ".idx")
                except OSError:
                    pass
                total -= sz
                with self._lock:
                    self.deleted_files += 1
        except OSError:
            pass

    # ---------------------------------------------------------- surfaces
    def corpus_paths(self) -> List[str]:
        """Corpus files in the active (or last) capture dir — every
        shard's files, not just this pid's (the supervisor's download
        merges the whole dir)."""
        cfg = self._cfg
        if cfg is None or not cfg.dir or not os.path.isdir(cfg.dir):
            return []
        return sorted(os.path.join(cfg.dir, n)
                      for n in os.listdir(cfg.dir) if n.endswith(SUFFIX))

    def snapshot(self) -> dict:
        with self._lock:
            pending = len(self._q)
        cfg = self._cfg
        out = {
            "active": self._active, "legacy": False,
            "incident_mode": self._incident_mode,
            "config": cfg.to_dict() if cfg is not None else None,
            "pending": pending,
            "sampled": self.written + self.dropped_queue + pending,
            "written": self.written,
            "written_bytes": self.written_bytes,
            "dropped_queue": self.dropped_queue,
            "dropped_budget": self.dropped_budget,
            "rotations": self.rotations,
            "deleted_files": self.deleted_files,
            "pid": os.getpid(),
        }
        paths = self.corpus_paths()
        out["files"] = [{"path": p, "bytes": _fsize(p)} for p in paths]
        return out


def _fsize(p: str) -> int:
    try:
        return os.stat(p).st_size
    except OSError:
        return 0


_recorder = Recorder()


def global_recorder() -> Recorder:
    return _recorder


def start_capture(dir: Optional[str] = None, **overrides) -> dict:
    """Runtime control (the /capture page's start action): flags
    provide defaults, keyword overrides win. Returns the snapshot."""
    r = global_recorder()
    cfg = CaptureConfig.from_flags(dir=dir, **overrides)
    if not cfg.dir:
        raise ValueError("capture needs a directory (capture_dir flag "
                         "or dir= argument)")
    r.start(cfg)
    return r.snapshot()


def stop_capture() -> dict:
    r = global_recorder()
    r.stop()
    return r.snapshot()


def _postfork_reset() -> None:
    """Fork hygiene, IN PLACE (dispatch code may hold the recorder
    object): the child inherits the parent's queue (parent's in-flight
    records), a writer thread that did not survive the fork, and a
    CorpusWriter whose fd shares the parent's file offset through the
    shared open-file description. Fresh lock/queue/event, thread and
    writer dropped (the inherited fd closes with the writer object;
    the PARENT keeps its own reference so nothing of the parent's is
    torn). The CONFIG and active state survive, so a capturing shard
    child keeps capturing — into its own per-pid file (_open_writer
    names files by os.getpid()), and counters restart at zero. Not
    registered: the postfork registry comes with shard groups (ROADMAP
    section 1)."""
    r = _recorder
    if r._incident_mode:
        # the incident window belongs to the PARENT (its watchdog, its
        # spool): the child resumes the pre-window session state
        cfg, was_active = r._pre_incident or (None, False)
        r._cfg = cfg
        r._active = bool(was_active and cfg is not None)
    r._incident_mode = False
    r._pre_incident = None
    r._lock = threading.Lock()
    r._q = deque()
    r._q_bytes = 0
    r._wake = threading.Event()
    r._thread = None
    r._stopping = False
    r._writer = None         # per-pid file: the child opens its own
    r._file_seq = 0
    r._closed_files = []
    r._second = 0
    r._taken = 0
    r._clock_anchor = (time.time_ns(), time.monotonic_ns())
    r.written = r.written_bytes = 0
    r.dropped_queue = r.dropped_budget = 0
    r.rotations = r.deleted_files = 0

