"""The flight recorder (the port of brpc_tpu/builtin/flight_recorder.py):
a continuous profiler, attributed by RPC method, and the event
dispatcher's stall watchdog, on one sampler thread.

  * The sampler (``continuous_profiler_hz``, 20 by default) walks
    ``sys._current_frames()`` and gives each sample a label, most
    specific first: the RPC method the thread's current fiber serves
    (the scheduler's per-thread cell, ``thread_current_fiber``, and the
    server's ``_serving_cntl``), the fiber's name, a worker module's
    slice (the serving engine's decode steps: ``rpc:GenerateService.
    Generate``), a serving or device thread's stamp, the device lane or
    socket a hint frame names, then the thread's name. Idle threads
    (parked in a wait or the selector) count but are not folded.
  * Samples gather into a ring of windows (``continuous_profiler_
    windows`` of ``continuous_profiler_window_s``), served by
    ``/hotspots?mode=continuous`` as text, folded stacks, an SVG
    flamegraph or JSON; ``diff=1`` compares the newest two windows.
  * The same thread watches the event dispatcher: a callback batch past
    ``dispatcher_stall_ms`` is counted once and annotated into the rpcz
    span of the request holding the thread.
  * On-demand profiles (``/hotspots``) run on this thread as jobs; the
    page's fiber parks until the job is done, and a second profile
    while one runs is refused (503).

Collaborators that import back into this package are bound on the
thread that starts the sampler (``_bind_sampler_imports``); the sampler
never imports. The port stops the sampler when its last running
``Server`` stops (``hold_recorder``/``release_recorder``), where the
reference leaves it running. ``merge_dump_states`` (the shard groups'
merge) and the postfork registration wait for shard groups (ROADMAP
section 1).
"""

from __future__ import annotations

import sys
import threading
import time
import weakref
from collections import Counter, deque
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch.butil.flags import define_flag, flag
# bound at load: the sampler's attribution reads these and must not
# import on its thread
from brpc_tpu_torch.fiber import worker_module as _worker_module
from brpc_tpu_torch.transport import device_stats as _device_stats

# import-cyclic with this module at load (they reach back into the
# builtin package): bound by _bind_sampler_imports on the caller's thread
_sched = None                  # brpc_tpu_torch.fiber.scheduler
_thread_current_fiber = None   # scheduler.thread_current_fiber
_serving_cntl = None           # server_dispatch._serving_cntl
_ed = None                     # brpc_tpu_torch.transport.event_dispatcher


def _bind_sampler_imports() -> None:
    """Bind what the sampler thread touches, once, on the thread that
    starts it."""
    global _sched, _thread_current_fiber, _serving_cntl, _ed
    if _ed is not None:
        return
    from brpc_tpu_torch.fiber import scheduler as sched
    from brpc_tpu_torch.rpc.server_dispatch import _serving_cntl as sc
    from brpc_tpu_torch.transport import event_dispatcher as ed
    _sched, _thread_current_fiber, _serving_cntl = (
        sched, sched.thread_current_fiber, sc)
    _ed = ed


define_flag("continuous_profiler_hz", 20,
            "continuous sampling profiler rate (samples/s across all "
            "threads); 0 parks the continuous profile only: on-demand "
            "/hotspots and the stall watchdog (50 ms poll) keep working")
define_flag("continuous_profiler_window_s", 10,
            "seconds per continuous-profile window")
define_flag("continuous_profiler_windows", 6,
            "completed windows kept in the continuous-profile ring")

_MAX_STACK = 48

# frames of transport/socket.py whose ``self`` is the Socket being read
# or written: a sample there with no other label takes the socket's
# last-served method
_SOCK_HINT_FRAMES = frozenset((
    "_drain_readable", "_process_input_entry", "_on_readable_event",
    "_drain_writes", "_on_writable_event"))

# frames of transport/ici.py and cudad.py whose ``self`` is the device
# lane's conn (pump, flush, staging, the pull): such a sample with no
# serving context is labelled ``device:<peer>``
_DEV_HINT_FRAMES = frozenset((
    "_pump", "_pump_locked", "_flush", "_stage_lane_frame",
    "_stage_coalesced_frame", "_pull_ipc", "take_device_payload",
    "write_device_payload"))
_DEV_HINT_FILES = ("ici.py", "cudad.py")

# frame labels, keyed by the code object itself (an id()-keyed cache
# could serve a dead function's label after the address is reused)
_frame_ids: Dict[tuple, str] = {}


def _frame_id(frame) -> str:
    code = frame.f_code
    key = (code, frame.f_lineno)
    s = _frame_ids.get(key)
    if s is None:
        if len(_frame_ids) > 65536:
            _frame_ids.clear()
        s = (f"{code.co_name} "
             f"({code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno})")
        _frame_ids[key] = s
    return s


def _is_idle(frame) -> bool:
    """A thread parked in a condition or event wait, or in the selector's
    poll, waits: it must not fill the flamegraph."""
    code = frame.f_code
    name = code.co_name
    if name in ("wait", "_wait_for_tstate_lock", "select", "poll"):
        fn = code.co_filename
        return fn.endswith(("threading.py", "selectors.py"))
    return False


class _Window:
    """One continuous-profile window: folded busy stacks and counts by
    label."""

    __slots__ = ("start_mono", "end_mono", "nsamples", "nbusy",
                 "folded", "labels")

    def __init__(self, now: float):
        self.start_mono = now
        self.end_mono = 0.0
        self.nsamples = 0       # thread samples taken (busy and idle)
        self.nbusy = 0
        self.folded: Counter = Counter()
        self.labels: Counter = Counter()


class _Job:
    """One on-demand profile, run by the sampler thread."""

    __slots__ = ("deadline", "interval", "next_due", "on_done",
                 "leaves", "folded", "nsamples", "idle")

    def __init__(self, seconds: float, interval: float, on_done: Callable):
        now = time.monotonic()
        self.deadline = now + seconds
        self.interval = max(0.001, interval)
        self.next_due = now
        self.on_done = on_done
        self.leaves: Counter = Counter()
        self.folded: Counter = Counter()
        self.nsamples = 0
        # idle samples by thread name: where a profiled wait sits (the
        # port's addition; the reference counts them only in nsamples)
        self.idle: Counter = Counter()


class FlightRecorder:
    def __init__(self):
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._wake = threading.Event()      # nudges the loop off a sleep
        self._thread: Optional[threading.Thread] = None
        self._cur: Optional[_Window] = None
        self._done: deque = deque(maxlen=16)
        self._job: Optional[_Job] = None
        self._next_cont = 0.0
        self._annotated_tick = -1

    # ----------------------------------------------------------- lifecycle
    def ensure_running(self) -> None:
        _bind_sampler_imports()
        t = self._thread
        if t is not None and t.is_alive() and self._stop_ev.is_set() \
                and t is not threading.current_thread():
            t.join(1.0)     # a stopping sampler ends within one sleep
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop_ev = threading.Event()
                self._wake = threading.Event()
                self._thread = threading.Thread(
                    target=self._loop, name="flight_recorder", daemon=True)
                self._thread.start()

    def stop(self, join_s: float = 0.0) -> None:
        """End the sampler thread; wait up to ``join_s`` for it."""
        self._stop_ev.set()
        self._wake.set()
        t = self._thread
        if join_s > 0 and t is not None and \
                t is not threading.current_thread():
            t.join(join_s)

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # ----------------------------------------------------------- on-demand
    def request_profile(self, seconds: float, interval_s: float,
                        on_done: Callable) -> bool:
        """Run an on-demand profile on the sampler thread;
        ``on_done(leaves, folded, nsamples, idle)`` fires there at the
        deadline (``idle``: the idle samples by thread name, which the
        reference does not keep). False (the page answers 503) while
        another profile runs."""
        with self._lock:
            if self._job is not None:
                return False
            self._job = _Job(seconds, interval_s, on_done)
        self.ensure_running()
        # off whatever sleep the loop is in: the job's window must not
        # be spent waiting for a low-rate continuous tick
        self._wake.set()
        return True

    def profiling(self) -> bool:
        return self._job is not None

    # ------------------------------------------------------------ sampling
    def _sample_pass(self, include_cont: bool, job: Optional[_Job]) -> None:
        me = threading.get_ident()
        frames = sys._current_frames()
        if _sched is not None:
            _sched.prune_thread_registry(frames.keys())
        names = {t.ident: t.name for t in threading.enumerate()}
        # counted locally, merged into the live window once under the
        # lock readers copy it under
        loc_folded: Counter = Counter()
        loc_labels: Counter = Counter()
        nsamples = nbusy = 0
        for tid, frame in frames.items():
            if tid == me:
                continue
            nsamples += 1
            if job is not None:
                job.nsamples += 1
            if _is_idle(frame):
                if job is not None:
                    job.idle[names.get(tid, tid)] += 1
                continue
            stack: List[str] = []
            hint_frame = None
            dev_hint_frame = None
            f = frame
            while f is not None and len(stack) < _MAX_STACK:
                stack.append(_frame_id(f))
                code = f.f_code
                if hint_frame is None and \
                        code.co_name in _SOCK_HINT_FRAMES and \
                        code.co_filename.endswith("socket.py"):
                    hint_frame = f
                if dev_hint_frame is None and \
                        code.co_name in _DEV_HINT_FRAMES and \
                        code.co_filename.endswith(_DEV_HINT_FILES):
                    dev_hint_frame = f
                f = f.f_back
            if not stack:
                continue
            label = self._attribute(tid, names, hint_frame,
                                    dev_hint_frame)
            folded_key = label + ";" + ";".join(reversed(stack))
            nbusy += 1
            loc_folded[folded_key] += 1
            loc_labels[label] += 1
            if job is not None:
                # only this thread touches the job until its on_done
                job.leaves[stack[0]] += 1
                job.folded[folded_key] += 1
        if include_cont:
            with self._lock:
                cur = self._cur
                if cur is not None:
                    cur.nsamples += nsamples
                    cur.nbusy += nbusy
                    cur.folded.update(loc_folded)
                    cur.labels.update(loc_labels)

    @staticmethod
    def _attribute(tid: int, names: Dict[int, str],
                   hint_frame=None, dev_hint_frame=None) -> str:
        """A sample's label, most specific first (see the module's
        docstring)."""
        if _thread_current_fiber is None:
            return f"thread:{names.get(tid, tid)}"
        fiber = _thread_current_fiber(tid)
        if fiber is not None:
            try:
                cntl = _serving_cntl.peek(fiber)
            except Exception:
                cntl = None
            if cntl is not None:
                svc = getattr(cntl, "_service_name", "") or ""
                meth = getattr(cntl, "_method_name", "") or ""
                if svc or meth:
                    return f"rpc:{svc}.{meth}"
            name = fiber.name
            if name:
                if "." in name and " " not in name:
                    return f"rpc:{name}"
                return f"fiber:{name}"
            return "fiber:<anon>"
        # the serving engine's decode slices run on a worker outside any
        # fiber; the module declares its label
        lbl = _worker_module.active_label(tid)
        if lbl:
            return f"rpc:{lbl}" if "." in lbl else f"module:{lbl}"
        # through sys.modules, never an import: the serving package
        # must not load because the recorder sampled a thread
        ss = sys.modules.get("brpc_tpu_torch.serving.serving_stats")
        if ss is not None:
            srv_lbl = ss.serving_thread_label(tid)
            if srv_lbl:
                return srv_lbl
        dev_lbl = _device_stats.device_thread_label(tid)
        if dev_lbl:
            return dev_lbl
        if dev_hint_frame is not None:
            # f_locals of another thread's frame is a copy: it never
            # changes the frame
            try:
                conn = dev_hint_frame.f_locals.get("self")
                rem = getattr(conn, "_remote", None)
                if rem is not None:
                    return f"device:{rem}"
            except Exception:
                pass
        if hint_frame is not None:
            try:
                sock = hint_frame.f_locals.get("self")
                lm = getattr(sock, "last_method", None)
                if lm:
                    return f"rpc:{lm}"
            except Exception:
                pass
        return f"thread:{names.get(tid, tid)}"

    # ------------------------------------------------------------ watchdog
    def _watchdog_pass(self, now_ns: int) -> None:
        ed = _ed
        if ed is None:
            return
        d = ed.peek_dispatcher()
        if d is None:
            return
        t0 = d._tick_start_ns
        if not t0:
            return
        stall_ms = (now_ns - t0) / 1e6
        if stall_ms <= 1.0:
            return
        ed.note_stall(stall_ms)
        if stall_ms < float(flag("dispatcher_stall_ms")):
            return
        seq = d._tick_seq
        if seq == self._annotated_tick:
            return                      # this overrun is flagged already
        self._annotated_tick = seq
        d.count_stall(seq)
        # name the culprit: the span of the request whose handler holds
        # the event thread (processed in place)
        t = d.thread
        if t is None or t.ident is None or _thread_current_fiber is None:
            return
        fiber = _thread_current_fiber(t.ident)
        if fiber is None:
            return
        try:
            cntl = _serving_cntl.peek(fiber)
            span = cntl.__dict__.get("_span") if cntl is not None else None
            if span is not None and hasattr(span, "annotate"):
                span.annotate(f"dispatcher_stall {stall_ms:.1f}ms "
                              "(handler held the event thread)")
        except Exception:
            pass

    # ---------------------------------------------------------------- loop
    def _sleep(self, seconds: float) -> None:
        """A sleep a new job or ``stop`` cuts short."""
        if self._wake.wait(max(0.001, seconds)):
            self._wake.clear()

    def _loop(self) -> None:
        stop = self._stop_ev
        while not stop.is_set():
            hz = flag("continuous_profiler_hz")
            with self._lock:
                job = self._job
            if hz <= 0 and job is None:
                # profiling parked: the stall watchdog stays on, a 50 ms
                # poll catches the default threshold
                try:
                    self._watchdog_pass(time.monotonic_ns())
                except Exception:
                    pass
                self._sleep(0.05)
                continue
            period = 1.0 / max(0.5, float(hz)) if hz > 0 else 0.25
            now = time.monotonic()
            if hz > 0:
                win_s = max(1.0, float(flag("continuous_profiler_window_s")))
                with self._lock:
                    if self._cur is None:
                        self._cur = _Window(now)
                        self._next_cont = now
                    elif now - self._cur.start_mono >= win_s:
                        self._cur.end_mono = now
                        # completed windows (at least 2, so window_diff
                        # has a pair); the live one rides on top
                        keep = max(
                            2, int(flag("continuous_profiler_windows")))
                        if self._done.maxlen != keep:
                            self._done = deque(self._done, maxlen=keep)
                        self._done.append(self._cur)
                        self._cur = _Window(now)
            cont_due = hz > 0 and now >= self._next_cont
            job_due = job is not None and now >= job.next_due
            if cont_due or job_due:
                try:
                    self._sample_pass(cont_due, job if job_due else None)
                except Exception:
                    pass                # sampling must never die
                if cont_due:
                    self._next_cont = now + period
                if job_due:
                    job.next_due = now + job.interval
            try:
                self._watchdog_pass(time.monotonic_ns())
            except Exception:
                pass
            if job is not None and now >= job.deadline:
                self._finish_job()
                job = None
            # the next due event sets the sleep, 50 ms at most, so the
            # stall watchdog keeps its resolution at any rate
            waits = [0.05]
            if hz > 0:
                waits.append(self._next_cont - time.monotonic())
            if job is not None:
                waits.append(job.next_due - time.monotonic())
            self._sleep(min(waits))
        # stopped with a profile running: answer it with what it has
        self._finish_job()

    def _finish_job(self) -> None:
        with self._lock:
            job, self._job = self._job, None
        if job is not None:
            try:
                job.on_done(job.leaves, job.folded, job.nsamples, job.idle)
            except Exception:
                pass

    # ------------------------------------------------------------- reading
    def windows(self) -> List[_Window]:
        """Completed windows, oldest first, and a copy of the live one
        (made under the lock the sampler merges under)."""
        with self._lock:
            out = list(self._done)
            cur = self._cur
            if cur is not None:
                snap = _Window(cur.start_mono)
                snap.nsamples = cur.nsamples
                snap.nbusy = cur.nbusy
                snap.folded = Counter(cur.folded)
                snap.labels = Counter(cur.labels)
                out.append(snap)
        return out

    def merged(self, windows: Optional[List[_Window]] = None) -> dict:
        wins = self.windows() if windows is None else windows
        folded: Counter = Counter()
        labels: Counter = Counter()
        nsamples = nbusy = 0
        for w in wins:
            folded.update(w.folded)
            labels.update(w.labels)
            nsamples += w.nsamples
            nbusy += w.nbusy
        span_s = 0.0
        if wins:
            end = wins[-1].end_mono or time.monotonic()
            span_s = max(0.0, end - wins[0].start_mono)
        return {"nsamples": nsamples, "nbusy": nbusy,
                "windows": len(wins), "span_s": round(span_s, 1),
                "folded": folded, "labels": labels}

    def window_diff(self) -> dict:
        """The change between the two newest completed windows (the live
        one is left out: a partial window would look cooler)."""
        with self._lock:
            done = list(self._done)
        if len(done) < 2:
            return {"ok": False, "reason":
                    "need two completed windows (profiler just "
                    "started? window_s too long for this wait?)"}
        prev, cur = done[-2], done[-1]
        delta: Counter = Counter(cur.folded)
        delta.subtract(prev.folded)
        return {"ok": True,
                "cur_samples": cur.nbusy, "prev_samples": prev.nbusy,
                "delta": {k: v for k, v in delta.items() if v},
                "labels_cur": dict(cur.labels),
                "labels_prev": dict(prev.labels)}

    def dump_state(self, top: int = 150) -> dict:
        """A JSON-ready snapshot: the bounded folded stacks and the
        labels (an incident artifact keeps it)."""
        m = self.merged()
        ed = _ed
        return {
            "nsamples": m["nsamples"], "nbusy": m["nbusy"],
            "windows": m["windows"], "span_s": m["span_s"],
            "folded": dict(m["folded"].most_common(top)),
            "labels": dict(m["labels"].most_common(50)),
            "stall_ms_max_10s": ed.stall_ms_max_10s()
            if ed is not None else None,
        }

    def note_incident(self, text: str) -> None:
        """The anomaly watchdog's stamp (``bvar/anomaly.py``): mark the
        live window, so the window of a break reads as such on
        ``/hotspots?mode=continuous``. No live window, nothing to mark."""
        with self._lock:
            cur = self._cur
            if cur is not None:
                cur.labels[f"incident:{text}"] += 1

    def clear(self) -> None:
        with self._lock:
            self._done.clear()
            self._cur = None


# ---------------------------------------------------------------- render

def render_continuous_text(m: dict, top: int = 40) -> str:
    """The text view of a merged continuous profile, labels first."""
    labels: Counter = m["labels"] if isinstance(m["labels"], Counter) \
        else Counter(m["labels"])
    nbusy = m["nbusy"] or 0
    lines = [f"continuous profile: {m['nsamples']} samples over "
             f"~{m.get('span_s', 0)}s in {m.get('windows', 0)} window(s); "
             f"{nbusy} busy\n"]
    if m.get("stall_ms_max_10s") is not None:
        lines.append(
            f"dispatcher_stall_ms_max_10s: {m['stall_ms_max_10s']}\n")
    lines.append("\nbusy samples by attribution:\n")
    for label, n in labels.most_common(top):
        pct = 100.0 * n / nbusy if nbusy else 0.0
        lines.append(f"{n:8d} {pct:5.1f}%  {label}\n")
    lines.append("\ntop stacks (folded):\n")
    folded: Counter = m["folded"] if isinstance(m["folded"], Counter) \
        else Counter(m["folded"])
    for stack, n in folded.most_common(top):
        lines.append(f"{n:8d}  {stack}\n")
    return "".join(lines)


def render_diff_text(d: dict, top: int = 40) -> str:
    if not d.get("ok"):
        return f"window diff unavailable: {d.get('reason')}\n"
    lines = [f"window diff (newest {d['cur_samples']} busy samples vs "
             f"previous {d['prev_samples']}):\n"]
    items = sorted(d["delta"].items(), key=lambda kv: -abs(kv[1]))
    for stack, dv in items[:top]:
        lines.append(f"{dv:+8d}  {stack}\n")
    if not items:
        lines.append("(no change)\n")
    return "".join(lines)


# ---------------------------------------------------------------- global

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()
# the running servers that hold the sampler (Server.start / stop)
_holders: "weakref.WeakSet" = weakref.WeakSet()


def global_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def hold_recorder(owner) -> None:
    """``Server.start``: the sampler runs while a server holds it."""
    with _recorder_lock:
        _holders.add(owner)
    global_recorder().ensure_running()


def release_recorder(owner, join_s: float = 1.0) -> None:
    """``Server.stop``: the last server to let go stops the sampler, so
    no 20 Hz walker of every thread's frames outlives the servers."""
    with _recorder_lock:
        _holders.discard(owner)
        last = not len(_holders)
    if last:
        global_recorder().stop(join_s)


def _postfork_reset() -> None:
    """Fork hygiene: the sampler thread exists only in the parent. Not
    registered: the postfork registry comes with shard groups (ROADMAP
    section 1)."""
    global _recorder, _recorder_lock, _holders
    _recorder = None
    _recorder_lock = threading.Lock()
    _holders = weakref.WeakSet()
