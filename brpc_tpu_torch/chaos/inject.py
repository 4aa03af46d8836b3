"""Chaos installation: wrap registered transports so every Conn they
hand out replays its scripted faults (the port of
brpc_tpu/chaos/inject.py; the script is ``chaos/plan.py``).

The seam is the ``Transport``/``Conn`` contract (transport/base.py): a
``ChaosConn`` is a byte-stream conn whose WRITE side applies the
script — delays park the writer exactly like a full kernel buffer
(BlockingIOError + a writable event when the hold elapses), drops kill
the conn mid-stream, corruption flips one byte, a partial stall accepts
a prefix and never becomes writable again. The read side is untouched:
every fault a peer can observe arrives through real bytes (or their
absence), so the layers above exercise their production paths.

Install wraps the process-global transport registry; uninstall restores
it. Sockets created while installed keep their chaos conns for life —
a storm's victims stay victims until closed.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.chaos.plan import Fault, FaultPlan, endpoint_key
from brpc_tpu_torch.transport.base import Conn, Listener, Transport

# one injection counter per primitive (/vars chaos_injected_*)
chaos_counters: Dict[str, Adder] = {
    kind: Adder().expose(f"chaos_injected_{kind}")
    for kind in ("delay", "drop", "corrupt", "partial", "refuse", "flap")
}

_COUNTER_FOR = {"delay": "delay", "drop": "drop", "corrupt": "corrupt",
                "partial_stall": "partial", "refuse": "refuse",
                "flap": "flap"}


def _count(kind: str) -> None:
    chaos_counters[_COUNTER_FOR[kind]].add(1)


class ChaosConn(Conn):
    """A Conn whose outbound stream replays a fault script. Reads,
    events and device payloads delegate to the wrapped conn."""

    # the Socket's gather writer would send through conn.writev and pass
    # write() by: hide it, so every outbound byte crosses the script
    writev = None

    # never ring-native (shadow the inner TcpConn's True before
    # __getattr__ can forward it): the ring tick's native recv and
    # gather write would move bytes without crossing this fault script.
    # Poll-only registration keeps the chaos lane seeing every byte
    # while the ring dispatcher still drives readiness.
    supports_ring_sink = False
    ring_attached = False

    def __init__(self, inner: Conn, faults: Optional[List[Fault]],
                 plan: FaultPlan, key: str, idx: int):
        self._inner = inner
        self._faults = list(faults or ())
        self._plan = plan
        self._key = key
        self._idx = idx
        self._wrote = 0
        self._dropped = False
        self._blocking: Optional[Fault] = None   # delay/stall in force
        self._on_writable: Optional[Callable[[], None]] = None

    # ------------------------------------------------------------- writes
    def write(self, mv: memoryview) -> int:
        if self._dropped:
            raise BrokenPipeError("chaos: connection dropped")
        if not isinstance(mv, memoryview):
            mv = memoryview(mv)
        faults = self._faults
        while faults:
            f = faults[0]
            if f.kind == "corrupt":
                if self._wrote + len(mv) <= f.at_byte:
                    break                      # trigger byte not here yet
                rel = f.at_byte - self._wrote
                if rel < 0:
                    faults.pop(0)              # offset already passed
                    continue
                buf = bytearray(mv)
                buf[rel] ^= (f.xor_mask or 0xFF)
                mv = memoryview(bytes(buf))
                # consumed only if the flipped byte actually leaves
                # (post-write check below) — remember where it sits
                f._armed_ns = rel
                break
            if f.kind == "drop":
                if self._wrote >= f.at_byte:
                    faults.pop(0)
                    _count("drop")
                    self._plan.record("drop", self._key, self._idx)
                    self.force_drop()
                    raise BrokenPipeError("chaos: dropped at offset "
                                          f"{f.at_byte}")
                mv = mv[:f.at_byte - self._wrote]
                break
            if f.kind == "delay":
                if self._wrote < f.at_byte:
                    mv = mv[:f.at_byte - self._wrote]
                    break
                now = time.monotonic_ns()
                if f._armed_ns is None:
                    f._armed_ns = now
                    _count("delay")
                    self._plan.record("delay", self._key, self._idx)
                if now - f._armed_ns < f.delay_ms * 1e6:
                    self._blocking = f
                    raise BlockingIOError("chaos: delayed "
                                          f"{f.delay_ms}ms")
                faults.pop(0)                  # hold elapsed: release
                self._blocking = None
                continue
            if f.kind == "partial_stall":
                if self._wrote >= f.at_byte:
                    if not f._done:
                        f._done = True
                        _count("partial_stall")
                        self._plan.record("partial_stall", self._key,
                                          self._idx)
                    self._blocking = f
                    raise BlockingIOError("chaos: stalled at offset "
                                          f"{f.at_byte}")
                mv = mv[:f.at_byte - self._wrote]
                break
            break
        n = self._inner.write(mv)
        self._wrote += n
        if faults and faults[0].kind == "corrupt" \
                and faults[0]._armed_ns is not None:
            f = faults[0]
            if f._armed_ns < n:                # the flipped byte left
                faults.pop(0)
                _count("corrupt")
                self._plan.record("corrupt", self._key, self._idx)
            else:                              # short write kept it home
                f._armed_ns = None
        return n

    def force_drop(self) -> None:
        """Kill the link now (flap/drop): the peer reads EOF, local
        writes fail."""
        self._dropped = True
        try:
            self._inner.close()
        except Exception:
            pass

    # -------------------------------------------------------------- reads
    def read_into(self, mv: memoryview) -> int:
        return self._inner.read_into(mv)

    def close(self) -> None:
        self._inner.close()

    # ------------------------------------------------------------- events
    def start_events(self, on_readable, on_writable) -> None:
        self._on_writable = on_writable
        self._inner.start_events(on_readable, on_writable)

    def request_writable_event(self) -> None:
        f = self._blocking
        if f is not None:
            if f.kind == "partial_stall":
                return          # never writable again: that's the fault
            # delay: fire the writable event when the hold elapses, not
            # when the kernel (which never blocked) says so
            remaining_s = max(0.0, f.delay_ms / 1e3 -
                              (time.monotonic_ns() -
                               (f._armed_ns or 0)) / 1e9)
            from brpc_tpu_torch.fiber.timer import global_timer
            cb = self._on_writable
            if cb is not None:
                global_timer().schedule_after(remaining_s + 0.001, cb)
            return
        self._inner.request_writable_event()

    def write_device_payload(self, arrays, tracker=None):
        if tracker is not None and \
                getattr(self._inner, "supports_device_tracker", False):
            return self._inner.write_device_payload(arrays,
                                                    tracker=tracker)
        return self._inner.write_device_payload(arrays)

    @property
    def supports_device_lane(self) -> bool:
        return self._inner.supports_device_lane

    @property
    def supports_device_tracker(self) -> bool:
        return getattr(self._inner, "supports_device_tracker", False)

    @property
    def local_endpoint(self):
        return self._inner.local_endpoint

    @property
    def remote_endpoint(self):
        return self._inner.remote_endpoint

    def __getattr__(self, name):
        # transport extras (read_chunks, pending_bytes, pluck_fd, ...):
        # read-side and identity surfaces pass straight through
        return getattr(self._inner, name)


class _ChaosListener(Listener):
    def __init__(self, inner: Listener, transport: "ChaosTransport",
                 key: str):
        self._inner = inner
        self._transport = transport
        self._key = key

    def stop(self) -> None:
        self._inner.stop()

    @property
    def endpoint(self):
        return self._inner.endpoint

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ChaosTransport(Transport):
    """Wraps a registered transport: connect/listen consult the plan;
    byte-stream faults ride the returned conns."""

    def __init__(self, inner: Transport, plan: FaultPlan):
        self._inner = inner
        self._plan = plan
        self.scheme = inner.scheme
        self._lock = threading.Lock()
        # live conns per endpoint key, for flap's drop-everything
        self._live: Dict[str, "weakref.WeakSet"] = {}

    def connect(self, ep) -> Conn:
        key = endpoint_key(ep)
        plan = self._plan
        with self._lock:
            idx = plan.next_conn_index(key)
            verdict = plan.connect_verdict(key, idx)
            # snapshot under the SAME lock registrations happen under:
            # a concurrent connect/accept mutating the WeakSet would
            # blow up the iteration (set changed size) mid-storm
            victims = list(self._live.get(key, ())) \
                if verdict == "flap" else ()
        if verdict == "flap":
            _count("flap")
            plan.record("flap", key, idx)
            for conn in victims:
                conn.force_drop()
            raise ConnectionRefusedError(
                f"chaos: {key} flapped at conn #{idx}")
        if verdict == "refuse":
            _count("refuse")
            plan.record("refuse", key, idx)
            raise ConnectionRefusedError(
                f"chaos: connect #{idx} to {key} refused")
        inner = self._inner.connect(ep)
        conn = ChaosConn(inner, plan.script_for(key, idx, "connect"),
                         plan, key, idx)
        with self._lock:
            self._live.setdefault(key, weakref.WeakSet()).add(conn)
        return conn

    def listen(self, ep, on_new_conn) -> Listener:
        key = endpoint_key(ep)
        plan = self._plan
        transport = self

        def _wrap_accept(inner_conn):
            with transport._lock:
                idx = plan.next_conn_index(key + "|accept")
            conn = ChaosConn(inner_conn,
                             plan.script_for(key, idx, "accept"),
                             plan, key, idx)
            with transport._lock:
                transport._live.setdefault(
                    key, weakref.WeakSet()).add(conn)
            on_new_conn(conn)

        return _ChaosListener(self._inner.listen(ep, _wrap_accept),
                              self, key)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# ------------------------------------------------------------- install --
_install_lock = threading.Lock()
_installed: Optional[tuple] = None     # (plan, {scheme: original})


def installed_schemes() -> list:
    """The schemes a plan wraps now ([] when none is installed: the
    tests' leak check)."""
    inst = _installed
    return sorted(inst[1]) if inst is not None else []


def install(plan: FaultPlan) -> None:
    """Wrap every transport scheme the plan references. One plan at a
    time; servers/channels created AFTER install see the faults."""
    global _installed
    from brpc_tpu_torch.transport import base
    base.get_transport("mem")          # force builtin registration
    with _install_lock:
        if _installed is not None:
            raise RuntimeError("a FaultPlan is already installed")
        originals: Dict[str, Transport] = {}
        with base._lock:
            for scheme in sorted(plan.schemes()):
                inner = base._transports.get(scheme)
                if inner is None:
                    continue
                originals[scheme] = inner
                base._transports[scheme] = ChaosTransport(inner, plan)
        _installed = (plan, originals)


def uninstall() -> None:
    """Restore the wrapped transports (idempotent)."""
    global _installed
    from brpc_tpu_torch.transport import base
    with _install_lock:
        if _installed is None:
            return
        _, originals = _installed
        with base._lock:
            for scheme, inner in originals.items():
                base._transports[scheme] = inner
        _installed = None


def installed_plan() -> Optional[FaultPlan]:
    inst = _installed
    return inst[0] if inst is not None else None
