"""Live fiber stacks (the port of brpc_tpu/fiber/stacks.py; the
reference's tools/gdb_bthread_stack.py).

Fibers are coroutines: a suspended fiber's continuation hangs off
``coro.cr_frame`` and ``cr_await``, so its stack is readable from Python
itself. The live fibers are found through the GC, so spawning pays
nothing for this.

  * ``dump_fiber_stacks()``: the text report;
  * ``/fibers?stacks=1`` (and ``/bthreads``): the same, from a server;
  * ``enable_stack_dump_signal()``: SIGUSR2 prints the report to
    stderr. ``Server.start`` installs it where it can (the main thread
    only, and only over the default disposition).
"""
from __future__ import annotations

import gc
import signal
import sys
import traceback
from typing import List

from brpc_tpu_torch.fiber.scheduler import (FIBER_STATE_DONE,
                                            FIBER_STATE_READY,
                                            FIBER_STATE_RUNNING,
                                            FIBER_STATE_SUSPENDED, Fiber)

_STATE_NAMES = {
    FIBER_STATE_READY: "READY",
    FIBER_STATE_RUNNING: "RUNNING",
    FIBER_STATE_SUSPENDED: "SUSPENDED",
    FIBER_STATE_DONE: "DONE",
}


def _coro_frames(coro) -> List:
    """Walk a suspended coroutine's await chain innermost-last."""
    frames = []
    seen = set()
    while coro is not None and id(coro) not in seen:
        seen.add(id(coro))
        frame = getattr(coro, "cr_frame", None) or \
            getattr(coro, "gi_frame", None)
        if frame is not None:
            frames.append(frame)
        coro = getattr(coro, "cr_await", None) or \
            getattr(coro, "gi_yieldfrom", None)
    return frames


def live_fibers() -> List[Fiber]:
    return [o for o in gc.get_objects()
            if type(o) is Fiber and o.state != FIBER_STATE_DONE]


def dump_fiber_stacks(include_ready: bool = True) -> str:
    """One block per live fiber: name, state, and the Python stack its
    continuation is parked on (RUNNING fibers show no stack here —
    they're on some thread's C stack; see /threads for those)."""
    out = []
    fibers = live_fibers()
    if not include_ready:
        fibers = [f for f in fibers if f.state != FIBER_STATE_READY]
    out.append(f"{len(fibers)} live fibers\n")
    for f in fibers:
        state = _STATE_NAMES.get(f.state, str(f.state))
        out.append(f"\n--- fiber {f.name or '<unnamed>'} [{state}]\n")
        if f.state == FIBER_STATE_RUNNING:
            out.append("  (executing on a worker thread — /threads "
                       "shows thread stacks)\n")
            continue
        frames = _coro_frames(f.coro)
        if not frames:
            out.append("  (not started)\n")
            continue
        for frame in frames:
            out.extend("  " + ln for ln in
                       traceback.format_stack(frame, limit=1))
    return "".join(out)


_installed = [False]


def enable_stack_dump_signal(signum: int = signal.SIGUSR2) -> bool:
    """SIGUSR2 -> fiber stack report on stderr. Main-thread only (a
    CPython restriction); returns False when it can't install — callers
    treat this as best-effort."""
    if _installed[0]:
        return True

    def _dump(sig, frm):
        try:
            sys.stderr.write(dump_fiber_stacks())
            sys.stderr.flush()
        except Exception:
            pass

    try:
        # never displace an application's own handler — only claim the
        # default disposition (the reference's gdb script needs no
        # in-process hook at all; this one stays polite)
        if signal.getsignal(signum) not in (signal.SIG_DFL, None):
            return False
        signal.signal(signum, _dump)
    except ValueError:      # not the main thread
        return False
    _installed[0] = True
    return True
