"""The pipelined client loop of the load tools (the port of
tools/pipeline_runner.py): a fixed window of calls in flight, the next
call issued from a completion, as the reference's async client does.

``issue`` is called with one argument, ``on_done(exc_or_none)``, and must
see that it runs exactly once a call; the caller checks and times each
call inside its own ``issue``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


def run_pipelined(iters: int, inflight: int,
                  issue: Callable[[Callable[[Optional[BaseException]], None]],
                                  None],
                  wait_s: float) -> float:
    """Run ``iters`` calls with ``inflight`` in the air; returns the wall
    seconds. Raises on the first call's error (the calls not yet issued
    are settled, so that the wait cannot hang) or on the timeout."""
    done_evt = threading.Event()
    errors: list = []
    remaining = [iters]
    to_issue = [iters]
    lock = threading.Lock()

    def on_done(exc: Optional[BaseException]) -> None:
        if exc is not None:
            errors.append(exc)
        with lock:
            remaining[0] -= 1
            if errors and to_issue[0]:
                # stop reissuing AND settle the unissued share, or
                # done_evt never fires and a timeout masks the error
                remaining[0] -= to_issue[0]
                to_issue[0] = 0
            fin = remaining[0] <= 0
            reissue = to_issue[0] > 0 and not errors
            if reissue:
                to_issue[0] -= 1
        if fin:
            done_evt.set()
        elif reissue:
            try:
                issue(on_done)
            except BaseException as e:  # noqa: BLE001 - surface, don't hang
                errors.append(e)
                with lock:
                    remaining[0] = 0
                done_evt.set()

    window = min(inflight, iters)
    with lock:
        to_issue[0] = iters - window
    t0 = time.perf_counter()
    try:
        for _ in range(window):
            issue(on_done)
    except BaseException as e:  # noqa: BLE001
        errors.append(e)
        done_evt.set()
    if not done_evt.wait(wait_s):
        raise RuntimeError(f"pipelined batch timed out after {wait_s:.0f}s "
                           f"({remaining[0]}/{iters} outstanding)")
    if errors:
        raise RuntimeError(f"pipelined call failed: {errors[0]}")
    return time.perf_counter() - t0
