"""The usercode pool (the port of brpc_tpu/rpc/usercode.py; the
reference's usercode_in_pthread and details/usercode_backup_pool).

With ``ServerOptions(usercode_in_pthread=True)`` a handler that is not a
coroutine function runs on this pool of threads while its request's
fiber parks, so a handler that blocks holds up no fiber worker; a
coroutine handler stays on the fibers. The pool's size is the
``usercode_backup_threads`` flag, read when the pool is first used.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.fiber.sync import FiberEvent

define_flag("usercode_backup_threads", 16,
            "threads that run usercode_in_pthread handlers")

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=flag("usercode_backup_threads"),
                thread_name_prefix="usercode")
        return _pool


async def run_usercode(fn, *args):
    """``fn(*args)`` on the pool; the calling fiber parks (not its
    worker) until it returns, and gets its result or its exception."""
    done = FiberEvent()
    box: list = [None, None]

    def run():
        try:
            box[0] = fn(*args)
        except BaseException as e:
            box[1] = e
        done.set()

    _get_pool().submit(run)
    await done.wait()
    if box[1] is not None:
        raise box[1]
    return box[0]
