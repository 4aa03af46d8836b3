"""Worker modules: co-schedule an external engine with the fiber workers
(the port of brpc_tpu/fiber/worker_module.py; the EloqModule hook,
eloq_module.h:60-64 and TaskGroup::NotifyRegisteredModules). Modules
register ``has_task``/``process`` callbacks that every worker's loop
polls, so an engine shares the worker threads instead of fighting them.

    class MyEngine(WorkerModule):
        def has_task(self): ...
        def process(self, group_index): ...   # run a slice of work
    register_module(MyEngine())

``on_worker_start/on_worker_stop`` mirror ExtThdStart/ExtThdEnd. The
registry is one per process, as in the reference: every TaskControl's
workers poll it.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

log = logging.getLogger("brpc_tpu_torch.fiber")


class WorkerModule:
    def has_task(self) -> bool:
        """Cheap check: is there engine work pending?"""
        return False

    def process(self, group_index: int):
        """Run a bounded slice of engine work on this worker.

        Return ``False`` to report that NO progress was made (a sibling
        worker already holds the engine's slice lock, say): the worker
        loop then treats this round as idle and may park instead of
        spinning on work it cannot touch. Any other return (the default
        None included) counts as progress."""

    def on_worker_start(self, group_index: int) -> None:
        """Called once per worker thread before its loop."""

    def on_worker_stop(self, group_index: int) -> None:
        """Called once per worker thread after its loop."""


_modules: List[WorkerModule] = []
_lock = threading.Lock()
# thread id -> attribution label while that thread is inside a module's
# process() slice: engine slices run outside any fiber, so a sampler
# attributes them by this label
_active: Dict[int, str] = {}


def register_module(module: WorkerModule) -> None:
    with _lock:
        _modules.append(module)


def unregister_module(module: WorkerModule) -> None:
    with _lock:
        try:
            _modules.remove(module)
        except ValueError:
            pass


def registered_modules() -> List[WorkerModule]:
    return list(_modules)


def has_modules() -> bool:
    """Allocation-free emptiness check for the worker hot loop."""
    return bool(_modules)


def process_modules(group_index: int) -> bool:
    """One pass over the registered modules from a worker loop; True if
    any ran work (the worker then skips parking this round). A module
    whose ``process`` returns False reported a no-progress slice and does
    NOT keep the worker awake."""
    ran = False
    tid = threading.get_ident()
    for m in list(_modules):
        try:
            if m.has_task():
                label = getattr(m, "attribution_label", None)
                if label is not None:
                    _active[tid] = label
                try:
                    r = m.process(group_index)
                finally:
                    if label is not None:
                        _active.pop(tid, None)
                if r is not False:
                    ran = True
        except Exception:               # boundary: the loop goes on
            log.exception("worker module failed")
    return ran


def active_label(tid: int) -> Optional[str]:
    """The attribution label of the module slice thread ``tid`` is in,
    if any."""
    return _active.get(tid)


def notify_start(group_index: int) -> None:
    for m in list(_modules):
        try:
            m.on_worker_start(group_index)
        except Exception:               # boundary: every module is told
            log.exception("worker module on_worker_start failed")


def notify_stop(group_index: int) -> None:
    for m in list(_modules):
        try:
            m.on_worker_stop(group_index)
        except Exception:               # boundary: every module is told
            log.exception("worker module on_worker_stop failed")


def _postfork_reset() -> None:
    """A forked shard must not inherit the parent's engines: their state
    belongs to threads that do not exist in the child. Each shard
    registers its own engine when its server starts."""
    global _modules, _lock, _active
    _modules = []
    _lock = threading.Lock()
    _active = {}


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("fiber.worker_module", _postfork_reset)
