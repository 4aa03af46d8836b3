"""The postfork registry (the port of brpc_tpu/butil/postfork.py): what
a forked child must rebuild of the process-global state.

Shard groups (``rpc/shard_group.py``) fork worker processes from a
supervisor that may already hold live machinery: fiber workers, the
event dispatcher's thread and selector (or the ring lane's native
ring), the timer thread, the bvar sampler, the socket pool and the
shared-connection map, cached native latches. None of it survives
``os.fork()``: threads exist only in the parent, a lock inherited from
a thread that no longer exists may be held for ever, and an inherited
epoll fd is the parent's kernel object.

Every module that caches such a singleton registers a reset here when
it is imported; ``os.register_at_fork(after_in_child=...)`` runs them
all in the child, so that the first use of each accessor after the fork
builds a private instance with fresh threads and locks.
``subprocess.Popen`` children are untouched: CPython's fork-exec runs
no ``register_at_fork`` handler.

Device state (the port's own rule). CUDA does not survive a fork, and a
child must never run the destructor of a parent's device object either:
a CUDA tensor, an IPC mapping or a library handle freed in the child
acts on a context the child does not have (brpc_tpu's ``ici`` reset
dropped a PjRt transfer server that way, and its children crash). A
reset hands such objects to ``keep_inherited`` instead of dropping
them: they stay referenced until the child exits through ``os._exit``,
which runs no finalizer. ``rpc/shard_group.py`` refuses to fork a
process in which CUDA was initialised at all.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, List, Tuple

_lock = threading.Lock()
_resets: List[Tuple[str, Callable[[], None]]] = []
_installed = False
# bumped once in each forked child, before the resets run
_generation = 0
_reset_errors: List[str] = []
# the parent's device objects a reset took out of service in the child
_inherited: List[Any] = []


def register(name: str, fn: Callable[[], None]) -> None:
    """Run ``fn`` in every forked child. ``name`` (the module's path
    under the package) identifies it: registering a name again replaces
    its callback, so a reloaded module does not stack stale closures."""
    global _installed
    with _lock:
        for i, (n, _) in enumerate(_resets):
            if n == name:
                _resets[i] = (name, fn)
                break
        else:
            _resets.append((name, fn))
        if not _installed:
            _installed = True
            os.register_at_fork(after_in_child=reset_all)


def reset_all() -> None:
    """Run every registered reset (the child side of a fork). A failing
    reset does not stop the others; its error is kept for
    ``reset_errors`` (logging may not be safe yet)."""
    global _generation, _lock
    _generation += 1
    # a dead parent thread may have held the registry's own lock
    _lock = threading.Lock()
    _reset_errors.clear()
    for name, fn in list(_resets):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - the others still run
            _reset_errors.append(f"{name}: {type(e).__name__}: {e}")


def keep_inherited(obj: Any) -> None:
    """Keep a parent's device object referenced for the child's life, so
    that its destructor never runs in the child."""
    if obj is not None:
        _inherited.append(obj)


def registered_names() -> List[str]:
    return [n for n, _ in list(_resets)]


def generation() -> int:
    """0 in the original process, one more for each fork crossed."""
    return _generation


def reset_errors() -> List[str]:
    return list(_reset_errors)
