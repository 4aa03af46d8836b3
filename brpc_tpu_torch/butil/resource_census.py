"""Resource census (the port of brpc_tpu/butil/resource_census.py): who
holds how many bytes and objects, by subsystem.

Each subsystem that holds resources registers a provider when its
module is imported; ``snapshot()`` gathers them for ``/census``. A
provider is a cheap zero-argument callable that returns a flat dict:
keys named ``bytes`` or ``*_bytes`` add up into the total, ``count`` is
its object count. A provider that raises shows as an ``error`` entry,
the rest of the page still renders.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

_lock = threading.Lock()
_providers: List[Tuple[str, Callable[[], dict]]] = []


def register(name: str, fn: Callable[[], dict]) -> None:
    """Register, or replace, subsystem ``name``'s provider."""
    with _lock:
        for i, (n, _) in enumerate(_providers):
            if n == name:
                _providers[i] = (name, fn)
                return
        _providers.append((name, fn))


def registered_names() -> List[str]:
    with _lock:
        return [n for n, _ in _providers]


def snapshot() -> Dict[str, dict]:
    """One pass: {subsystem: provider's dict}; a failing provider gives
    {"error": ...}."""
    with _lock:
        providers = list(_providers)
    out: Dict[str, dict] = {}
    for name, fn in providers:
        try:
            d = fn()
            out[name] = d if isinstance(d, dict) else {"value": d}
        except Exception as e:  # noqa: BLE001 - quarantine, keep the page
            out[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
    return out


def total_bytes(census: Optional[Dict[str, dict]] = None) -> int:
    """The sum of every provider's byte-denominated keys."""
    census = snapshot() if census is None else census
    total = 0
    for d in census.values():
        for k, v in d.items():
            if (k == "bytes" or k.endswith("_bytes")) and \
                    isinstance(v, (int, float)) and not isinstance(v, bool):
                total += int(v)
    return total


def census_page() -> dict:
    """The /census payload."""
    c = snapshot()
    return {"subsystems": c, "total_bytes": total_bytes(c)}


def _postfork_reset() -> None:
    """Fork hygiene: the registrations stay valid, the lock may have been
    held by a parent thread."""
    global _lock
    _lock = threading.Lock()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("butil.resource_census", _postfork_reset)


def _fd_census() -> dict:
    try:
        return {"count": len(os.listdir("/proc/self/fd"))}
    except OSError:
        return {"count": -1}


register("fds", _fd_census)
