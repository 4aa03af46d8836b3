"""Variable registry: expose/describe/dump (the port of
brpc_tpu/bvar/variable.py; bvar/variable.h:102).

Every metric can be exposed under a globally-unique name and then appears
in /vars, the prometheus dump, and window samplers.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "Variable"] = {}


class Variable:
    """Base of every metric. Subclasses implement get_value()."""

    def __init__(self) -> None:
        self._name: Optional[str] = None

    # -- value -----------------------------------------------------------
    def get_value(self):
        raise NotImplementedError

    def describe(self) -> str:
        return str(self.get_value())

    # -- registry --------------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        return self._name

    def expose(self, name: str) -> "Variable":
        name = name.strip().replace(" ", "_")
        with _registry_lock:
            old = _registry.get(name)
            if old is not None and old is not self:
                old._name = None
            _registry[name] = self
            self._name = name
        return self

    def hide(self) -> None:
        with _registry_lock:
            if self._name and _registry.get(self._name) is self:
                del _registry[self._name]
            self._name = None


def expose(name: str, var: Variable) -> Variable:
    return var.expose(name)


def dump_exposed(prefix: str = "") -> List[Tuple[str, object]]:
    """Snapshot of (name, value) for all exposed vars, sorted by name."""
    with _registry_lock:
        items = [(n, v) for n, v in _registry.items() if n.startswith(prefix)]
    return sorted((n, v.get_value()) for n, v in items)


def dump_exposed_variables(prefix: str = "") -> List[Tuple[str, "Variable"]]:
    """Snapshot of (name, variable) — for dumpers that need the variable
    itself (e.g. prometheus labeling of MultiDimension series)."""
    with _registry_lock:
        return sorted((n, v) for n, v in _registry.items()
                      if n.startswith(prefix))


def describe_exposed(name: str) -> Optional[str]:
    with _registry_lock:
        v = _registry.get(name)
    return v.describe() if v is not None else None


def unexpose_all() -> None:
    """Test helper."""
    with _registry_lock:
        for v in list(_registry.values()):
            v._name = None
        _registry.clear()


def _bvar_census() -> dict:
    """Census: the exposed variables (a leak of per-connection or
    per-method bvars shows here first)."""
    with _registry_lock:
        return {"count": len(_registry)}


from brpc_tpu_torch.butil import resource_census as _census  # noqa: E402
#   (the census registration ships with the registry it measures)

_census.register("bvar", _bvar_census)
