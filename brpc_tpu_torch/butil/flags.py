"""Runtime flags (the port of brpc_tpu/butil/flags.py, bRPC's gflags):
``define_flag`` where a module needs a knob, ``flag`` to read it,
``set_flag`` to change it at run time (parsed and validated), and the
``/flags`` builtin page lists and sets them.

This module defines only the flags of the modules that import it
(rpcz here; ``serving_stats_enabled`` and ``serving_step_ring_cap`` in
``serving/serving_stats.py``; the contention budget in
``fiber/contention.py``), so a flag exists once its module does.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple


class _Flag:
    __slots__ = ("name", "value", "default", "help", "validator", "ftype")

    def __init__(self, name, default, help_, validator):
        self.name = name
        self.value = default
        self.default = default
        self.help = help_
        self.validator = validator
        self.ftype = type(default)


_flags: Dict[str, _Flag] = {}
_lock = threading.Lock()


def define_flag(name: str, default: Any, help_: str = "",
                validator: Optional[Callable[[Any], bool]] = None) -> None:
    with _lock:
        if name in _flags:
            raise ValueError(f"flag {name!r} already defined")
        _flags[name] = _Flag(name, default, help_, validator)
    # the environment form of gflags' --flag=value, for subprocesses:
    # BRPC_TPU_FLAG_<NAME>=value, parsed as set_flag parses a string
    env = os.environ.get(f"BRPC_TPU_FLAG_{name.upper()}")
    if env is not None and not set_flag(name, env):
        # a dropped override would leave the operator on the default
        # while believing the environment applied
        logging.getLogger("brpc_tpu_torch.flags").warning(
            "env override BRPC_TPU_FLAG_%s=%r rejected (bad value or "
            "validator); keeping default %r", name.upper(), env, default)


def flag(name: str) -> Any:
    f = _flags.get(name)
    if f is None:
        raise KeyError(f"undefined flag {name!r}")
    return f.value


def set_flag(name: str, value: Any) -> bool:
    """Parses a string to the flag's type and runs the validator.
    Returns False, leaving the flag as it was, on a bad value."""
    f = _flags.get(name)
    if f is None:
        return False
    if isinstance(value, str) and f.ftype is not str:
        try:
            if f.ftype is bool:
                value = value.lower() in ("1", "true", "yes", "on")
            else:
                value = f.ftype(value)
        except (TypeError, ValueError):
            return False
    if not isinstance(value, f.ftype) and f.ftype is not type(None):
        return False
    if f.validator is not None and not f.validator(value):
        return False
    f.value = value
    return True


def list_flags() -> List[Tuple[str, Any, Any, str]]:
    with _lock:
        return sorted((f.name, f.value, f.default, f.help)
                      for f in _flags.values())


# rpcz (rpc/span.py)
define_flag("rpcz_enabled", False,
            "collect per-RPC spans for /rpcz (off by default, as the "
            "reference's rpcz; turn on at run time through /flags)")
define_flag("rpcz_max_spans", 1024, "span ring-buffer capacity",
            validator=lambda v: v >= 16)
define_flag("rpcz_dir", "",
            "directory for on-disk rpcz persistence (empty = memory only)")
define_flag("rpcz_db_max_bytes", 16 << 20,
            "rotate the rpcz span file at this size; one old file is kept",
            validator=lambda v: v >= 1 << 20)
