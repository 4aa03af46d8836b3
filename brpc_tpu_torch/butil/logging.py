"""LOG, VLOG and LogSink (the port of brpc_tpu/butil/logging.py;
butil/logging.h), on top of the standard library's logging:

* ``LOG(severity, ...)`` logs through one logger tree
  (``brpc_tpu_torch``), so handlers, levels and ``/vlog`` all apply;
* ``set_log_sink``: a process-wide hook that sees every LOG and VLOG of
  this module first and may consume it (SetLogSink);
* ``VLOG(verbosity, ...)`` with verbosity by module (--vmodule):
  ``set_vmodule("pattern=N,...")`` maps module-name globs to levels, at
  run time too (``/vlog?vmodule=...``).
"""

from __future__ import annotations

import fnmatch
import logging as _pylog
import threading
from typing import Dict, Optional

INFO = _pylog.INFO
WARNING = _pylog.WARNING
ERROR = _pylog.ERROR
FATAL = _pylog.CRITICAL

_root = _pylog.getLogger("brpc_tpu_torch")


# ------------------------------------------------------------------ sink

class LogSink:
    """Subclass and override on_log; return True to CONSUME the record
    (default handlers never see it), False to let it pass through."""

    def on_log(self, record: _pylog.LogRecord) -> bool:
        raise NotImplementedError


_sink_lock = threading.Lock()
_sink: Optional[LogSink] = None


def set_log_sink(sink: Optional[LogSink]) -> Optional[LogSink]:
    """Install a process-wide sink; returns the previous one
    (butil/logging.h SetLogSink contract). The sink intercepts every
    LOG/VLOG call made through THIS module's API — same scope as the
    reference, whose sink hooks its own LOG macros."""
    global _sink
    with _sink_lock:
        old, _sink = _sink, sink
    return old


# ------------------------------------------------------------------- LOG

def logger(module: str = "") -> _pylog.Logger:
    return _root.getChild(module) if module else _root


def LOG(severity: int, msg: str, *args, module: str = "") -> None:
    lg = logger(module)
    sink = _sink
    if sink is not None:
        # the sink sees every LOG() regardless of configured levels and
        # may consume it (the record is built here, not by the logger,
        # so interception works even for disabled levels)
        record = lg.makeRecord(lg.name, severity, "(butil)", 0, msg,
                               args, None)
        try:
            if sink.on_log(record):
                return
        except Exception:
            pass               # a broken sink must not eat logs
    lg.log(severity, msg, *args)


def log_info(msg: str, *args, module: str = "") -> None:
    LOG(INFO, msg, *args, module=module)


def log_warning(msg: str, *args, module: str = "") -> None:
    LOG(WARNING, msg, *args, module=module)


def log_error(msg: str, *args, module: str = "") -> None:
    LOG(ERROR, msg, *args, module=module)


# ------------------------------------------------------------------ VLOG

_vmodule_lock = threading.Lock()
_vmodule: Dict[str, int] = {}       # glob pattern -> verbosity
_global_v = 0


def set_vmodule(spec: str) -> None:
    """--vmodule syntax: "pattern=N[,pattern=N...]"; bare "N" sets the
    global verbosity. Replaces the previous mapping."""
    new: Dict[str, int] = {}
    global_v = 0
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            pat, _, lv = part.rpartition("=")
            new[pat.strip()] = int(lv)
        else:
            global_v = int(part)
    global _global_v
    with _vmodule_lock:
        _vmodule.clear()
        _vmodule.update(new)
        _global_v = global_v


def vmodule() -> Dict[str, int]:
    with _vmodule_lock:
        d = dict(_vmodule)
    if _global_v:
        d["*"] = max(_global_v, d.get("*", 0))
    return d


def vlog_is_on(verbosity: int, module: str = "") -> bool:
    """Longest/most-specific glob wins, like --vmodule."""
    with _vmodule_lock:
        best: Optional[int] = None
        best_len = -1
        for pat, lv in _vmodule.items():
            if fnmatch.fnmatch(module, pat) and len(pat) > best_len:
                best, best_len = lv, len(pat)
        level = best if best is not None else _global_v
    return verbosity <= level


def VLOG(verbosity: int, msg: str, *args, module: str = "") -> None:
    """Verbose log: emitted at INFO when the module's configured
    verbosity admits it (VLOG(n) of butil/logging.h)."""
    if vlog_is_on(verbosity, module):
        LOG(INFO, msg, *args, module=module)
