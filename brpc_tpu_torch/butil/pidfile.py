"""Pidfiles of long-running servers (the port of brpc_tpu/butil/
pidfile.py): ``.pids/`` at the repository root, or
``BRPC_TPU_TORCH_PID_DIR``.

Each file records the pid and the process's command line, so that a
reaper of stray servers tells a live one from a recycled pid without
guessing from paths.
"""

from __future__ import annotations

import os
from typing import Optional

PID_DIR = os.environ.get(
    "BRPC_TPU_TORCH_PID_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".pids"))


def cmdline(pid: Optional[int] = None) -> str:
    """The process's command line from /proc, whitespace-normalised to
    one line (``python -c`` scripts hold newlines): every reader
    compares these strings, so every reader uses this normalisation."""
    try:
        with open(f"/proc/{pid or os.getpid()}/cmdline", "rb") as f:
            raw = f.read().replace(b"\0", b" ").decode("utf-8", "replace")
        return " ".join(raw.split())
    except OSError:
        return ""


def self_cmdline() -> str:
    return cmdline()


def write_pidfile(name: str) -> Optional[str]:
    """Record this process (pid, command line) under ``PID_DIR``; the
    path for the caller to remove at a clean exit, or None."""
    try:
        os.makedirs(PID_DIR, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_." else "-"
                       for c in str(name))[:80]
        path = os.path.join(PID_DIR, f"{safe}.{os.getpid()}.pid")
        with open(path, "w") as f:
            f.write(f"{os.getpid()}\n{self_cmdline()}\n")
        return path
    except OSError:
        return None


def remove_pidfile(path: Optional[str]) -> None:
    if path:
        try:
            os.unlink(path)
        except OSError:
            pass
