"""Start a server process that announces its ports with ``<KEY> <n>``
lines on stdout (the port of tools/spawn_util.py).

Stdout is read without blocking, so that a child wedged mid-line cannot
hold the caller past its deadline, and only whole lines are parsed, so
that a read cut mid-line never yields a truncated port.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Optional


def package_root() -> str:
    """The directory that holds ``brpc_tpu_torch``: the working directory
    of a tool's ``python3 -m brpc_tpu_torch.tools.<tool>`` workers."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def spawn_announcing_server(argv, wall_s: float, keys=("PORT",),
                            env: Optional[dict] = None,
                            stderr=subprocess.DEVNULL,
                            cwd: Optional[str] = None):
    """Start ``python argv...`` (in ``cwd``) and wait up to ``wall_s`` for
    a line ``<KEY> <n>`` of each of ``keys``: (process, {key: n}) once all
    came; (None, None) if the child died or the time ran out first (the
    child is then killed). Never raises."""
    want = set(keys)
    got = {}
    try:
        proc = subprocess.Popen([sys.executable] + list(argv),
                                stdout=subprocess.PIPE, stderr=stderr,
                                env=env, cwd=cwd)
    except Exception:
        return None, None
    try:
        os.set_blocking(proc.stdout.fileno(), False)
        pending = b""
        deadline = time.monotonic() + wall_s
        while time.monotonic() < deadline:
            chunk = proc.stdout.read()
            if chunk:
                pending += chunk
                complete, _, pending = pending.rpartition(b"\n")
                for ln in complete.decode("utf-8", "replace").splitlines():
                    parts = ln.split()
                    if len(parts) == 2 and parts[0] in want:
                        got[parts[0]] = int(parts[1])
                if want.issubset(got):
                    return proc, got
            if proc.poll() is not None:
                return None, None
            time.sleep(0.05)
    except Exception:
        pass
    try:
        proc.kill()
        proc.wait(10)
    except Exception:
        pass
    return None, None
