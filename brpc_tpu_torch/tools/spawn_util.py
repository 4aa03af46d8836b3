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
import threading
import time
from typing import Optional, Tuple


def package_root() -> str:
    """The directory that holds ``brpc_tpu_torch``: the working directory
    of a tool's ``python3 -m brpc_tpu_torch.tools.<tool>`` workers."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def spawn_port_server(argv, wall_s: float, env: Optional[dict] = None,
                      stderr=subprocess.DEVNULL, cwd: Optional[str] = None
                      ) -> Tuple[Optional[subprocess.Popen], Optional[int]]:
    """Start ``python argv...`` and wait up to ``wall_s`` for its ``PORT
    <n>`` line: (process, n), or (None, None) if the child died or never
    announced in time (the child is then killed). Never raises."""
    proc, got = spawn_announcing_server(argv, wall_s, keys=("PORT",),
                                        env=env, stderr=stderr, cwd=cwd)
    if got is None:
        return None, None
    return proc, got["PORT"]


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


def parent_death_watchdog_loop() -> None:
    """A spawned server's half of the protocol: block for good, and exit
    when the parent dies, so that a stray server never outlives the
    process that started it. It parks on an Event, not in ``time.sleep``, so that the
    flight recorder sees a waiting thread and not a busy one."""
    parent = os.getppid()
    park = threading.Event()
    while True:
        park.wait(1)
        if os.getppid() != parent:
            os._exit(0)


def http_get_local(port: int, path: str,
                   timeout_s: float = 10.0) -> Tuple[int, bytes]:
    """One HTTP/1.1 GET of a loopback server's builtin page: (status,
    body). Content-Length framing only, which is all the builtin pages
    send."""
    import socket as pysock
    s = pysock.create_connection(("127.0.0.1", port), timeout=timeout_s)
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n"
              f"Content-Length: 0\r\n\r\n".encode())
    data = b""
    s.settimeout(timeout_s)
    try:
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            data += chunk
            head, sep, rest = data.partition(b"\r\n\r\n")
            if sep and b"content-length" in head.lower():
                clen = [int(h.split(b":")[1]) for h in head.split(b"\r\n")
                        if h.lower().startswith(b"content-length")][0]
                if len(rest) >= clen:
                    break
    finally:
        s.close()
    head, _, body = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ")[1]) if head else 0
    return status, body
