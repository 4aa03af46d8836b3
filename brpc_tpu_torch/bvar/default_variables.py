"""Default process/system variables (the port of
brpc_tpu/bvar/default_variables.py; bvar/default_variables.cpp): cpu,
rss, fds, threads, io, uptime — sampled lazily from /proc with a short
cache so a /vars scrape doesn't hammer procfs."""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

from brpc_tpu_torch.bvar.reducer import PassiveStatus

_CACHE_S = 0.5
_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
_start_time = time.time()


class _ProcSampler:
    """One /proc read per cache window serving all derived vars."""

    def __init__(self):
        self._ts = 0.0
        self._stat: Dict[str, float] = {}
        self._last_cpu: Optional[tuple] = None  # (wall, user+sys seconds)
        self._cpu_pct = 0.0

    def sample(self) -> Dict[str, float]:
        now = time.monotonic()
        if now - self._ts < _CACHE_S and self._stat:
            return self._stat
        out: Dict[str, float] = {}
        try:
            with open("/proc/self/stat") as f:
                parts = f.read().split()
            # fields (1-indexed): 14 utime, 15 stime, 20 num_threads, 23 vsize
            utime, stime = int(parts[13]), int(parts[14])
            out["threads"] = int(parts[19])
            out["vsize_bytes"] = int(parts[22])
            out["rss_bytes"] = int(parts[23]) * _PAGE
            cpu_s = (utime + stime) / _CLK_TCK
            if self._last_cpu is not None:
                dwall = now - self._last_cpu[0]
                dcpu = cpu_s - self._last_cpu[1]
                if dwall > 0:
                    self._cpu_pct = max(0.0, dcpu / dwall)
            self._last_cpu = (now, cpu_s)
            out["cpu_usage"] = round(self._cpu_pct, 4)
            out["cpu_seconds_total"] = round(cpu_s, 3)
        except (OSError, IndexError, ValueError):
            pass
        try:
            out["fd_count"] = len(os.listdir("/proc/self/fd"))
        except OSError:
            out["fd_count"] = -1
        try:
            with open("/proc/self/io") as f:
                for line in f:
                    k, _, v = line.partition(":")
                    if k in ("read_bytes", "write_bytes"):
                        out[f"io_{k}"] = int(v)
        except (OSError, ValueError):
            pass
        try:
            out["loadavg_1m"] = os.getloadavg()[0]
        except OSError:
            pass
        out["uptime_seconds"] = round(time.time() - _start_time, 1)
        self._ts = now
        self._stat = out
        return out


_sampler = _ProcSampler()


def _getter(key: str):
    return lambda: _sampler.sample().get(key, 0)


def expose_default_variables() -> None:
    """Idempotent: register the process_* vars (default_variables.cpp
    exposes at global init; here the first Server.start does it). Always
    (re)exposes — a flag would go stale after unexpose_all()."""
    from brpc_tpu_torch.bvar.variable import dump_exposed_variables
    if any(n == "process_pid" for n, _ in dump_exposed_variables("process_")):
        return
    for key, name in [
        ("cpu_usage", "process_cpu_usage"),
        ("cpu_seconds_total", "process_cpu_seconds_total"),
        ("rss_bytes", "process_memory_resident"),
        ("vsize_bytes", "process_memory_virtual"),
        ("fd_count", "process_fd_count"),
        ("threads", "process_thread_count"),
        ("io_read_bytes", "process_io_read_bytes"),
        ("io_write_bytes", "process_io_write_bytes"),
        ("loadavg_1m", "system_loadavg_1m"),
        ("uptime_seconds", "process_uptime_seconds"),
    ]:
        PassiveStatus(_getter(key)).expose(name)
    PassiveStatus(lambda: os.getpid()).expose("process_pid")
    # the reference adds the IOBuf block pool's iobuf_pool_hit_ratio and
    # iobuf_pool_bytes here; the port has no IOBuf pool yet
