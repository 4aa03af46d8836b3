"""Clocks of butil/time.h (the port of brpc_tpu/butil/timekeeping.py)."""

from __future__ import annotations

import time


def cpuwide_time_ns() -> int:
    """Cheapest high-resolution monotonic clock (the reference uses rdtsc)."""
    return time.perf_counter_ns()


def monotime_us() -> int:
    return time.monotonic_ns() // 1000


def gettimeofday_us() -> int:
    return time.time_ns() // 1000
