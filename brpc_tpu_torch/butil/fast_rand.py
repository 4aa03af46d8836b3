"""Per-thread xorshift64* (the port of brpc_tpu/butil/fast_rand.py,
butil/fast_rand.cpp): seeds work stealing, reservoir sampling and trace
ids without contending on a shared generator."""

from __future__ import annotations

import threading
import time

_MASK = 0xFFFFFFFFFFFFFFFF


class _TLS(threading.local):
    def __init__(self) -> None:
        seed = (time.monotonic_ns() ^ (threading.get_ident() << 17)) & _MASK
        self.state = seed or 0x9E3779B97F4A7C15


_tls = _TLS()


def fast_rand() -> int:
    """xorshift64*: a 64-bit pseudo-random int."""
    x = _tls.state
    x ^= x >> 12
    x ^= (x << 25) & _MASK
    x ^= x >> 27
    _tls.state = x
    return (x * 0x2545F4914F6CDD1D) & _MASK


def fast_rand_less_than(n: int) -> int:
    if n <= 0:
        return 0
    return fast_rand() % n
