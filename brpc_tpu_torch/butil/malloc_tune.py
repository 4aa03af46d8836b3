"""glibc malloc tuning for large payloads (the port of
brpc_tpu/butil/malloc_tune.py).

glibc serves every allocation above ``M_MMAP_THRESHOLD`` (128 KB by
default) with a fresh ``mmap`` and gives it back with ``munmap`` on free,
so a steady stream of 256 KB read blocks and 1 MB payload joins pays a
page fault and zeroing a call instead of reusing warm heap pages. The
reference links tcmalloc for this; glibc offers the same lever at run
time: ``mallopt`` raises the mmap and trim thresholds, so freed blocks up
to 32 MB stay on the heap (a higher steady RSS in exchange).

``tune_malloc()`` runs when ``brpc_tpu_torch.butil`` is imported, as
brpc_tpu's does; it is process-wide and idempotent, and does nothing off
glibc. ``BRPC_TPU_TORCH_NO_MALLOPT=1`` before the import keeps glibc's
defaults.
"""

from __future__ import annotations

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_applied = False


def tune_malloc(mmap_threshold: int = 32 << 20,
                trim_threshold: int = 32 << 20) -> bool:
    """Raise glibc's mmap and trim thresholds; True once applied."""
    global _applied
    if _applied:
        return True
    if os.environ.get("BRPC_TPU_TORCH_NO_MALLOPT"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):   # not glibc
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    ok = bool(mallopt(_M_MMAP_THRESHOLD, mmap_threshold))
    ok = bool(mallopt(_M_TRIM_THRESHOLD, trim_threshold)) and ok
    _applied = ok
    return ok


def applied() -> bool:
    return _applied
