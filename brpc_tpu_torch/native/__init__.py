"""The port's native host core, loaded with ctypes (the port of
brpc_tpu/native/__init__.py).

A shared library built from the port's own copies of the reference's
C++ sources (``src/*.cc``, ``build.py``) with a C ABI:

  hash.cc        crc32c and murmur3_x64_128, behind ``butil/hash.py``
                 (byte-equal pure-Python twins stay beside them).
  snappy.cc      the snappy block format, behind ``butil/snappy_codec.py``.
  framing.cc     ``trpc_scan``: cuts the complete tpu_std frames of a
                 window in one call.
  block_pool.cc  the size-classed refcounted block pool and its pinned
  nbuf.cc        arena, and the chained buffer over it; declared here.
                 The port's pinned staging stays torch's page-locked
                 freelist (``butil/iobuf.py``, ``PinnedStaging``), so
                 nothing routes ``iobuf`` through these.
  queues.cc      the work-stealing deque and the writer-retire MPSC.
  respool.cc     the versioned-id pool.

``lib()`` is the loaded library, or None: no compiler, a failed build,
or ``BRPC_TPU_TORCH_NO_NATIVE`` set (the port's name for the reference's
``BRPC_TPU_NO_NATIVE``). Every consumer keeps its pure-Python path.
Under a sanitize mode (``BRPC_TPU_TORCH_SANITIZE``, ``build.py``) it
loads the ``.san`` output and never falls back: the mode is latched at
the first call, and a typo, a change after the latch, ``NO_NATIVE``
beside it, or a sanitized output that fails to build or load raises, on
every call.
The per-call lanes use the CPython extension of ``fastcore.py``, which
costs ~50 ns a call against ctypes' ~1 us.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
import weakref
from typing import Optional

log = logging.getLogger("brpc_tpu_torch.native")

NO_NATIVE_ENV = "BRPC_TPU_TORCH_NO_NATIVE"
SANITIZE_ENV = "BRPC_TPU_TORCH_SANITIZE"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# the error of the build or load that failed, for the smoke to print
load_error: Optional[str] = None
# BRPC_TPU_TORCH_SANITIZE as the loader latched it
_latched_san: Optional[str] = None

c_u32 = ctypes.c_uint32
c_u64 = ctypes.c_uint64
c_size = ctypes.c_size_t
_vp = ctypes.c_void_p


def _declare(L: ctypes.CDLL) -> None:
    # hash
    L.bt_crc32c.restype = c_u32
    L.bt_crc32c.argtypes = [ctypes.c_char_p, c_size, c_u32]
    L.bt_murmur3_x64_128.restype = None
    L.bt_murmur3_x64_128.argtypes = [ctypes.c_char_p, c_size, c_u32,
                                     ctypes.POINTER(c_u64)]
    # block pool
    L.bt_block_alloc.restype = _vp
    L.bt_block_alloc.argtypes = [ctypes.c_int]
    L.bt_block_alloc_pinned.restype = _vp
    L.bt_block_alloc_pinned.argtypes = [ctypes.c_int]
    L.bt_block_is_pinned.restype = ctypes.c_int
    L.bt_block_is_pinned.argtypes = [_vp]
    L.bt_block_ref.restype = None
    L.bt_block_ref.argtypes = [_vp]
    L.bt_block_unref.restype = None
    L.bt_block_unref.argtypes = [_vp]
    L.bt_block_refcount.restype = c_u32
    L.bt_block_refcount.argtypes = [_vp]
    L.bt_block_size.restype = c_size
    L.bt_block_size.argtypes = [ctypes.c_int]
    L.bt_block_class_for.restype = ctypes.c_int
    L.bt_block_class_for.argtypes = [c_size]
    L.bt_block_pool_stats.restype = c_u64
    L.bt_block_pool_stats.argtypes = [ctypes.c_int, ctypes.c_int]
    # nbuf
    L.bt_nbuf_create.restype = _vp
    L.bt_nbuf_create.argtypes = []
    L.bt_nbuf_destroy.restype = None
    L.bt_nbuf_destroy.argtypes = [_vp]
    L.bt_nbuf_clear.restype = None
    L.bt_nbuf_clear.argtypes = [_vp]
    L.bt_nbuf_size.restype = c_size
    L.bt_nbuf_size.argtypes = [_vp]
    L.bt_nbuf_block_count.restype = c_size
    L.bt_nbuf_block_count.argtypes = [_vp]
    L.bt_nbuf_append.restype = c_size
    L.bt_nbuf_append.argtypes = [_vp, ctypes.c_char_p, c_size]
    L.bt_nbuf_append_nbuf.restype = None
    L.bt_nbuf_append_nbuf.argtypes = [_vp, _vp]
    L.bt_nbuf_cut.restype = _vp
    L.bt_nbuf_cut.argtypes = [_vp, c_size]
    L.bt_nbuf_pop_front.restype = c_size
    L.bt_nbuf_pop_front.argtypes = [_vp, c_size]
    L.bt_nbuf_copy_to.restype = c_size
    L.bt_nbuf_copy_to.argtypes = [_vp, ctypes.c_char_p, c_size, c_size]
    L.bt_nbuf_ref_at.restype = ctypes.c_int
    L.bt_nbuf_ref_at.argtypes = [_vp, c_size, ctypes.POINTER(_vp),
                                 ctypes.POINTER(c_size)]
    # framing
    L.bt_trpc_scan.restype = ctypes.c_long
    L.bt_trpc_scan.argtypes = [ctypes.c_char_p, c_size,
                               ctypes.POINTER(c_u64), c_size,
                               ctypes.POINTER(c_size),
                               ctypes.POINTER(c_size)]
    L.bt_trpc_probe.restype = ctypes.c_int
    L.bt_trpc_probe.argtypes = [ctypes.c_char_p, c_size,
                                ctypes.POINTER(c_u32), ctypes.POINTER(c_u32)]
    # snappy
    L.bt_snappy_max_compressed.restype = c_size
    L.bt_snappy_max_compressed.argtypes = [c_size]
    L.bt_snappy_compress.restype = c_size
    L.bt_snappy_compress.argtypes = [ctypes.c_char_p, c_size,
                                     ctypes.c_char_p, c_size]
    L.bt_snappy_decompress.restype = ctypes.c_int64
    L.bt_snappy_decompress.argtypes = [ctypes.c_char_p, c_size,
                                       ctypes.c_char_p, c_size]
    # work-stealing deque
    L.bt_wsq_create.restype = _vp
    L.bt_wsq_create.argtypes = [c_size]
    L.bt_wsq_destroy.restype = None
    L.bt_wsq_destroy.argtypes = [_vp]
    L.bt_wsq_size.restype = c_size
    L.bt_wsq_size.argtypes = [_vp]
    L.bt_wsq_push.restype = ctypes.c_bool
    L.bt_wsq_push.argtypes = [_vp, c_u64]
    L.bt_wsq_pop.restype = ctypes.c_bool
    L.bt_wsq_pop.argtypes = [_vp, ctypes.POINTER(c_u64)]
    L.bt_wsq_steal.restype = ctypes.c_bool
    L.bt_wsq_steal.argtypes = [_vp, ctypes.POINTER(c_u64)]
    # mpsc
    L.bt_mpsc_create.restype = _vp
    L.bt_mpsc_create.argtypes = []
    L.bt_mpsc_destroy.restype = None
    L.bt_mpsc_destroy.argtypes = [_vp]
    L.bt_mpsc_push.restype = ctypes.c_bool
    L.bt_mpsc_push.argtypes = [_vp, c_u64]
    L.bt_mpsc_drain.restype = c_size
    L.bt_mpsc_drain.argtypes = [_vp, ctypes.POINTER(c_u64), c_size]
    L.bt_mpsc_pushed.restype = c_u64
    L.bt_mpsc_pushed.argtypes = [_vp]
    # respool
    L.bt_respool_create.restype = _vp
    L.bt_respool_create.argtypes = [c_size]
    L.bt_respool_destroy.restype = None
    L.bt_respool_destroy.argtypes = [_vp]
    L.bt_respool_acquire.restype = c_u64
    L.bt_respool_acquire.argtypes = [_vp, c_u64]
    L.bt_respool_get.restype = ctypes.c_bool
    L.bt_respool_get.argtypes = [_vp, c_u64, ctypes.POINTER(c_u64)]
    L.bt_respool_release.restype = ctypes.c_bool
    L.bt_respool_release.argtypes = [_vp, c_u64]
    L.bt_respool_live.restype = c_u64
    L.bt_respool_live.argtypes = [_vp]


def native_disabled() -> bool:
    """``BRPC_TPU_TORCH_NO_NATIVE`` is set: every lane runs pure Python."""
    return bool(os.environ.get(NO_NATIVE_ENV))


def lib() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None when it is switched
    off or cannot be built or loaded (callers take the Python path).
    Raises under a sanitize mode instead (the module's doc)."""
    global _lib, _tried, load_error, _latched_san
    if _tried:
        if os.environ.get(SANITIZE_ENV, "") != _latched_san:
            from .build import sanitize_changed_error
            raise sanitize_changed_error(_latched_san)
        return _lib
    with _lock:
        if _tried:
            return _lib
        # the mode is checked before the latch, the broad except and
        # NO_NATIVE: a typo raises on every call
        from .build import (build, check_no_native_conflict, sanitize_mode,
                            sanitized_load_failure)
        san = sanitize_mode()
        if native_disabled():
            check_no_native_conflict(san)
        else:
            try:
                L = ctypes.CDLL(str(build()))
                _declare(L)
                _lib = L
            except Exception as e:      # no compiler, a failed build
                if san:
                    # not latched: every call raises again
                    raise sanitized_load_failure(san,
                                                 "native library") from e
                load_error = f"{type(e).__name__}: {e}"
                log.warning("native library unavailable: %s", load_error)
        _latched_san = os.environ.get(SANITIZE_ENV, "")
        _tried = True
    return _lib


def available() -> bool:
    return lib() is not None


def _postfork_reset() -> None:
    """A forked child keeps the parent's loaded library; only the latch
    lock must be fresh."""
    global _lock
    _lock = threading.Lock()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("native", _postfork_reset)


# ------------------------------------------------------------ wrappers

def crc32c(data: bytes, init: int = 0) -> Optional[int]:
    L = lib()
    if L is None:
        return None
    data = bytes(data)
    return int(L.bt_crc32c(data, len(data), init))


def murmur3_x64_128(data: bytes, seed: int = 0) -> Optional[int]:
    L = lib()
    if L is None:
        return None
    data = bytes(data)
    out = (c_u64 * 2)()
    L.bt_murmur3_x64_128(data, len(data), seed, out)
    return (int(out[1]) << 64) | int(out[0])


def trpc_scan(data, max_frames: int = 256):
    """``(frames, consumed, need)`` for a contiguous window (bytes or a
    memoryview): ``frames`` lists ``(offset, total_len)`` of each
    complete tpu_std frame; None when the library is unavailable.
    Raises ValueError on a foreign magic."""
    L = lib()
    if L is None:
        return None
    size = len(data)
    if isinstance(data, memoryview):
        try:
            data = (ctypes.c_char * size).from_buffer(data)
        except TypeError:           # a read-only buffer
            data = bytes(data)
    out = (c_u64 * (2 * max_frames))()
    consumed = c_size()
    need = c_size()
    n = L.bt_trpc_scan(data, size, out, max_frames, ctypes.byref(consumed),
                       ctypes.byref(need))
    if n < 0:
        raise ValueError("not a tpu_std stream")
    frames = [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]
    return frames, int(consumed.value), int(need.value)


def snappy_compress(data: bytes) -> Optional[bytes]:
    L = lib()
    if L is None:
        return None
    data = bytes(data)
    cap = int(L.bt_snappy_max_compressed(len(data)))
    dst = ctypes.create_string_buffer(max(cap, 1))
    n = int(L.bt_snappy_compress(data, len(data), dst, cap))
    if n == 0 and data:
        return None
    return dst.raw[:n]


def snappy_decompress(data: bytes) -> Optional[bytes]:
    """None when the library is unavailable; ValueError on a corrupt
    stream."""
    L = lib()
    if L is None:
        return None
    data = bytes(data)
    want = int(L.bt_snappy_decompress(data, len(data), None, 0))
    # the preamble is the peer's word (up to 2^35-1): cap it by the
    # format's largest expansion (a copy turns 3 bytes into 64, < 22x)
    # before allocating, or a 5-byte input asks for 32 GB
    if want < 0 or want > 32 + 22 * len(data):
        raise ValueError("corrupt snappy stream")
    dst = ctypes.create_string_buffer(max(want, 1))
    n = int(L.bt_snappy_decompress(data, len(data), dst, want))
    if n < 0:
        raise ValueError("corrupt snappy stream")
    return dst.raw[:n]


def _unref_block(ptr: int) -> None:
    L = lib()
    if L is not None:
        L.bt_block_unref(ctypes.c_void_p(ptr))


class PinnedBlock:
    """One mlock'd block of the native pinned arena as a writable
    memoryview (``view``); it returns to the freelist on ``release`` or
    when the wrapper dies."""

    __slots__ = ("ptr", "size", "view", "_buf", "_fin", "__weakref__")

    def __init__(self, ptr: int, size: int):
        self.ptr = ptr
        self.size = size
        self._buf = (ctypes.c_char * size).from_address(ptr)
        self.view = memoryview(self._buf).cast("B")
        self._fin = weakref.finalize(self, _unref_block, ptr)

    def release(self) -> None:
        """Back to the freelist; the view must not be written after."""
        self._fin()


def alloc_pinned_block(nbytes: int) -> Optional[PinnedBlock]:
    """A pinned staging block of at least ``nbytes``; None without the
    library, past the largest class, at the pinned cap, or when mlock is
    refused."""
    L = lib()
    if L is None:
        return None
    cls = int(L.bt_block_class_for(nbytes))
    if cls < 0:
        return None
    ptr = L.bt_block_alloc_pinned(cls)
    if not ptr:
        return None
    return PinnedBlock(int(ptr), int(L.bt_block_size(cls)))


def pinned_pool_stats() -> Optional[dict]:
    """The pinned arena's counters by size class."""
    L = lib()
    if L is None:
        return None
    return {"classes": [{"total": int(L.bt_block_pool_stats(c, 3)),
                         "live": int(L.bt_block_pool_stats(c, 4)),
                         "free": int(L.bt_block_pool_stats(c, 5))}
                        for c in range(3)],
            "pinned_bytes": int(L.bt_block_pool_stats(0, 6))}
