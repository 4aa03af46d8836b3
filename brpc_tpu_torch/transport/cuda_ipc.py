"""CUDA IPC through libcuda (``libcuda.so.1``, ctypes): the pull
lane of ``ici://`` between processes (``transport/ici.py``), in the place
of brpc_tpu's PjRt transfer server.

The sender names each tensor by the IPC handle of the allocation that
holds it (``cuIpcGetMemHandle`` of the base that
``cuMemGetAddressRange`` gives; the caching allocator packs many tensors
into one allocation, so the offset of the tensor in it travels beside
the handle) and keeps the tensor alive until the peer has acknowledged
the batch. The receiver opens the handle (``cuIpcOpenMemHandle``),
copies the bytes into a tensor of its own on its own stream
(``cuMemcpyDtoDAsync``), and closes the mapping once that copy has run:
it never holds the sender's memory past the copy. A mapping is counted
by the batches that use it (``acquire``/``release``): the tensors of a
batch often share an allocation, and one mapping serves every batch
that reads the allocation at once. A process cannot open its own
handles; same-process peers use ``ici.py``'s exchange instead.

torch's own route (``UntypedStorage._share_cuda_``) was not taken: it
keeps a shared block alive on the sender until the receiver's storage
dies *and* the sender collects it (``torch.cuda.ipc_collect``), and
leaves the block in its limbo for good when no receiver opens it. Here
the lifetimes are the lane's own: held until the ACK, dropped after a
closed connection's grace period.

Every call binds the device's primary context to the calling thread
first (the dispatcher and the poller's threads may not have done any
CUDA work yet). Nothing is loaded until the lane is first probed
(``probe``), so importing this module needs no card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

HANDLE_BYTES = 64           # CU_IPC_HANDLE_SIZE
_LAZY_ENABLE_PEER_ACCESS = 1


class _IpcMemHandle(ctypes.Structure):
    _fields_ = [("reserved", ctypes.c_char * HANDLE_BYTES)]


def _handle_bytes(h: _IpcMemHandle) -> bytes:
    """All 64 bytes of ``h`` (its ``reserved`` field reads as a C string
    and would stop at the first zero byte)."""
    return bytes(h)


def _handle_struct(handle: bytes) -> _IpcMemHandle:
    if len(handle) != HANDLE_BYTES:
        raise CudaIpcError(f"an IPC handle of {len(handle)} bytes")
    return _IpcMemHandle.from_buffer_copy(handle)


_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None
_lock = threading.Lock()
_primary: Dict[int, ctypes.c_void_p] = {}


class CudaIpcError(RuntimeError):
    """A libcuda call of the IPC lane failed."""


def _declare(lib: ctypes.CDLL) -> None:
    u64, vp, sz = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t
    sigs = {
        "cuInit": [ctypes.c_uint],
        "cuDeviceGet": [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
        "cuDevicePrimaryCtxRetain": [ctypes.POINTER(vp), ctypes.c_int],
        "cuCtxGetCurrent": [ctypes.POINTER(vp)],
        "cuCtxSetCurrent": [vp],
        "cuMemGetAddressRange_v2": [ctypes.POINTER(u64),
                                    ctypes.POINTER(sz), u64],
        "cuIpcGetMemHandle": [ctypes.POINTER(_IpcMemHandle), u64],
        "cuIpcOpenMemHandle_v2": [ctypes.POINTER(u64), _IpcMemHandle,
                                  ctypes.c_uint],
        "cuIpcCloseMemHandle": [u64],
        "cuMemcpyDtoDAsync_v2": [u64, u64, sz, vp],
        "cuGetErrorName": [ctypes.c_int,
                           ctypes.POINTER(ctypes.c_char_p)],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def _libcuda() -> ctypes.CDLL:
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None and _lib_error is None:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
                _declare(lib)
                _lib = lib
                _check(lib.cuInit(0), "cuInit")
            except (OSError, AttributeError, CudaIpcError) as e:
                _lib = None
                _lib_error = f"{type(e).__name__}: {e}"
    if _lib is None:
        raise CudaIpcError(f"libcuda is unavailable: "
                           f"{_lib_error}")
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        name = ctypes.c_char_p()
        lib = _lib
        if lib is not None and lib.cuGetErrorName(
                rc, ctypes.byref(name)) == 0 and name.value:
            raise CudaIpcError(f"{what} failed: {name.value.decode()}")
        raise CudaIpcError(f"{what} failed: CUresult {rc}")


def probe() -> Optional[str]:
    """None when this process can export and import IPC handles, else
    the reason it cannot."""
    import torch
    if not torch.cuda.is_available():
        return "CUDA is not available"
    try:
        _libcuda()
    except CudaIpcError as e:
        return str(e)
    return None


def _bind(device_index: int) -> None:
    """Make ``device_index``'s primary context current on this thread."""
    lib = _libcuda()
    ctx = _primary.get(device_index)
    if ctx is None:
        with _lock:
            ctx = _primary.get(device_index)
            if ctx is None:
                dev = ctypes.c_int()
                _check(lib.cuDeviceGet(ctypes.byref(dev), device_index),
                       "cuDeviceGet")
                ctx = ctypes.c_void_p()
                _check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                    dev.value),
                       "cuDevicePrimaryCtxRetain")
                _primary[device_index] = ctx
    cur = ctypes.c_void_p()
    _check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        _check(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def export_tensor(t) -> Tuple[bytes, int]:
    """(handle, offset): the IPC handle of the allocation holding the
    contiguous CUDA tensor ``t``, and where ``t``'s bytes start in it."""
    lib = _libcuda()
    _bind(t.device.index or 0)
    ptr = t.data_ptr()
    base = ctypes.c_uint64()
    size = ctypes.c_size_t()
    _check(lib.cuMemGetAddressRange_v2(ctypes.byref(base),
                                       ctypes.byref(size), ptr),
           "cuMemGetAddressRange")
    handle = _IpcMemHandle()
    _check(lib.cuIpcGetMemHandle(ctypes.byref(handle), base.value),
           "cuIpcGetMemHandle")
    return _handle_bytes(handle), ptr - base.value


# handle -> [base, size, opens]: a peer's allocation mapped here, counted
# by the batches that use it (a batch's small tensors often share one
# allocation, and batches from one allocation can overlap)
_mapped: Dict[Tuple[bytes, int], list] = {}
_map_lock = threading.Lock()


def acquire(handle: bytes, device_index: int) -> Tuple[int, int]:
    """(base, size) of the peer allocation ``handle`` names, mapped once
    and counted; every acquire is matched by one ``release`` once no
    queued work reads the mapping."""
    key = (handle, device_index)
    with _map_lock:
        m = _mapped.get(key)
        if m is None:
            base, size = open_handle(handle, device_index)
            m = _mapped[key] = [base, size, 0]
        m[2] += 1
        return m[0], m[1]


def release(handle: bytes, device_index: int) -> None:
    """Drop one use of a mapping; the last closes it."""
    key = (handle, device_index)
    with _map_lock:
        m = _mapped.get(key)
        if m is None:
            return
        m[2] -= 1
        if m[2] > 0:
            return
        del _mapped[key]
    close_handle(m[0], device_index)


def mapped_count() -> int:
    """Peer allocations mapped into this process now."""
    with _map_lock:
        return len(_mapped)


def open_handle(handle: bytes, device_index: int) -> Tuple[int, int]:
    """(base, size): a peer's allocation mapped into this process. Close
    it with ``close_handle`` once no queued work reads it."""
    h = _handle_struct(handle)
    lib = _libcuda()
    _bind(device_index)
    base = ctypes.c_uint64()
    _check(lib.cuIpcOpenMemHandle_v2(ctypes.byref(base), h,
                                     _LAZY_ENABLE_PEER_ACCESS),
           "cuIpcOpenMemHandle")
    lo = ctypes.c_uint64()
    size = ctypes.c_size_t()
    try:
        _check(lib.cuMemGetAddressRange_v2(ctypes.byref(lo),
                                           ctypes.byref(size), base.value),
               "cuMemGetAddressRange")
    except CudaIpcError:
        lib.cuIpcCloseMemHandle(base.value)
        raise
    return base.value, size.value


def close_handle(base: int, device_index: int) -> None:
    lib = _libcuda()
    _bind(device_index)
    _check(lib.cuIpcCloseMemHandle(base), "cuIpcCloseMemHandle")


def copy_async(dst: int, src: int, nbytes: int, stream: int,
               device_index: int) -> None:
    """Queue a device-to-device copy of ``nbytes`` on ``stream`` (a
    ``torch.cuda.Stream``'s ``cuda_stream``)."""
    lib = _libcuda()
    _bind(device_index)
    _check(lib.cuMemcpyDtoDAsync_v2(dst, src, nbytes,
                                    ctypes.c_void_p(stream or None)),
           "cuMemcpyDtoDAsync")
