"""Tensors as wire bytes: dtype names and explicit host copies.

brpc_tpu names a device payload's dtype as numpy and JAX do
(``"float32"``, ``"bfloat16"``), in the tpu_std meta
(``DevicePayloadMeta.dtype``) and in tpud's batch codec. ``str`` of a
torch dtype is ``"torch.float32"``, so the port keeps one table in each
direction and rejects a name or dtype outside it.

Bytes never come from a tensor implicitly: ``host_bytes`` makes the copy
to the host explicit (``.cpu()``, a synchronous D2H for a CUDA tensor),
and the bytes of a 16-bit float go through a ``uint8`` view, never a
numpy bf16 dtype (numpy has none). ``from_host_bytes`` builds the
tensor over a writable buffer with ``torch.frombuffer`` and moves it to
the device asked for; a failed copy raises.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

DTYPE_BY_NAME = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
NAME_BY_DTYPE = {v: k for k, v in DTYPE_BY_NAME.items()}


def dtype_name(t: torch.Tensor) -> str:
    name = NAME_BY_DTYPE.get(t.dtype)
    if name is None:
        raise TypeError(f"no wire name for dtype {t.dtype}")
    return name


def torch_dtype(name: str) -> torch.dtype:
    dt = DTYPE_BY_NAME.get(name)
    if dt is None:
        raise ValueError(f"unknown wire dtype {name!r}")
    return dt


def nbytes(t: torch.Tensor) -> int:
    """``numel * element_size``: 0 for a shape with a 0 in it, one element
    for a scalar (brpc_tpu's ``np.prod(shape or (1,)) * itemsize``)."""
    return t.numel() * t.element_size()


def check_tensor(t) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"a device payload must be a torch.Tensor, "
                        f"not {type(t).__name__}")
    dtype_name(t)
    return t


def host_bytes(t: torch.Tensor) -> bytes:
    """The tensor's bytes in C order, through an explicit host copy."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.numel() == 0:
        return b""
    return flat.view(torch.uint8).cpu().numpy().tobytes()


def from_host_bytes(buf: Union[bytes, bytearray, memoryview], name: str,
                    shape: Sequence[int], device: Union[str, torch.device],
                    offset: int = 0, count: int = -1) -> torch.Tensor:
    """A tensor of dtype ``name`` and ``shape`` from ``count`` bytes of
    ``buf`` at ``offset`` (all of it when -1), on ``device``. A
    ``bytes`` buffer is copied into a ``bytearray`` first: torch only
    wraps writable memory."""
    dtype = torch_dtype(name)
    shape = tuple(int(s) for s in shape)
    if count < 0:
        count = len(buf) - offset
    want = math.prod(shape) * dtype.itemsize
    if count != want:
        raise ValueError(f"{count} bytes for {name}{list(shape)}, "
                         f"which needs {want}")
    if want == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    if isinstance(buf, bytes) or (isinstance(buf, memoryview)
                                  and buf.readonly):
        buf = bytearray(memoryview(buf)[offset:offset + count])
        offset = 0
    raw = torch.frombuffer(buf, dtype=torch.uint8, count=count,
                           offset=offset)
    return raw.view(dtype).reshape(shape).to(device)
