"""Blockwise (flash) attention: the port of brpc_tpu/ops/flash_attention.py.

Two versions of one online-softmax recurrence:

  * ``flash_attn_fwd``, a CUDA kernel written for Hopper
    (``csrc/flash_attention.cu``), the port of the Pallas kernel
    ``_flash_pallas_2d``. Tensors on a CUDA device go to it; there is no
    fallback, a shape or dtype it does not take raises;
  * ``_flash_plain``, the plain PyTorch version: the ``_flash_lax``
    recurrence with ``q_offset``/``k_offset``, step for step. Tensors on
    the CPU go to it, and ``chip_smoke.py`` holds the kernel against it.

Both keep the reference's layout ([..., seq, head_dim]) and numerics:
fp32 (m, l, o) accumulators, NEG_INF = -1e30 for masked scores with their
probabilities forced to 0, zeros for rows with nothing to attend to.

``flash_attention.launches`` and ``decode_attention.launches`` count
kernel launches (never plain-version calls), so a run can show that its
path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


# ------------------------------------------------------------ plain version

def _flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, causal: bool, block_k: int,
                 q_offset: Union[int, torch.Tensor] = 0,
                 k_offset: int = 0) -> torch.Tensor:
    """[..., sq, d] x [..., sk, d] blockwise attention, a Python loop over
    k blocks (``_flash_lax``). ``q_offset`` is an int or a tensor of the
    leading shape: the global position of each row block's row 0."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    lead = q.shape[:-2]
    block_k = min(block_k, sk)
    nblocks = (sk + block_k - 1) // block_k
    pad = nblocks * block_k - sk
    qf = q.float()
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    dev = q.device
    q_off = torch.as_tensor(q_offset, device=dev).expand(lead)
    q_pos = q_off[..., None] + torch.arange(sq, device=dev)   # [..., sq]
    m = torch.full((*lead, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((*lead, sq), dtype=torch.float32, device=dev)
    o = torch.zeros((*lead, sq, d), dtype=torch.float32, device=dev)
    for b in range(nblocks):
        kblk = kf[..., b * block_k:(b + 1) * block_k, :]
        vblk = vf[..., b * block_k:(b + 1) * block_k, :]
        k_pos = k_offset + b * block_k + torch.arange(block_k, device=dev)
        mask = (k_pos < k_offset + sk).expand(*lead, sq, block_k)
        if causal:
            mask = mask & (k_pos <= q_pos[..., None])
        s = torch.einsum("...qd,...kd->...qk", qf, kblk) * scale
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        correction = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * correction + p.sum(dim=-1)
        o = o * correction[..., None] + torch.einsum("...qk,...kd->...qd",
                                                     p, vblk)
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    return (o / safe_l[..., None]).to(q.dtype)


# ------------------------------------------------------------ kernel wrapper

def _check_kernel_inputs(q, k, v, q_offset):
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q_offset is not None and q_offset.device != dev:
        raise ValueError(f"q_offset is on {q_offset.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attn_fwd takes fp32/fp16/bf16, not {q.dtype}")
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"flash_attn_fwd takes head dim in "
                         f"{KERNEL_HEAD_DIMS} and v shaped like k; got "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _launch(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
            scale: float, causal: bool,
            q_offset: Optional[torch.Tensor] = None,
            q_offset_add: int = 0) -> torch.Tensor:
    """One flash_attn_fwd launch over [bh, sq, d] x [bh, sk, d] on the
    current stream. ``q_offset``: None or int32 [bh] on the device."""
    from ._build import load_flash_attention

    bh, sq, d = q3.shape
    sk = k3.shape[1]
    if k3.shape[0] != bh or bh > 65535:
        raise ValueError(f"batch*heads {bh} must match k and be <= 65535")
    if q_offset is not None and (q_offset.dtype != torch.int32
                                 or q_offset.shape != (bh,)
                                 or not q_offset.is_contiguous()):
        raise ValueError("q_offset must be contiguous int32 [batch*heads]")
    out = torch.empty_like(q3)
    if bh == 0 or sq == 0:
        return out
    lib = load_flash_attention()
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    with torch.cuda.device(q3.device):
        err = lib.flash_attn_fwd(
            ctypes.c_void_p(q3.data_ptr()), ctypes.c_void_p(k3.data_ptr()),
            ctypes.c_void_p(v3.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(0 if q_offset is None else q_offset.data_ptr()),
            int(q_offset_add), bh, sq, sk, d, float(scale), int(causal),
            _DTYPE_CODES[q3.dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    return out


def _route(t: torch.Tensor) -> str:
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no attention path for device {t.device}")


# ------------------------------------------------------------- public API

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Blockwise attention over [..., seq, head_dim] operands. On the CPU
    ``block_k`` sets the plain version's k blocks; the kernel's tiles are
    fixed by its shared-memory budget (16 query rows, 32 keys), which
    changes only the fp32 summation order. ``block_q`` is kept for the
    reference's signature."""
    del block_q
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "plain":
        return _flash_plain(q, k, v, scale, causal, block_k)
    _check_kernel_inputs(q, k, v, None)
    if q.shape[:-2] != k.shape[:-2]:
        raise ValueError("q and k must share their leading dims")
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    out = _launch(q.reshape(-1, sq, d), k.reshape(-1, sk, d),
                  v.reshape(-1, sk, d), scale, causal)
    flash_attention.launches += 1
    return out.reshape(q.shape)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: Optional[float] = None,
                     block_k: int = 128) -> torch.Tensor:
    """Single-query attention over per-sequence KV caches (one decode
    step). q [B, d]; k_cache, v_cache [B, L, d]; lengths [B]: the number
    of valid cache rows, the query sitting at ``lengths - 1``. A causal
    mask with that offset admits exactly rows 0 .. lengths-1, whatever
    the tail holds; a length-0 row gives zeros. Returns [B, d]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "plain":
        return _flash_plain(q[:, None, :], k_cache, v_cache, scale, True,
                            block_k, q_offset=lengths - 1)[:, 0]
    _check_kernel_inputs(q, k_cache, v_cache, lengths)
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        lengths = lengths.to(torch.int32).contiguous()
    b, d = q.shape
    out = _launch(q.reshape(b, 1, d), k_cache, v_cache, scale, True,
                  q_offset=lengths, q_offset_add=-1)
    decode_attention.launches += 1
    return out.reshape(b, d)


flash_attention.launches = 0
decode_attention.launches = 0


def kernel_launches() -> int:
    """flash_attn_fwd launches through either entry point."""
    return flash_attention.launches + decode_attention.launches


def reset_launches() -> None:
    flash_attention.launches = 0
    decode_attention.launches = 0


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive full-matrix softmax attention, the numerics oracle. Its
    causal mask is ``tril(k = sk - sq)``, aligned bottom-right as in the
    reference; the flash versions align top-left, so the two differ when
    ``sq != sk``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p, v.float()).to(q.dtype)
