"""Blockwise (flash) attention: the port of brpc_tpu/ops/flash_attention.py.

One online-softmax recurrence, four versions:

  * ``flash_decode`` (``csrc/flash_decode.cu``): single-query attention
    over per-sequence KV caches, the serving path's kernel. Warps score
    keys in parallel with 16-byte loads; a long cache is split over
    several blocks per sequence and a second launch,
    ``flash_decode_combine``, merges the per-split ``(m, l, o)``;
  * ``flash_attn_fwd_tc`` (``csrc/flash_attention_tc.cu``): fp16/bf16
    tiles on the tensor cores (``wgmma``), K/V streamed by TMA through a
    ring of shared-memory stages, head dim 64 or 128;
  * ``flash_attn_fwd`` (``csrc/flash_attention.cu``): fp32 (or head dim
    16/32) tiles on the CUDA cores, 64 query rows a block whose key range
    two groups of 4 warps split, register tiles fed by 16-byte shared
    loads, K/V streamed by ``cp.async`` through a two-stage ring;
  * ``_flash_plain``, the plain PyTorch version: the ``_flash_lax``
    recurrence with ``q_offset``/``k_offset``, step for step. Tensors on
    the CPU go to it, and ``chip_smoke.py`` holds every kernel against it.

``_plan`` is the dispatch: from the device, dtype and shape it names the
kernel and its launch parameters. It is not a fallback: a CUDA tensor
launches the kernel it names, or the call raises.

All keep the reference's layout ([..., seq, head_dim]) and numerics:
fp32 (m, l, o) accumulators, NEG_INF = -1e30 for masked scores with their
probabilities forced to 0, zeros for rows with nothing to attend to.

``launches`` counts kernel launches by kernel name (never plain-version
calls), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Union

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
TC_DTYPES = (torch.float16, torch.bfloat16)
TC_HEAD_DIMS = (64, 128)
# the card's streaming multiprocessors (H100 SXM): decode splits a cache
# until the grid covers them, keeping at least this many keys a split
SM_COUNT = 132
DECODE_MIN_KEYS_PER_SPLIT = 128
DECODE_MAX_SPLITS = 64
GRID_Y_MAX = 65535
# query rows a block of each tile kernel (``kBQ`` in its source, which the
# CPU tests read): the launch's q tiles, gridDim.y, come from it
TILE_BLOCK_Q = {"flash_attn_fwd": 64, "flash_attn_fwd_tc": 64}
# fp32 summation-order slack of the 16-bit kernels' checks (_rounding_bound)
LOWP_ATOL = 1e-5

launches: Dict[str, int] = {"flash_decode": 0, "flash_decode_combine": 0,
                            "flash_attn_fwd_tc": 0, "flash_attn_fwd": 0}


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


def _decode_partials_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           scale: float, splits: int, chunk: int):
    """``flash_decode``'s first pass: per split s, the unnormalised
    ``(m, l, o)`` of rows ``s*chunk .. min((s+1)*chunk, lengths)-1``.
    Returns m, l [B, splits] and o [B, splits, d], fp32; an empty split
    has m = NEG_INF, l = 0, o = 0."""
    b, L, d = k.shape
    dev = q.device
    s = torch.einsum("bd,bkd->bk", q.float(), k.float()) * scale   # [B, L]
    pos = torch.arange(L, device=dev)
    valid = pos[None, :] < lengths.to(dev).long()[:, None]
    split_of = pos // chunk
    m = torch.full((b, splits), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, splits), dtype=torch.float32, device=dev)
    o = torch.zeros((b, splits, d), dtype=torch.float32, device=dev)
    for i in range(splits):
        mask = valid & (split_of == i)[None, :]
        si = torch.where(mask, s, NEG_INF)
        m[:, i] = si.amax(dim=-1)
        p = torch.where(mask, torch.exp(si - m[:, i, None]), 0.0)
        l[:, i] = p.sum(dim=-1)
        o[:, i] = torch.einsum("bk,bkd->bd", p, v.float())
    return m, l, o


def _decode_combine_plain(m: torch.Tensor, l: torch.Tensor,
                          o: torch.Tensor, dtype: torch.dtype):
    """``flash_decode_combine``: merge per-split partials. A split that
    saw no rows (l = 0) gets weight 0, so exp(NEG_INF - NEG_INF) = 1
    never leaks into the sum; a sequence with no rows gives zeros."""
    live = l > 0
    m_max = torch.where(live, m, NEG_INF).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - m_max), 0.0)
    den = (w * l).sum(dim=-1)
    num = (w[..., None] * o).sum(dim=-2)
    safe = torch.where(den == 0.0, 1.0, den)
    return (num / safe[:, None]).to(dtype)


def _decode_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, splits: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """``flash_decode``'s arithmetic end to end: per-split partials, then
    the combine, with the chunk ``_plan`` would give for ``splits``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    chunk = -(-k.shape[1] // splits)
    return _decode_combine_plain(
        *_decode_partials_plain(q, k, v, lengths, scale, splits, chunk),
        q.dtype)


def _rounding_bound(want: torch.Tensor, dtype: torch.dtype,
                    pv_abs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Element by element, the largest difference from the fp32 plain
    version ``want`` that a 16-bit kernel's own roundings explain. Every
    kernel accumulates in fp32 from inputs that convert exactly and rounds
    its output to ``dtype``: at most u |want|, u the unit roundoff. A
    kernel that also rounds P to ``dtype`` before P V (flash_attn_fwd_tc)
    moves o by at most u sum_i p_i |v_i| / l, which is ``pv_abs``, the
    plain version run on |v|. LOWP_ATOL covers fp32 summation order."""
    u = torch.finfo(dtype).eps / 2
    bound = u * want.abs() + LOWP_ATOL
    if pv_abs is not None:
        bound = bound + u * (1 + u) * pv_abs
    return bound


# ------------------------------------------------------------ the dispatch

class Plan(NamedTuple):
    kernel: str                  # "plain" or the name of a CUDA kernel
    splits: int = 1              # flash_decode: blocks per sequence
    chunk: int = 0               # flash_decode: cache rows per split


def _decode_splits(bh: int, cache_len: int) -> int:
    """Blocks per sequence for flash_decode, from the shapes alone (never
    from the lengths, which live on the device): enough to cover the SMs,
    at least DECODE_MIN_KEYS_PER_SPLIT cache rows each."""
    want = -(-SM_COUNT // max(bh, 1))
    return max(1, min(want, cache_len // DECODE_MIN_KEYS_PER_SPLIT,
                      DECODE_MAX_SPLITS))


def _causal_tile_order(n: int) -> List[int]:
    """The q tiles in the order the tile kernels launch them under a
    causal mask: heaviest first (the last tile sees the most keys), so
    the long blocks start in the first wave. The kernels take the order
    from ``causal_tile`` in ``csrc/tile_order.cuh``, which derives it
    from the causal flag alone; the CPU tests hold this mirror to that
    function's text."""
    return list(range(n - 1, -1, -1))


def _plan(op: str, device: Union[str, torch.device], dtype: torch.dtype,
          d: int, *, bh: int = 1, sk: int = 1) -> Plan:
    """Which version runs ``op`` ("attention" or "decode") and how:

    ========== ============================== =====================
    device     dtype, head dim                kernel
    ========== ============================== =====================
    cpu        any                            plain (``_flash_plain``)
    cuda       decode, any                    flash_decode
    cuda       fp16/bf16, d 64 or 128         flash_attn_fwd_tc
    cuda       fp32, or d 16/32               flash_attn_fwd
    ========== ============================== =====================

    For decode, ``sk`` is the cache capacity L. Inputs a kernel does not
    take are refused by the wrapper's checks, not rerouted."""
    device = torch.device(device)
    if device.type == "cpu":
        return Plan("plain")
    if device.type != "cuda":
        raise ValueError(f"no attention path for device {device}")
    if op == "decode":
        splits = _decode_splits(bh, sk)
        return Plan("flash_decode", splits, -(-sk // splits))
    if op != "attention":
        raise ValueError(f"unknown op {op!r}")
    if dtype in TC_DTYPES and d in TC_HEAD_DIMS:
        return Plan("flash_attn_fwd_tc")
    return Plan("flash_attn_fwd")


# ------------------------------------------------------------ kernel wrappers

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
        raise TypeError(f"the attention kernels take fp32/fp16/bf16, not "
                        f"{q.dtype}")
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"the attention kernels take head dim in "
                         f"{KERNEL_HEAD_DIMS} and v shaped like k; got "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def _launch_tile(kernel: str, q3: torch.Tensor, k3: torch.Tensor,
                 v3: torch.Tensor, scale: float, causal: bool,
                 q_offset: Optional[torch.Tensor] = None,
                 q_offset_add: int = 0) -> torch.Tensor:
    """One launch of a tile kernel (``flash_attn_fwd`` or
    ``flash_attn_fwd_tc``) over [bh, sq, d] x [bh, sk, d] on the current
    stream. ``q_offset``: None or int32 [bh] on the device."""
    from . import _build

    bh, sq, d = q3.shape
    sk = k3.shape[1]
    if k3.shape[0] != bh:
        raise ValueError(f"batch*heads {bh} of q does not match k's "
                         f"{k3.shape[0]}")
    if kernel == "flash_attn_fwd_tc" and (q3.dtype not in TC_DTYPES
                                          or d not in TC_HEAD_DIMS):
        raise ValueError(f"flash_attn_fwd_tc takes fp16/bf16 with head dim "
                         f"in {TC_HEAD_DIMS}, not {q3.dtype} d {d}")
    if -(-sq // TILE_BLOCK_Q[kernel]) > GRID_Y_MAX:
        raise ValueError(f"{kernel}: sq {sq} needs more than {GRID_Y_MAX} "
                         f"q tiles")
    if q_offset is not None and (q_offset.dtype != torch.int32
                                 or q_offset.shape != (bh,)
                                 or not q_offset.is_contiguous()):
        raise ValueError("q_offset must be contiguous int32 [batch*heads]")
    out = torch.empty_like(q3)
    if bh == 0 or sq == 0:
        return out
    lib = _build.load(_build.LIBRARY_OF[kernel])
    with torch.cuda.device(q3.device):
        err = getattr(lib, kernel)(
            _ptr(q3), _ptr(k3), _ptr(v3), _ptr(out), _ptr(q_offset),
            int(q_offset_add), bh, sq, sk, d, float(scale), int(causal),
            _DTYPE_CODES[q3.dtype], _stream(q3))
    _raise_on(err, kernel)
    launches[kernel] += 1
    return out


def _launch_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, scale: float, plan: Plan):
    """flash_decode over q [B, d], caches [B, L, d], int32 lengths [B]
    on the device. With one split it writes and returns out [B, d]; with
    ``plan.splits`` > 1 it returns the per-split partials (m_l
    [B, splits, 2], o_part [B, splits, d], fp32) for ``_launch_combine``."""
    from . import _build

    b, L, d = k.shape
    splits = plan.splits
    out = ml = o_part = None
    if splits == 1:
        out = torch.empty_like(q)
    else:
        ml = torch.empty((b, splits, 2), dtype=torch.float32, device=q.device)
        o_part = torch.empty((b, splits, d), dtype=torch.float32,
                             device=q.device)
    if b > 0:
        lib = _build.load("flash_decode")
        with torch.cuda.device(q.device):
            err = lib.flash_decode(
                _ptr(q), _ptr(k), _ptr(v), _ptr(lengths), _ptr(out),
                _ptr(ml), _ptr(o_part), b, L, d, splits, plan.chunk,
                float(scale), _DTYPE_CODES[q.dtype], _stream(q))
        _raise_on(err, "flash_decode")
        launches["flash_decode"] += 1
    return out if splits == 1 else (ml, o_part)


def _launch_combine(ml: torch.Tensor, o_part: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """flash_decode_combine: per-split partials -> out [B, d]."""
    from . import _build

    b, splits, d = o_part.shape
    if b == 0:
        return out
    lib = _build.load("flash_decode")
    with torch.cuda.device(out.device):
        err = lib.flash_decode_combine(
            _ptr(ml), _ptr(o_part), _ptr(out), b, d, splits,
            _DTYPE_CODES[out.dtype], _stream(out))
    _raise_on(err, "flash_decode_combine")
    launches["flash_decode_combine"] += 1
    return out


# ------------------------------------------------------------- public API

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Blockwise attention over [..., seq, head_dim] operands. On the CPU
    ``block_k`` sets the plain version's k blocks; the kernels' tiles are
    their own (``flash_attn_fwd`` 64 query rows x 64 keys, 32 at head
    dim 128; ``flash_attn_fwd_tc`` 64 x 64), which changes only the fp32
    summation order. ``block_q`` is kept for the reference's signature."""
    del block_q
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    if scale is None:
        scale = d ** -0.5
    plan = _plan("attention", q.device, q.dtype, d)
    if plan.kernel == "plain":
        return _flash_plain(q, k, v, scale, causal, block_k)
    _check_kernel_inputs(q, k, v, None)
    if q.shape[:-2] != k.shape[:-2]:
        raise ValueError("q and k must share their leading dims")
    out = _launch_tile(plan.kernel, q.reshape(-1, sq, d),
                       k.reshape(-1, sk, d), v.reshape(-1, sk, d), scale,
                       causal)
    return out.reshape(q.shape)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: Optional[float] = None,
                     block_k: int = 128) -> torch.Tensor:
    """Single-query attention over per-sequence KV caches (one decode
    step). q [B, d]; k_cache, v_cache [B, L, d]; lengths [B]: the number
    of valid cache rows, the query sitting at ``lengths - 1``. A causal
    mask with that offset admits exactly rows 0 .. lengths-1, whatever
    the tail holds; a length-0 row gives zeros. Returns [B, d]. On the
    card the lengths are read by the kernel: no host sync."""
    b, L, d = k_cache.shape
    if scale is None:
        scale = d ** -0.5
    plan = _plan("decode", q.device, q.dtype, d, bh=b, sk=L)
    if plan.kernel == "plain":
        return _flash_plain(q[:, None, :], k_cache, v_cache, scale, True,
                            block_k, q_offset=lengths - 1)[:, 0]
    _check_kernel_inputs(q, k_cache, v_cache, lengths)
    if q.shape != (b, d) or lengths.shape != (b,):
        raise ValueError(f"decode takes q [B, d] and lengths [B]; got q "
                         f"{tuple(q.shape)} lengths {tuple(lengths.shape)} "
                         f"for caches {tuple(k_cache.shape)}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        lengths = lengths.to(torch.int32).contiguous()
    first = _launch_decode(q, k_cache, v_cache, lengths, scale, plan)
    if plan.splits == 1:
        return first
    return _launch_combine(*first, torch.empty_like(q))


def kernel_launches() -> int:
    """Launches of all attention kernels."""
    return sum(launches.values())


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
