"""Sequence-parallel attention over a mesh's shard ring (the port of
brpc_tpu/ops/ring_attention.py).

``ring_attention``: the sequence is split over the shard axis; each
shard attends its queries to every shard's K/V chunk as the chunks hop
around the ring (``parallel/ring.py``'s hops), with the online-softmax
(m, l, o) carry (``_online_softmax_step``) making the result independent
of the order the chunks arrive in: n steps and n - 1 hops of a K/V chunk
a shard.

``ulysses_attention``: the all-to-all alternative (DeepSpeed-Ulysses):
one all-to-all reshards seq -> heads, each shard attends its heads over
the whole sequence (``attention_reference``), and a second all-to-all
reshards back.

Both run as plain PyTorch on each shard's device, as the reference's
steps are plain ``jnp`` code. On an ``RpcMesh`` the inputs and outputs
are global tensors, the outputs on the mesh's first device
(``parallel/collective.py``). On a ``PodMesh`` each rank gives its piece
of q, k and v along the sequence and gets its piece of the output, as
the reference's ``P(None, shard, None)`` leaves it: the K/V chunks hop
between the ranks (one ``batch_isend_irecv`` a step), and Ulysses'
two all-to-alls are two ``all_to_all_single`` calls (q, k and v go
together in the first).
"""

from __future__ import annotations

from typing import Optional

import torch

from brpc_tpu_torch.parallel.collective import (_all_to_all, _gather,
                                                _pod_hop, _pod_reshard)
from brpc_tpu_torch.parallel.mesh import SHARD_AXIS, PodMesh, split_shards
from brpc_tpu_torch.parallel.ring import _hop

from .flash_attention import (NEG_INF, _finalize, _online_softmax_step,
                              attention_reference)


def _shard_axis(mesh, axis_name: str) -> int:
    """The ring's size: the mesh's shard axis, the only one the port's
    rings run over."""
    if axis_name != SHARD_AXIS:
        raise ValueError(f"the port's rings run over the {SHARD_AXIS!r} "
                         f"axis, not {axis_name!r}")
    return mesh.shape[SHARD_AXIS]


def _pod_ring_attention(mesh: PodMesh, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, causal: bool,
                        scale: float) -> torch.Tensor:
    """One rank's part of ring attention: its queries against each K/V
    chunk in turn, the chunk then handed to the next rank of the row."""
    n, i = mesh.shape[SHARD_AXIS], mesh.coords[1]
    q, k, v = (t.to(mesh.device) for t in (q, k, v))
    sq, sk = q.shape[-2], k.shape[-2]
    m = torch.full((*q.shape[:-1],), NEG_INF, dtype=torch.float32,
                   device=mesh.device)
    acc = (m, torch.zeros_like(m),
           torch.zeros(q.shape, dtype=torch.float32, device=mesh.device))
    for t in range(n):
        src = (i - t) % n               # the owner of the chunk in hand
        mask = None
        if causal:
            q_pos = i * sq + torch.arange(sq, device=mesh.device)
            k_pos = src * sk + torch.arange(sk, device=mesh.device)
            mask = k_pos[None, :] <= q_pos[:, None]
        acc = _online_softmax_step(q, k, v, *acc, scale, mask)
        if t < n - 1:
            k, v = _pod_hop(mesh, [k, v])
    return _finalize(*acc, q.dtype)[0]


def ring_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, causal: bool = False,
                   scale: Optional[float] = None,
                   axis_name: str = SHARD_AXIS) -> torch.Tensor:
    """Attention over [..., seq, head_dim] operands with seq split over
    the ring (it must divide by the shard count); leading dims are
    batched. Shard i owns rows [i*sq, (i+1)*sq); at step t it holds the
    K/V chunk of shard (i - t) % n and masks causally by global
    position, ``k_pos <= q_pos`` (_local_ring_attention, :43). On a
    ``PodMesh`` q, k and v are the rank's rows, and so is the output."""
    n = _shard_axis(mesh, axis_name)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if isinstance(mesh, PodMesh):
        return _pod_ring_attention(mesh, q, k, v, causal, scale)
    devs = mesh.shard_devices()
    qs = split_shards(mesh, q, -2)
    kv = list(zip(split_shards(mesh, k, -2), split_shards(mesh, v, -2)))
    sq, sk = q.shape[-2] // n, k.shape[-2] // n
    lead = q.shape[:-2]
    acc = []
    for dev in devs:
        m = torch.full((*lead, sq), NEG_INF, dtype=torch.float32,
                       device=dev)
        acc.append((m, torch.zeros_like(m),
                    torch.zeros((*lead, sq, q.shape[-1]),
                                dtype=torch.float32, device=dev)))
    for t in range(n):
        for i, dev in enumerate(devs):
            src = (i - t) % n           # the owner of the chunk in hand
            mask = None
            if causal:
                q_pos = i * sq + torch.arange(sq, device=dev)
                k_pos = src * sk + torch.arange(sk, device=dev)
                mask = k_pos[None, :] <= q_pos[:, None]
            acc[i] = _online_softmax_step(qs[i], *kv[i], *acc[i], scale,
                                          mask)
        if t < n - 1:
            kv = list(zip(_hop(devs, [c[0] for c in kv]),
                          _hop(devs, [c[1] for c in kv])))
    outs = [_finalize(*a, q.dtype)[0] for a in acc]
    return torch.cat(_gather(outs, mesh.first_device), dim=-2)


def ulysses_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *, causal: bool = False,
                      scale: Optional[float] = None,
                      axis_name: str = SHARD_AXIS) -> torch.Tensor:
    """All-to-all sequence parallelism: q/k/v [heads, seq, head_dim] with
    seq split over the shard axis; heads and seq must divide by the
    shard count. Each shard's [h, s/n, d] becomes [h/n, s, d], is
    attended locally, and goes back. On a ``PodMesh`` q, k and v are the
    rank's [h, s/n, d], and so is the output."""
    n = _shard_axis(mesh, axis_name)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    h, s, _ = q.shape
    if isinstance(mesh, PodMesh):
        if h % n:
            raise ValueError(f"heads ({h}) must divide the {axis_name} "
                             f"axis size {n}")
        qkv = torch.stack([t.to(mesh.device) for t in (q, k, v)])
        qh, kh, vh = _pod_reshard(mesh, qkv, 1, 2)   # [3, h/n, s*n, d]
        out = attention_reference(qh, kh, vh, causal=causal, scale=scale)
        return _pod_reshard(mesh, out, 1, 0)
    if h % n or s % n:
        raise ValueError(f"heads ({h}) and seq ({s}) must divide the "
                         f"{axis_name} axis size {n}")
    devs = mesh.shard_devices()
    qh, kh, vh = (_all_to_all(devs, split_shards(mesh, x, 1), 0, 1)
                  for x in (q, k, v))
    outs = [attention_reference(a, b, c, causal=causal, scale=scale)
            for a, b, c in zip(qh, kh, vh)]
    back = _all_to_all(devs, outs, 1, 0)
    return torch.cat(_gather(back, mesh.first_device), dim=1)
