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
steps are plain ``jnp`` code; outputs are global tensors on the mesh's
first device (``parallel/collective.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from brpc_tpu_torch.parallel.collective import _all_to_all, _gather
from brpc_tpu_torch.parallel.mesh import SHARD_AXIS, RpcMesh, split_shards
from brpc_tpu_torch.parallel.ring import _hop

from .flash_attention import (NEG_INF, _finalize, _online_softmax_step,
                              attention_reference)


def _shard_axis(mesh: RpcMesh, axis_name: str):
    if axis_name != SHARD_AXIS:
        raise ValueError(f"the port's rings run over the {SHARD_AXIS!r} "
                         f"axis, not {axis_name!r}")
    return mesh.shard_devices()


def ring_attention(mesh: RpcMesh, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, causal: bool = False,
                   scale: Optional[float] = None,
                   axis_name: str = SHARD_AXIS) -> torch.Tensor:
    """Attention over [..., seq, head_dim] operands with seq split over
    the ring (it must divide by the shard count); leading dims are
    batched. Shard i owns rows [i*sq, (i+1)*sq); at step t it holds the
    K/V chunk of shard (i - t) % n and masks causally by global
    position, ``k_pos <= q_pos`` (_local_ring_attention, :43)."""
    devs = _shard_axis(mesh, axis_name)
    n = len(devs)
    if scale is None:
        scale = q.shape[-1] ** -0.5
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


def ulysses_attention(mesh: RpcMesh, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *, causal: bool = False,
                      scale: Optional[float] = None,
                      axis_name: str = SHARD_AXIS) -> torch.Tensor:
    """All-to-all sequence parallelism: q/k/v [heads, seq, head_dim] with
    seq split over the shard axis; heads and seq must divide by the
    shard count. Each shard's [h, s/n, d] becomes [h/n, s, d], is
    attended locally, and goes back."""
    devs = _shard_axis(mesh, axis_name)
    n = len(devs)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    h, s, _ = q.shape
    if h % n or s % n:
        raise ValueError(f"heads ({h}) and seq ({s}) must divide the "
                         f"{axis_name} axis size {n}")
    qh, kh, vh = (_all_to_all(devs, split_shards(mesh, x, 1), 0, 1)
                  for x in (q, k, v))
    outs = [attention_reference(a, b, c, causal=causal, scale=scale)
            for a, b, c in zip(qh, kh, vh)]
    back = _all_to_all(devs, outs, 1, 0)
    return torch.cat(_gather(back, mesh.first_device), dim=1)
