"""Ring streaming: StreamingRPC as neighbour hops around the shard ring
(the port of brpc_tpu/parallel/ring.py).

The reference's ``ppermute`` becomes a hop: each shard's tensor
``.to(device of the next shard)``, a copy even where two shards share a
device (each shard owns its tensors). All shards step together: every
hop of a step reads what the shards held before the step.

  ring_shift      -- every shard hands its block to the ring neighbour
  ring_allreduce  -- reduce-scatter then all-gather, 2(n - 1) hops of one
                     chunk a shard (bandwidth-optimal on a ring)
  ring_scan       -- n - 1 hops with a combine a step: the blockwise
                     consumer pattern of ring attention

On an ``RpcMesh`` outputs are global tensors on the mesh's first device
(``collective.py``). On a ``PodMesh`` each rank gives its piece and gets
its piece (``ring_allreduce``: its whole copy), and a hop is one
``batch_isend_irecv`` between the ranks of a row.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from .collective import _gather, _pod_hop
from .mesh import SHARD_AXIS, PodMesh, split_shards


def _hop(devs: Sequence[torch.device], blocks: Sequence[torch.Tensor],
         step: int = 1) -> List[torch.Tensor]:
    """One ``ppermute`` round: shard i's block moves to shard
    (i + step) % n."""
    n = len(devs)
    out: List = [None] * n
    for i, b in enumerate(blocks):
        j = (i + step) % n
        out[j] = b.to(devs[j], copy=True)
    return out


def ring_shift(mesh, x: torch.Tensor, step: int = 1) -> torch.Tensor:
    """Shift the shard blocks of ``x`` (split along dim 0) around the ring
    by ``step`` positions (on a ``PodMesh``, ``x`` is the rank's block:
    it goes to shard (s + step) % n, and shard (s - step) % n's
    comes back)."""
    if isinstance(mesh, PodMesh):
        return _pod_hop(mesh, [x.to(mesh.device)], step)[0]
    devs = mesh.shard_devices()
    moved = _hop(devs, split_shards(mesh, x), step)
    return torch.cat(_gather(moved, mesh.first_device), dim=0)


def ring_allreduce(mesh, x: torch.Tensor) -> torch.Tensor:
    """Allreduce of ``x`` [n, chunk], which every shard holds whole (the
    reference's replicated in-spec), so the result is n times ``x``. At
    reduce-scatter step i shard r receives chunk (r - i - 1) % n from
    shard r - 1 and adds it to its own; at all-gather step i it receives
    the finished chunk (r - i) % n and keeps it. On a ``PodMesh`` each
    rank gives its copy and gets the sum: 2(n - 1) hops of one chunk."""
    n = mesh.shape[SHARD_AXIS]
    if x.shape[0] != n:
        raise ValueError(f"ring_allreduce takes [n_shards, chunk]; got "
                         f"{tuple(x.shape)} for {n} shards")
    if isinstance(mesh, PodMesh):
        r = mesh.coords[1]
        acc = x.to(mesh.device, copy=True)
        for i in range(n - 1):
            recv, = _pod_hop(mesh, [acc[(r - i) % n]])
            acc[(r - i - 1) % n] += recv
        for i in range(n - 1):
            recv, = _pod_hop(mesh, [acc[(r + 1 - i) % n]])
            acc[(r - i) % n] = recv
        return acc
    devs = mesh.shard_devices()
    acc = [x.to(d, copy=True) for d in devs]
    for i in range(n - 1):
        sends = [acc[s][(s - i) % n] for s in range(n)]
        for r, recv in enumerate(_hop(devs, sends)):
            acc[r][(r - i - 1) % n] += recv
    for i in range(n - 1):
        sends = [acc[s][(s + 1 - i) % n] for s in range(n)]
        for r, recv in enumerate(_hop(devs, sends)):
            acc[r][(r - i) % n] = recv
    return acc[0].to(mesh.first_device)


def ring_scan(mesh, x: torch.Tensor, combine: Callable,
              init=None) -> torch.Tensor:
    """Blockwise ring consumption: each shard starts from its own block
    (``combine(init, block)`` when ``init`` is given) and, over n - 1
    hops, combines every other shard's block as it arrives from its
    neighbour (``combine(carry, block) -> carry``). On a ``PodMesh``
    ``x`` is the rank's block and the output its carry."""
    if isinstance(mesh, PodMesh):
        block = x.to(mesh.device)
        carry = combine(init, block) if init is not None else block
        for _ in range(mesh.shape[SHARD_AXIS] - 1):
            block, = _pod_hop(mesh, [block])
            carry = combine(carry, block)
        return carry
    devs = mesh.shard_devices()
    blocks = list(split_shards(mesh, x))
    carry = [combine(init, b) if init is not None else b for b in blocks]
    inflight = blocks
    for _ in range(len(devs) - 1):
        inflight = _hop(devs, inflight)
        carry = [combine(c, b) for c, b in zip(carry, inflight)]
    return torch.cat(_gather(carry, mesh.first_device), dim=0)
