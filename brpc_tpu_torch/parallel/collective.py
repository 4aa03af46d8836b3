"""Collective lowering: the combo-channel shapes run on a mesh (the port
of brpc_tpu/parallel/collective.py).

When a ParallelChannel's sub-targets are the devices of one mesh, N RPCs
and a host merge are the wrong program. The reference compiles the same
dataflow into one SPMD program (``shard_map`` and XLA collectives); the
port runs it from one process as per-shard tensor ops:

  ParallelChannel fan-out + merge -> ``CollectiveChannel.call``: the
      request split over the 'shard' axis, the service function on each
      shard's device, the merge (sum, mean, max, min; or concatenation)
      on the mesh's first device after a hop from every shard
  Replica selection (Selective)   -> ``replicated_call``
  Fan-in reduce                   -> ``all_reduce``; ``reduce_scatter``,
      ``all_gather`` and ``all_to_all_reshard`` as explicit hops

On an ``RpcMesh`` (one process's devices) inputs and outputs are plain
global tensors, and an output lies on the mesh's first device: its value
equals the reference's global array, but nothing stays sharded
(``merge="none"`` concatenates like "concat"). Every computation runs on
replica 0's row: the reference replicates the request over the replica
axis, so every replica computes the same values.

On a ``PodMesh`` (one rank a process, ``distributed.pod_mesh``) every
rank of the world runs the same call on its own piece, as the
reference's SPMD program runs on each device: an input the reference
splits over the shard axis (``P(shard)``) is the rank's piece of it
(``sharding(mesh, ...).local(x)``), an input it replicates is given
whole, and the output is what the reference leaves on the rank's device:
its piece of a split output, all of a replicated one. The collectives
run over the process group of the rank's replica row:

  sum, max, min   -> ``all_reduce``; mean is the sum over n (gloo has
                     no AVG); every rank of the row holds the result
  concat, stack,  -> the rank's own response, no communication
  none
  all_gather      -> ``all_gather``: the whole tensor on every rank
  reduce_scatter  -> ``reduce_scatter``: rank j sums part j of every
                     rank's copy
  all_to_all      -> one ``all_to_all_single``
  ring hops       -> ``batch_isend_irecv`` (``ring.py``)

Gloo takes host tensors, so over gloo a rank's CUDA tensors go through
the host, and the result comes back to the rank's device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .mesh import SHARD_AXIS, PodMesh, RpcMesh, split_shards

_MERGES = ("sum", "mean", "max", "min", "concat", "stack", "none")
_REDUCE = {"sum": torch.sum, "mean": torch.mean, "max": torch.amax,
           "min": torch.amin}


def _gather(parts: Sequence[torch.Tensor], dev: torch.device
            ) -> List[torch.Tensor]:
    """Every shard's part, hopped onto ``dev``."""
    return [p.to(dev) for p in parts]


def _all_to_all(devs: Sequence[torch.device],
                shards: Sequence[torch.Tensor], split_axis: int,
                concat_axis: int) -> List[torch.Tensor]:
    """``lax.all_to_all(tiled=True)`` over per-shard tensors: shard i
    splits its tensor along ``split_axis`` into n parts and sends part j
    to shard j, which concatenates what it receives, in sender order,
    along ``concat_axis``."""
    n = len(devs)
    if shards[0].shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} ({shards[0].shape[split_axis]})"
                         f" does not divide the shard count {n}")
    parts = [s.chunk(n, split_axis) for s in shards]
    return [torch.cat([parts[i][j].to(devs[j]) for i in range(n)],
                      concat_axis) for j in range(n)]


# ------------------------------------------------- a pod's collectives

def _staged(mesh: PodMesh, t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` where ``mesh``'s backend takes it:
    the host for gloo, else the rank's device (a copy, since the
    collectives write in place)."""
    where = "cpu" if mesh.backend == "gloo" else mesh.device
    return t.detach().to(where, copy=True).contiguous()


def _pod_all_reduce(mesh: PodMesh, t: torch.Tensor, op: str
                    ) -> torch.Tensor:
    import torch.distributed as dist
    buf = _staged(mesh, t)
    dist.all_reduce(buf, {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
                          "max": dist.ReduceOp.MAX,
                          "min": dist.ReduceOp.MIN}[op], group=mesh.group)
    if op == "mean":
        buf = buf / mesh.shape[SHARD_AXIS]
    return buf.to(mesh.device)


def _pod_all_gather(mesh: PodMesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (all of one shape), in shard order."""
    import torch.distributed as dist
    buf = _staged(mesh, t)
    parts = [torch.empty_like(buf) for _ in mesh.row_ranks]
    dist.all_gather(parts, buf, group=mesh.group)
    return [p.to(mesh.device) for p in parts]


def _pod_reduce_scatter(mesh: PodMesh, x: torch.Tensor) -> torch.Tensor:
    """Part j (of n along dim 0) of the sum of every rank's ``x``, on
    rank j."""
    import torch.distributed as dist
    n = mesh.shape[SHARD_AXIS]
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) does not divide the "
                         f"shard count {n}")
    parts = [p.contiguous() for p in _staged(mesh, x).chunk(n, 0)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=mesh.group)
    return out.to(mesh.device)


def _pod_reshard(mesh: PodMesh, t: torch.Tensor, split_axis: int,
                 concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)`` between the ranks of a row, in one
    ``all_to_all_single``: this rank splits ``t`` along ``split_axis``
    into n parts and sends part j to shard j, and concatenates what it
    receives, in sender order, along ``concat_axis``."""
    import torch.distributed as dist
    n = mesh.shape[SHARD_AXIS]
    if t.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} ({t.shape[split_axis]}) does "
                         f"not divide the shard count {n}")
    send = _staged(mesh, torch.stack(t.chunk(n, split_axis)))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    return torch.cat(recv.unbind(0), concat_axis).to(mesh.device)


def _pod_hop(mesh: PodMesh, blocks: Sequence[torch.Tensor],
             step: int = 1) -> List[torch.Tensor]:
    """One ``ppermute`` round of each block, in one
    ``batch_isend_irecv``: this rank's blocks go to shard (s + step) % n
    of its row, and it receives shard (s - step) % n's."""
    import torch.distributed as dist
    n = mesh.shape[SHARD_AXIS]
    if step % n == 0:
        return [b.clone() for b in blocks]
    row, s = mesh.row_ranks, mesh.coords[1]
    sends = [_staged(mesh, b) for b in blocks]
    recvs = [torch.empty_like(b) for b in sends]
    ops = []
    for out, into in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, out, row[(s + step) % n],
                              mesh.group))
        ops.append(dist.P2POp(dist.irecv, into, row[(s - step) % n],
                              mesh.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(mesh.device) for r in recvs]


class CollectiveChannel:
    """The ParallelChannel of a device mesh.

    ``call(service_fn, request)``: ``request``'s leading dim is split over
    the 'shard' axis (it must divide by the shard count), ``service_fn``
    runs on each shard's piece on that shard's device, and the responses
    merge: reduced elementwise ("sum", "mean", "max", "min") or
    concatenated along dim 0 ("concat", "stack", "none")."""

    def __init__(self, mesh: RpcMesh, merge: str = "concat"):
        if merge not in _MERGES:
            raise ValueError(f"merge must be one of {_MERGES}")
        self.mesh = mesh
        self.merge = merge

    @property
    def spans_ranks(self) -> bool:
        """A shard row of more than one rank process: a call is a
        collective that every rank of the row must join."""
        return isinstance(self.mesh, PodMesh) and self.n_shards > 1

    def call(self, service_fn: Callable, request: torch.Tensor,
             merge: Optional[str] = None) -> torch.Tensor:
        """On a ``PodMesh``, ``request`` is the rank's piece; a reduced
        response is the whole result on every rank of the row, any other
        is the rank's own."""
        merge = merge or self.merge
        if merge not in _MERGES:
            raise ValueError(f"merge must be one of {_MERGES}")
        if isinstance(self.mesh, PodMesh):
            y = service_fn(request.to(self.mesh.device))
            return (_pod_all_reduce(self.mesh, y, merge)
                    if merge in _REDUCE else y)
        ys = [service_fn(s) for s in split_shards(self.mesh, request)]
        parts = _gather(ys, self.mesh.first_device)
        if merge in _REDUCE:
            return _REDUCE[merge](torch.stack(parts), dim=0)
        return torch.cat(parts, dim=0)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.call(lambda s: s, x, merge=op)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard sees the full request (the fan-out's broadcast
        side); the output is that full tensor. On a ``PodMesh`` ``x`` is
        the rank's piece."""
        if isinstance(self.mesh, PodMesh):
            return torch.cat(_pod_all_gather(self.mesh, x), dim=0)
        return torch.cat(_gather(split_shards(self.mesh, x),
                                 self.mesh.first_device), dim=0)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard holds all of ``x``; shard j sums part j of every
        shard's copy (``psum_scatter``). The output, the parts
        concatenated, is n times ``x``. On a ``PodMesh`` every rank gives
        its copy and gets its part of the sum."""
        if isinstance(self.mesh, PodMesh):
            return _pod_reduce_scatter(self.mesh, x)
        devs = self.mesh.shard_devices()
        n = len(devs)
        copies = [x.to(d, copy=True) for d in devs]
        if x.shape[0] % n:
            raise ValueError(f"dim 0 ({x.shape[0]}) does not divide the "
                             f"shard count {n}")
        parts = [c.chunk(n, 0) for c in copies]
        reduced = [torch.stack([parts[i][j].to(devs[j]) for i in range(n)]
                               ).sum(0) for j in range(n)]
        return torch.cat(_gather(reduced, self.mesh.first_device), dim=0)

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[SHARD_AXIS]


def all_to_all_reshard(mesh, x: torch.Tensor, concat_axis: int,
                       split_axis: int) -> torch.Tensor:
    """Ulysses-style resharding: ``x`` split over the shard axis along
    ``concat_axis`` becomes ``x`` split along ``split_axis``, by one
    all-to-all (for example [seq/N, heads] -> [seq, heads/N]). The
    output is the global tensor, equal to ``x``, assembled from the new
    shards. On a ``PodMesh`` ``x`` is the rank's piece along
    ``concat_axis``, and the output its piece along ``split_axis``."""
    if isinstance(mesh, PodMesh):
        return _pod_reshard(mesh, x.to(mesh.device), split_axis,
                            concat_axis)
    devs = mesh.shard_devices()
    shards = _all_to_all(devs, split_shards(mesh, x, concat_axis),
                         split_axis, concat_axis)
    return torch.cat(_gather(shards, mesh.first_device), split_axis)


def replicated_call(mesh, service_fn: Callable,
                    request: torch.Tensor) -> torch.Tensor:
    """SelectiveChannel's mesh form: every replica holds the whole
    request and computes the same response, so it runs once, on the
    mesh's first device (on a ``PodMesh``, on each rank's own)."""
    return service_fn(request.to(mesh.first_device))
