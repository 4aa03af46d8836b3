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

Inputs and outputs are plain global tensors, and an output lies on the
mesh's first device: its value equals the reference's global array, but
nothing stays sharded (``merge="none"`` concatenates like "concat").
Every computation runs on replica 0's row: the reference replicates the
request over the replica axis, so every replica computes the same
values.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .mesh import RpcMesh, split_shards

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

    def call(self, service_fn: Callable, request: torch.Tensor,
             merge: Optional[str] = None) -> torch.Tensor:
        merge = merge or self.merge
        if merge not in _MERGES:
            raise ValueError(f"merge must be one of {_MERGES}")
        ys = [service_fn(s) for s in split_shards(self.mesh, request)]
        parts = _gather(ys, self.mesh.first_device)
        if merge in _REDUCE:
            return _REDUCE[merge](torch.stack(parts), dim=0)
        return torch.cat(parts, dim=0)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.call(lambda s: s, x, merge=op)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard sees the full request (the fan-out's broadcast
        side); the output is that full tensor."""
        return torch.cat(_gather(split_shards(self.mesh, x),
                                 self.mesh.first_device), dim=0)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard holds all of ``x``; shard j sums part j of every
        shard's copy (``psum_scatter``). The output, the parts
        concatenated, is n times ``x``."""
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
        return len(self.mesh.shard_devices())


def all_to_all_reshard(mesh: RpcMesh, x: torch.Tensor, concat_axis: int,
                       split_axis: int) -> torch.Tensor:
    """Ulysses-style resharding: ``x`` split over the shard axis along
    ``concat_axis`` becomes ``x`` split along ``split_axis``, by one
    all-to-all (for example [seq/N, heads] -> [seq, heads/N]). The
    output is the global tensor, equal to ``x``, assembled from the new
    shards."""
    devs = mesh.shard_devices()
    shards = _all_to_all(devs, split_shards(mesh, x, concat_axis),
                         split_axis, concat_axis)
    return torch.cat(_gather(shards, mesh.first_device), split_axis)


def replicated_call(mesh: RpcMesh, service_fn: Callable,
                    request: torch.Tensor) -> torch.Tensor:
    """SelectiveChannel's mesh form: every replica holds the whole
    request and computes the same response, so it runs once, on the
    mesh's first device."""
    return service_fn(request.to(mesh.first_device))
