"""RpcMesh: the devices of one process as a named grid (the port of
brpc_tpu/parallel/mesh.py).

The reference wraps ``jax.sharding.Mesh``: one process drives every
device of the mesh and its collectives compile into one SPMD program.
The port's mesh is a ``[n_replicas][n_shards]`` grid of
``torch.device``, still driven by one process; its collectives
(``collective.py``, ``ring.py``) are explicit per-shard tensor ops and
``.to(device)`` hops between the shards. The two axes:

  'replica' -- interchangeable servers (SelectiveChannel's replica set;
               the data-parallel axis)
  'shard'   -- partitions of one logical service (PartitionChannel's
               shards; the tensor- and sequence-parallel axis)

A device may repeat: 8 shards on ``cuda:0`` (one card), or on ``cpu`` in
the tests, as the reference's tests run 8 virtual CPU devices. Each
shard then still holds a tensor of its own, and a hop between two shards
on one device is a copy.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

REPLICA_AXIS = "replica"
SHARD_AXIS = "shard"


class RpcMesh:
    """``devices[r][s]`` is the device at replica r, shard s."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices: List[List[torch.device]] = [
            [torch.device(d) for d in row] for row in devices]
        if not self.devices or not self.devices[0] or any(
                len(row) != len(self.devices[0]) for row in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid")

    @property
    def shape(self) -> Dict[str, int]:
        return {REPLICA_AXIS: len(self.devices),
                SHARD_AXIS: len(self.devices[0])}

    @property
    def first_device(self) -> torch.device:
        """Where the collectives leave their (global) outputs."""
        return self.devices[0][0]

    def shard_devices(self, replica: int = 0) -> List[torch.device]:
        """The devices along the shard axis of one replica."""
        return self.devices[replica]


def make_rpc_mesh(n_replicas: Optional[int] = None,
                  n_shards: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> RpcMesh:
    """A (n_replicas, n_shards) mesh over ``devices`` (default: every card
    of this process; without CUDA ``devices`` must be given). Either count
    may be left out and is worked out from the other; the grid must
    cover the devices exactly."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices= (for example "
                               "['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if n_replicas is None and n_shards is None:
        n_replicas, n_shards = 1, n
    elif n_replicas is None:
        n_replicas = n // n_shards
    elif n_shards is None:
        n_shards = n // n_replicas
    if n_replicas * n_shards != n or n == 0:
        raise ValueError(
            f"{n_replicas}x{n_shards} mesh does not cover {n} devices")
    return RpcMesh([devices[r * n_shards:(r + 1) * n_shards]
                    for r in range(n_replicas)])


class ShardSpec(tuple):
    """PartitionSpec's counterpart: for each tensor dim, the mesh axis it
    is split over, or None (replicated)."""


class Sharding(NamedTuple):
    """NamedSharding's counterpart: where each piece of a global tensor
    lives on ``mesh``."""
    mesh: RpcMesh
    spec: ShardSpec

    def place(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        """The pieces of ``x`` by mesh coordinate: ``[r][s]``, each on its
        device; a dim split over an axis is split into equal parts."""
        def split(t, axis: str, index: int) -> torch.Tensor:
            for dim, name in enumerate(self.spec):
                if name == axis:
                    n = self.mesh.shape[axis]
                    if t.shape[dim] % n:
                        raise ValueError(f"dim {dim} ({t.shape[dim]}) does "
                                         f"not divide the {axis} axis "
                                         f"size {n}")
                    t = t.chunk(n, dim)[index]
            return t
        return [[split(split(x, REPLICA_AXIS, r), SHARD_AXIS, s).to(dev)
                 for s, dev in enumerate(row)]
                for r, row in enumerate(self.mesh.devices)]


def shard_spec(*names: Optional[str]) -> ShardSpec:
    return ShardSpec(names)


def sharding(mesh: RpcMesh, *names: Optional[str]) -> Sharding:
    return Sharding(mesh, ShardSpec(names))


def endpoint_for_coords(mesh: RpcMesh, replica: int,
                        shard: int) -> torch.device:
    """Mesh coordinate -> the device there (what a cuda:// endpoint's
    ``#device=`` extra names)."""
    return mesh.devices[replica][shard]


def split_shards(mesh: RpcMesh, x: torch.Tensor,
                 dim: int = 0) -> Tuple[torch.Tensor, ...]:
    """``x`` split over the shard axis along ``dim``: shard s's piece on
    its device (replica 0's row: a replica holds the same pieces)."""
    devs = mesh.shard_devices()
    n = len(devs)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) does not divide the "
                         f"{SHARD_AXIS} axis size {n}")
    return tuple(p.to(d) for p, d in zip(x.chunk(n, dim), devs))
