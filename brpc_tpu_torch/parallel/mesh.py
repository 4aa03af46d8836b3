"""RpcMesh and PodMesh: a named grid of devices or of rank processes (the
port of brpc_tpu/parallel/mesh.py).

The reference wraps ``jax.sharding.Mesh``: its devices may belong to
many processes (after ``jax.distributed`` is up), and its collectives
compile into one SPMD program. The port has two meshes:

- ``RpcMesh``, a ``[n_replicas][n_shards]`` grid of ``torch.device``
  driven by one process; its collectives (``collective.py``,
  ``ring.py``) are per-shard tensor ops and ``.to(device)`` hops between
  the shards;
- ``PodMesh``, a grid of the ranks of a ``torch.distributed`` world, one
  device a rank (``distributed.pod_mesh``); every rank runs the same
  program on its own piece, and the collectives are ``torch.distributed``
  calls over the process group of the rank's replica row.

The two axes:

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

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

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


class PodMesh:
    """The ranks of a process group as a grid: ``ranks[r][s]`` is the rank
    at replica r, shard s (row r holds ranks ``r * n_shards`` up to
    ``r * n_shards + n_shards - 1``, the order of the reference's pod
    mesh). This process is ``rank``, at ``coords``, on ``device``;
    ``group`` is the process group of its replica row, the shard axis
    its collectives run over. Made by ``distributed.pod_mesh``."""

    def __init__(self, n_replicas: int, n_shards: int, rank: int,
                 device: torch.device, group: Any, backend: str):
        if not 0 <= rank < n_replicas * n_shards:
            raise ValueError(f"rank {rank} is outside a {n_replicas}x"
                             f"{n_shards} grid")
        self.ranks: List[List[int]] = [
            [r * n_shards + s for s in range(n_shards)]
            for r in range(n_replicas)]
        self.rank = rank
        self.coords: Tuple[int, int] = divmod(rank, n_shards)
        self.device = torch.device(device)
        self.group = group
        self.backend = backend

    @property
    def shape(self) -> Dict[str, int]:
        return {REPLICA_AXIS: len(self.ranks),
                SHARD_AXIS: len(self.ranks[0])}

    @property
    def row_ranks(self) -> List[int]:
        """The ranks of this rank's replica row, in shard order."""
        return self.ranks[self.coords[0]]

    @property
    def first_device(self) -> torch.device:
        """Where this rank's outputs lie: its own device."""
        return self.device


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
    lives on ``mesh`` (an ``RpcMesh`` or a ``PodMesh``)."""
    mesh: Any
    spec: ShardSpec

    def piece(self, x: torch.Tensor, replica: int,
              shard: int) -> torch.Tensor:
        """The piece of ``x`` at mesh coordinate (replica, shard): a dim
        split over an axis is split into equal parts."""
        for axis, index in ((REPLICA_AXIS, replica), (SHARD_AXIS, shard)):
            for dim, name in enumerate(self.spec):
                if name == axis:
                    n = self.mesh.shape[axis]
                    if x.shape[dim] % n:
                        raise ValueError(f"dim {dim} ({x.shape[dim]}) does "
                                         f"not divide the {axis} axis "
                                         f"size {n}")
                    x = x.chunk(n, dim)[index]
        return x

    def place(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        """The pieces of ``x`` by mesh coordinate: ``[r][s]``, each on its
        device (an ``RpcMesh``)."""
        return [[self.piece(x, r, s).to(dev) for s, dev in enumerate(row)]
                for r, row in enumerate(self.mesh.devices)]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the global ``x``, on its device (a
        ``PodMesh``): what ``jax.make_array_from_callback`` hands the
        process's device."""
        return self.piece(x, *self.mesh.coords).to(self.mesh.device)


def shard_spec(*names: Optional[str]) -> ShardSpec:
    return ShardSpec(names)


def sharding(mesh, *names: Optional[str]) -> Sharding:
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
