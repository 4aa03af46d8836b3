"""Combo-channel shapes on a mesh of torch devices (the port of
brpc_tpu/parallel/): the mesh, the collectives a ParallelChannel lowers
to, the ring hops, and the multi-process bring-up."""

from .collective import CollectiveChannel, all_to_all_reshard, replicated_call
from .mesh import (REPLICA_AXIS, SHARD_AXIS, RpcMesh, endpoint_for_coords,
                   make_rpc_mesh, shard_spec, sharding)
from .ring import ring_allreduce, ring_scan, ring_shift

__all__ = [
    "REPLICA_AXIS", "SHARD_AXIS", "RpcMesh", "endpoint_for_coords",
    "make_rpc_mesh", "sharding", "shard_spec",
    "CollectiveChannel", "all_to_all_reshard", "replicated_call",
    "ring_allreduce", "ring_scan", "ring_shift",
]
