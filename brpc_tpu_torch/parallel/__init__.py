"""Combo-channel shapes on a mesh of torch devices or of rank processes
(the port of brpc_tpu/parallel/): the meshes, the collectives a
ParallelChannel lowers to, the ring hops, and the multi-process pod
(``init_pod``, ``pod_mesh``, ``pod_endpoints``)."""

from .collective import CollectiveChannel, all_to_all_reshard, replicated_call
from .distributed import init_pod, pod_endpoints, pod_mesh
from .mesh import (REPLICA_AXIS, SHARD_AXIS, PodMesh, RpcMesh,
                   endpoint_for_coords, make_rpc_mesh, shard_spec, sharding)
from .ring import ring_allreduce, ring_scan, ring_shift

__all__ = [
    "REPLICA_AXIS", "SHARD_AXIS", "PodMesh", "RpcMesh",
    "endpoint_for_coords", "make_rpc_mesh", "sharding", "shard_spec",
    "CollectiveChannel", "all_to_all_reshard", "replicated_call",
    "init_pod", "pod_endpoints", "pod_mesh",
    "ring_allreduce", "ring_scan", "ring_shift",
]
