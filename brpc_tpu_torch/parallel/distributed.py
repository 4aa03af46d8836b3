"""Multi-process bring-up (the port of brpc_tpu/parallel/distributed.py):
``torch.distributed`` in the place of ``jax.distributed``, a mesh of this
process's devices, and one RPC endpoint a process.

    from brpc_tpu_torch.parallel.distributed import init_pod, pod_mesh

    init_pod(coordinator="10.0.0.1:8476", num_processes=4, process_id=i)
    mesh = pod_mesh(n_replicas=1)     # this process's cards

A single process skips ``init_process_group``, so the same code runs on
one card or many. Unlike the reference's ``pod_mesh``, which covers the
devices of every host once ``jax.distributed`` is up, a torch process
addresses only its own devices: the mesh is local, and the processes
reach each other through the RPC endpoints ``pod_endpoints`` lists
(``cudad://``, the counterpart of ``tpud://``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

_initialized = False


def init_pod(coordinator: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None) -> None:
    """``torch.distributed.init_process_group`` once, over
    ``tcp://<coordinator>``: nccl with a card, gloo without. A single
    process (no coordinator, or one process) does nothing."""
    global _initialized
    if _initialized:
        return
    import torch.distributed as dist
    if coordinator is not None and (num_processes or 1) > 1 \
            and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id)
    _initialized = True


def _process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def pod_mesh(n_replicas: Optional[int] = None,
             n_shards: Optional[int] = None):
    """An RpcMesh over this process's cards (``make_rpc_mesh``'s
    default devices)."""
    from .mesh import make_rpc_mesh
    return make_rpc_mesh(n_replicas=n_replicas, n_shards=n_shards)


def pod_endpoints(base_port: int = 8750, scheme: str = "cudad",
                  hosts: Optional[List[str]] = None) -> List[str]:
    """One RPC endpoint a process: ``cudad://<host>:<port>``. Hosts
    default to localhost for every process (one host: ports
    ``base_port + i``); with one distinct host a process, every process
    listens on ``base_port``."""
    n = _process_count()
    if hosts is None:
        hosts = ["127.0.0.1"] * n
    if len(hosts) != n:
        raise ValueError(f"{len(hosts)} hosts for {n} processes")
    return [f"{scheme}://{host}:"
            f"{base_port + (0 if len(set(hosts)) == n else i)}"
            for i, host in enumerate(hosts)]
