"""Multi-process bring-up (the port of brpc_tpu/parallel/distributed.py):
``torch.distributed`` in the place of ``jax.distributed``, a mesh whose
cells are the rank processes, and one RPC endpoint a process.

    from brpc_tpu_torch.parallel.distributed import init_pod, pod_mesh

    init_pod(coordinator="10.0.0.1:8476", num_processes=4, process_id=i)
    mesh = pod_mesh(n_replicas=2)     # a 2x2 grid of the four ranks

One rank a process and one device a rank: once ``init_pod`` is up,
``pod_mesh`` gives a ``PodMesh`` over the ranks of the world, and the
collectives of ``collective.py``, ``ring.py`` and
``ops/ring_attention.py`` run between the processes over the process
group of each replica row. Without a process group, ``pod_mesh`` is
``make_rpc_mesh`` over this process's cards, as before. The processes
also reach each other through the RPC endpoints ``pod_endpoints`` lists
(``cudad://``, the counterpart of ``tpud://``).

The backend is NCCL when each rank has a card of its own, gloo
otherwise (gloo's collectives take host tensors: a rank's CUDA tensors
go through the host for them). One host may hold more ranks than cards,
and NCCL refuses two ranks on one card, so ``backend=`` may choose; the
reference has no such keyword.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch

from .mesh import PodMesh, make_rpc_mesh

INIT_TIMEOUT_S = 60.0

_initialized = False


def _default_backend(world: int) -> str:
    """NCCL when every rank on this host has a card of its own: the host's
    ranks are ``LOCAL_WORLD_SIZE`` (torchrun sets it), else the world."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def init_pod(coordinator: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None, *,
             backend: Optional[str] = None,
             timeout_s: float = INIT_TIMEOUT_S) -> None:
    """``torch.distributed.init_process_group`` once: over
    ``tcp://<coordinator>`` when one is given, over ``env://`` (the
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` of a
    launcher) when no argument is and ``WORLD_SIZE`` is above 1, the
    counterpart of ``jax.distributed.initialize()``'s detection.
    Otherwise a single process does nothing. A rank that never joins
    makes every other rank's ``init_pod`` raise after ``timeout_s``."""
    global _initialized
    if _initialized:
        return
    import torch.distributed as dist
    if dist.is_initialized():
        _initialized = True
        return
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
        world, rank = int(num_processes or 1), int(process_id or 0)
    elif num_processes is None and \
            int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        _initialized = True
        return
    dist.init_process_group(
        backend or _default_backend(world), init_method=init_method,
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    _initialized = True


def _process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def pod_mesh(n_replicas: Optional[int] = None,
             n_shards: Optional[int] = None, device=None):
    """With a process group up, a ``PodMesh`` over its ranks in rank order
    (either count may be left out; the grid must cover the world), this
    rank on ``device`` (``cuda:<LOCAL_RANK>`` unless given). Every rank
    must call it, in the same order: each replica row's process group is
    made by all of them. Without a process group, ``make_rpc_mesh`` over
    this process's cards."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return make_rpc_mesh(n_replicas=n_replicas, n_shards=n_shards)
    n = dist.get_world_size()
    if n_replicas is None and n_shards is None:
        n_replicas, n_shards = 1, n
    elif n_replicas is None:
        n_replicas = n // n_shards
    elif n_shards is None:
        n_shards = n // n_replicas
    if n_replicas * n_shards != n or n == 0:
        raise ValueError(
            f"{n_replicas}x{n_shards} mesh does not cover {n} ranks")
    if device is None:
        from brpc_tpu_torch.butil.device import resolve_device
        device = resolve_device(
            f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)    # NCCL's communicator takes it
    rank = dist.get_rank()
    group = None
    for r in range(n_replicas):          # new_group is itself collective
        g = dist.new_group(list(range(r * n_shards, (r + 1) * n_shards)))
        if r == rank // n_shards:
            group = g
    return PodMesh(n_replicas, n_shards, rank, device, group,
                   dist.get_backend())


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
