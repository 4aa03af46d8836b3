"""A pod across rank processes: every collective of ``parallel/`` and
``ops/ring_attention.py`` on a ``PodMesh``, run in n rank processes over
``torch.distributed`` and held against the single-process mesh.

    python3 -m brpc_tpu_torch.tools.pod_smoke --ranks 4 --device cpu
    python3 -m brpc_tpu_torch.tools.pod_smoke --ranks 4 --device cuda:0 \\
        --backend gloo --full --iters 20 --kernel --out /tmp/pod

The launcher binds a socket for the rendezvous port, starts the ranks
(``--rank i``: ``init_pod`` over ``tcp://127.0.0.1:<port>``), waits for
them under ``--timeout`` and prints one JSON line: each rank's mesh
shapes (1 x n, and 2 x n/2 when n is even and at least 4), and for each
operation the largest difference from the same operation on one
process's ``make_rpc_mesh`` of n shards on the same device (data
movement equal to the bit, reductions and attention within ``--tol``).
``--iters`` adds each operation's median wall ms over that many calls on
the 1 x n mesh; ``--kernel`` runs a ``CollectiveChannel.call`` whose
service function is ``flash_attention`` on the rank's heads, merged with
``all_gather``, and counts the rank's kernel launches (each rank's
output is saved under ``--out``). A rank's outputs go to
``--out/rank<i>.npz`` when ``--out`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import traceback
from statistics import median
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

SEED = 20261019
# rows x cols of the request, heads x seq x head dim of the attention
SMALL = dict(rows=16, cols=8, heads=4, seq=32, dim=8)
FULL = dict(rows=1024, cols=1024, heads=8, seq=2048, dim=64)
KERNEL_SHAPE = (32, 2048, 64)          # heads x seq x head dim, bf16
TOL = 2e-5


def mesh_shapes(world: int) -> List[Tuple[int, int]]:
    """(replicas, shards) of the meshes a world of ``world`` ranks runs."""
    out = [(1, world)]
    if world >= 4 and world % 2 == 0:
        out.append((2, world // 2))
    return out


def make_inputs(sizes: Dict[str, int], seed: int = SEED
                ) -> Dict[str, np.ndarray]:
    """The global inputs, from ``seed``: the request x [rows, cols] and
    q, k, v [heads, seq, dim], all fp32."""
    rng = np.random.RandomState(seed)
    out = {"x": rng.randn(sizes["rows"], sizes["cols"]).astype(np.float32)}
    for name in "qkv":
        out[name] = rng.randn(sizes["heads"], sizes["seq"],
                              sizes["dim"]).astype(np.float32)
    return out


def service(s):
    """The service function of ``CollectiveChannel.call``."""
    return s * 2 + 1


def _keep_last(c, b):
    return c * 0 + b


# name -> (exact, the dim of the output split over the shard axis or
# None for a replicated output); the merges, then the collectives, the
# ring and the attention, in the order every rank runs them
MERGES = ("sum", "mean", "max", "min", "concat", "stack", "none")
OPS: Dict[str, Tuple[bool, Optional[int]]] = {
    **{f"call_{m}": (m not in ("sum", "mean"),
                     0 if m in ("concat", "stack", "none") else None)
       for m in MERGES},
    "all_gather": (True, None),
    "reduce_scatter": (False, 0),
    "all_to_all_reshard": (True, 1),
    "all_to_all_reshard_back": (True, 0),
    "replicated_call": (True, None),
    "ring_shift_1": (True, 0),
    "ring_shift_2": (True, 0),
    "ring_allreduce": (False, None),
    "ring_scan": (False, 0),
    "ring_scan_init": (True, 0),
    "ring_attention": (False, 1),
    "ring_attention_causal": (False, 1),
    "ulysses_attention": (False, 1),
    "ulysses_attention_causal": (False, 1),
}


def _pod_calls(mesh, x, qkv) -> Dict[str, Callable]:
    """Each operation on the pod mesh, from the global inputs: a rank
    takes its piece of what the reference splits, all of the rest."""
    import torch

    from brpc_tpu_torch.ops import ring_attention, ulysses_attention
    from brpc_tpu_torch.parallel import (SHARD_AXIS, CollectiveChannel,
                                         all_to_all_reshard,
                                         replicated_call, ring_allreduce,
                                         ring_scan, ring_shift, sharding)
    n = mesh.shape[SHARD_AXIS]
    rows = sharding(mesh, SHARD_AXIS).local(x)
    seq = [sharding(mesh, None, SHARD_AXIS, None).local(t) for t in qkv]
    whole = x.to(mesh.device)
    init = torch.zeros(1, device=mesh.device)
    calls = {f"call_{m}": (lambda m=m: CollectiveChannel(mesh, m).call(
        service, rows)) for m in MERGES}
    calls.update({
        "all_gather": lambda: CollectiveChannel(mesh).all_gather(rows),
        "reduce_scatter": lambda: CollectiveChannel(mesh).reduce_scatter(
            whole),
        "all_to_all_reshard": lambda: all_to_all_reshard(
            mesh, rows, concat_axis=0, split_axis=1),
        "all_to_all_reshard_back": lambda: all_to_all_reshard(
            mesh, all_to_all_reshard(mesh, rows, concat_axis=0,
                                     split_axis=1),
            concat_axis=1, split_axis=0),
        "replicated_call": lambda: replicated_call(mesh, service, whole),
        "ring_shift_1": lambda: ring_shift(mesh, rows, 1),
        "ring_shift_2": lambda: ring_shift(mesh, rows, 2),
        "ring_allreduce": lambda: ring_allreduce(mesh, whole.reshape(n, -1)),
        "ring_scan": lambda: ring_scan(mesh, rows, lambda c, b: c + b),
        "ring_scan_init": lambda: ring_scan(mesh, rows, _keep_last,
                                            init=init),
        "ring_attention": lambda: ring_attention(mesh, *seq),
        "ring_attention_causal": lambda: ring_attention(mesh, *seq,
                                                        causal=True),
        "ulysses_attention": lambda: ulysses_attention(mesh, *seq),
        "ulysses_attention_causal": lambda: ulysses_attention(
            mesh, *seq, causal=True),
    })
    return calls


def _single_outputs(mesh, x, qkv) -> dict:
    """Each operation on one process's mesh of the same shape: global
    outputs."""
    import torch

    from brpc_tpu_torch.ops import ring_attention, ulysses_attention
    from brpc_tpu_torch.parallel import (SHARD_AXIS, CollectiveChannel,
                                         all_to_all_reshard,
                                         replicated_call, ring_allreduce,
                                         ring_scan, ring_shift)
    n = mesh.shape[SHARD_AXIS]
    out = {f"call_{m}": CollectiveChannel(mesh, m).call(service, x)
           for m in MERGES}
    coll = CollectiveChannel(mesh)
    out["all_gather"] = coll.all_gather(x)
    out["reduce_scatter"] = coll.reduce_scatter(x)
    out["all_to_all_reshard"] = all_to_all_reshard(mesh, x, 0, 1)
    out["all_to_all_reshard_back"] = all_to_all_reshard(
        mesh, out["all_to_all_reshard"], 1, 0)
    out["replicated_call"] = replicated_call(mesh, service, x)
    out["ring_shift_1"] = ring_shift(mesh, x, 1)
    out["ring_shift_2"] = ring_shift(mesh, x, 2)
    out["ring_allreduce"] = ring_allreduce(mesh, x.reshape(n, -1))
    out["ring_scan"] = ring_scan(mesh, x, lambda c, b: c + b)
    out["ring_scan_init"] = ring_scan(mesh, x, _keep_last,
                                      init=torch.zeros(1, device=x.device))
    for causal in (False, True):
        tag = "_causal" if causal else ""
        out[f"ring_attention{tag}"] = ring_attention(mesh, *qkv,
                                                     causal=causal)
        out[f"ulysses_attention{tag}"] = ulysses_attention(mesh, *qkv,
                                                           causal=causal)
    return out


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _compare(got, want, exact: bool, tol: float) -> dict:
    import torch
    same_shape = tuple(got.shape) == tuple(want.shape)
    if not same_shape:
        return {"ok": False, "shape": list(got.shape),
                "want_shape": list(want.shape)}
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool(torch.equal(got, want)) if exact else bool(
        torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
    return {"ok": ok, "max_abs_err": err}


def _kernel_part(mesh, dev) -> dict:
    """``flash_attention`` on the rank's heads of the global bf16 input
    through ``CollectiveChannel.call``, merged with ``all_gather``; the
    rank's kernel launches, zeroed just before and read just after."""
    import importlib

    import torch

    from brpc_tpu_torch.parallel import (SHARD_AXIS, CollectiveChannel,
                                         sharding)
    # the ops package exports the function under the submodule's name
    fa = importlib.import_module("brpc_tpu_torch.ops.flash_attention")
    qkv = torch.stack(kernel_inputs(dev), 1)     # [heads, 3, seq, dim]
    mine = sharding(mesh, SHARD_AXIS).local(qkv)
    coll = CollectiveChannel(mesh, "concat")
    _sync(dev)
    fa.reset_launches()
    out = coll.call(lambda s: fa.flash_attention(
        *(t.contiguous() for t in s.unbind(1))), mine)
    whole = coll.all_gather(out)
    _sync(dev)
    return {"launches": dict(fa.launches), "out": whole,
            "shape": list(whole.shape)}


def kernel_inputs(dev):
    """q, k, v [32, 2048, 64] bf16 from the seed, on ``dev``."""
    import torch
    g = torch.Generator().manual_seed(SEED)
    return [torch.randn(KERNEL_SHAPE, generator=g).to(torch.bfloat16).to(dev)
            for _ in range(3)]


def _time_ops(calls, dev, iters: int) -> Dict[str, float]:
    """Each operation's median wall ms over ``iters`` calls after one
    warm-up; the ranks start each operation together."""
    import torch.distributed as dist
    out = {}
    for name, fn in calls.items():
        fn()
        _sync(dev)
        dist.barrier()
        ms = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = median(ms)
    return out


def run_rank(rank: int, world: int, coordinator: str, device: str,
             backend: Optional[str], sizes: Dict[str, int], tol: float,
             iters: int, kernel: bool, out_dir: Optional[str],
             init_timeout_s: Optional[float]) -> dict:
    """One rank: the pod up, every operation on each mesh shape against
    the single-process mesh; the times and the kernel part if asked."""
    import torch
    import torch.distributed as dist

    from brpc_tpu_torch.butil.device import resolve_device
    from brpc_tpu_torch.parallel import (init_pod, make_rpc_mesh,
                                         pod_endpoints, pod_mesh, sharding)
    from brpc_tpu_torch.parallel.distributed import INIT_TIMEOUT_S
    dev = resolve_device(device)
    t0 = time.monotonic()
    init_pod(coordinator, world, rank, backend=backend,
             timeout_s=init_timeout_s or INIT_TIMEOUT_S)
    rep = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(dev), "init_s": time.monotonic() - t0,
           "endpoints": pod_endpoints(), "shapes": {}}
    inputs = {k: torch.from_numpy(a).to(dev)
              for k, a in make_inputs(sizes).items()}
    x, qkv = inputs["x"], [inputs[k] for k in "qkv"]
    saved = {}
    ok = True
    timing = None
    for nr, ns in mesh_shapes(world):
        tag = f"{nr}x{ns}"
        mesh = pod_mesh(nr, ns, device=dev)
        single = make_rpc_mesh(nr, ns, devices=[dev] * world)
        calls = _pod_calls(mesh, x, qkv)
        want = _single_outputs(single, x, qkv)
        shape = {"coords": list(mesh.coords), "ranks": mesh.ranks,
                 "ops": {}}
        for name, fn in calls.items():
            got = fn()
            exact, dim = OPS[name]
            spec = [None] * want[name].dim()
            if dim is not None:
                spec[dim] = "shard"
            piece = sharding(single, *spec).piece(want[name], *mesh.coords)
            shape["ops"][name] = _compare(got, piece, exact, tol)
            ok &= shape["ops"][name]["ok"]
            saved[f"{tag}/{name}"] = got.detach().cpu().numpy()
        _sync(dev)
        rep["shapes"][tag] = shape
        if timing is None:
            timing = calls
    if iters:
        rep["times_ms"] = _time_ops(timing, dev, iters)
    if kernel:
        k = _kernel_part(pod_mesh(1, world, device=dev), dev)
        rep["kernel"] = {"launches": k["launches"], "shape": k["shape"]}
        if out_dir:
            torch.save(k["out"].cpu(), os.path.join(out_dir,
                                                    f"kernel{rank}.pt"))
    if out_dir:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    dist.barrier()
    dist.destroy_process_group()
    rep["ok"] = ok
    return rep


def free_port() -> int:
    """A port from a socket bound to port 0 and closed."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_pod(ranks: int, device: str = "cuda:0",
            backend: Optional[str] = None, full: bool = False,
            iters: int = 0, kernel: bool = False,
            out_dir: Optional[str] = None, tol: float = TOL,
            timeout_s: float = 300.0, absent: Optional[int] = None,
            init_timeout_s: Optional[float] = None,
            env: Optional[dict] = None) -> dict:
    """Start ``ranks`` rank processes (all but ``absent``, a rank that
    never joins), wait for them under ``timeout_s`` and kill what is
    left: ``{"ok", "wall_s", "ranks": [each rank's report or error]}``.
    Every child is reaped before it returns."""
    from .spawn_util import package_root
    port = free_port()
    argv = ["--world", str(ranks), "--coordinator", f"127.0.0.1:{port}",
            "--device", device, "--tol", repr(tol), "--iters", str(iters)]
    argv += ["--init-timeout", repr(init_timeout_s)] if init_timeout_s else []
    argv += ["--backend", backend] if backend else []
    argv += ["--full"] if full else []
    argv += ["--kernel"] if kernel else []
    argv += ["--out", out_dir] if out_dir else []
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "brpc_tpu_torch.tools.pod_smoke",
         "--rank", str(i)] + argv, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=package_root(), env=env)
        for i in range(ranks) if i != absent]
    reports = []
    deadline = t0 + timeout_s
    for p in procs:
        try:
            out, err = p.communicate(
                timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            err = f"over the {timeout_s} s limit\n{err}"
        rep = _last_json(out)
        if rep is None:
            rep = {"ok": False, "rc": p.returncode, "error": err[-4000:]}
        rep["rc"] = p.returncode
        reports.append(rep)
    for p in procs:          # every child reaped, whatever came before
        if p.poll() is None:
            p.kill()
        p.wait()
    return {"ok": all(r.get("ok") and r["rc"] == 0 for r in reports)
            and absent is None, "wall_s": time.monotonic() - t0,
            "ranks": reports}


def _last_json(text: str) -> Optional[dict]:
    for line in reversed((text or "").strip().splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                return None
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4,
                   help="start a pod of this many rank processes")
    p.add_argument("--rank", type=int,
                   help="run one rank (the launcher starts them)")
    p.add_argument("--world", type=int)
    p.add_argument("--coordinator")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--backend", choices=("gloo", "nccl"))
    p.add_argument("--full", action="store_true",
                   help="the card's sizes: x 1024 x 1024, attention 8 x "
                        "2048 x 64")
    p.add_argument("--iters", type=int, default=0)
    p.add_argument("--kernel", action="store_true")
    p.add_argument("--out")
    p.add_argument("--tol", type=float, default=TOL)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--init-timeout", type=float,
                   help="init_pod's timeout (default: init_pod's own)")
    args = p.parse_args(argv)
    sizes = FULL if args.full else SMALL
    if args.rank is not None:
        import torch.distributed  # noqa: F401  (before the clock starts)
        t0 = time.monotonic()
        try:
            rep = run_rank(args.rank, args.world, args.coordinator,
                           args.device, args.backend, sizes, args.tol,
                           args.iters, args.kernel, args.out,
                           args.init_timeout)
        except Exception:
            rep = {"rank": args.rank, "ok": False,
                   "error": traceback.format_exc()[-4000:]}
        rep["wall_s"] = time.monotonic() - t0
        print(json.dumps(rep))
        return 0 if rep["ok"] else 1
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    out = run_pod(args.ranks, args.device, args.backend, args.full,
                  args.iters, args.kernel, args.out, args.tol, args.timeout,
                  init_timeout_s=args.init_timeout)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.exit(rc)
