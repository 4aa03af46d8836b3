"""The port's pod across rank processes against brpc_tpu's, on the CPU.

brpc_tpu's pod path runs as it runs on a pod: four JAX processes, each
with one CPU device and gloo collectives (set in the child only), call
``init_pod(coordinator, 4, i)``, build ``pod_mesh`` at 1x4 and 2x2, and
run every collective of ``parallel/`` and ``ops/ring_attention.py`` on
the same numpy inputs (``tools/pod_smoke.make_inputs``, from a seed);
each process keeps what its device holds (``addressable_data(0)``). The
port's four rank processes (``tools.pod_smoke`` over gloo, ``device=
"cpu"``) run the same operations on their pieces. On each rank:

- the mesh's rank grid and the rank's coordinates, and ``pod_endpoints``;
- each of the seven merges, ``all_gather``, ``reduce_scatter``,
  ``all_to_all_reshard`` both ways, ``replicated_call``, ``ring_shift``
  by 1 and 2, ``ring_allreduce``, ``ring_scan`` with and without init,
  ring attention causal and not, and Ulysses attention causal and not:
  data movement equal to the bit, reductions and attention within
  ``TOL`` (tests/test_torch_parallel.py's);
- the rank's result also equals its piece of the same operation on the
  port's single-process mesh (each rank checks it, ``pod_smoke``).

Then the failures: a world whose rank 2 never joins fails in every other
rank within ``init_pod``'s timeout, every child reaped; and a
ParallelChannel given a CollectiveChannel over a 2-rank row declines it
(one ``collective_fallbacks`` a call, the call fanned out at once), where
brpc_tpu's lowers it and leaves the caller only its own piece (ROADMAP
§3). Every child runs under a timeout, its rendezvous port from a bound
socket. One collected test over the cases (``_run_cases`` of
test_torch_cluster.py, which fails a case that leaves a child process).
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=2e-5, rtol=2e-5)
WORLD = 4
ABSENT_INIT_TIMEOUT_S = 5.0
CHILD_TIMEOUT_S = 120.0


# ------------------------------------------------------------- children

def _ref_rank(rank: int, world: int, port: int, out: str) -> None:
    """brpc_tpu's pod path in one of ``world`` JAX processes: every
    operation, what this process's device holds of each output saved to
    ``out``/ref<rank>.npz, the grid and endpoints to ref<rank>.json.
    Rank 0 then puts a CollectiveChannel over the pod behind a
    ParallelChannel and calls it alone."""
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from brpc_tpu import parallel as ref
    from brpc_tpu.ops import ring_attention, ulysses_attention
    from brpc_tpu.parallel.distributed import (init_pod, pod_endpoints,
                                               pod_mesh)
    from brpc_tpu_torch.tools import pod_smoke
    init_pod(coordinator=f"127.0.0.1:{port}", num_processes=world,
             process_id=rank)
    inputs = pod_smoke.make_inputs(pod_smoke.SMALL)
    x, q, k, v = (inputs[n] for n in "xqkv")
    saved, grids = {}, {}
    for nr, ns in pod_smoke.mesh_shapes(world):
        tag = f"{nr}x{ns}"
        m = pod_mesh(n_replicas=nr)
        grids[tag] = [[d.process_index for d in row] for row in m.devices]
        outs = {f"call_{merge}": ref.CollectiveChannel(m, merge).call(
                    pod_smoke.service, x) for merge in pod_smoke.MERGES}
        coll = ref.CollectiveChannel(m)
        outs["all_gather"] = coll.all_gather(x)
        outs["reduce_scatter"] = coll.reduce_scatter(x)
        outs["all_to_all_reshard"] = ref.all_to_all_reshard(
            m, x, concat_axis=0, split_axis=1)
        outs["all_to_all_reshard_back"] = ref.all_to_all_reshard(
            m, x, concat_axis=1, split_axis=0)
        outs["replicated_call"] = ref.replicated_call(
            m, pod_smoke.service, x)
        outs["ring_shift_1"] = ref.ring_shift(m, x, 1)
        outs["ring_shift_2"] = ref.ring_shift(m, x, 2)
        outs["ring_allreduce"] = ref.ring_allreduce(m, x.reshape(ns, -1))
        outs["ring_scan"] = ref.ring_scan(m, x, combine=lambda c, b: c + b)
        outs["ring_scan_init"] = ref.ring_scan(
            m, x, combine=pod_smoke._keep_last,
            init=np.zeros(1, np.float32))
        for causal in (False, True):
            t = "_causal" if causal else ""
            outs[f"ring_attention{t}"] = ring_attention(m, q, k, v,
                                                        causal=causal)
            outs[f"ulysses_attention{t}"] = ulysses_attention(
                m, q, k, v, causal=causal)
        for name, a in outs.items():
            saved[f"{tag}/{name}"] = np.asarray(a.addressable_data(0))
    rep = {"grids": grids, "endpoints": pod_endpoints()}
    if rank == 0:
        rep["parallel_channel"] = _ref_parallel_channel(
            pod_mesh(n_replicas=1))
    np.savez(os.path.join(out, f"ref{rank}.npz"), **saved)
    with open(os.path.join(out, f"ref{rank}.json"), "w") as f:
        json.dump(rep, f)
    os._exit(0)          # the peers may be gone: skip the runtime's teardown


def _ref_parallel_channel(mesh) -> dict:
    """brpc_tpu's ParallelChannel over four device-lane sub-channels with
    a "concat" CollectiveChannel over the pod, called by this process
    alone."""
    import jax.numpy as jnp

    import brpc_tpu.rpc as rpc
    from brpc_tpu import parallel as ref
    srv = rpc.Server(rpc.ServerOptions(enable_builtin_services=False))
    svc = rpc.Service("EchoService")

    def Scale(cntl, request):
        cntl.response_device_arrays = [
            a * 3 for a in cntl.request_device_arrays]
        return b"s"
    svc.register_method("Scale", Scale)
    srv.add_service(svc)
    ep = srv.start("tpu://pod-decline:1#device=0")
    pch = rpc.ParallelChannel()
    for _ in range(mesh.shape["shard"]):
        pch.add_sub_channel(rpc.Channel(str(ep), rpc.ChannelOptions(
            timeout_ms=5000, max_retry=0)))
    pch.attach_collective(ref.CollectiveChannel(mesh, "concat"),
                          {("EchoService", "Scale"): lambda s: s * 3})
    cntl = rpc.Controller()
    cntl.request_device_arrays = [jnp.arange(8.0)]
    pch.call("EchoService", "Scale", b"", cntl=cntl)
    joined = cntl.join(10)
    out = cntl.response_device_arrays[0] if joined and \
        cntl.response_device_arrays else None
    srv.stop()
    srv.join(2)
    return {"joined": joined, "fused": pch.collective_fused,
            "fallbacks": pch.collective_fallbacks,
            "lowered": bool(getattr(cntl, "collective_lowered", False)),
            "fully_addressable": None if out is None
            else bool(out.is_fully_addressable),
            "held_here": None if out is None
            else np.asarray(out.addressable_data(0)).tolist()}


def _decline_rank(rank: int, port: int) -> None:
    """The port's ParallelChannel on rank 0 of a 2-rank pod, given a
    "sum" and then a "concat" CollectiveChannel over the pod's row, calls
    it alone while rank 1 waits at a barrier: one line of JSON."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.parallel import CollectiveChannel, init_pod, pod_mesh
    init_pod(f"127.0.0.1:{port}", 2, rank, timeout_s=30)
    mesh = pod_mesh(1, 2, device="cpu")
    rep = {"rank": rank, "calls": []}
    if rank == 0:
        srv = rpc.Server(rpc.ServerOptions(enable_builtin_services=False))
        svc = rpc.Service("EchoService")

        def Scale(cntl, request):
            cntl.response_device_arrays = [
                a * 3 for a in cntl.request_device_arrays]
            return b"s"
        svc.register_method("Scale", Scale)
        srv.add_service(svc)
        ep = srv.start(f"cuda://pod-decline-{port}:1#device=cpu")
        chans = [rpc.Channel(str(ep), rpc.ChannelOptions(timeout_ms=5000))
                 for _ in range(2)]
        pch = rpc.ParallelChannel()
        for ch in chans:
            pch.add_sub_channel(ch)
        for merge in ("sum", "concat"):
            pch.attach_collective(CollectiveChannel(mesh, merge),
                                  {("EchoService", "Scale"):
                                   lambda s: s * 3})
            cntl = rpc.Controller()
            cntl.request_device_arrays = [torch.arange(8.0)]
            t0 = time.monotonic()
            pch.call("EchoService", "Scale", b"", cntl=cntl)
            joined = cntl.join(10)
            rep["calls"].append({
                "merge": merge, "joined": joined, "s": time.monotonic() - t0,
                "failed": cntl.failed(),
                "lowered": bool(getattr(cntl, "collective_lowered", False)),
                "fused": pch.collective_fused,
                "fallbacks": pch.collective_fallbacks,
                "subs": [[a.tolist() for a in sub or []]
                         for sub in cntl.sub_device_arrays]})
        for ch in chans:
            ch.close()
        srv.stop()
        srv.join(2)
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(rep))
    sys.stdout.flush()
    os._exit(0)


# --------------------------------------------------------------- worlds

def _free_port() -> int:
    from brpc_tpu_torch.tools.pod_smoke import free_port
    return free_port()


def _run_children(argvs, env, timeout_s=CHILD_TIMEOUT_S):
    """Start one child a command line, wait for all under ``timeout_s``,
    kill and reap what is left: [(rc, stdout, stderr)]."""
    procs = [subprocess.Popen([sys.executable] + argv, cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    deadline = time.monotonic() + timeout_s
    out = []
    for p in procs:
        try:
            so, se = p.communicate(
                timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            se = f"over the {timeout_s} s limit\n{se}"
        out.append((p.returncode, so, se))
    return out


def _child_env():
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    # one CPU device a process, as a pod host has its own devices
    env["XLA_FLAGS"] = re.sub(r"--xla_force_host_platform_device_count=\d+",
                              "", env.get("XLA_FLAGS", "")).strip()
    return env


RESULTS = {}


def _worlds(tmp):
    """The four worlds at once: brpc_tpu's four JAX processes, the port's
    four rank processes, the port's world with rank 2 absent, and the
    2-rank world of the ParallelChannel; every child reaped when it
    returns."""
    from brpc_tpu_torch.tools import pod_smoke
    env = _child_env()
    me = str(Path(__file__).resolve())
    box = {}

    def port_world():
        box["port"] = pod_smoke.run_pod(WORLD, device="cpu", out_dir=tmp,
                                        timeout_s=CHILD_TIMEOUT_S, env=env)

    def absent_world():
        box["absent"] = pod_smoke.run_pod(
            3, device="cpu", absent=2, timeout_s=CHILD_TIMEOUT_S,
            init_timeout_s=ABSENT_INIT_TIMEOUT_S, env=env)

    def decline_world():
        port = _free_port()
        box["decline"] = _run_children(
            [[me, "--decline", str(i), str(port)] for i in range(2)], env)

    threads = [threading.Thread(target=f, daemon=True)
               for f in (port_world, absent_world, decline_world)]
    for t in threads:
        t.start()
    port = _free_port()
    box["ref"] = _run_children(
        [[me, "--ref", str(i), str(WORLD), str(port), tmp]
         for i in range(WORLD)], env)
    for t in threads:
        t.join(CHILD_TIMEOUT_S + 10)
    return box


# ---------------------------------------------------------------- cases

def _run_worlds():
    with tempfile.TemporaryDirectory(prefix="torch-pod-") as tmp:
        box = _worlds(tmp)
        for i, (rc, _, err) in enumerate(box["ref"]):
            assert rc == 0, f"brpc_tpu rank {i}: rc {rc}\n{err[-3000:]}"
        RESULTS["ref"] = [dict(np.load(os.path.join(tmp, f"ref{i}.npz")))
                          for i in range(WORLD)]
        RESULTS["ref_meta"] = [json.load(open(os.path.join(
            tmp, f"ref{i}.json"))) for i in range(WORLD)]
        RESULTS["port_run"] = box["port"]
        RESULTS["port"] = [dict(np.load(os.path.join(tmp, f"rank{i}.npz")))
                           for i in range(WORLD)
                           if os.path.exists(os.path.join(
                               tmp, f"rank{i}.npz"))]
        RESULTS["absent"] = box["absent"]
        RESULTS["decline"] = box["decline"]
    run = box["port"]
    bad = [r.get("error", r) for r in run["ranks"] if not r.get("ok")]
    assert run["ok"] and len(run["ranks"]) == WORLD, bad
    assert len(RESULTS["port"]) == WORLD


def _single_process_check():
    """Every rank's result equals its piece of the single-process mesh's
    (each rank's own check), at both shapes, for every operation."""
    from brpc_tpu_torch.tools.pod_smoke import OPS, mesh_shapes
    tags = [f"{a}x{b}" for a, b in mesh_shapes(WORLD)]
    for rep in RESULTS["port_run"]["ranks"]:
        assert sorted(rep["shapes"]) == sorted(tags)
        for tag in tags:
            ops = rep["shapes"][tag]["ops"]
            assert list(ops) == list(OPS), list(ops)
            bad = {k: v for k, v in ops.items() if not v["ok"]}
            assert not bad, (rep["rank"], tag, bad)


def _grids_and_endpoints():
    for rank, (rep, meta) in enumerate(zip(RESULTS["port_run"]["ranks"],
                                           RESULTS["ref_meta"])):
        assert rep["rank"] == rank
        for tag, shape in rep["shapes"].items():
            assert shape["ranks"] == meta["grids"][tag], (tag, shape)
            r, s = shape["coords"]
            assert shape["ranks"][r][s] == rank
        assert meta["grids"] == {"1x4": [[0, 1, 2, 3]],
                                 "2x2": [[0, 1], [2, 3]]}
        assert rep["endpoints"] == [e.replace("tpud://", "cudad://")
                                    for e in meta["endpoints"]]
        assert len(rep["endpoints"]) == WORLD


def _same_as_reference(names):
    """The port's outputs of ``names`` equal brpc_tpu's on every rank, at
    1x4 and 2x2: to the bit for data movement, within TOL else."""
    from brpc_tpu_torch.tools.pod_smoke import OPS
    checked = 0
    for rank in range(WORLD):
        port, ref = RESULTS["port"][rank], RESULTS["ref"][rank]
        for key in ref:
            tag, name = key.split("/")
            if name not in names:
                continue
            got, want = port[key], ref[key]
            assert got.shape == want.shape, (rank, key, got.shape,
                                             want.shape)
            if OPS[name][0]:
                np.testing.assert_array_equal(got, want, err_msg=f"{rank} "
                                              f"{key}")
            else:
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg=f"{rank} {key}")
            checked += 1
    assert checked == WORLD * 2 * len(names), checked


def _absent_rank():
    """Rank 2 never starts: ranks 0 and 1 fail within init_pod's timeout
    (plus a process start), with a timeout's error, and none is left."""
    run = RESULTS["absent"]
    assert not run["ok"] and len(run["ranks"]) == 2, run
    for rep in run["ranks"]:
        assert rep["rc"] != 0 and not rep.get("ok"), rep
        assert re.search(r"timed out|timeout", rep["error"], re.I), rep
        assert rep["wall_s"] <= ABSENT_INIT_TIMEOUT_S + 15, rep
    assert run["wall_s"] <= ABSENT_INIT_TIMEOUT_S + 60, run["wall_s"]


def _parallel_channel_declines():
    """The port: each call fans out (one fallback each, nothing fused) at
    once, every sub-channel's answer x * 3, and rank 1 never joined a
    collective. brpc_tpu: the concat lowers, and this process holds only
    its own piece of a global array."""
    outs = RESULTS["decline"]
    for i, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {i}: rc {rc}\n{err[-3000:]}"
    rep = json.loads(outs[0][1].strip().splitlines()[-1])
    want = [(np.arange(8.0) * 3).tolist()]
    assert [c["merge"] for c in rep["calls"]] == ["sum", "concat"]
    for n, call in enumerate(rep["calls"], 1):
        assert call["joined"] and not call["failed"], call
        assert not call["lowered"] and call["fused"] == 0, call
        assert call["fallbacks"] == n, call
        assert call["subs"] == [want, want], call
        assert call["s"] < 5.0, call
    ref = RESULTS["ref_meta"][0]["parallel_channel"]
    assert ref["joined"] and ref["lowered"] and ref["fused"] == 1, ref
    assert ref["fallbacks"] == 0 and ref["fully_addressable"] is False, ref
    assert ref["held_here"] == [0.0, 3.0], ref


MERGE_OPS = [f"call_{m}" for m in ("sum", "mean", "max", "min", "concat",
                                   "stack", "none")]
CASES = [
    ("four JAX processes and four rank processes", _run_worlds, ()),
    ("each rank against the single-process mesh", _single_process_check,
     ()),
    ("mesh grids, coordinates and pod_endpoints", _grids_and_endpoints, ()),
    ("the seven merges", _same_as_reference, (MERGE_OPS,)),
    ("all_gather, reduce_scatter, all_to_all both ways", _same_as_reference,
     (["all_gather", "reduce_scatter", "all_to_all_reshard",
       "all_to_all_reshard_back"],)),
    ("replicated_call", _same_as_reference, (["replicated_call"],)),
    ("ring_shift by 1 and 2", _same_as_reference,
     (["ring_shift_1", "ring_shift_2"],)),
    ("ring_allreduce", _same_as_reference, (["ring_allreduce"],)),
    ("ring_scan with and without init", _same_as_reference,
     (["ring_scan", "ring_scan_init"],)),
    ("ring attention, causal and not", _same_as_reference,
     (["ring_attention", "ring_attention_causal"],)),
    ("ulysses attention, causal and not", _same_as_reference,
     (["ulysses_attention", "ulysses_attention_causal"],)),
    ("a rank that never joins", _absent_rank, ()),
    ("a ParallelChannel declines a pod CollectiveChannel",
     _parallel_channel_declines, ()),
]


def test_pod_across_processes():
    from test_torch_cluster import _run_cases
    RESULTS.clear()
    try:
        _run_cases(CASES, limit_s=CHILD_TIMEOUT_S + 30)
    finally:
        RESULTS.clear()


if __name__ == "__main__":
    if sys.argv[1] == "--ref":
        _ref_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
    elif sys.argv[1] == "--decline":
        _decline_rank(int(sys.argv[2]), int(sys.argv[3]))
