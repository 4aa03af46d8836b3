#!/usr/bin/env python3
"""Smoke run of brpc_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each:

1. card and build: the card's name and power limit (nvidia-smi), torch
   and CUDA versions, and the build of the three CUDA libraries from the
   checkout's sources (nvcc, sm_90a, one process each, started together):
   ``flash_decode``, ``flash_attn_fwd_tc`` and ``flash_attn_fwd``, with
   each one's build time and ptxas lines, and the count of HGMMA (wgmma)
   instructions in ``flash_attn_fwd_tc``'s SASS, which must not be 0;
2. kernel check: every kernel against its plain PyTorch version, both on
   the card, at the serving shape, a split decode cache, and long,
   ragged and sq != sk shapes, in fp32, fp16 and bf16: fp32 within
   FP32_TOL, fp16/bf16 element by element within ``_rounding_bound``
   (the error the kernel's own roundings explain), and four controls, a
   split decode with one split dropped and bf16 (d 64, d 32) and fp32
   attention with their last 64 keys dropped, that these bounds must
   reject; each case names the kernel ``_plan`` chose and checks that it
   was the one launched. ``flash_attn_fwd_tc`` takes every 16-bit head
   dim: it is held at one tile (sq 64 x sk 64 at d 16 and 32), inside
   one tile (sq 16 x sk 40) and at ragged, causal and sq != sk shapes.
   ``flash_attn_fwd`` is also held at its 64-row block's edges (sq < 64,
   sq and sk off the tile sizes, head dims 16/32/128, causal with sq !=
   sk), in bf16 at d 32 and fp16 at d 16 through ``_launch_tile`` (the
   ``ms_simt`` of phase 5), and with a per-head device ``q_offset``
   (lengths 0, 1, L and between, ``q_offset_add`` -1);
3. serving (the main path): a port Server on tcp://127.0.0.1:0 with the
   default GenerateService on cuda:0 answers a burst of 16 unary
   Generate calls from 8 client threads; every token list must equal the
   plain CPU path's ``TinyDecoder.generate``, and ``flash_decode``'s
   launch count, zeroed just before the server starts and read just
   after the burst, must equal the engine's decode steps plus its
   warm-up step. The same burst then runs warm, and once more under the
   profiler for the device's busy share and its time by kernel. Decode
   runs on the server's fiber workers (the engine is a WorkerModule):
   in every burst the steps counted by worker group must sum to the
   burst's decode steps, and no ``serving-decode`` thread,
   ``rpc-handler`` pool, or reader, writer or accept thread may exist.
   The transport reads on one event dispatcher: while a client process
   holds 8 connections open (``--client hold``), the server's process
   must have no thread per connection and the threads it had with none
   open, give or take the fixed ones (``FIXED_THREADS``); each burst
   reports the steps by
   group, the worker threads used, the decode lock's misses, the
   control's concurrency, ``os.cpu_count()`` and the scheduler's
   ``saturation_snapshot()``;
   then the two other paths, each with the counts zeroed just before and
   read just after: long-context attention (``flash_attention`` at 8
   heads x 2048 x 64, bf16 and fp32, and x 32 bf16, causal and not) and
   a long-cache decode step (``decode_attention`` at B 4, L 4096, d 128,
   bf16, split);
4. streaming (the main path since the stream and HTTP transports): a
   fresh default server on cuda:0, launch counts zeroed before each part
   and read after it, each part's ``flash_decode`` launches equal to its
   decode steps (plus the warm-up in the first) and no other kernel: (a)
   the burst with every call attaching a Stream, cold then warm, every
   token list and ``d`` frame equal to the CPU plain path; (b) the same
   burst over HTTP chunked transfer (``http.client``), footer
   ``completed n=32``; (c) one 120-token stream whose first token lands
   before half its last token's time, an HTTP peer that dies after its
   first chunk, whose slot must be freed within 5 s before a following
   request completes, and one stream burst under the profiler. Client-side
   time to first token and gaps between tokens, per transport, and the
   bursts' tokens/s; the fiber fields and checks of phase 3 for every
   burst, and each decode step's time with the prompts it admitted
   (prefilled) and the host time of its prefills and its model step:
   the median and p99 of steps that admitted none and of steps that
   admitted some, the phase's first steps, and each worker thread's
   first step, to show whether a worker's first step costs more than
   its kind's median;
5. kernel times: device times of each kernel, its plain version and one
   PyTorch call (``scaled_dot_product_attention``, a yardstick the port
   never calls), from CUDA events and from the profiler, beside the bound
   from bytes and operations, and, in the same run, the CUDA-core tile
   kernel (``flash_attn_fwd`` through ``_launch_tile``) on the same
   inputs as ``ms_simt`` where another kernel serves the call (decode,
   and every 16-bit row); ``flash_attn_fwd_tc`` at 8 x 2048 x 16 fp16,
   x 32, x 64 and x 128 bf16 and 32 x 2048 x 64 bf16, ``flash_attn_fwd``
   at 8 x 2048 x 64 and x 128 fp32, causal and not. Each long case also
   gives, on its kernel_times line only, ``mufu_ms``: its exponentials
   at the special-function rate, worked out and not measured.

After phase 4, the phase ``observability``: a fresh default server on
cuda:0 with the ``rpcz_enabled`` flag on; one warm burst of each kind
(stream, HTTP, unary; phase 4's sizes) from client processes that trace
too (``--client KIND PORT --rpcz``), then the pages ``/rpcz``,
``/serving``, ``/status``, ``/vars`` and ``/brpc_metrics``. Every
tpu_std call has one client span and one server span of its trace whose
parent is the client span; every call has one serving span, whose four
stages sum to its latency; ``/serving`` counts every call; ``/vars``
lists the fiber variables and ``fiber_wake``; every Prometheus line
parses; tokens equal the CPU plain path's; ``flash_decode`` runs once a
decode step and no other kernel runs. It prints, per transport, the
median and p99 of each call's stages on the wall clock that both
processes share (``STAGES``: client issue -> server arrival -> handler
-> admitted -> prefilled -> first token -> the client's first frame)
and their sum beside the client's TTFT, then the warm stream burst in
turns with ``serving_stats_enabled`` and ``rpcz_enabled`` off and on.

After ``observability``, the phase ``device_lane``: tensors in RPCs on
the three device lanes, each part with the launch counts zeroed just
before and read just after it. (a) A port Server on
``cuda://smoke:1#device=0`` with ``Perf.Echo`` (response tensors = request
tensors) answers fp32 tensors of 4 B to 4 MiB in x4 steps (the sizes of
examples/tpu_performance/main.py), 3 warm-up and 30 timed calls each:
every echo equal and the same memory (``data_ptr``), p50/p99 us and
GB/s (2 x bytes per echo). (b) The same sweep from a client process
(``--client device_lane PORT``) to a ``cudad://127.0.0.1:0#device=0``
server: the handler sees ``cuda:0`` tensors, every echo equal; with the
dispatcher's ``dispatcher_stall_ms_max_10s`` and, at 1 and 4 MiB, the
time of each batch landing on the card (in parse, on the dispatcher)
and of each response's host copy (on a fiber worker). (c) One send of a
tensor filled on a fresh stream behind a device sleep: the handler must
read the filled values. (d) ``Attend`` on both lanes, 4 calls at once,
each on a connection of its own (on one connection a request is read
only after the handler of the one before has finished):
q [4, 128], K/V [4, 4096, 128] bf16 and lengths 0/1/4096/3000 ride the
lane, the async handler waits until all 4 calls have arrived (parked
on a Future, so that the 4 parks below overlap however far apart the
requests came in), runs ``decode_attention``, parks on a CUDA event
(``device_ready``) and returns O as a response tensor; each call
launches ``flash_decode`` and ``flash_decode_combine`` once and nothing
else, O is within ``_rounding_bound`` of the plain version computed from
the client's tensors, every handler resumed on a fiber worker after its
event completed, and the poller's waiter threads never outnumbered the
calls in flight; a thread waiting in ``Event.synchronize`` must not hold
the interpreter lock. (e) A stream of 16 tensor frames of 64 KiB from
the server beside unary device calls on the same connection, on both
lanes: every frame and every response pairs with its own tensor.
(f) The sweep on ``ici://127.0.0.1:0#device=0`` from a client process
run with ``BRPC_TPU_TORCH_ICI_REQUIRE_PULL=1`` (``--client ici``, a
session of steps, the next on the server's go): lane ``cuda-ipc`` on
both sides (one card: a same-device CUDA IPC hand-off between two
processes, not a link), every echo equal, the handler's tensors on
``cuda:0``, no kernel launched, no staged batch and every cell balanced
on both sides, the first call timed apart, a send filled on a side
stream read whole, then ICI_CYCLES connect/echo/close cycles after
which both processes' allocated bytes on the card and their mappings
of the peer's memory are back where they were; with the server's takes
(on the dispatcher), its IPC opens and closes, and the dispatcher's
longest tick. (g) ``Attend`` as in (d), its 4 calls from the ici client
process. (h) With rpcz on, a short sweep (SHORT_SWEEP_BYTES) on each
lane, the server's spans read from ``/rpcz`` of an admin server in this
process and the client's from its line: each lane's write side (stage,
wire, ack) and receive side (``device-recv``) beside its echo p50; on
``ici://`` every device span's stage + wire + ack equals its latency
and its stage is at most its size's slowest echo; ``/device`` has a
cell for every lane, ``transfer_lane: up``, the recv pool and the leak
pane; then ``device_stats_enabled`` off and on in turns on ``ici://``
at 64 KiB.

After ``device_lane``, the phase ``combo``: combo channels, the async
client and mesh collectives on the card, each part with the launch
counts zeroed just before and read just after it. (a) BASELINE's
"ParallelChannel 8-shard tensor allreduce", shaped as
examples/parallel_allreduce/main.py: 8 port servers on
``cuda://combo-<i>:1#device=0`` serve ``Reduce.Sum`` (the sum of the
shard on the card, returned as a response tensor); a ParallelChannel
whose mapper gives sub i row i of a [8, dim/8] fp32 request on cuda:0,
and whose merger sums the responses on the card, at dim 2^16 and 2^20
(256 KiB and 4 MiB), three ways: ``call_sync``, ``call(done=)`` and
``call_async`` awaited in a fiber; every sum within FP32_TOL (relative)
of the host's, p50/p99 ms of each; no kernel launched. (b) The same
calls through a ParallelChannel lowered by ``attach_collective`` onto a
``CollectiveChannel`` (merge "sum") over ``make_rpc_mesh(1, 8,
devices=[cuda:0] * 8)``: ``collective_fused`` up by one a call,
``collective_fallbacks`` 0, the same sums, p50/p99. (c) Nested async
calls: an async handler fans ``Attend`` out by head (PR 10's case: q [4,
128], K/V [4, 4096, 128] bf16, lengths 0/1/4096/3000) through a
PartitionChannel of 4 ``cuda://`` servers and awaits ``call_async``:
each partition call launches ``flash_decode`` and
``flash_decode_combine`` once (a split decode) and nothing else, the
merged O is within ``_rounding_bound`` of the plain version, every
sub-call's meta ``timeout_ms`` is at most the handler's remaining budget,
and a handler whose budget is spent gets ERPCTIMEDOUT from a nested call
that reaches no server. (d) ``ring_attention`` and ``ulysses_attention``
on an 8-shard mesh on cuda:0 at 8 heads x 2048 x 64 fp32, causal and
not, within FP32_TOL of ``flash_attention`` (which launches
``flash_attn_fwd``), with the wall ms of each beside that call's.

Phase cluster (the cluster client, overload control, auth and
compression): three
GenerateService replicas, each a port Server on tcp with its own engine
on cuda:0 at phase 3's width, behind one ``ClusterChannel`` ("la", a
retry budget), launch counts zeroed before each part and read after it,
``flash_decode``'s equal to the replicas' decode steps and warm-ups,
every token list equal to the CPU plain path's, no call failed. (a) 48
unary Generate calls from 8 threads: each replica serves; beside them
phase 3's burst (a Channel a thread) at one replica, and calls one at a
time through the ClusterChannel and a plain Channel in turns (the
cluster layer's cost: the pick, the stats, the feedback), with each
replica's tokens a step. (b) Replica 0 restarted with
``max_concurrency=2`` and 2 waiting, 16 threads: it sheds
(``server_limit_shed`` or the engine's sheds), calls retry elsewhere
(``retried_count``), the retry budget keeps its tokens, and the
balancer takes no latency sample from a reject. (c) Replica 1 killed
(its connections dropped, then stopped) 150 ms into a burst: the calls
it held retry elsewhere (``tried_servers``), the health checker marks it
dead, ``/backends`` and the breaker snapshot show it; the time from the
kill to the last retried call's end; then it restarts on its port, is
revived, and serves. (d) The ``Attend`` of phase device_lane (a split
decode and its combine) on two ``cuda://`` servers, one 50 ms slow,
through a ClusterChannel ("rr", ``backup_request_ms=5``): every call
first sent to the slow server used a backup and was answered by the
fast one, each ``done`` ran once, the late answers were dropped, no
attempt is left in flight and the backend cells count each call once,
O within ``_rounding_bound``, p50 within 10 ms of the fast server's
called directly. (e) Replica 2 restarted with a ``TokenAuthenticator``;
a second ClusterChannel sends the token and every request with
``compress_type`` 3 (snappy): every token list right, replica 2 serves,
every request reaches its handler compressed (the server's
``cntl.compress_type``) and every response comes back so (its meta's
``compress_type``); a ClusterChannel with a wrong token to replica 2
gets ERPCAUTH on every call, none retried. p50/p99 of every part.

Phase incident (trend rings, the anomaly watchdog, the flight
recorder, capture and incidents), after cluster, at phase 3's width:
launch counts zeroed before each part and read after it,
``flash_decode``'s equal to the part's decode steps and warm-ups, every
token list equal to the CPU plain path's. (a) Phase 3's burst on a
default server with the rings on and the recorder at 20 Hz: the
one-second ring of ``/timeline?name=server_processed`` sums to the
calls served, ``/vars?series=serving_ttft_p99_us`` has buckets, and
``/hotspots?mode=continuous`` gives busy samples to
``rpc:GenerateService.Generate``; the busy share by label and the top
folded stacks. (b) An on-demand ``/hotspots`` profile at 1 ms while 32
fresh Channels of this process each make their first unary Generate
call, one after another (one profile holds both sides of the
connection): the first calls' p50/p99 beside 8 later calls on one
Channel, and the profile's top 15 self and cumulative frames. (c) A
server at ``max_concurrency=2`` with ``anomaly_watch_filter=
server_limit_shed``, 3 warm-up and 3 close ticks, incident capture on
into a temporary ``incident_dir`` and a 3-tick window: calm calls over
the warm-up ticks (the bvar sampler's own, once a second), then 24
concurrent Generate calls: incident #1 opens on ``server_limit_shed``,
4 calls made inside the window are captured, the artifact appears on
``/incidents`` and downloads byte for byte, the port's reader finds in
it the incident document and the in-window requests with their
prompts, rpcz spans carry ``incident #1``, a continuous-profile window
is labelled, the incident closes, and ``/census`` lists every
registered provider; the times from the first shed to the open and from
the close to the artifact. (d) Phase 3's burst in turns, 3 pairs: the
recorder at 20 Hz with the rings on against both off, then capture at
rate 1.0 against capture off; p50/p99 and tokens/s of each.

``python3 chip_smoke.py --phase streaming`` (or ``--phase
observability``, ``--phase device_lane``, ``--phase combo``, ``--phase
cluster``, ``--phase incident``) runs that phase alone (after the card
line), so that two trees' serving can be compared in one call: run each
tree's script in turns.

The last lines are the card line, the kernels line and the result line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without the
result line. Without CUDA, or without the package beside it, it fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "fp16": 989e12}
# H100 SXM special-function (exp2) rate: 3.9e12/s (Shah et al. 2024,
# the FlashAttention-3 paper); attention takes one exponential a score
MUFU_PER_S = 3.9e12
FP32_TOL = 1e-4        # fp16/bf16: _rounding_bound, element by element
N_CLIENTS = 8
N_REQUESTS = 16
MAX_TOKENS = 32


def _prompts():
    return [f"request {i:02d}: {'the quick brown fox '[: 3 + i]}"
            for i in range(N_REQUESTS)]


def _fa_module():
    # the ops package exports the flash_attention function under the
    # submodule's name, so the module is fetched by its full name
    import importlib
    return importlib.import_module("brpc_tpu_torch.ops.flash_attention")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(what: str) -> None:
    """A line on stderr as a part starts: where a hang sits."""
    print(f"chip_smoke: {time.strftime('%H:%M:%S')} {what}",
          file=sys.stderr, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 5):
    """(device ms per call, host ms per call). The device time comes from
    CUDA events around ``iters`` back-to-back calls queued behind a
    device-side sleep, so that the host's enqueue cost (Python, ctypes)
    is hidden and the events see the launches run one after another."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup
    # at most 2 GHz: a slower clock only sleeps longer, which is safe
    cycles = int(min(2.0, host_s * iters * 1.5 + 0.002) * 2e9)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3


def profiled_device_ms(fn, iters: int) -> float:
    """Device time per call from the profiler: the summed durations of the
    device activities (kernels, copies) that ``iters`` calls ran, so a
    host-side stall between launches does not count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if "CUDA" in str(getattr(e, "device_type", "")))
    return total / 1e3 / iters


# ------------------------------------------------------------- phase 1

KERNELS = {
    # kernel -> (library, source)
    "flash_decode": ("flash_decode", "brpc_tpu_torch/ops/csrc/flash_decode.cu"),
    "flash_decode_combine": ("flash_decode",
                             "brpc_tpu_torch/ops/csrc/flash_decode.cu"),
    "flash_attn_fwd_tc": ("flash_attention_tc",
                          "brpc_tpu_torch/ops/csrc/flash_attention_tc.cu"),
    "flash_attn_fwd": ("flash_attention",
                       "brpc_tpu_torch/ops/csrc/flash_attention.cu"),
}
REPLACES = "brpc_tpu/ops/flash_attention.py:104"


def _sass_count(lib_path: str, opcode: str) -> int:
    from brpc_tpu_torch.ops import _build
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", lib_path],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    return sum(opcode in line for line in out.stdout.splitlines())


def phase_build():
    import torch

    from brpc_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build_all()
    wall = time.monotonic() - t0
    for name, (source, fns) in _build.LIBRARIES.items():
        info = _build.build_info[name]
        emit({"phase": "build", "library": name, "functions": sorted(fns),
              "source": f"brpc_tpu_torch/ops/csrc/{source}",
              "build_s": info["build_s"], "cached": info["cached"],
              "ptxas": info["ptxas"].splitlines()})
    hgmma = _sass_count(_build.build_info["flash_attention_tc"]["path"],
                        "HGMMA")
    emit({"phase": "build", "wall_s": wall, "parallel": True,
          "flash_attn_fwd_tc_hgmma_sass_lines": hgmma,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    check(hgmma > 0, "flash_attn_fwd_tc's SASS has no HGMMA instruction")


# ------------------------------------------------------------- phase 2

def _rand(rng, shape, dtype, dev):
    import torch
    return torch.from_numpy(rng.randn(*shape).astype("float32")).to(
        dev).to(dtype)


def _launched(fa, before):
    """The kernels whose launch counts grew since ``before``."""
    return sorted(n for n, c in fa.launches.items() if c > before[n])


def phase_kernel_check(dev):
    """Each case: a kernel (through the public wrapper) against the plain
    version on the same inputs, on the card. fp32 cases hold the largest
    difference to FP32_TOL; fp16/bf16 cases hold every element to
    ``_rounding_bound``, the error the kernel's own roundings explain, and
    two controls show that bound rejects a dropped split and a dropped K
    tile. Returns the serving-shape and split-decode inputs (for phase 5)
    and the largest error seen by each kernel."""
    import numpy as np
    import torch

    fa = _fa_module()

    rng = np.random.RandomState(20260803)
    results = []
    errs = {name: 0.0 for name in KERNELS}

    def record(case, kernels, got, want, bound):
        """``bound``: FP32_TOL, or a tensor of per-element limits."""
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if isinstance(bound, float):
            ok = bool(np.isfinite(err) and err <= bound)
            extra = {"tol": bound}
        else:
            worst = float((diff / bound).max())
            ok = bool(np.isfinite(worst) and worst <= 1.0)
            extra = {"worst_over_bound": worst,
                     "bound_at_worst": float(bound.flatten()[
                         int((diff / bound).argmax())])}
        results.append(ok)
        for name in kernels:
            errs[name] = max(errs[name], err)
        emit({"phase": "kernel_check", "case": case, "kernels": kernels,
              "max_abs_err": err, **extra, "ok": ok})
        return err

    def control(case, wrong, want, bound):
        """A deliberately wrong answer the check must reject."""
        worst = float(((wrong - want).abs() / bound).max())
        emit({"phase": "kernel_check", "case": f"control: {case}",
              "worst_over_bound": worst, "rejected": worst > 1.0})
        results.append(worst > 1.0)

    def decode_case(name, b, L, d, dtype, lengths):
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = _rand(rng, (b, d), dtype, dev)
        k = _rand(rng, (b, L, d), dtype, dev)
        v = _rand(rng, (b, L, d), dtype, dev)
        plan = fa._plan("decode", dev, dtype, d, bh=b, sk=L)
        before = dict(fa.launches)
        got = fa.decode_attention(q, k, v, lengths, block_k=64)
        launched = _launched(fa, before)
        want = fa._flash_plain(q[:, None].float(), k.float(), v.float(),
                               d ** -0.5, True, 64,
                               q_offset=lengths - 1)[:, 0]
        want_kernels = ["flash_decode"] + (["flash_decode_combine"]
                                           if plan.splits > 1 else [])
        check(launched == sorted(want_kernels),
              f"{name}: launched {launched}, planned {want_kernels}")
        bound = (FP32_TOL if dtype == torch.float32
                 else fa._rounding_bound(want, dtype))
        err = record(f"{name} (splits {plan.splits})", launched, got, want,
                     bound)
        check(got.dtype == dtype and not got[lengths == 0].any().item(),
              f"{name}: a length-0 slot must give zeros in q's dtype")
        return (q, k, v, lengths, plan), err, want, bound

    # the serving shape: 8 slots, 160-row fp32 cache, d 32: one launch
    decode_inputs, errs["serving_decode"], _, _ = decode_case(
        "decode B8 L160 d32 fp32 lengths 0/1/160", 8, 160, 32, torch.float32,
        [0, 1, 160, 37, 80, 5, 159, 100])
    check(decode_inputs[4].splits == 1, "the serving shape must not split")
    # a long cache over few sequences: split over blocks, then combined
    split_inputs, errs["split_decode"], want, bound = decode_case(
        "decode B4 L4096 d128 bf16 lengths 0/1/4096/3000", 4, 4096, 128,
        torch.bfloat16, [0, 1, 4096, 3000])
    q, k, v, lengths, plan = split_inputs
    check(plan.splits > 1, "the long cache must split")
    m, l, o = fa._decode_partials_plain(q, k, v, lengths, 128 ** -0.5,
                                        plan.splits, plan.chunk)
    l[:, plan.splits // 2] = 0.0
    control(f"split decode without split {plan.splits // 2} of "
            f"{plan.splits}",
            fa._decode_combine_plain(m, l, o, torch.float32), want, bound)
    # the combine pass alone, on the first pass's own partials
    ml, o_part = fa._launch_decode(q, k, v, lengths, 128 ** -0.5, plan)
    got = fa._launch_combine(ml, o_part, torch.empty_like(q))
    want = fa._decode_combine_plain(ml[..., 0], ml[..., 1], o_part,
                                    torch.float32)
    record("combine B4 splits %d d128 bf16" % plan.splits,
           ["flash_decode_combine"], got, want,
           fa._rounding_bound(want, q.dtype))

    # flash_attn_fwd with a per-head device q_offset, as decode_attention
    # used it before flash_decode: row r of head b at lengths[b] - 1 + r
    for name, (bh, sq, sk, d), lens in (
            ("q_offset sq1 sk160 d32 fp32 lengths 0/1/160",
             (8, 1, 160, 32), [0, 1, 160, 37, 80, 5, 159, 100]),
            ("q_offset sq100 sk300 d64 fp32 lengths 0/1/300",
             (8, 100, 300, 64), [0, 1, 300, 37, 150, 299, 64, 200])):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = _rand(rng, (bh, sq, d), torch.float32, dev)
        k = _rand(rng, (bh, sk, d), torch.float32, dev)
        v = _rand(rng, (bh, sk, d), torch.float32, dev)
        before = dict(fa.launches)
        got = fa._launch_tile("flash_attn_fwd", q, k, v, d ** -0.5, True,
                              q_offset=lengths, q_offset_add=-1)
        launched = _launched(fa, before)
        check(launched == ["flash_attn_fwd"], f"{name}: launched {launched}")
        want = fa._flash_plain(q, k, v, d ** -0.5, True, 64,
                               q_offset=lengths - 1)
        record(name, launched, got, want, FP32_TOL)
        check(not got[lengths == 0, 0].any().item(),
              f"{name}: row 0 of a length-0 head must be zeros")

    cases = [
        # (name, shape q, sk, dtype, causal, block_k)
        ("8x2048x64 fp32", (8, 2048, 64), 2048, torch.float32, False, 128),
        ("8x2048x64 fp32 causal", (8, 2048, 64), 2048, torch.float32, True,
         128),
        ("8x2048x64 bf16", (8, 2048, 64), 2048, torch.bfloat16, False, 128),
        ("8x2048x64 bf16 causal", (8, 2048, 64), 2048, torch.bfloat16, True,
         128),
        ("8x2048x64 fp16 causal", (8, 2048, 64), 2048, torch.float16, True,
         128),
        ("ragged 4x1000x64 block 128 causal", (4, 1000, 64), 1000,
         torch.float32, True, 128),
        ("sq16 sk40 d32 causal", (2, 16, 32), 40, torch.float32, True, 128),
        ("2x300x16 fp32 causal", (2, 300, 16), 300, torch.float32, True,
         128),
        ("2x300x128 bf16", (2, 300, 128), 300, torch.bfloat16, False, 128),
        ("sq16 sk40 d64 bf16 causal", (16, 16, 64), 40, torch.bfloat16,
         True, 128),
        ("ragged 2x1000x128 fp16 causal", (2, 1000, 128), 1000,
         torch.float16, True, 128),
        # flash_attn_fwd at its tile edges: 64-row blocks, 64-key tiles
        # (32 at d 128)
        ("sq50 sk50 d64 fp32", (3, 50, 64), 50, torch.float32, False, 64),
        ("sq130 sk97 d64 fp32 causal", (2, 130, 64), 97, torch.float32,
         True, 64),
        ("sq70 sk200 d128 fp32 causal", (2, 70, 128), 200, torch.float32,
         True, 64),
        ("sq200 sk161 d128 fp32", (2, 200, 128), 161, torch.float32, False,
         64),
        ("sq100 sk77 d32 fp32 causal", (3, 100, 32), 77, torch.float32, True,
         64),
        ("sq65 sk129 d16 fp32", (2, 65, 16), 129, torch.float32, False, 64),
        # 16-bit inputs at head dim 16/32 (flash_attn_fwd_tc; flash_attn_fwd
        # is held on them below, through _launch_tile)
        ("4x257x32 bf16", (4, 257, 32), 257, torch.bfloat16, False, 64),
        ("4x257x32 bf16 causal", (4, 257, 32), 257, torch.bfloat16, True,
         64),
        ("3x190x16 fp16", (3, 190, 16), 190, torch.float16, False, 64),
        ("3x190x16 fp16 causal", (3, 190, 16), 190, torch.float16, True, 64),
        # one tile, and the ragged edge inside one tile, at d 16/32
        ("sq64 sk64 d16 bf16", (2, 64, 16), 64, torch.bfloat16, False, 64),
        ("sq64 sk64 d32 fp16 causal", (2, 64, 32), 64, torch.float16, True,
         64),
        ("sq16 sk40 d32 bf16 causal", (3, 16, 32), 40, torch.bfloat16, True,
         64),
        ("8x2048x32 bf16", (8, 2048, 32), 2048, torch.bfloat16, False, 128),
    ]
    simt_16bit = ("4x257x32 bf16", "4x257x32 bf16 causal", "3x190x16 fp16",
                  "3x190x16 fp16 causal")
    for name, qshape, sk, dtype, causal, block_k in cases:
        kshape = qshape[:-2] + (sk, qshape[-1])
        q = _rand(rng, qshape, dtype, dev)
        k = _rand(rng, kshape, dtype, dev)
        v = _rand(rng, kshape, dtype, dev)
        scale = qshape[-1] ** -0.5
        plan = fa._plan("attention", dev, dtype, qshape[-1])
        before = dict(fa.launches)
        got = fa.flash_attention(q, k, v, causal=causal, block_k=block_k)
        launched = _launched(fa, before)
        check(launched == [plan.kernel],
              f"{name}: launched {launched}, planned {plan.kernel}")
        check(got.dtype == dtype and got.shape == q.shape,
              f"{name}: output {got.dtype} {tuple(got.shape)}")
        qf, kf, vf = q.float(), k.float(), v.float()
        want = fa._flash_plain(qf, kf, vf, scale, causal, block_k)
        if dtype == torch.float32:
            bound = FP32_TOL
        else:
            # flash_attn_fwd_tc rounds P before P V; the SIMT kernel not
            pv_abs = (fa._flash_plain(qf, kf, vf.abs(), scale, causal,
                                      block_k)
                      if plan.kernel == "flash_attn_fwd_tc" else None)
            bound = fa._rounding_bound(want, dtype, pv_abs)
        record(name, launched, got, want, bound)
        if name in simt_16bit:
            # flash_attn_fwd on the same inputs: it rounds only its output
            before = dict(fa.launches)
            got = fa._launch_tile("flash_attn_fwd", q, k, v, scale, causal)
            launched = _launched(fa, before)
            check(launched == ["flash_attn_fwd"],
                  f"{name} via _launch_tile: launched {launched}")
            record(f"{name} via _launch_tile", launched, got, want,
                   fa._rounding_bound(want, dtype))
        if name in ("8x2048x64 bf16", "8x2048x32 bf16", "8x2048x64 fp32"):
            control(f"{name} without its last 64 keys",
                    fa._flash_plain(qf, kf[:, :-64], vf[:, :-64], scale,
                                    causal, block_k), want, bound)
    torch.cuda.synchronize()
    check(all(results), "a kernel disagrees with its plain version, or a "
                        "control passed the check")
    return decode_inputs[:4], split_inputs, errs


# ------------------------------------------------------------- phase 3

def _real_us() -> int:
    """The wall clock in microseconds: the axis that spans of two
    processes share (``base_real_us``)."""
    return time.time_ns() // 1000


def _burst(port: int, prompts, max_tokens: int, calls=None):
    """N_CLIENTS threads, one Channel each, the prompts dealt round-robin;
    returns ({prompt: tokens}, [(prompt, errno, text)], wall seconds,
    [client ms per call: the first token comes with the last], []).
    ``calls``: a list that gets each call's trace id and its wall-clock
    issue and response times."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions

    results, errors, latency = {}, [], []

    def client(idx):
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=120000))
        try:
            for seq, p in enumerate(prompts[idx::N_CLIENTS]):
                t0, issue = time.perf_counter(), _real_us()
                c = ch.call_sync("GenerateService", "Generate",
                                 json.dumps({"prompt": p,
                                             "max_tokens": max_tokens}
                                            ).encode())
                if c.failed():
                    errors.append((p, c.error_code, c.error_text))
                else:
                    latency.append((time.perf_counter() - t0) * 1e3)
                    results[p] = json.loads(c.response)["tokens"]
                    if calls is not None:
                        calls.append({"prompt": p, "seq": seq,
                                      "trace_id": c.trace_id,
                                      "issue_real_us": issue,
                                      "first_real_us": _real_us()})
        finally:
            ch.close()

    return results, errors, _run_clients(client), latency, []


def _check_burst(name, results, errors, oracle):
    check(not errors, f"{name}: failed calls: {errors[:3]}")
    check(len(results) == len(oracle), f"{name}: {len(results)} responses")
    wrong = [p for p in oracle if results[p] != oracle[p]]
    check(not wrong, f"{name}: tokens differ from the CPU plain path for "
                     f"{wrong}")


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2] if s else None


def _p99(xs):
    s = sorted(xs)
    return s[min(len(s) - 1, int(0.99 * len(s)))] if s else None


# threads that exist once per process however many connections are open
FIXED_THREADS = {"event_dispatcher", "fiber_timer", "bvar_sampler"}


def _per_connection_threads(names) -> list:
    return [n for n in names if n.endswith(("-reader", "-writer"))
            or n == "tcp-accept"]


def _check_no_decode_thread() -> None:
    """No decode thread, no handler pool, and no thread per connection
    (the transport reads on the one event dispatcher)."""
    names = [t.name for t in threading.enumerate()]
    check("serving-decode" not in names and
          not any(n.startswith("rpc-handler") for n in names),
          f"a decode thread or handler pool exists: {sorted(names)}")
    check(not _per_connection_threads(names),
          f"a reader, writer or accept thread exists: {sorted(names)}")


def _check_no_thread_per_connection(server, port: int) -> dict:
    """A client process opens N_CLIENTS connections to ``server`` and
    holds them open (``--client hold``); meanwhile this process, the
    server's, must have no reader, writer or accept thread, and the same
    threads as with no client connected, give or take the fixed ones."""
    from collections import Counter
    idle = Counter(t.name for t in threading.enumerate())
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--client", "hold",
         str(port)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()       # "" once the client has died
    if line.strip():
        held = json.loads(line)["connections"]
        open_now = len(server.connections())
        names = Counter(t.name for t in threading.enumerate())
    try:
        _, err = proc.communicate("\n", timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
    check(line.strip() != "" and proc.returncode == 0,
          f"hold client exited {proc.returncode}: {err[-2000:]}")
    check(open_now >= held == N_CLIENTS,
          f"{open_now} server connections while the client held {held}")
    check(not _per_connection_threads(names),
          f"per-connection threads with {held} connections open: "
          f"{sorted(names)}")
    extra = names - idle
    check(set(extra) <= FIXED_THREADS,
          f"{held} connections open added threads {dict(extra)}")
    return {"connections": open_now, "threads_idle": sum(idle.values()),
            "threads_held": sum(names.values()), "added": dict(extra)}


class _FiberBurst:
    """Reads the fiber fields of one burst: steps by worker group (their
    sum must equal the burst's decode steps), the engine's worker
    threads and decode-lock misses, and the scheduler's counters over
    the burst (the snapshot taken at the start opens the interval)."""

    def __init__(self, server, gs):
        self.server, self.gs = server, gs
        self.groups0 = dict(gs.batcher.steps_by_group)
        self.steps0 = gs.batcher.decode_steps
        self.contended0 = gs.engine.contended
        server.control.saturation_snapshot()

    def finish(self, name: str) -> dict:
        gs = self.gs
        groups = {g: n - self.groups0.get(g, 0)
                  for g, n in sorted(gs.batcher.steps_by_group.items())
                  if n - self.groups0.get(g, 0)}
        steps = gs.batcher.decode_steps - self.steps0
        check(sum(groups.values()) == steps > 0,
              f"{name}: steps by worker group {groups} do not sum to the "
              f"burst's {steps} decode steps")
        _check_no_decode_thread()
        return {"steps_by_group": groups,
                "worker_threads_used": len(gs.engine.threads_seen),
                "decode_lock_contended": gs.engine.contended
                - self.contended0,
                "concurrency": self.server.control.concurrency,
                "cpu_count": os.cpu_count(),
                "saturation": self.server.control.saturation_snapshot()}


def _device_profile(events, window_us: float):
    """Device busy share and kernel time by name from profiler events:
    the union of device intervals over the host window."""
    spans, by_name = [], {}
    for e in events:
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        tr = e.time_range
        spans.append((tr.start, tr.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (tr.end - tr.start)
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_events": len(spans),
            "device_busy_us": busy if spans else None,
            "device_busy_share": busy / window_us if spans else None,
            "top_device_us": [[n[:90], t] for n, t in top]}


def phase_serving():
    import torch
    from torch.profiler import ProfilerActivity, profile

    fa = _fa_module()
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)

    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}

    # the main path: counts to zero, server start (its warm-up step
    # launches flash_decode once), one burst, counts read just after
    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)           # defaults, on cuda:0
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    ep = server.start("tcp://127.0.0.1:0")
    try:
        fb = _FiberBurst(server, gs)
        results, errors, wall = _burst(ep.port, prompts, MAX_TOKENS)[:3]
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        fibers1 = fb.finish("burst 1")
        steps = gs.batcher.decode_steps
        warm = gs.engine.warmup_steps
        hist = dict(gs.batcher.batch_hist)
        ttft_first = gs.ttft_samples()
        _check_burst("burst 1", results, errors, oracle)
        # the serving shape takes one flash_decode launch a step, and no
        # combine pass (one split)
        check(launches["flash_decode"] == steps + warm and
              sum(launches.values()) == launches["flash_decode"],
              f"kernel launches {launches} != decode steps {steps} + "
              f"warm-up {warm} of flash_decode alone")
        check(launches["flash_decode"] > 0, "flash_decode was never launched")
        held = _check_no_thread_per_connection(server, ep.port)
        # the same burst again, warm, then once more under the profiler
        fb = _FiberBurst(server, gs)
        results2, errors2, wall2 = _burst(ep.port, prompts, MAX_TOKENS)[:3]
        _check_burst("burst 2", results2, errors2, oracle)
        fibers2 = fb.finish("burst 2")
        ttft_warm = gs.ttft_samples()[len(ttft_first):]
        steps2 = gs.batcher.decode_steps - steps
        fb = _FiberBurst(server, gs)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            results3, errors3, _ = _burst(ep.port, prompts, MAX_TOKENS)[:3]
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        _check_burst("burst 3 (profiled)", results3, errors3, oracle)
        fb.finish("burst 3 (profiled)")
    finally:
        server.stop()
        server.join(10)
    tokens = sum(len(t) for t in results.values())
    out = {"phase": "serving", "requests": N_REQUESTS, "clients": N_CLIENTS,
           "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_p50_ms": _median(ttft_first), "ttft_p99_ms": _p99(ttft_first),
           "decode_steps": steps, "warmup_steps": warm,
           "kernel_launches": launches,
           "batch_size_hist": hist, "tokens_equal_cpu_plain": True,
           "warm_wall_s": wall2, "warm_tokens_per_s": tokens / wall2,
           "warm_ttft_p50_ms": _median(ttft_warm),
           "warm_ttft_p99_ms": _p99(ttft_warm), "warm_decode_steps": steps2,
           "warm_ms_per_step": wall2 * 1e3 / steps2,
           "fibers": fibers1, "warm_fibers": fibers2,
           "held_connections": held}
    emit(out)
    trace = {"phase": "serving_trace", "window_us": window_us}
    trace.update(_device_profile(prof.events(), window_us))
    emit(trace)
    return out


# ------------------------------------------------------------- phase 4

def _stream_burst(port: int, prompts, max_tokens: int, calls=None):
    """The burst of ``_burst`` with every call streaming its tokens back
    (``stream_options``). Returns ({prompt: tokens}, [errors], wall s,
    [client ms to the first token], [ms between tokens]); ``calls`` as
    in ``_burst``, the first token frame's arrival as the response."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, StreamOptions

    results, errors, ttft, gaps = {}, [], [], []
    want_done = b'd{"n": %d, "status": "completed"}' % max_tokens

    def one(ch, p, seq):
        toks, times, verdict, first_real = [], [], [], []
        done = threading.Event()

        def on_received(stream, msg):
            if msg.payload[:1] == b"t":
                if not toks:
                    first_real.append(_real_us())
                toks.append(msg.payload[1])
                times.append(time.perf_counter())
            else:
                verdict.append(msg.payload)
                done.set()

        t0, issue = time.perf_counter(), _real_us()
        c = ch.call_sync("GenerateService", "Generate",
                         json.dumps({"prompt": p, "max_tokens": max_tokens}
                                    ).encode(),
                         stream_options=StreamOptions(
                             on_received=on_received))
        if c.failed():
            errors.append((p, c.error_code, c.error_text))
            return
        try:
            if not done.wait(120) or verdict != [want_done]:
                errors.append((p, "verdict", verdict))
                return
        finally:
            c.stream.close()
        results[p] = toks
        ttft.append((times[0] - t0) * 1e3)
        gaps.extend((b - a) * 1e3 for a, b in zip(times, times[1:]))
        if calls is not None:
            calls.append({"prompt": p, "seq": seq, "trace_id": c.trace_id,
                          "issue_real_us": issue,
                          "first_real_us": first_real[0]})

    def client(idx):
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=120000))
        try:
            for seq, p in enumerate(prompts[idx::N_CLIENTS]):
                one(ch, p, seq)
        finally:
            ch.close()

    wall = _run_clients(client)
    return results, errors, wall, ttft, gaps


def _http_generate(conn, prompt: str, max_tokens: int, call=None):
    """One chunked Generate over ``conn``: (tokens, footer, client ms to
    the first token byte, [ms between token bytes]). ``call``: a dict
    that gets the connection's local address and the wall-clock issue
    and first-byte times."""
    t0, issue = time.perf_counter(), _real_us()
    conn.request("POST", "/GenerateService/Generate",
                 body=json.dumps({"prompt": prompt,
                                  "max_tokens": max_tokens}))
    resp = conn.getresponse()
    check(resp.status == 200 and
          resp.getheader("Transfer-Encoding") == "chunked",
          f"HTTP Generate answered {resp.status}")
    data, times, first_real = b"", [], None
    while True:
        part = resp.read1(65536)        # one chunk's data at most
        if not part:
            break
        now = time.perf_counter()
        if first_real is None:
            first_real = _real_us()
        data += part
        times.extend([now] * len(part))
    payload, _, footer = data.rpartition(b"\n#")
    times = times[:len(payload)]
    gaps = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    if call is not None:
        host, port = conn.sock.getsockname()[:2]
        call.update(local=f"{host}:{port}", issue_real_us=issue,
                    first_real_us=first_real)
    return (list(payload), footer,
            (times[0] - t0) * 1e3 if times else None, gaps)


def _http_burst(port: int, prompts, max_tokens: int, calls=None):
    """The burst over HTTP/1.1 chunked transfer, one keep-alive
    connection a client thread; ``calls`` as in ``_burst``, with each
    call's connection (local address) and its order on it."""
    import http.client

    results, errors, ttft, gaps = {}, [], [], []
    want_footer = b"completed n=%d" % max_tokens

    def client(idx):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for seq, p in enumerate(prompts[idx::N_CLIENTS]):
                call = {"prompt": p, "seq": seq}
                toks, footer, first, g = _http_generate(conn, p, max_tokens,
                                                        call)
                if footer != want_footer:
                    errors.append((p, footer))
                    continue
                results[p] = toks
                ttft.append(first)
                gaps.extend(g)
                if calls is not None:
                    calls.append(call)
        finally:
            conn.close()

    wall = _run_clients(client)
    return results, errors, wall, ttft, gaps


def _run_clients(client) -> float:
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "clients hung")
    return time.monotonic() - t0


BURSTS = {"stream": _stream_burst, "http": _http_burst, "unary": _burst}


def client_main(kind: str, port: int, traced: bool = False) -> int:
    """``python3 chip_smoke.py --client KIND PORT [--rpcz]``: one burst of
    KIND (stream, http or unary) against the server on PORT, from a
    process of its own, so that the clients do not share the server's
    interpreter lock; prints its result as one JSON line. ``--rpcz``
    turns rpcz on in this process and adds each call's record and the
    process's finished client spans to the line. KIND ``cost``: the
    turns of the observability phase's flag costs instead."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if kind == "cost":
        emit({"runs": _cost_turns(port)})
        return 0
    if kind == "hold":
        return _hold_connections(port)
    calls = None
    if traced:
        from brpc_tpu_torch.butil.flags import set_flag
        check(set_flag("rpcz_enabled", True), "cannot turn rpcz on")
        calls = []
    res, errs, wall, ttft, gaps = BURSTS[kind](port, _prompts(), MAX_TOKENS,
                                               calls=calls)
    doc = {"results": res, "errors": errs, "wall_s": wall, "ttft_ms": ttft,
           "gaps_ms": gaps}
    if traced:
        from brpc_tpu_torch.rpc.span import global_collector
        doc["calls"] = calls
        doc["spans"] = [s.to_dict() for s in global_collector.recent(4096)]
    emit(doc)
    return 0


def _hold_connections(port: int) -> int:
    """``--client hold PORT``: N_CLIENTS channels, one answered call on
    each (an unknown service: no decode step), a JSON line, then the
    connections stay open until a line comes on stdin."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    channels = [Channel(f"tcp://127.0.0.1:{port}",
                        ChannelOptions(timeout_ms=30000))
                for _ in range(N_CLIENTS)]
    try:
        for ch in channels:
            c = ch.call_sync("NoSuchService", "Hold", b"")
            check(c.error_code == 1001, f"hold call: {c.error_code} "
                                        f"{c.error_text}")
        emit({"connections": len(channels)})
        sys.stdin.readline()
    finally:
        for ch in channels:
            ch.close()
    return 0


def _client_process(args, timeout_s: float = 300) -> dict:
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--client", *args],
        capture_output=True, text=True, timeout=timeout_s)
    check(out.returncode == 0,
          f"{args[0]} client process failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _client_process_burst(kind: str, port: int):
    doc = _client_process([kind, str(port)])
    return (doc["results"], doc["errors"], doc["wall_s"], doc["ttft_ms"],
            doc["gaps_ms"])


def _burst_line(res, wall, ttft, gaps) -> dict:
    tokens = sum(len(t) for t in res.values())
    return {"wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_ms": _median(ttft), "ttft_p99_ms": _p99(ttft),
            "gap_p50_ms": _median(gaps), "gap_p99_ms": _p99(gaps)}


def phase_streaming():
    """The stream and HTTP paths of Generate, each part with the launch
    counts zeroed just before and read just after: (a) the burst with
    every call streaming, cold then warm; (b) the same burst over HTTP
    chunked transfer; (c) one 120-token stream whose first token must
    land before half its last token's time, a dead HTTP peer whose slot
    must be freed, a stream burst under the profiler, and two bursts to
    compare with: unary calls, and streams from this process. The bursts
    of (a), (b) and the unary and profiled ones run in a client process
    of their own (``--client``)."""
    import http.client
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    fa = _fa_module()
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, StreamOptions
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)

    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    long_prompt = "one longer stream"
    long_want = cpu_model.generate(list(long_prompt.encode()), 120)
    out = {"phase": "streaming", "requests": N_REQUESTS,
           "clients": N_CLIENTS, "max_tokens": MAX_TOKENS}
    parts = {}

    def counted(name, steps_before, warmup=0):
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        steps = gs.batcher.decode_steps - steps_before
        check(launches["flash_decode"] == steps + warmup > 0 and
              sum(launches.values()) == launches["flash_decode"],
              f"{name}: kernel launches {launches} != decode steps "
              f"{steps} + warm-up {warmup} of flash_decode alone")
        parts[name] = {"flash_decode": launches["flash_decode"],
                       "decode_steps": steps, "warmup_steps": warmup}

    def bursts(kind, labels, burst=None):
        for label in labels:
            n0, steps0 = len(gs.ttft_samples()), gs.batcher.decode_steps
            fb = _FiberBurst(server, gs)
            res, errs, wall, ttft, gaps = (
                burst(ep.port, prompts, MAX_TOKENS) if burst
                else _client_process_burst(kind, ep.port))
            _check_burst(f"{kind} burst ({label})", res, errs, oracle)
            line = _burst_line(res, wall, ttft, gaps)
            # the server's own TTFT (request made to first token decoded)
            # and the batch it kept: what the transport does not explain
            server_ttft = gs.ttft_samples()[n0:]
            steps = gs.batcher.decode_steps - steps0
            line.update(server_ttft_p50_ms=_median(server_ttft),
                        server_ttft_p99_ms=_p99(server_ttft),
                        decode_steps=steps,
                        tokens_per_step=N_REQUESTS * MAX_TOKENS / steps,
                        **fb.finish(f"{kind} burst ({label})"))
            out[f"{kind}_{label}"] = line

    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)           # defaults, on cuda:0
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    ep = server.start("tcp://127.0.0.1:0")
    _check_no_decode_thread()
    # every decode step timed on the worker that runs it, with the
    # prompts it admitted and the host time of its prefills and of the
    # model's decode step (steps are serialized, so the counters'
    # differences across a step are that step's own)
    step_ms, acc = [], {"prefills": 0, "prefill_s": 0.0, "decode_s": 0.0}
    model = gs.batcher.model
    real_step, real_prefill = gs.batcher.step, model.prefill
    real_decode = model.decode_step

    def counted_prefill(tokens):
        t0 = time.perf_counter()
        out = real_prefill(tokens)
        acc["prefills"] += 1
        acc["prefill_s"] += time.perf_counter() - t0
        return out

    def timed_decode(*args):
        t0 = time.perf_counter()
        out = real_decode(*args)
        acc["decode_s"] += time.perf_counter() - t0
        return out

    def timed_step(group_index=None):
        a0, t0 = dict(acc), time.perf_counter()
        did = real_step(group_index)
        if did:
            step_ms.append((threading.get_ident(),
                            (time.perf_counter() - t0) * 1e3,
                            acc["prefills"] - a0["prefills"],
                            (acc["prefill_s"] - a0["prefill_s"]) * 1e3,
                            (acc["decode_s"] - a0["decode_s"]) * 1e3))
        return did

    model.prefill, model.decode_step = counted_prefill, timed_decode
    gs.batcher.step = timed_step
    try:
        bursts("stream", ("cold", "warm"))                  # (a)
        counted("stream", 0, gs.engine.warmup_steps)
        fa.reset_launches()
        steps0 = gs.batcher.decode_steps
        bursts("http", ("cold", "warm"))                    # (b)
        counted("http", steps0)

        fa.reset_launches()
        steps0 = gs.batcher.decode_steps
        # (c) one longer stream: tokens leave as they decode
        ch = Channel(f"tcp://127.0.0.1:{ep.port}",
                     ChannelOptions(timeout_ms=60000))
        toks, times, done = [], [], threading.Event()

        def on_received(stream, msg):
            if msg.payload[:1] == b"t":
                toks.append(msg.payload[1])
                times.append(time.perf_counter())
            else:
                done.set()

        t0 = time.perf_counter()
        c = ch.call_sync("GenerateService", "Generate",
                         json.dumps({"prompt": long_prompt,
                                     "max_tokens": 120}).encode(),
                         stream_options=StreamOptions(
                             on_received=on_received))
        check(not c.failed() and done.wait(60),
              f"long stream failed: {c.error_text}")
        c.stream.close()
        ch.close()
        check(toks == long_want, "long stream: tokens differ from the CPU "
                                 "plain path")
        first_ms, last_ms = (times[0] - t0) * 1e3, (times[-1] - t0) * 1e3
        check(first_ms < 0.5 * last_ms,
              f"long stream: first token at {first_ms} ms, last at "
              f"{last_ms} ms")
        out["long_stream"] = {"tokens": len(toks), "first_token_ms": first_ms,
                              "last_token_ms": last_ms}

        # (c) a dead HTTP peer: its slot must be freed
        sock = socket.create_connection(("127.0.0.1", ep.port), timeout=30)
        body = json.dumps({"prompt": "a peer that dies",
                           "max_tokens": 120}).encode()
        sock.sendall(b"POST /GenerateService/Generate HTTP/1.1\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        got = b""
        while b"\r\n\r\n" not in got or \
                got.index(b"\r\n\r\n") + 4 >= len(got):
            part = sock.recv(4096)
            check(bool(part), "dead peer: no first chunk")
            got += part
        canceled0 = gs.batcher.canceled
        sock.close()
        t0 = time.monotonic()
        while gs.batcher.running_count() and time.monotonic() - t0 < 5:
            time.sleep(0.002)
        freed_s = time.monotonic() - t0
        check(gs.batcher.running_count() == 0,
              "dead HTTP peer: its slot was not freed within 5 s")
        check(gs.batcher.canceled == canceled0 + 1,
              "dead HTTP peer: its sequence was not cancelled")
        conn = http.client.HTTPConnection("127.0.0.1", ep.port, timeout=60)
        toks, footer, _, _ = _http_generate(conn, prompts[0], MAX_TOKENS)
        conn.close()
        check(footer == b"completed n=%d" % MAX_TOKENS
              and toks == oracle[prompts[0]],
              "the request after the dead peer did not complete")
        out["dead_http_peer"] = {"slot_freed_s": freed_s}

        # (c) a stream burst under the profiler, then the comparisons
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bursts("stream", ("profiled",))
            torch.cuda.synchronize()
        # the burst's own wall, as its client process timed it: the
        # server is idle before and after, the process start-up is not
        # the burst's
        window_us = out["stream_profiled"]["wall_s"] * 1e6
        bursts("unary", ("warm",))
        bursts("stream", ("in_process",), _stream_burst)
        counted("long stream, dead peer, profiled and compared bursts",
                steps0)
    finally:
        server.stop()
        server.join(10)
    trace = {"phase": "streaming_trace", "window_us": window_us}
    trace.update(_device_profile(prof.events(), window_us))
    def step_doc(ms, admitted, prefill_ms, decode_ms):
        return {"ms": ms, "admitted": admitted, "prefill_host_ms": prefill_ms,
                "decode_host_ms": decode_ms}

    first, seen = [], set()
    for tid, *rest in step_ms:
        if tid not in seen:
            seen.add(tid)
            first.append(step_doc(*rest))
    plain = [ms for _, ms, a, _, _ in step_ms if not a]
    admit = [ms for _, ms, a, _, _ in step_ms if a]
    out["steps"] = {
        "first_of_phase": [step_doc(*s[1:]) for s in step_ms[:3]],
        "first_per_thread": first,
        "no_admission": {"count": len(plain), "ms_p50": _median(plain),
                         "ms_p99": _p99(plain)},
        "admission": {"count": len(admit), "ms_p50": _median(admit),
                      "ms_p99": _p99(admit),
                      "prompts": sum(s[2] for s in step_ms)}}
    out["launches"] = parts
    out["tokens_equal_cpu_plain"] = True
    out["stream_profiled"]["device_busy_share"] = trace["device_busy_share"]
    out["phase_s"] = time.monotonic() - phase_t0
    emit(out)
    emit(trace)
    return out


# ------------------------------------------------------ observability

# the stitched timeline of one call, in order; consecutive stamps on the
# wall clock of both processes, so the stages sum to the client's TTFT
STAGES = ("way_in", "received_to_handler", "handler_to_admitted",
          "admitted_to_prefilled", "prefilled_to_first_token", "way_out")
COST_FLAGS = ("serving_stats_enabled", "rpcz_enabled")
COST_TURNS = 3


def _http_page(port: int, path: str, method: str = "GET"):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=b"" if method == "POST" else None)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _set_flags(port: int, **flags) -> None:
    """Set flags on the server at ``port`` (``POST /flags/<name>``);
    ``rpcz_enabled`` in this process too, whose client spans it rules."""
    from brpc_tpu_torch.butil.flags import set_flag
    for name, value in flags.items():
        status, body = _http_page(
            port, f"/flags/{name}?setvalue={str(value).lower()}", "POST")
        check(status == 200, f"server refused flag {name}: {body!r}")
        if name == "rpcz_enabled":
            check(set_flag(name, value), f"cannot set flag {name}")


def _cost_turns(port: int) -> list:
    """The warm stream burst in turns, off and on, COST_TURNS times for
    each of COST_FLAGS, the order of a pair alternating (off first in
    even turns), so that neither setting always runs second; rpcz stays
    off while serving_stats is measured, and serving_stats on while rpcz
    is (a serving span needs it)."""
    runs = []
    for name in COST_FLAGS:
        for turn in range(COST_TURNS):
            for on in ((False, True) if turn % 2 == 0 else (True, False)):
                flags = {"serving_stats_enabled": True,
                         "rpcz_enabled": False}
                flags[name] = on
                _set_flags(port, **flags)
                res, errs, wall, ttft, _ = _stream_burst(port, _prompts(),
                                                         MAX_TOKENS)
                runs.append({"flag": name, "on": on, "turn": turn,
                             "results": res, "errors": errs, "wall_s": wall,
                             "client_ttft_p50_ms": _median(ttft)})
    _set_flags(port, serving_stats_enabled=True, rpcz_enabled=False)
    return runs


def _stitch(kind: str, calls, client_spans, server_spans, first_token):
    """Each call's stages (STAGES, microseconds on the wall clock) from
    its client record, its client span (tpu_std), its server span
    (tpu_std) and its serving span, checked for one of each per call;
    ``first_token``: {serving span id: the tracker's first-token stamp,
    monotonic ns}. An HTTP call has no client or server span: it is
    matched to its serving span by its connection and its order there,
    and its handler start is the serving span's start."""
    by_trace = {}
    for s in server_spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    mine = {s["trace_id"]: s for s in client_spans}
    check(len(mine) == len(client_spans),
          f"{kind}: two client spans share a trace")
    http_serving = {}
    if kind == "http":
        for s in server_spans:
            if s["side"] == "serving" and not int(s["parent_span_id"], 16):
                http_serving.setdefault(s["remote_side"], []).append(s)
        for v in http_serving.values():
            v.sort(key=lambda s: s["start_us"])
    rows = []
    for c in calls:
        if kind == "http":
            server = None
            conn = http_serving.get(f"tcp://{c['local']}", [])
            check(c["seq"] < len(conn),
                  f"http call {c['prompt']!r}: no serving span")
            serving = conn[c["seq"]]
            check(len(by_trace[serving["trace_id"]]) == 1,
                  f"http call {c['prompt']!r}: more than one span")
        else:
            tid = f"{c['trace_id']:016x}"
            cs = mine.get(tid)
            check(cs is not None, f"{kind} call {c['prompt']!r}: no client "
                                  "span")
            spans = by_trace.get(tid, [])
            sides = sorted(s["side"] for s in spans)
            check(sides == ["server", "serving"],
                  f"{kind} trace {tid}: server-side spans {sides}")
            server = next(s for s in spans if s["side"] == "server")
            serving = next(s for s in spans if s["side"] == "serving")
            check(server["parent_span_id"] == cs["span_id"]
                  and serving["parent_span_id"] == server["span_id"],
                  f"{kind} trace {tid}: parent links broken")
        stages = [serving[k] for k in ("queue_us", "prefill_us",
                                       "decode_us", "emit_us")]
        check(abs(sum(stages) - serving["latency_us"]) <= len(stages),
              f"{kind}: serving stages {stages} do not sum to "
              f"{serving['latency_us']}")
        off = serving["base_real_us"] - serving["start_us"]
        first = first_token.get(serving["span_id"])
        check(bool(first), f"{kind}: no first-token stamp for a call")
        wall = {
            "issue": c["issue_real_us"],
            "handler": (server["handler_start_us"] if server
                        else serving["start_us"]) + off,
            "admitted": serving["write_done_us"] + off,
            "prefilled": serving["first_byte_us"] + off,
            "first_token": first // 1000 + off,
            "client_first": c["first_real_us"],
        }
        if server is not None:
            wall["received"] = server["received_us"] + (
                server["base_real_us"] - server["start_us"])
        # an HTTP call has no arrival stamp: its way in runs to the
        # handler, and received -> handler is not known
        wall.setdefault("received", wall["handler"])
        order = ["issue", "received", "handler", "admitted", "prefilled",
                 "first_token", "client_first"]
        row = {stage: wall[b] - wall[a]
               for stage, a, b in zip(STAGES, order, order[1:])}
        if server is None:
            row["received_to_handler"] = None
        row["sum"] = sum(v for v in row.values() if v is not None)
        row["client_ttft"] = wall["client_first"] - wall["issue"]
        # a client's first call on its connection opens it (the Channel
        # and http.client connect on first use)
        row["first_on_connection"] = c["seq"] == 0
        rows.append(row)
    return rows


def _timeline_line(kind: str, rows) -> dict:
    out = {"transport": kind, "calls": len(rows), "unit": "us"}
    for stage in STAGES + ("sum", "client_ttft"):
        xs = [r[stage] for r in rows if r[stage] is not None]
        out[stage] = ({"p50": _median(xs), "p99": _p99(xs)} if xs
                      else None)
    for first in (True, False):
        xs = [r for r in rows if r["first_on_connection"] == first]
        key = "first_call_on_connection" if first else "later_calls"
        out[key] = {"calls": len(xs), **{
            stage: _median([r[stage] for r in xs])
            for stage in ("way_in", "client_ttft")}}
    return out


def phase_observability():
    """rpcz spans, serving stats and the builtin pages on the main path:
    a fresh default server on cuda:0 with rpcz on, one warm burst of
    each kind (stream, HTTP, unary) from client processes that trace
    too, the pages, the stitched stage timeline of every call across
    the two processes, and the cost of ``serving_stats_enabled`` and
    ``rpcz_enabled`` in turns."""
    import torch

    fa = _fa_module()
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)
    from brpc_tpu_torch.serving import serving_stats

    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    # the trackers' first-token stamps, which no span carries
    trackers = []
    real_open = serving_stats.open_generation

    def kept_open(*args, **kwargs):
        tr = real_open(*args, **kwargs)
        if tr is not None and tr.span is not None:
            trackers.append(tr)
        return tr

    fa.reset_launches()
    check(set_flag("rpcz_enabled", False), "cannot set rpcz_enabled")
    server = Server()
    gs = add_generate_service(server)           # defaults, on cuda:0
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    ep = server.start("tcp://127.0.0.1:0")
    serving_stats.open_generation = kept_open
    out = {"phase": "observability", "requests": N_REQUESTS,
           "clients": N_CLIENTS, "max_tokens": MAX_TOKENS}
    try:
        # warm the server untraced, then trace one burst of each kind
        res, errs = _client_process_burst("stream", ep.port)[:2]
        _check_burst("observability warm-up", res, errs, oracle)

        def cell_requests():
            doc = json.loads(_http_page(ep.port, "/serving")[1])
            cell = doc["stats"]["methods"].get("GenerateService.Generate")
            return cell["requests"] if cell else 0

        requests0 = cell_requests()
        check(set_flag("rpcz_enabled", True), "cannot set rpcz_enabled")
        traced = {}
        for kind in ("stream", "http", "unary"):
            doc = _client_process([kind, str(ep.port), "--rpcz"])
            _check_burst(f"traced {kind} burst", doc["results"],
                         doc["errors"], oracle)
            check(len(doc["calls"]) == N_REQUESTS,
                  f"{kind}: {len(doc['calls'])} call records")
            traced[kind] = doc
        check(set_flag("rpcz_enabled", False), "cannot set rpcz_enabled")

        pages = {}
        for path in ("/rpcz?n=4096", "/serving", "/status", "/vars",
                     "/brpc_metrics"):
            status, body = _http_page(ep.port, path)
            check(status == 200, f"{path} answered {status}")
            pages[path.split("?")[0]] = body
        server_spans = json.loads(pages["/rpcz"])
        first_token = {f"{t.span.span_id:016x}": t.t_first_token
                       for t in trackers}
        timeline = {}
        for kind, doc in traced.items():
            rows = _stitch(kind, doc["calls"], doc["spans"], server_spans,
                           first_token)
            timeline[kind] = _timeline_line(kind, rows)
        n_tpu_std = sum(1 for s in server_spans if s["side"] == "server")
        check(n_tpu_std == 2 * N_REQUESTS,
              f"{n_tpu_std} server spans for {2 * N_REQUESTS} tpu_std calls")
        check(sum(1 for s in server_spans if s["side"] == "serving")
              == 3 * N_REQUESTS, "serving spans do not match the calls")
        served = cell_requests() - requests0
        check(served == 3 * N_REQUESTS,
              f"/serving counted {served} of {3 * N_REQUESTS} calls")
        var_names = [ln.split(" : ")[0]
                     for ln in pages["/vars"].decode().splitlines()]
        check("fiber_wake" in var_names and
              {"fiber_count", "fiber_created", "fiber_worker_count",
               "fiber_switch_count", "fiber_steal_count",
               "fiber_runqueue_depth", "fiber_runqueue_peak_10s",
               "fiber_worker_busy_fraction"} <= set(var_names),
              f"/vars lacks the fiber variables: {var_names}")
        _check_prometheus(pages["/brpc_metrics"].decode())
        status_doc = json.loads(pages["/status"])
        check("GenerateService.Generate" in status_doc["method_status"],
              "/status has no Generate latency window")

        # the flags' costs, in turns, from one client process; each
        # request's server stamps split its TTFT into the wait for
        # admission and admission -> first token
        steps0 = gs.batcher.decode_steps
        submitted = []
        real_submit = gs.batcher.submit

        def kept_submit(req):
            submitted.append(req)
            return real_submit(req)

        gs.batcher.submit = kept_submit
        try:
            runs = _client_process(["cost", str(ep.port)], 600)["runs"]
        finally:
            gs.batcher.submit = real_submit
        check(len(submitted) == len(runs) * N_REQUESTS,
              "cost runs: server requests do not match the calls")
        cost = []
        for i, r in enumerate(runs):
            _check_burst(f"cost run {r['flag']}={r['on']}", r["results"],
                         r["errors"], oracle)
            tokens = sum(len(t) for t in r["results"].values())
            mine = submitted[i * N_REQUESTS:(i + 1) * N_REQUESTS]
            ms = lambda a, b: _median(  # noqa: E731
                [(getattr(q, b) - getattr(q, a)) / 1e6 for q in mine])
            cost.append({"flag": r["flag"], "on": r["on"],
                         "turn": r["turn"], "wall_s": r["wall_s"],
                         "tokens_per_s": tokens / r["wall_s"],
                         "client_ttft_p50_ms": r["client_ttft_p50_ms"],
                         "server_ttft_p50_ms": ms("created_ns",
                                                  "first_token_ns"),
                         "queue_p50_ms": ms("created_ns", "admitted_ns"),
                         "admitted_to_first_p50_ms": ms("admitted_ns",
                                                        "first_token_ns")})
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        steps = gs.batcher.decode_steps
        warm = gs.engine.warmup_steps
        check(launches["flash_decode"] == steps + warm > 0 and
              sum(launches.values()) == launches["flash_decode"],
              f"observability: kernel launches {launches} != decode steps "
              f"{steps} + warm-up {warm} of flash_decode alone")
        out["cost_decode_steps"] = steps - steps0
    finally:
        serving_stats.open_generation = real_open
        set_flag("rpcz_enabled", False)
        server.stop()
        server.join(10)
    for kind, line in timeline.items():
        emit({"phase": "observability_timeline", **line})
    for name in COST_FLAGS:
        rows = [c for c in cost if c["flag"] == name]
        emit({"phase": "observability_cost", "flag": name, "runs": rows,
              **{f"{'on' if on else 'off'}_{k}_median": _median(
                  [c[k] for c in rows if c["on"] == on])
                 for on in (False, True)
                 for k in ("tokens_per_s", "server_ttft_p50_ms",
                           "queue_p50_ms", "admitted_to_first_p50_ms")}})
    out.update(launches={"flash_decode": launches["flash_decode"],
                         "decode_steps": steps, "warmup_steps": warm},
               served_calls=served, server_spans=len(server_spans),
               tokens_equal_cpu_plain=True,
               phase_s=time.monotonic() - phase_t0)
    emit(out)
    return out


def _check_prometheus(text: str) -> None:
    """Every sample line reads ``name{labels} value``."""
    import re
    sample = re.compile(
        r'^[A-Za-z_:][A-Za-z0-9_:]*(\{[A-Za-z_][A-Za-z0-9_]*="(?:[^"\\]|'
        r'\\.)*"(,[A-Za-z_][A-Za-z0-9_]*="(?:[^"\\]|\\.)*")*\})? '
        r'[-+]?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?$')
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    bad = [ln for ln in lines if not sample.match(ln)]
    check(lines and not bad, f"/brpc_metrics lines that do not parse: "
                             f"{bad[:5]}")


# ------------------------------------------------------ phase device_lane

# the north-star sweep (examples/tpu_performance/main.py:48-78): 4 B to
# 4 MiB in x4 steps
SWEEP_BYTES = [4 << (2 * i) for i in range(11)]
SWEEP_WARMUP = 3
SWEEP_CALLS = 30
ATTEND_CALLS = 4
# device-side sleep queued behind each Attend's kernels (~0.1 s at
# 2 GHz), so that its event is still pending when the handler parks
ATTEND_PARK_CYCLES = int(2e8)
# the longest an Attend part's handlers wait at its gate for one another
ATTEND_GATE_S = 30.0
STREAM_FRAMES = 16
STREAM_FRAME_BYTES = 64 << 10
# parts (f)-(h): ici://
ICI_CYCLES = 100
ICI_CYCLE_BYTES = 64 << 10
SHORT_SWEEP_BYTES = [4, 64 << 10, 4 << 20]
SHORT_SWEEP_CALLS = 10
DEVICE_COST_BYTES = 64 << 10
DEVICE_COST_CALLS = 60
# the client process's switch: a batch that would go staged fails
ICI_REQUIRE_PULL = {"BRPC_TPU_TORCH_ICI_REQUIRE_PULL": "1"}
ICI_LANES = ("local-d2d", "cuda-ipc", "staged")


def _device_spec(dev) -> str:
    """The ``#device=`` extra that names ``dev``."""
    return "cpu" if dev.type == "cpu" else str(dev.index or 0)


def _device_event(dev):
    """A CUDA event recorded on the current stream of ``dev``."""
    import torch
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sweep(ch, dev, check_zero_copy: bool, sizes=SWEEP_BYTES,
           calls: int = SWEEP_CALLS) -> list:
    """Echo fp32 tensors of every size in ``sizes``: SWEEP_WARMUP calls,
    then ``calls`` timed ones. Rows of p50/p99 us and GB/s (2 x bytes
    per echo, as the example counts)."""
    import torch
    rows = []
    for nbytes in sizes:
        n = nbytes // 4
        times = []
        for i in range(SWEEP_WARMUP + calls):
            x = torch.arange(n, dtype=torch.float32, device=dev) + i
            _sync(dev)
            t0 = time.perf_counter()
            c = ch.call_sync("Perf", "Echo", b"",
                             request_device_arrays=[x])
            dt = time.perf_counter() - t0
            check(not c.failed(), f"echo {nbytes} B: {c.error_code} "
                                  f"{c.error_text}")
            (y,) = c.response_device_arrays
            check(y.device == x.device and y.dtype == x.dtype
                  and torch.equal(y, x), f"echo {nbytes} B: not equal")
            if check_zero_copy:
                check(y.data_ptr() == x.data_ptr(),
                      f"echo {nbytes} B: the hand-off copied")
            if i >= SWEEP_WARMUP:
                times.append(dt)
        p50 = _median(times)
        rows.append({"bytes": nbytes, "p50_us": p50 * 1e6,
                     "p99_us": _p99(times) * 1e6,
                     "gb_per_s": 2 * nbytes / p50 / 1e9})
    return rows


class _CopyTimes:
    """Times of the cudad conns' host copies in this process, by size:
    ``write`` (the whole lane write on the sender's thread), ``encode``
    (its part that copies to the host and builds the envelope) and
    ``take`` (the batch landing on the device, in parse: the dispatcher
    thread).
    Measurement only: the methods are wrapped for the phase and put
    back after it."""

    def __init__(self):
        from brpc_tpu_torch.transport import cudad
        self._mod = cudad
        self._cls = cudad.CudadConn
        self._orig = (self._cls.write_device_payload,
                      self._cls.take_device_payload,
                      cudad._encode_device_batch)
        self.rows = []

    def __enter__(self):
        write, take, encode = self._orig
        rows = self.rows

        def timed_encode(arrays):
            t0 = time.perf_counter()
            r = encode(arrays)
            rows.append(("encode", nb(arrays), time.perf_counter() - t0,
                         threading.current_thread().name))
            return r

        def nb(arrays):
            return sum(t.numel() * t.element_size() for t in arrays)

        def timed_write(conn, arrays):
            t0 = time.perf_counter()
            r = write(conn, arrays)
            rows.append(("write", nb(arrays), time.perf_counter() - t0,
                         threading.current_thread().name))
            return r

        def timed_take(conn):
            t0 = time.perf_counter()
            r = take(conn)
            if r is not None:
                rows.append(("take", nb(r), time.perf_counter() - t0,
                             threading.current_thread().name))
            return r
        self._cls.write_device_payload = timed_write
        self._cls.take_device_payload = timed_take
        self._mod._encode_device_batch = timed_encode
        return self

    def __exit__(self, *exc):
        (self._cls.write_device_payload, self._cls.take_device_payload,
         self._mod._encode_device_batch) = self._orig

    def summary(self, kind: str, nbytes: int) -> dict:
        ts = [r[2] for r in self.rows if r[0] == kind and r[1] == nbytes]
        threads = sorted({r[3] for r in self.rows
                          if r[0] == kind and r[1] == nbytes})
        return {"calls": len(ts), "p50_ms": _median(ts) and
                _median(ts) * 1e3, "max_ms": max(ts) * 1e3 if ts else None,
                "threads": threads}


def _device_lane_server(addr: str, dev, seen: dict):
    """A port Server with Perf.Echo (response = request tensors),
    Perf.Check (the side-stream read) and the async Perf.Attend
    (decode_attention on the delivered tensors, on a stream of its own
    behind which a device-side sleep keeps the event pending, parked on
    it through ``device_ready``), and Perf.Frames (a stream of
    tensors)."""
    import torch

    from brpc_tpu_torch.fiber import current_group, device_ready
    from brpc_tpu_torch.rpc import (Server, ServerOptions, Service,
                                    stream_accept)
    fa = _fa_module()
    svc = Service("Perf")

    @svc.method()
    def Echo(cntl, request):
        seen.setdefault("echo_devices", set()).update(
            str(t.device) for t in cntl.request_device_arrays)
        seen.setdefault("echo_lanes", set()).add(
            cntl._server_socket.conn.lane_kind)
        cntl.response_device_arrays = cntl.request_device_arrays
        return request

    @svc.method()
    async def Check(cntl, request):
        (x,) = cntl.request_device_arrays
        ok = (x == 7).all()
        await device_ready(_device_event(dev))
        return b"1" if bool(ok) else b"0"

    @svc.method()
    async def Attend(cntl, request):
        q, k, v, lengths = cntl.request_device_arrays
        # the part's calls park here (a Future: the callback path) until
        # its last call has arrived, so that their parks on the device
        # events below overlap however far apart the requests came in
        if not await device_ready(_arrive(seen)):
            raise RuntimeError(f"only {len(seen['arrivals'])} of "
                               f"{ATTEND_CALLS} Attend calls arrived in "
                               f"{ATTEND_GATE_S} s")
        if dev.type == "cuda":
            # a stream of the call's own, so one call's parked work
            # holds back neither another call nor a lane's host copy
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for t in (q, k, v, lengths):
                    t.record_stream(side)
                o = fa.decode_attention(q, k, v, lengths)
                o.record_stream(cur)
                torch.cuda._sleep(ATTEND_PARK_CYCLES)
                ev = _device_event(dev)
        else:
            o = fa.decode_attention(q, k, v, lengths)
            ev = _device_event(dev)
        seen.setdefault("in_flight", []).append(1)
        seen["max_in_flight"] = max(seen.get("max_in_flight", 0),
                                    len(seen["in_flight"]))
        await device_ready(ev)
        seen["in_flight"].pop()
        seen.setdefault("attend_resumed", []).append(
            (bool(ev.query()), current_group() is not None,
             threading.current_thread().name))
        cntl.response_device_arrays = [o]
        return b"o"

    @svc.method()
    def Frames(cntl, request):
        st = stream_accept(cntl)
        n = STREAM_FRAME_BYTES // 4

        def send():
            for i in range(STREAM_FRAMES):
                t = torch.full((n,), float(i), device=dev)
                deadline = time.monotonic() + 10
                while not st.write_nowait(b"f%d" % i, device_arrays=[t]):
                    if time.monotonic() > deadline:
                        seen["frames_error"] = f"frame {i}: no credit"
                        return
                    time.sleep(0.0005)
                time.sleep(0.001)   # spread the frames among the calls
        threading.Thread(target=send, name="smoke_frames",
                         daemon=True).start()
        return b"ok"

    srv = Server(ServerOptions(enable_builtin_services=False))
    srv.add_service(svc)
    ep = srv.start(addr)
    return srv, ep


def _open_gate(seen: dict) -> None:
    """A fresh gate for an Attend part: a Future set True by the part's
    ATTEND_CALLS-th arrival, or False by a timer if they do not all come."""
    import concurrent.futures
    gate = concurrent.futures.Future()
    seen.update(gate=gate, arrivals=[], gate_lock=threading.Lock())

    def expire():
        with seen["gate_lock"]:
            if not gate.done():
                gate.set_result(False)
    timer = threading.Timer(ATTEND_GATE_S, expire)
    timer.daemon = True
    timer.start()
    seen["gate_timer"] = timer


def _arrive(seen: dict):
    """Count one Attend arrival at the part's gate and return the gate."""
    with seen["gate_lock"]:
        seen["arrivals"].append(time.monotonic())
        if len(seen["arrivals"]) == ATTEND_CALLS and not seen["gate"].done():
            seen["gate"].set_result(True)
    return seen["gate"]


def _attend(addr: str, dev, calls: int, rng) -> dict:
    """``calls`` concurrent Attend calls (q [4, 128], K/V [4, 4096, 128]
    bf16, lengths 0/1/4096/3000), each O held within ``_rounding_bound``
    of the plain version computed here from the client's own tensors.
    Each call has a connection of its own: on one connection the next
    request is read only when the handler of the last one has finished
    (in-place processing, as in brpc_tpu), so parked handlers of one
    connection do not overlap unless their requests came in one read."""
    import torch

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    fa = _fa_module()
    b, L, d = 4, 4096, 128
    lengths = torch.tensor([0, 1, 4096, 3000], dtype=torch.int32,
                           device=dev)
    inputs = []
    for _ in range(calls):
        q = _rand(rng, (b, d), torch.bfloat16, dev)
        k = _rand(rng, (b, L, d), torch.bfloat16, dev)
        v = _rand(rng, (b, L, d), torch.bfloat16, dev)
        inputs.append((q, k, v))
    _sync(dev)
    out = [None] * calls
    errs = []
    chans = [Channel(addr, ChannelOptions(timeout_ms=60000))
             for _ in range(calls)]

    def one(i):
        try:
            q, k, v = inputs[i]
            c = chans[i].call_sync("Perf", "Attend", b"",
                                   request_device_arrays=[q, k, v, lengths])
            check(not c.failed(), f"Attend: {c.error_code} {c.error_text}")
            out[i] = c.response_device_arrays[0]
        except Exception as e:      # reported below, on the main thread
            errs.append(e)
    threads = [threading.Thread(target=one, args=(i,)) for i in
               range(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for c in chans:
        c.close()
    check(not errs, f"Attend failed: {errs[:1]}")
    worst = 0.0
    max_err = 0.0
    for (q, k, v), o in zip(inputs, out):
        want = fa._flash_plain(q[:, None].float(), k.float(), v.float(),
                               d ** -0.5, True, 64,
                               q_offset=lengths - 1)[:, 0]
        bound = fa._rounding_bound(want, torch.bfloat16)
        diff = (o.float() - want.float()).abs()
        check(o.shape == q.shape and o.dtype == q.dtype,
              f"Attend output {tuple(o.shape)} {o.dtype}")
        worst = max(worst, float((diff / bound).max()))
        max_err = max(max_err, float(diff.max()))
    check(worst <= 1.0, f"Attend: O off the plain version by "
                        f"{worst:.3f} x its rounding bound")
    return {"calls": calls, "worst_over_bound": worst,
            "max_abs_err": max_err,
            "request_bytes": sum(t.numel() * t.element_size()
                                 for t in (*inputs[0], lengths))}


def _frames_beside_unary(ch, dev) -> dict:
    """A stream of STREAM_FRAMES tensor frames from the server while
    unary device calls run on the same connection: every frame and every
    response must pair with its own tensor."""
    import torch

    from brpc_tpu_torch.rpc import StreamOptions
    frames = []
    done = threading.Event()

    def on_received(stream, msg):
        frames.append((msg.payload, msg.device_arrays))
        if len(frames) == STREAM_FRAMES:
            done.set()
    c = ch.call_sync("Perf", "Frames", b"", stream_options=StreamOptions(
        on_received=on_received))
    check(not c.failed(), f"Frames: {c.error_text}")
    unary = 0
    while unary < 4 or (not done.is_set() and unary < 400):
        x = torch.full((STREAM_FRAME_BYTES // 4,), -1.0 - unary,
                       device=dev)
        r = ch.call_sync("Perf", "Echo", b"", request_device_arrays=[x])
        check(not r.failed() and torch.equal(r.response_device_arrays[0],
                                             x),
              f"unary call {unary} beside the stream got another tensor")
        unary += 1
    check(done.wait(30), f"{len(frames)} of {STREAM_FRAMES} frames")
    for i, (payload, arrays) in enumerate(frames):
        check(payload == b"f%d" % i and len(arrays) == 1
              and bool((arrays[0] == float(i)).all()),
              f"stream frame {i} paired with another tensor")
    c.stream.close()
    return {"frames": len(frames), "unary_calls_beside": unary}


def _side_stream_send(ch, dev) -> bool:
    """Fill a tensor on a fresh stream behind a device-side sleep and
    send it at once, from that stream: the handler must read the filled
    values (the writer's event, waited on by the taker's stream)."""
    import torch
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e8))             # ~0.1 s at 2 GHz
        x = torch.full((1 << 20,), 7.0, device=dev)
        c = ch.call_sync("Perf", "Check", b"", request_device_arrays=[x])
    check(not c.failed(), f"Check: {c.error_text}")
    return c.response == b"1"


def _gil_released_by_event_wait(dev) -> dict:
    """While a thread waits in ``Event.synchronize`` on ~0.2 s of device
    sleep, this thread keeps running: the longest gap between its loop
    turns shows whether the wait held the interpreter lock."""
    import torch
    torch.cuda._sleep(int(4e8))
    ev = _device_event(dev)
    t = threading.Thread(target=ev.synchronize, name="smoke_ev_wait")
    t0 = time.perf_counter()
    t.start()
    last = t0
    gap = 0.0
    while t.is_alive():
        now = time.perf_counter()
        gap = max(gap, now - last)
        last = now
    return {"wait_ms": (time.perf_counter() - t0) * 1e3,
            "max_gap_ms": gap * 1e3}


def _process_spans() -> list:
    """This process's client and device spans, as dicts."""
    from brpc_tpu_torch.rpc.span import global_collector
    return [s.to_dict() for s in global_collector.recent(4096)
            if s.side in ("client", "device")]


def _client_device(spec: str):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from brpc_tpu_torch.butil.device import resolve_device
    return resolve_device("cpu" if spec == "cpu" else f"cuda:{spec}")


def _next_step() -> None:
    """A session client's wait for the server's go (a line on stdin)."""
    check(sys.stdin.readline() != "", "the server ended the session")


def _traced_short_sweep(addr: str, dev) -> dict:
    """SHORT_SWEEP_BYTES with rpcz on in this process, and its spans."""
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.span import global_collector
    check(set_flag("rpcz_enabled", True), "cannot turn rpcz on")
    global_collector.clear()
    ch = Channel(addr, ChannelOptions(timeout_ms=30000))
    try:
        rows = _sweep(ch, dev, False, SHORT_SWEEP_BYTES, SHORT_SWEEP_CALLS)
    finally:
        ch.close()
        set_flag("rpcz_enabled", False)
    return {"sweep": rows, "spans": _process_spans()}


def device_lane_client(port: int, spec: str) -> int:
    """``--client device_lane PORT [DEVICE]``: a session over
    ``cudad://127.0.0.1:PORT#device=DEVICE`` from a process of its own:
    the sweep (part b), then, on the server's go, SHORT_SWEEP_BYTES under
    rpcz (part h); a JSON line each."""
    dev = _client_device(spec)
    import torch

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    addr = f"cudad://127.0.0.1:{port}#device={spec}"
    ch = Channel(addr, ChannelOptions(timeout_ms=30000))
    try:
        rows = _sweep(ch, dev, check_zero_copy=False)
        emit({"sweep": rows, "lane": ch.device_lane_kind(),
              "peer_info": ch._socket.conn.peer_info,
              "torch": torch.__version__})
    finally:
        ch.close()
    _next_step()
    emit(_traced_short_sweep(addr, dev))
    return 0


def _device_cells(lanes=None) -> dict:
    """This process's device cells (``peer|lane`` -> value), of ``lanes``
    or all."""
    from brpc_tpu_torch.transport.device_stats import global_device_stats
    return {f"{peer}|{lane}": cell.get_value()
            for (peer, lane), cell in global_device_stats().rows()
            if lanes is None or lane in lanes}


def _wait_for_value(fn, want, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while fn() != want and time.monotonic() < deadline:
        time.sleep(0.01)
    return fn() == want


def _allocated(dev) -> int:
    """The card's allocated bytes once collectable tensors are gone (0
    on the host)."""
    import gc

    import torch
    gc.collect()
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _ici_cycles(addr: str, dev) -> dict:
    """ICI_CYCLES times: dial, echo one ICI_CYCLE_BYTES tensor, close.
    The card's allocated bytes must come back to where they were: the
    registry drops each batch on its ACK and a close acknowledges what
    its copies consumed, so nothing stays held."""
    import torch

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    x = torch.full((ICI_CYCLE_BYTES // 4,), 3.0, device=dev)
    _sync(dev)
    base = _allocated(dev)
    t0 = time.perf_counter()
    for i in range(ICI_CYCLES):
        ch = Channel(addr, ChannelOptions(timeout_ms=30000))
        c = ch.call_sync("Perf", "Echo", b"", request_device_arrays=[x])
        check(not c.failed() and torch.equal(c.response_device_arrays[0], x),
              f"cycle {i}: {c.error_code} {c.error_text}")
        del c
        ch.close()
    wall = time.perf_counter() - t0
    _wait_for_value(lambda: _allocated(dev), base, 10.0)
    after = _allocated(dev)
    check(after == base, f"{ICI_CYCLES} connect/echo/close cycles left "
                         f"{after - base} bytes allocated on the card")
    return {"cycles": ICI_CYCLES, "bytes": ICI_CYCLE_BYTES,
            "wall_ms_per_cycle": wall / ICI_CYCLES * 1e3,
            "allocated_before": base, "allocated_after": after}


def _device_cost_turns(ch, dev, admin_port: int) -> list:
    """Echoes of DEVICE_COST_BYTES with ``device_stats_enabled`` off and
    on in turns (COST_TURNS pairs, the order alternating), set here and
    on the server (its admin port's ``/flags``)."""
    import torch

    from brpc_tpu_torch.butil.flags import set_flag
    runs = []
    x = torch.ones(DEVICE_COST_BYTES // 4, device=dev)
    for turn in range(COST_TURNS):
        for on in ((False, True) if turn % 2 == 0 else (True, False)):
            status, body = _http_page(
                admin_port, f"/flags/device_stats_enabled?setvalue="
                f"{str(on).lower()}", "POST")
            check(status == 200, f"server refused the flag: {body!r}")
            check(set_flag("device_stats_enabled", on), "flag")
            times = []
            for i in range(SWEEP_WARMUP + DEVICE_COST_CALLS):
                t0 = time.perf_counter()
                c = ch.call_sync("Perf", "Echo", b"",
                                 request_device_arrays=[x])
                dt = time.perf_counter() - t0
                check(not c.failed(), f"cost echo: {c.error_text}")
                if i >= SWEEP_WARMUP:
                    times.append(dt)
            runs.append({"on": on, "turn": turn,
                         "p50_us": _median(times) * 1e6,
                         "p99_us": _p99(times) * 1e6})
    _http_page(admin_port, "/flags/device_stats_enabled?setvalue=true",
               "POST")
    set_flag("device_stats_enabled", True)
    return runs


def _mapped_check(dev) -> None:
    """A peer's allocations stay mapped only while a copy reads them."""
    if dev.type == "cuda":
        from brpc_tpu_torch.transport import cuda_ipc
        _sync(dev)
        check(_wait_for_value(cuda_ipc.mapped_count, 0),
              f"{cuda_ipc.mapped_count()} peer allocations still mapped")


def ici_client(port: int, spec: str, admin_port: int) -> int:
    """``--client ici PORT DEVICE ADMIN_PORT``: parts (f)-(h) over
    ``ici://127.0.0.1:PORT#device=DEVICE`` from a process of its own, a
    session of four steps, each a JSON line, the next on the server's go:
    (f) the first call timed apart, the sweep, a send filled on a side
    stream, ICI_CYCLES connect/echo/close cycles; (g) ATTEND_CALLS
    concurrent Attend calls; (h) SHORT_SWEEP_BYTES under rpcz, then
    ``device_stats_enabled`` off and on in turns. Each line carries this
    process's ici cells."""
    dev = _client_device(spec)
    import numpy as np
    import torch

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    addr = f"ici://127.0.0.1:{port}#device={spec}"
    doc = {"torch": torch.__version__}
    ch = Channel(addr, ChannelOptions(timeout_ms=30000))
    try:
        doc["lane"] = ch.device_lane_kind()
        doc["peer_info"] = ch._socket.conn.peer_info
        # the first call: the first IPC open on each side, timed apart
        x = torch.arange(1024, dtype=torch.float32, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        c = ch.call_sync("Perf", "Echo", b"", request_device_arrays=[x])
        doc["first_call_ms"] = (time.perf_counter() - t0) * 1e3
        check(not c.failed(), f"first ici echo: {c.error_code} "
                              f"{c.error_text}")
        check(torch.equal(c.response_device_arrays[0], x),
              f"first ici echo: {c.response_device_arrays[0][:8]} for "
              f"{x[:8]}")
        doc["sweep"] = _sweep(ch, dev, check_zero_copy=False)
        if dev.type == "cuda":
            doc["side_stream_filled"] = _side_stream_send(ch, dev)
    finally:
        ch.close()
    doc["cycles"] = _ici_cycles(addr, dev)
    _mapped_check(dev)
    doc["cells"] = _device_cells(ICI_LANES)
    emit(doc)
    _next_step()
    emit({"attend": _attend(addr, dev, ATTEND_CALLS,
                            np.random.RandomState(20261018)),
          "cells": _device_cells(ICI_LANES)})
    _next_step()
    emit(_traced_short_sweep(addr, dev))
    _next_step()
    ch = Channel(addr, ChannelOptions(timeout_ms=30000))
    try:
        runs = _device_cost_turns(ch, dev, admin_port)
    finally:
        ch.close()
    _mapped_check(dev)
    emit({"runs": runs, "cells": _device_cells(ICI_LANES)})
    return 0


class _Session:
    """A client process driven step by step: each step's JSON line is
    read from its stdout, the next step starts on a line to its stdin."""

    def __init__(self, args, env=None, timeout_s: float = 300):
        import queue
        self._timeout = timeout_s
        self._p = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--client",
             *args], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=None if env is None else dict(os.environ, **env))
        self._lines = queue.Queue()
        self._err = []
        threading.Thread(target=self._pump, args=(self._p.stdout,
                                                  self._lines),
                         daemon=True).start()
        threading.Thread(target=self._pump, args=(self._p.stderr,
                                                  self._err),
                         daemon=True).start()
        self.name = args[0]

    @staticmethod
    def _pump(f, sink) -> None:
        for line in f:
            (sink.put if hasattr(sink, "put") else sink.append)(line)
        if hasattr(sink, "put"):
            sink.put(None)

    def read(self) -> dict:
        """The step's JSON line (the last one it printed)."""
        import queue
        while True:
            try:
                line = self._lines.get(timeout=self._timeout)
            except queue.Empty:
                line = None
            if line is None:
                self.close()
                raise SmokeFailure(f"{self.name} client process failed: "
                                   f"{''.join(self._err)[-2000:]}")
            if line.startswith("{"):
                return json.loads(line)

    def step(self) -> dict:
        """Start the next step and read its line."""
        self._p.stdin.write("go\n")
        self._p.stdin.flush()
        return self.read()

    def close(self) -> None:
        try:
            self._p.stdin.close()
        except OSError:
            pass
        try:
            self._p.wait(30)
        except subprocess.TimeoutExpired:
            self._p.kill()
            self._p.wait()


class _IciTimes:
    """Times of this process's ici takes (in parse: the dispatcher) by
    size, and of each IPC open and close of a peer's allocation (the
    first open apart). Measurement only: wrapped for the part and put
    back after it."""

    def __init__(self):
        from brpc_tpu_torch.transport import cuda_ipc, ici
        self._ipc = cuda_ipc
        self._cls = ici.IciConn
        self._orig = (self._cls.take_device_payload, cuda_ipc.open_handle,
                      cuda_ipc.close_handle)
        self.takes = []
        self.opens = []
        self.closes = []

    def __enter__(self):
        take, open_handle, close_handle = self._orig
        takes, opens, closes = self.takes, self.opens, self.closes

        def timed_take(conn):
            t0 = time.perf_counter()
            r = take(conn)
            if r is not None:
                takes.append((sum(t.numel() * t.element_size() for t in r),
                              time.perf_counter() - t0,
                              threading.current_thread().name))
            return r

        def timed_open(handle, device_index):
            t0 = time.perf_counter()
            r = open_handle(handle, device_index)
            opens.append(time.perf_counter() - t0)
            return r

        def timed_close(base, device_index):
            t0 = time.perf_counter()
            close_handle(base, device_index)
            closes.append(time.perf_counter() - t0)
        self._cls.take_device_payload = timed_take
        self._ipc.open_handle = timed_open
        self._ipc.close_handle = timed_close
        return self

    def __exit__(self, *exc):
        (self._cls.take_device_payload, self._ipc.open_handle,
         self._ipc.close_handle) = self._orig

    def summary(self) -> dict:
        by_size = {}
        for n, dt, th in self.takes:
            by_size.setdefault(n, []).append(dt)
        later = self.opens[1:]
        return {
            "ipc_opens": len(self.opens),
            "first_open_ms": self.opens[0] * 1e3 if self.opens else None,
            "later_open_p50_ms": _median(later) * 1e3 if later else None,
            "later_open_max_ms": max(later) * 1e3 if later else None,
            "close_p50_ms": _median(self.closes) * 1e3
            if self.closes else None,
            "take_p50_ms_by_bytes": {str(n): _median(ts) * 1e3
                                     for n, ts in sorted(by_size.items())},
            "take_threads": sorted({th for _, _, th in self.takes})}


def _check_ici_cells(cells: dict, where: str, dev) -> None:
    """Each ici:// cell balanced; on a card, no staged batch (on the
    host, where the smoke is only rehearsed, the lane is staged)."""
    check(cells, f"{where}: no ici:// cell")
    for key, c in cells.items():
        if dev.type == "cuda":
            check(not key.endswith("|staged")
                  and c["staged_fallbacks"] == 0,
                  f"{where}: staged batches on {key}: {c}")
        check(c["transfers"] == c["completed"] + c["failed"],
              f"{where}: cell {key} does not balance: {c}")
        check(c["failed"] == 0, f"{where}: failed transfers on {key}")


def _settled_cells(lanes, timeout_s: float = 5.0) -> dict:
    """This process's cells of ``lanes`` once every transfer settled
    (the last batch of a connection is acknowledged by its close)."""
    deadline = time.monotonic() + timeout_s
    while True:
        cells = _device_cells(lanes)
        if all(c["transfers"] == c["completed"] + c["failed"]
               for c in cells.values()) or time.monotonic() > deadline:
            return cells
        time.sleep(0.02)


def _lane_spans(spans, lane: str) -> dict:
    """Medians of the device spans of ``lane`` by size: the write side
    (stage, wire, ack, latency) and the receive side (recv)."""
    rows = {}
    for d in spans:
        if d.get("side") != "device" or d.get("method") != lane:
            continue
        recv = not (d["write_done_us"] or d["first_byte_us"])
        r = rows.setdefault(str(d["request_size"]),
                            {"recv_us": [], "stage_us": [], "wire_us": [],
                             "ack_us": [], "latency_us": []})
        if recv:
            r["recv_us"].append(d["latency_us"])
        else:
            for k in ("stage_us", "wire_us", "ack_us", "latency_us"):
                r[k].append(d[k])
    return {n: {k + "_p50": _median(v) for k, v in r.items() if v}
            | {"sends": len(r["latency_us"]), "recvs": len(r["recv_us"])}
            for n, r in rows.items()}


class _LaneSpans:
    """Part (h)'s record: per lane, a short sweep under rpcz, the server
    spans read from ``/rpcz`` of the admin server right after it, and the
    client process's spans."""

    def __init__(self, admin_port: int):
        self.admin_port = admin_port
        self.lanes = {}

    def begin(self) -> None:
        from brpc_tpu_torch.butil.flags import set_flag
        from brpc_tpu_torch.rpc.span import global_collector
        check(set_flag("rpcz_enabled", True), "cannot turn rpcz on")
        global_collector.clear()

    def end(self, name: str, lane: str, doc: dict) -> None:
        """``doc``: the sweep's rows and the client's spans (None when
        the client ran in this process)."""
        from brpc_tpu_torch.butil.flags import set_flag
        status, body = _http_page(self.admin_port, "/rpcz?n=100000")
        set_flag("rpcz_enabled", False)
        check(status == 200, f"/rpcz: {status}")
        self.lanes[name] = {"lane": lane, "sweep": doc["sweep"],
                            "server_spans": json.loads(body),
                            "client_spans": doc.get("spans")}

    def report(self, dev) -> dict:
        """Each lane's write and receive sides against its echo p50; on
        ici:// every device span's stage + wire + ack equals its latency
        and its stage is at most its size's slowest echo; /device has a
        cell for every lane, the recv pool and the leaks."""
        out = {}
        for name, info in self.lanes.items():
            lane = info["lane"]
            mine = _lane_spans(info["server_spans"], lane)
            check(mine, f"{name}: no device span on the server")
            out[name] = {
                "lane": lane,
                "echo_p50_us": {str(r["bytes"]): r["p50_us"]
                                for r in info["sweep"]},
                "server_side": mine,
                "client_side": (_lane_spans(info["client_spans"], lane)
                                if info["client_spans"] is not None
                                else None)}
        ici = self.lanes["ici://"]
        slowest = {str(r["bytes"]): r["p99_us"] for r in ici["sweep"]}
        sends = [d for d in ici["server_spans"] + ici["client_spans"]
                 if d.get("side") == "device" and d.get("method")
                 == ici["lane"] and (d["write_done_us"]
                                     or d["first_byte_us"])]
        check(sends, "no ici:// device span")
        for d in sends:
            check(d["stage_us"] + d["wire_us"] + d["ack_us"]
                  == d["latency_us"], f"ici:// device span stages do not "
                                      f"sum to its latency: {d}")
            cap = slowest.get(str(d["request_size"]))
            check(cap is None or d["stage_us"] <= cap,
                  f"ici:// stage {d['stage_us']} us over the slowest echo "
                  f"{cap} us of its size")
        status, body = _http_page(self.admin_port, "/device")
        check(status == 200, f"/device: {status}")
        page = json.loads(body)
        cell_lanes = {k.rsplit("|", 1)[1] for k in page["cells"]}
        for info in self.lanes.values():
            check(info["lane"] in cell_lanes,
                  f"/device has no {info['lane']} cell: {cell_lanes}")
        if dev.type == "cuda":
            check(page["transfer_lane"] == "up",
                  f"/device transfer_lane {page['transfer_lane']}")
        check("recv_pool" in page and "leaks" in page,
              f"/device lacks the recv pool or the leaks: {sorted(page)}")
        return {"lanes": out,
                "device_page": {"cells": len(page["cells"]),
                                "lanes": sorted(cell_lanes),
                                "transfer_lane": page["transfer_lane"],
                                "recv_pool": page["recv_pool"],
                                "leaks": page["leaks"],
                                "totals": page["totals"],
                                "conns": len(page["conns"])}}


def _ici_parts(dev, spec: str, seen: dict, counted, parked,
               spans: _LaneSpans) -> dict:
    """Parts (f), (g) and ici:// of (h): one client process session (lane
    cuda-ipc on a card; the client fails any batch that would go
    staged)."""
    from brpc_tpu_torch.transport import event_dispatcher
    from brpc_tpu_torch.transport.ici import transfer_lane_status
    fa = _fa_module()
    env = ICI_REQUIRE_PULL if dev.type == "cuda" else None
    want_lane = "cuda-ipc" if dev.type == "cuda" else "staged"
    out = {}
    times = _IciTimes()
    with times:
        srv, ep = _device_lane_server(f"ici://127.0.0.1:0#device={spec}",
                                      dev, seen)
        session = None
        try:
            seen.pop("echo_devices", None)
            seen.pop("echo_lanes", None)
            _sync(dev)
            base = _allocated(dev)
            stalls0 = event_dispatcher.nstalls.get_value()
            progress("device_lane f_ici_sweep (client process)")
            fa.reset_launches()
            session = _Session(["ici", str(ep.port), spec,
                                str(spans.admin_port)], env, 600)
            doc = session.read()
            _sync(dev)
            out["launches_f"] = dict(fa.launches)
            check(not any(fa.launches.values()),
                  f"the ici sweep launched {fa.launches}")
            check(doc["lane"] == want_lane, f"client lane {doc['lane']}")
            check(seen.get("echo_lanes") == {want_lane},
                  f"server lanes {seen.get('echo_lanes')}")
            check(seen.get("echo_devices") == {str(dev)},
                  f"the handler saw tensors on {seen.get('echo_devices')}")
            if dev.type == "cuda":
                check(doc.get("side_stream_filled") is True,
                      "the ici side-stream send was read before it was "
                      "written")
                check(transfer_lane_status() == "up",
                      f"ici transfer lane {transfer_lane_status()}")
            server_cells = _settled_cells(ICI_LANES)
            _check_ici_cells(doc["cells"], "client process", dev)
            _check_ici_cells(server_cells, "server", dev)
            _wait_for_value(lambda: _allocated(dev), base, 10.0)
            after = _allocated(dev)
            check(after == base, f"the server holds {after - base} bytes "
                                 f"more on the card after the ici cycles")
            _mapped_check(dev)
            emit({"phase": "device_lane", "part": "f", "lane": "ici://",
                  "lane_kind": doc["lane"],
                  "note": "one card: a same-device CUDA IPC hand-off "
                          "between two processes, not a link",
                  "first_call_ms": doc["first_call_ms"],
                  "sweep": doc["sweep"],
                  "p50_us_ici_vs_cudad": {
                      str(r["bytes"]): [r["p50_us"], c["p50_us"]]
                      for r, c in zip(doc["sweep"],
                                      seen.get("cudad_sweep", []))},
                  "side_stream_filled": doc.get("side_stream_filled"),
                  "cycles": doc["cycles"],
                  "server_allocated": {"before": base, "after": after},
                  "server_takes": times.summary(),
                  "dispatcher_stall_ms_max_10s":
                      event_dispatcher.stall_ms_max_10s(),
                  "dispatcher_stalls": event_dispatcher.nstalls.get_value()
                  - stalls0,
                  "cells": {"client": doc["cells"],
                            "server": server_cells},
                  "transfer_lane": transfer_lane_status()})
            out["sweep"] = doc["sweep"]
            doc = parked("ici", counted, "g_attend_ici", session.step,
                         want={"flash_decode": ATTEND_CALLS,
                               "flash_decode_combine": ATTEND_CALLS})
            out["attend"] = doc["attend"]
            _check_ici_cells(doc["cells"], "attend client process", dev)
            progress("device_lane h_spans_ici (client process)")
            spans.begin()
            spans.end("ici://", want_lane, session.step())
            progress("device_lane h_device_stats_cost (client process)")
            doc = session.step()
            _check_ici_cells(doc["cells"], "cost client process", dev)
            out["cost"] = doc["runs"]
        finally:
            if session is not None:
                session.close()
            srv.stop()
            srv.join()
    _check_ici_cells(_settled_cells(ICI_LANES), "server", dev)
    return out


def phase_device_lane(dev):
    """Tensors in RPCs on the three device lanes: (a) the cuda:// sweep,
    zero-copy; (b) the cudad:// sweep from a client process, with the
    dispatcher's stall and the host copies' times; (c) one side-stream
    send; (d) Attend (decode_attention on delivered tensors, the handler
    parked on a CUDA event) on cuda:// and cudad://; (e) a stream of
    tensors beside unary calls on one connection, on both; (f) the
    sweep, a side-stream send and ICI_CYCLES connect/echo/close cycles on
    ici:// from a client process; (g) Attend over ici://; (h) a short
    sweep on each lane under rpcz, its device spans and /device, and
    ``device_stats_enabled``'s cost on ici://. Launch counts zeroed
    before each part, read after it."""
    import numpy as np
    import torch

    from brpc_tpu_torch.fiber import global_poller
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                    ServerOptions)
    from brpc_tpu_torch.transport import event_dispatcher
    fa = _fa_module()
    spec = _device_spec(dev)
    rng = np.random.RandomState(20261017)
    out = {"launches": {}, "stalls": {}}

    def counted(part, fn, *args, want=None, **kw):
        progress(f"device_lane {part}")
        stalls0 = event_dispatcher.nstalls.get_value()
        fa.reset_launches()
        r = fn(*args, **kw)
        _sync(dev)
        got = dict(fa.launches)
        out["launches"][part] = got
        # dispatcher ticks of dispatcher_stall_ms or more while the part ran
        out["stalls"][part] = event_dispatcher.nstalls.get_value() - stalls0
        want = want or {}
        check(all(got[k] == want.get(k, 0) for k in got),
              f"{part}: launched {got}, want {want}")
        return r

    poller = global_poller()
    park = {}

    def parked(lane, fn, *args, **kw):
        """Run an Attend part; every call must park on the waiter path,
        more than one at once, with no more waiter threads than calls
        in flight."""
        seen["max_in_flight"] = 0
        _open_gate(seen)
        poller.max_active_waiters = 0
        w0 = dict(poller.nwaits)
        try:
            r = fn(*args, **kw)
        finally:
            seen["gate_timer"].cancel()
        arrivals = seen["arrivals"]
        got = {"poller_waits": {k: poller.nwaits[k] - w0[k] for k in w0},
               "max_waiter_threads": poller.max_active_waiters,
               "max_calls_in_flight": seen["max_in_flight"],
               "arrival_spread_ms": (max(arrivals) - min(arrivals)) * 1e3}
        park[lane] = got
        check(got["poller_waits"]["waiter"] >= ATTEND_CALLS,
              f"{lane}: Attend did not park on the waiter path: {got}")
        check(got["max_calls_in_flight"] > 1,
              f"{lane}: Attend calls ran one at a time: {got}")
        check(0 < got["max_waiter_threads"] <= got["max_calls_in_flight"],
              f"{lane}: waiter threads against calls in flight: {got}")
        return r

    if dev.type == "cuda":
        # build and load flash_decode, and load Check's kernels, before
        # any handler launches them (the handler runs in place on the
        # dispatcher until it parks, and a kernel's first launch loads
        # its module, which can wait for the work on the card)
        z = torch.zeros(4, 64, 128, dtype=torch.bfloat16, device=dev)
        fa.decode_attention(z[:, 0].contiguous(), z, z, torch.full(
            (4,), 64, dtype=torch.int32, device=dev))
        bool((torch.full((1 << 20,), 7.0, device=dev) == 7).all())
    seen = {}
    # the pages (/rpcz, /device, /flags) of this process, for part (h)
    admin = Server(ServerOptions(enable_builtin_services=True))
    spans = _LaneSpans(admin.start("tcp://127.0.0.1:0").port)
    try:
        srv, ep = _device_lane_server(f"cuda://smoke:1#device={spec}", dev,
                                      seen)
        try:
            ch = Channel(str(ep), ChannelOptions(timeout_ms=60000))
            check(ch.device_lane_kind() == "loopback-d2d",
                  "cuda:// lane kind")
            rows = counted("a_cuda_sweep", _sweep, ch, dev, True)
            emit({"phase": "device_lane", "part": "a", "lane": "cuda://",
                  "zero_copy": True, "sweep": rows})
            if dev.type == "cuda":
                w0 = dict(poller.nwaits)
                ok = counted("c_side_stream", _side_stream_send, ch, dev)
                check(ok, "the side-stream send was read before it was "
                          "written")
                emit({"phase": "device_lane", "part": "c", "filled": ok,
                      "poller_waits": {k: poller.nwaits[k] - w0[k]
                                       for k in w0}})
            attend = {}
            attend["cuda"] = parked(
                "cuda", counted, "d_attend_cuda", _attend, str(ep), dev,
                ATTEND_CALLS, rng,
                want={"flash_decode": ATTEND_CALLS,
                      "flash_decode_combine": ATTEND_CALLS})
            streams = {"cuda": counted("e_streams_cuda",
                                       _frames_beside_unary, ch, dev)}
            progress("device_lane h_spans_cuda")
            spans.begin()
            spans.end("cuda://", "loopback-d2d",
                      {"sweep": _sweep(ch, dev, False, SHORT_SWEEP_BYTES,
                                       SHORT_SWEEP_CALLS)})
            ch.close()
        finally:
            srv.stop()
            srv.join()

        copies = _CopyTimes()
        with copies:
            srv, ep = _device_lane_server(
                f"cudad://127.0.0.1:0#device={spec}", dev, seen)
            session = None
            try:
                seen.pop("echo_devices", None)
                stalls0 = event_dispatcher.nstalls.get_value()
                progress("device_lane b_cudad_sweep (client process)")
                fa.reset_launches()
                session = _Session(["device_lane", str(ep.port), spec],
                                   timeout_s=600)
                doc = session.read()
                _sync(dev)
                out["launches"]["b_cudad_sweep"] = dict(fa.launches)
                check(not any(fa.launches.values()), "the sweep launched "
                                                     "a kernel")
                out["stalls"]["b_cudad_sweep"] = \
                    event_dispatcher.nstalls.get_value() - stalls0
                check(doc["lane"] == "staged-dcn", f"lane {doc['lane']}")
                check(seen.get("echo_devices") == {str(dev)},
                      f"the handler saw tensors on "
                      f"{seen.get('echo_devices')}")
                stall = event_dispatcher.stall_ms_max_10s()
                big = {str(n): {
                    "take_on_dispatcher": copies.summary("take", n),
                    "response_write": copies.summary("write", n),
                    "response_encode": copies.summary("encode", n)}
                    for n in (1 << 20, 4 << 20)}
                seen["cudad_sweep"] = doc["sweep"]
                emit({"phase": "device_lane", "part": "b",
                      "lane": "cudad://", "sweep": doc["sweep"],
                      "peer_info": doc["peer_info"],
                      "dispatcher_stall_ms_max_10s": stall,
                      "dispatcher_stalls":
                          event_dispatcher.nstalls.get_value() - stalls0,
                      "host_copies": big})
                progress("device_lane h_spans_cudad (client process)")
                spans.begin()
                spans.end("cudad://", "staged-dcn", session.step())
                session.close()
                session = None
                ch = Channel(str(ep), ChannelOptions(timeout_ms=60000))
                attend["cudad"] = parked(
                    "cudad", counted, "d_attend_cudad", _attend, str(ep),
                    dev, ATTEND_CALLS, rng,
                    want={"flash_decode": ATTEND_CALLS,
                          "flash_decode_combine": ATTEND_CALLS})
                streams["cudad"] = counted("e_streams_cudad",
                                           _frames_beside_unary, ch, dev)
                ch.close()
            finally:
                if session is not None:
                    session.close()
                srv.stop()
                srv.join()
        ici = _ici_parts(dev, spec, seen, counted, parked, spans)
        attend["ici"] = ici["attend"]
        emit({"phase": "device_lane", "part": "h", **spans.report(dev),
              "device_stats_cost_ici_64KiB": ici["cost"]})
    finally:
        admin.stop()
        admin.join()
    resumed = seen.get("attend_resumed", [])
    check(len(resumed) == 3 * ATTEND_CALLS
          and all(r[0] and r[1] for r in resumed),
          f"Attend handlers resumed off a worker or before the event: "
          f"{resumed}")
    check("frames_error" not in seen, seen.get("frames_error", ""))
    gil = _gil_released_by_event_wait(dev) if dev.type == "cuda" else None
    if gil is not None:
        check(gil["max_gap_ms"] < 20.0,
              f"Event.synchronize held the interpreter lock: {gil}")
    emit({"phase": "device_lane", "part": "d", "attend": attend,
          "resumed_threads": sorted({r[2] for r in resumed}),
          "park": park, "event_synchronize": gil})
    emit({"phase": "device_lane", "part": "e", "streams": streams})
    emit({"phase": "device_lane", "launches": out["launches"],
          "dispatcher_stalls_by_part": out["stalls"]})
    out["attend"] = attend
    out["ici_sweep"] = ici["sweep"]
    return out


# ------------------------------------------------------------- combo

COMBO_SHARDS = 8
# fp32 [8, dim/8] requests of 256 KiB and 4 MiB
COMBO_DIMS = (1 << 16, 1 << 20)
COMBO_CALLS = 20            # timed calls of each style and size
COMBO_WARMUP = 2
COMBO_ATTEND_CALLS = 5      # nested Attend calls, the first cold
RING_SHAPE = (8, 2048, 64)  # examples/long_context's heads x seq x dim
RING_ITERS = 5


def _combo_server(addr: str, service: str, methods: dict):
    """A port Server with ``service``'s ``methods``, started on ``addr``."""
    from brpc_tpu_torch.rpc import Server, ServerOptions, Service
    svc = Service(service)
    for name, fn in methods.items():
        svc.register_method(name, fn)
    srv = Server(ServerOptions(enable_builtin_services=False))
    srv.add_service(svc)
    return srv, str(srv.start(addr))


class _MetaTimeouts:
    """The request meta's ``timeout_ms`` of every request the port's
    servers in this process process, by service. Measurement only: the
    dispatch entry is wrapped for the part and put back after it."""

    def __init__(self):
        from brpc_tpu_torch.rpc import server_dispatch
        self._mod = server_dispatch
        self._orig = server_dispatch.process_request
        self.seen = []

    def __enter__(self):
        orig, seen = self._orig, self.seen

        def spy(proto, msg, socket):
            r = msg.meta.request
            seen.append((r.service_name, r.timeout_ms))
            return orig(proto, msg, socket)
        self._mod.process_request = spy
        return self

    def __exit__(self, *exc):
        self._mod.process_request = self._orig

    def of(self, service: str) -> list:
        return [t for s, t in self.seen if s == service]


def _reduce_style(pch, style: str, x, want: float, calls: int) -> dict:
    """``calls`` ParallelChannel calls of one style: ``sync``
    (``call_sync``), ``done`` (``call(done=)``, waited on an Event) or
    ``async`` (``call_async`` awaited in a fiber). Each result read back
    (a host sync) and held to the host's sum; p50/p99 of the wall ms."""
    from brpc_tpu_torch.fiber import spawn
    from brpc_tpu_torch.rpc import Controller

    def one():
        cntl = Controller()
        cntl.request_device_arrays = [x]
        if style == "sync":
            pch.call_sync("Reduce", "Sum", b"", cntl=cntl)
        elif style == "done":
            ev = threading.Event()
            pch.call("Reduce", "Sum", b"", cntl=cntl,
                     done=lambda c: ev.set())
            check(ev.wait(30), "Reduce: done never ran")
        else:
            async def in_fiber():
                return await pch.call_async("Reduce", "Sum", b"",
                                            cntl=cntl)
            f = spawn(in_fiber)
            check(f.join(30), "Reduce: the fiber never finished")
            check(f.value() is cntl, "Reduce: call_async's controller")
        check(not cntl.failed(), f"Reduce {style}: {cntl.error_code} "
                                 f"{cntl.error_text}")
        (total,) = cntl.response_device_arrays
        got = float(total.sum())
        check(abs(got - want) <= FP32_TOL * abs(want),
              f"Reduce {style}: sum {got} against the host's {want}")
        return cntl
    times = []
    for i in range(COMBO_WARMUP + calls):
        t0 = time.perf_counter()
        cntl = one()
        if i >= COMBO_WARMUP:
            times.append(time.perf_counter() - t0)
    return {"p50_ms": _median(times) * 1e3, "p99_ms": _p99(times) * 1e3,
            "calls": calls, "lowered": cntl.collective_lowered}


def _allreduce_parts(dev, rng, counted) -> dict:
    """(a) ParallelChannel 8-shard tensor allreduce on 8 cuda:// servers,
    three call styles; (b) the same calls with attach_collective."""
    import torch

    from brpc_tpu_torch.parallel import CollectiveChannel, make_rpc_mesh
    from brpc_tpu_torch.rpc import (CallMapper, Channel, ChannelOptions,
                                    ParallelChannel, ResponseMerger, SubCall)

    def Sum(cntl, request):
        (x,) = cntl.request_device_arrays
        cntl.response_device_arrays = [x.sum().reshape(1)]
        return b""
    spec = _device_spec(dev)
    made = [_combo_server(f"cuda://combo-{i}:1#device={spec}", "Reduce",
                          {"Sum": Sum}) for i in range(COMBO_SHARDS)]

    class RowMapper(CallMapper):
        def map(self, i, n, service, method, request, cntl):
            return SubCall(service, method, request,
                           device_arrays=[cntl.request_device_arrays[0][i]])

    class SumMerger(ResponseMerger):
        """Sums the sub-responses on the card as they come."""

        def __init__(self):
            self._lock = threading.Lock()

        def merge(self, final, i, sub):
            (t,) = sub.response_device_arrays
            with self._lock:
                acc = final.response_device_arrays
                final.response_device_arrays = [t if not acc else acc[0] + t]
    chans = []

    def channels():
        out = [Channel(addr, ChannelOptions(timeout_ms=10000))
               for _, addr in made]
        chans.extend(out)
        return out
    fanned = ParallelChannel(call_mapper=RowMapper(),
                             response_merger=SumMerger())
    for ch in channels():
        fanned.add_sub_channel(ch)
    lowered = ParallelChannel()
    for ch in channels():
        lowered.add_sub_channel(ch)
    mesh = make_rpc_mesh(1, COMBO_SHARDS, devices=[dev] * COMBO_SHARDS)
    lowered.attach_collective(CollectiveChannel(mesh, merge="sum"),
                              {("Reduce", "Sum"):
                               lambda s: s.sum().reshape(1)})
    out = {"a": {}, "b": {}}
    try:
        for dim in COMBO_DIMS:
            x = torch.from_numpy(rng.rand(COMBO_SHARDS, dim // COMBO_SHARDS)
                                 .astype("float32")).to(dev)
            want = float(x.double().sum())
            key = f"{dim * 4 >> 10}KiB"
            out["a"][key] = counted(
                f"a_{key}", lambda: {s: _reduce_style(fanned, s, x, want,
                                                      COMBO_CALLS)
                                     for s in ("sync", "done", "async")})
            before = (lowered.collective_fused, lowered.collective_fallbacks)
            b = counted(f"b_{key}", _reduce_style, lowered, "sync", x, want,
                        COMBO_CALLS)
            calls = COMBO_WARMUP + COMBO_CALLS
            check(b["lowered"] and lowered.collective_fused == before[0]
                  + calls and lowered.collective_fallbacks == 0,
                  f"attach_collective: fused {lowered.collective_fused}, "
                  f"fallbacks {lowered.collective_fallbacks} after {calls} "
                  f"calls")
            b["fused"] = lowered.collective_fused - before[0]
            b["fallbacks"] = lowered.collective_fallbacks
            out["b"][key] = b
    finally:
        for ch in chans:
            ch.close()
        for srv, _ in made:
            srv.stop()
            srv.join()
    return out


def _nested_attend(dev, rng, counted) -> dict:
    """(c) An async handler fans Attend out by head to 4 partition
    servers through a PartitionChannel, awaiting ``call_async``; the
    sub-calls' meta timeout against the handler's remaining budget; a
    handler whose budget is spent issues nothing."""
    import torch

    from brpc_tpu_torch.fiber import sleep
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller,
                                    PartitionChannel, PartitionParser,
                                    SubCall, errno_codes as berr)
    fa = _fa_module()
    spec = _device_spec(dev)
    b, L, d = 4, 4096, 128

    def Attend(cntl, request):
        q, k, v, lengths = cntl.request_device_arrays
        cntl.response_device_arrays = [fa.decode_attention(q, k, v,
                                                           lengths)]
        return b"o"
    parts = [_combo_server(f"cuda://combo-part-{i}:1#device={spec}",
                           "Part", {"Attend": Attend}) for i in range(b)]

    class HeadParser(PartitionParser):
        def parse(self, i, n, service, method, request, cntl):
            return SubCall("Part", "Attend", request, device_arrays=[
                t[i:i + 1] for t in cntl.request_device_arrays])
    # the partitions' own timeout is longer than any parent's budget:
    # what reaches them is the parent's remaining budget
    chans = [Channel(addr, ChannelOptions(timeout_ms=600000))
             for _, addr in parts]
    pch = PartitionChannel(partition_parser=HeadParser())
    for ch in chans:
        ch.device_lane_kind()           # dial before any handler runs
        pch.add_partition(ch)
    seen = {"remaining": [], "spent": []}

    async def FrontAttend(cntl, request):
        seen["remaining"].append(cntl.remaining_ms())
        sub = Controller()
        sub.request_device_arrays = list(cntl.request_device_arrays)
        c = await pch.call_async("Part", "Attend", b"", cntl=sub)
        if c.failed():
            cntl.set_failed(c.error_code, c.error_text)
            return b""
        cntl.response_device_arrays = [
            torch.cat([a[0] for a in c.sub_device_arrays])]
        return b"o"

    async def Spent(cntl, request):
        await sleep(0.08)               # past the client's 40 ms
        one = chans[0].call("Part", "Attend", b"",
                            request_device_arrays=cntl.request_device_arrays)
        sub = Controller()
        sub.request_device_arrays = list(cntl.request_device_arrays)
        fan = pch.call("Part", "Attend", b"", cntl=sub)
        seen["spent"].append((one._finalized and fan._finalized,
                              one.error_code, fan.error_code,
                              [e[0] for e in fan.sub_errors if e],
                              one.latency_us()))
        return b""
    front, front_addr = _combo_server(
        f"cuda://combo-front:1#device={spec}", "Front",
        {"Attend": FrontAttend, "Spent": Spent})
    client = Channel(front_addr, ChannelOptions(timeout_ms=30000))
    lengths = torch.tensor([0, 1, 4096, 3000], dtype=torch.int32,
                           device=dev)
    out = {}
    try:
        inputs = [(_rand(rng, (b, d), torch.bfloat16, dev),
                   _rand(rng, (b, L, d), torch.bfloat16, dev),
                   _rand(rng, (b, L, d), torch.bfloat16, dev))
                  for _ in range(COMBO_ATTEND_CALLS)]
        _sync(dev)

        def calls():
            times, outs = [], []
            for q, k, v in inputs:
                t0 = time.perf_counter()
                c = client.call_sync("Front", "Attend", b"",
                                     request_device_arrays=[q, k, v,
                                                            lengths])
                check(not c.failed(), f"nested Attend: {c.error_code} "
                                      f"{c.error_text}")
                (o,) = c.response_device_arrays
                _sync(dev)
                times.append(time.perf_counter() - t0)
                outs.append(o)
            return times, outs
        with _MetaTimeouts() as meta:
            times, outs = counted(
                "c_nested_attend", calls,
                want={"flash_decode": b * COMBO_ATTEND_CALLS,
                      "flash_decode_combine": b * COMBO_ATTEND_CALLS})
            sub_timeouts = meta.of("Part")
            n_before = len(sub_timeouts)
            c = Channel(front_addr, ChannelOptions(timeout_ms=40))
            r = c.call_sync("Front", "Spent", b"",
                            request_device_arrays=[*inputs[0], lengths])
            c.close()
            check(r.error_code == berr.ERPCTIMEDOUT,
                  f"Spent: the client got {r.error_code}")
            check(_wait_for_value(lambda: len(seen["spent"]), 1),
                  "Spent: the handler never ran its nested call")
            check(len(meta.of("Part")) == n_before,
                  "a nested call with its parent's budget spent reached "
                  "a partition")
        worst = max_err = 0.0
        for (q, k, v), o in zip(inputs, outs):
            want = fa._flash_plain(q[:, None].float(), k.float(), v.float(),
                                   d ** -0.5, True, 64,
                                   q_offset=lengths - 1)[:, 0]
            check(o.shape == q.shape and o.dtype == q.dtype,
                  f"nested Attend output {tuple(o.shape)} {o.dtype}")
            diff = (o.float() - want).abs()
            worst = max(worst, float((diff / fa._rounding_bound(
                want, torch.bfloat16)).max()))
            max_err = max(max_err, float(diff.max()))
        check(worst <= 1.0, f"nested Attend: O off the plain version by "
                            f"{worst:.3f} x its rounding bound")
        check(len(sub_timeouts) == b * COMBO_ATTEND_CALLS,
              f"{len(sub_timeouts)} partition calls seen")
        pairs = [(max(sub_timeouts[i * b:(i + 1) * b]), rem)
                 for i, rem in enumerate(seen["remaining"])]
        check(all(0 < t <= rem for t, rem in pairs),
              f"sub-call timeouts over the parent's remaining budget: "
              f"{pairs}")
        finalized, one, fan, sub_codes, spent_us = seen["spent"][0]
        check(finalized and one == berr.ERPCTIMEDOUT
              and fan == berr.ETOOMANYFAILS and sub_codes
              and set(sub_codes) == {berr.ERPCTIMEDOUT},
              f"Spent: {one}, fan-out {fan} {sub_codes}")
        out = {"calls": COMBO_ATTEND_CALLS, "worst_over_bound": worst,
               "max_abs_err": max_err, "first_ms": times[0] * 1e3,
               "p50_ms": _median(times[1:]) * 1e3,
               "sub_timeout_ms_vs_parent_remaining_ms": pairs,
               "spent_budget_us": spent_us}
    finally:
        client.close()
        for ch in chans:
            ch.close()
        for srv, _ in parts + [(front, front_addr)]:
            srv.stop()
            srv.join()
    return out


def _wall_ms(fn, iters: int) -> list:
    """Wall ms of each of ``iters`` calls after one warm-up, the device
    synchronised after each."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _sequence_parallel(dev, rng, counted) -> dict:
    """(d) Ring and Ulysses attention on an 8-shard mesh of ``dev`` at 8
    heads x 2048 x 64 fp32, causal and not, held to the port's
    flash_attention (flash_attn_fwd)."""
    import torch

    from brpc_tpu_torch.ops import ring_attention, ulysses_attention
    from brpc_tpu_torch.parallel import make_rpc_mesh
    fa = _fa_module()
    mesh = make_rpc_mesh(1, COMBO_SHARDS, devices=[dev] * COMBO_SHARDS)
    q, k, v = (_rand(rng, RING_SHAPE, torch.float32, dev) for _ in range(3))

    def check_all():
        res = {}
        for causal in (False, True):
            want = fa.flash_attention(q, k, v, causal=causal)
            for name, fn in (("ring", ring_attention),
                             ("ulysses", ulysses_attention)):
                got = fn(mesh, q, k, v, causal=causal)
                err = float((got - want).abs().max())
                check(got.shape == want.shape and err <= FP32_TOL,
                      f"{name} attention{' causal' if causal else ''}: "
                      f"{err} from flash_attention")
                res[f"{name}{'_causal' if causal else ''}_max_abs_err"] = err
        return res
    out = counted("d_sequence_parallel", check_all,
                  want={"flash_attn_fwd": 2})
    for causal in (False, True):
        tag = "_causal" if causal else ""
        for name, fn in (
                ("flash_attention",
                 lambda: fa.flash_attention(q, k, v, causal=causal)),
                ("ring", lambda: ring_attention(mesh, q, k, v,
                                                causal=causal)),
                ("ulysses", lambda: ulysses_attention(mesh, q, k, v,
                                                      causal=causal))):
            if dev.type == "cuda":
                out[f"{name}{tag}_wall_ms_p50"] = _median(
                    _wall_ms(fn, RING_ITERS))
        if dev.type == "cuda":
            out[f"flash_attention{tag}_ms"] = cuda_time_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal), 20)[0]
    return out


def phase_combo(dev):
    """Combo channels and mesh collectives on the card: (a) the 8-shard
    tensor allreduce through a ParallelChannel, call_sync, call(done=)
    and call_async; (b) the same call lowered by attach_collective;
    (c) nested async calls through a PartitionChannel with inherited
    deadlines; (d) ring and Ulysses attention. Launch counts zeroed
    before each part, read after it."""
    import numpy as np

    fa = _fa_module()
    rng = np.random.RandomState(20261018)
    launches = {}

    def counted(part, fn, *args, want=None, **kw):
        progress(f"combo {part}")
        fa.reset_launches()
        r = fn(*args, **kw)
        _sync(dev)
        got = dict(fa.launches)
        launches[part] = got
        want = want or {}
        check(all(got[k] == want.get(k, 0) for k in got),
              f"combo {part}: launched {got}, want {want}")
        return r
    out = _allreduce_parts(dev, rng, counted)
    out["c"] = _nested_attend(dev, rng, counted)
    out["d"] = _sequence_parallel(dev, rng, counted)
    for part in "abcd":
        emit({"phase": "combo", "part": part, part: out[part]})
    emit({"phase": "combo", "launches": launches})
    out["launches"] = launches
    return out


# ------------------------------------------------------- phase cluster

CLUSTER_REPLICAS = 3
CLUSTER_CALLS = 48
CLUSTER_THREADS = 8
CLUSTER_SHED_THREADS = 16
CLUSTER_SEQ_CALLS = 8           # a turn of calls one at a time
CLUSTER_KILL_AFTER_S = 0.15
BACKUP_MS = 5
SLOW_DELAY_S = 0.05
BACKUP_CALLS = 20
CLUSTER_TOKEN = "cluster-secret"
AUTH_BAD_CALLS = 8
COMPRESS_SNAPPY = 3


def _cluster_prompts(n: int = CLUSTER_CALLS):
    return [f"replica {i:02d}: {'jumps over the lazy dog '[: 4 + i % 20]}"
            for i in range(n)]


class _Replica:
    """A GenerateService replica: a port Server on tcp with its own
    engine on the default device (cuda:0), restartable on its port.
    Every replica joins ``fleet``, whose decode steps the launch counts
    are held against, stopped ones too."""

    def __init__(self, fleet: list, port: int = 0, max_waiting=None,
                 **opts):
        from brpc_tpu_torch import serving
        from brpc_tpu_torch.rpc import Server, ServerOptions
        self.server = Server(ServerOptions(**opts))
        kw = {} if max_waiting is None else {"max_waiting": max_waiting}
        self.gs = serving.add_generate_service(self.server, **kw)
        check(str(self.gs.device) == "cuda:0",
              f"service device {self.gs.device}")
        ep = self.server.start(f"tcp://127.0.0.1:{port}")
        self.port = ep.port
        self.addr = f"tcp://127.0.0.1:{ep.port}"
        fleet.append(self)

    def steps(self) -> int:
        return self.gs.batcher.decode_steps + self.gs.engine.warmup_steps

    def kill(self) -> None:
        """A replica that dies: its connections drop first, so nothing it
        was doing answers, then it stops."""
        for s in self.server.connections():
            s.set_failed(ConnectionError("replica stopped"))
        self.server.stop()
        self.server.join(0)

    def stop(self) -> None:
        self.server.stop()
        self.server.join(10)


def _cluster_burst(ch, prompts, threads: int, calls=None):
    """``threads`` client threads share ``ch``, the prompts dealt
    round-robin; returns ({prompt: tokens}, [(prompt, errno, text)],
    wall s, [ms a call], [controllers])."""
    results, errors, latency, cntls = {}, [], [], []
    lock = threading.Lock()

    def client(idx):
        for p in prompts[idx::threads]:
            t0 = time.perf_counter()
            c = ch.call_sync("GenerateService", "Generate", json.dumps(
                {"prompt": p, "max_tokens": MAX_TOKENS}).encode())
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                cntls.append((p, c))
                if c.failed():
                    errors.append((p, c.error_code, c.error_text))
                else:
                    latency.append(ms)
                    results[p] = json.loads(c.response)["tokens"]
    ts = [threading.Thread(target=client, args=(i,)) for i in
          range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return results, errors, time.perf_counter() - t0, latency, cntls


def _by_replica(cntls, replicas) -> dict:
    """Calls answered by each replica, by the port of the server whose
    response completed the call."""
    ports = {r.port: i for i, r in enumerate(replicas)}
    out = [0] * len(replicas)
    for _, c in cntls:
        if c.responded_server is not None:
            out[ports[c.responded_server.port]] += 1
    return out


def _mean_batch(gs, before: dict) -> float:
    """Tokens a decode step since ``before`` (a copy of batch_hist)."""
    hist = dict(gs.batcher.batch_hist)
    steps = sum(hist.values()) - sum(before.values())
    toks = sum(k * v for k, v in hist.items()) - sum(
        k * v for k, v in before.items())
    return toks / steps if steps else 0.0


def _p50_p99(xs) -> dict:
    return {"p50_ms": _median(xs), "p99_ms": _p99(xs), "n": len(xs)}


def _cluster_spread(replicas, ch, oracle, prompts) -> dict:
    """(a) The burst through the ClusterChannel, then phase 3's burst
    (a Channel a thread) at replica 0 alone, then calls one at a time,
    cluster and plain channel in turns."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    hists = [dict(r.gs.batcher.batch_hist) for r in replicas]
    res, errs, wall, lat, cntls = _cluster_burst(
        ch, prompts, CLUSTER_THREADS)
    _check_burst("cluster (a)", res, errs, oracle)
    served = _by_replica(cntls, replicas)
    check(all(n > 0 for n in served),
          f"cluster (a): calls by replica {served}")
    mean_batch = [_mean_batch(r.gs, h) for r, h in zip(replicas, hists)]
    h0 = dict(replicas[0].gs.batcher.batch_hist)
    res2, errs2, wall2, lat2 = _burst(replicas[0].port, prompts,
                                      MAX_TOKENS)[:4]
    _check_burst("cluster (a) plain", res2, errs2, oracle)
    plain_batch = _mean_batch(replicas[0].gs, h0)
    # the cluster layer's cost: one call at a time, the two channels in
    # turns (C P C P); the ClusterChannel's picks land anywhere
    plain = Channel(replicas[0].addr, ChannelOptions(timeout_ms=120000))
    seq = {"cluster": [], "plain": []}
    body = json.dumps({"prompt": prompts[0],
                       "max_tokens": MAX_TOKENS}).encode()
    try:
        for turn in ("cluster", "plain", "cluster", "plain"):
            c_ = ch if turn == "cluster" else plain
            for _ in range(CLUSTER_SEQ_CALLS):
                t0 = time.perf_counter()
                c = c_.call_sync("GenerateService", "Generate", body)
                check(not c.failed() and json.loads(c.response)[
                    "tokens"] == oracle[prompts[0]],
                      f"cluster (a) {turn}: {c.error_code} {c.error_text}")
                seq[turn].append((time.perf_counter() - t0) * 1e3)
    finally:
        plain.close()
    check(not any(c.current_try for _, c in cntls),
          "cluster (a): a call retried with every replica up")
    tokens = sum(len(t) for t in res.values())
    return {"calls": len(cntls), "by_replica": served, "wall_s": wall,
            "tokens_per_s": tokens / wall, **_p50_p99(lat),
            "tokens_per_step": mean_batch,
            "plain_burst": {"wall_s": wall2, "tokens_per_s": tokens / wall2,
                            "tokens_per_step": plain_batch,
                            **_p50_p99(lat2)},
            "one_at_a_time": {k: _p50_p99(v) for k, v in seq.items()},
            "cluster_cost_p50_ms": _median(seq["cluster"])
            - _median(seq["plain"])}


def _la_feedback_spy(ch, ep):
    """Latency samples ``ch``'s balancer takes for ``ep`` (measurement
    only: the balancer's method is wrapped for the part)."""
    lb = ch._lb
    seen = []
    orig = lb.feedback

    def spy(server, latency_us, failed):
        if server == ep:
            seen.append((latency_us, failed))
        return orig(server, latency_us, failed)
    lb.feedback = spy
    return seen, lambda: setattr(lb, "feedback", orig)


def _cluster_shed(replicas, ch, oracle, prompts) -> dict:
    """(b) Replica 0 restarted with max_concurrency 2 and 2 waiting: it
    sheds, the calls retry elsewhere, no call fails."""
    from brpc_tpu_torch.rpc import backend_stats as bs
    from brpc_tpu_torch.rpc import server_dispatch
    from brpc_tpu_torch.butil.endpoint import str2endpoint
    r0 = replicas[0]
    ep0 = str2endpoint(r0.addr)
    limit0 = server_dispatch.nlimit_shed.get_value()
    shed0 = r0.gs.batcher.shed
    rb = ch._retry_budget
    tokens0 = rb.tokens()
    cell = bs.global_stats().cell(ch.stats_name, bs.ep_key(ep0))
    row0 = cell.get_value()
    rejects0 = (ch._lb.decision_info(ep0) or {}).get("rejects", 0)
    seen, restore = _la_feedback_spy(ch, ep0)
    try:
        res, errs, wall, lat, cntls = _cluster_burst(
            ch, prompts, CLUSTER_SHED_THREADS)
    finally:
        restore()
    _check_burst("cluster (b)", res, errs, oracle)
    limit_shed = server_dispatch.nlimit_shed.get_value() - limit0
    engine_shed = replicas[0].gs.batcher.shed - shed0
    retried = sum(c.retried_count() for _, c in cntls)
    check(limit_shed > 0 or engine_shed > 0,
          "cluster (b): replica 0 shed nothing")
    check(retried > 0, "cluster (b): no call retried")
    row = cell.get_value()
    rejects = row["rejects"] - row0["rejects"]
    answered = sum(1 for _, c in cntls
                   if c.responded_server is not None
                   and c.responded_server.port == r0.port)
    la_rejects = ch._lb.decision_info(ep0).get("rejects", 0) - rejects0
    check(rb.tokens() == tokens0,
          f"cluster (b): retry tokens {tokens0} -> {rb.tokens()}")
    # rejects return la's slot and nothing else: its latency samples
    # for replica 0 are the calls replica 0 answered
    check(rejects > 0 and la_rejects == rejects and len(seen) == answered
          and not any(f for _, f in seen),
          f"cluster (b): {rejects} rejects in the cell, {la_rejects} in la,"
          f" {len(seen)} la samples for {answered} calls answered")
    return {"calls": len(cntls), "threads": CLUSTER_SHED_THREADS,
            "server_limit_shed": limit_shed, "engine_shed": engine_shed,
            "retried": retried, "rejects": rejects,
            "by_replica": _by_replica(cntls, replicas),
            "retry_tokens": [tokens0, rb.tokens()], "wall_s": wall,
            **_p50_p99(lat)}


def _http_json(port: int, path: str):
    return json.loads(_http_page(port, path)[1])


def _cluster_failover(replicas, fleet, ch, oracle, prompts) -> dict:
    """(c) Replica 1 killed while a burst is in flight; every call ends
    with the right tokens, the ones it held retried elsewhere; then it
    restarts on its port, is revived, and serves again."""
    from brpc_tpu_torch.rpc import backend_stats as bs
    from brpc_tpu_torch.rpc.circuit_breaker import all_breaker_snapshots
    r1 = replicas[1]
    kill_us = []

    def kill():
        kill_us.append(time.monotonic_ns() // 1000)
        r1.kill()
    timer = threading.Timer(CLUSTER_KILL_AFTER_S, kill)
    timer.start()
    res, errs, wall, lat, cntls = _cluster_burst(ch, prompts,
                                                 CLUSTER_THREADS)
    timer.join()
    _check_burst("cluster (c)", res, errs, oracle)
    moved = [c for _, c in cntls if c.tried_servers
             and c.tried_servers[0].port == r1.port and c.current_try]
    check(moved, "cluster (c): no call in flight on replica 1 retried")
    check(all(c.responded_server.port != r1.port for c in moved),
          "cluster (c): a retried call was answered by the dead replica")
    key = f"tcp://127.0.0.1:{r1.port}"
    dead = [e.port for e in ch._health.dead_set()]
    breaker = all_breaker_snapshots().get(key)
    page = _http_json(replicas[0].port, "/backends")
    row = page["channels"][ch.stats_name]["backends"][key]
    check(r1.port in dead and row["state"]["health_dead"],
          f"cluster (c): replica 1 not dead ({dead}, {row['state']})")
    check(breaker is not None and breaker["error_rate_long"] > 0,
          f"cluster (c): breaker {breaker}")
    failover_ms = (max(c.end_us for c in moved) - kill_us[0]) / 1e3
    # the restart: the health checker revives it, and it serves again
    t0 = time.perf_counter()
    replicas[1] = _Replica(fleet, r1.port)
    check(_wait_for_value(lambda: not ch._health.dead_set(), True, 10.0),
          "cluster (c): replica 1 never revived")
    revive_ms = (time.perf_counter() - t0) * 1e3
    res2, errs2, _, _, cntls2 = _cluster_burst(ch, prompts[:24],
                                               CLUSTER_THREADS)
    _check_burst("cluster (c) after", res2, errs2,
                 {p: oracle[p] for p in prompts[:24]})
    after = _by_replica(cntls2, replicas)
    check(after[1] > 0, f"cluster (c): calls by replica after {after}")
    return {"calls": len(cntls), "retried_from_dead": len(moved),
            "retried": sum(c.current_try for _, c in cntls),
            "failover_ms": failover_ms, "revive_ms": revive_ms,
            "breaker": breaker, "backends_row": {
                k: row[k] for k in ("attempts", "completed", "abandoned",
                                    "connect_errors", "errors")},
            "by_replica_after": after, "wall_s": wall, **_p50_p99(lat)}


class _HandlerSpy:
    """Wraps a replica's ``Generate`` handler (a coroutine function
    still) to read each request's codec and verified user on the
    server's controller: measurement only, for the part."""

    def __init__(self, replicas):
        self.seen = []
        self._methods = []
        for i, r in enumerate(replicas):
            m = r.server.find_method("GenerateService", "Generate")
            orig = m.handler

            async def spy(cntl, request, i=i, orig=orig):
                ctx = cntl.auth_context
                self.seen.append((i, cntl.compress_type,
                                  ctx.user if ctx is not None else None))
                return await orig(cntl, request)
            m.handler = spy
            self._methods.append((m, orig))

    def restore(self) -> None:
        for m, orig in self._methods:
            m.handler = orig


class _ResponseCodecs:
    """Each response's ``RpcMeta.compress_type``, read on the client as
    ``client_dispatch`` fills the controller (measurement only)."""

    def __init__(self):
        from brpc_tpu_torch.rpc import client_dispatch
        self._mod = client_dispatch
        self._orig = client_dispatch._fill_response
        self.seen = []

        def spy(cntl, msg, socket):
            self.seen.append(msg.meta.compress_type)
            return self._orig(cntl, msg, socket)
        client_dispatch._fill_response = spy

    def restore(self) -> None:
        self._mod._fill_response = self._orig


def _cluster_auth(replicas, oracle, prompts) -> dict:
    """(e) Replica 2 verifies a token; a ClusterChannel that sends it,
    with every request snappy-compressed, serves the burst; a channel
    with a wrong token gets ERPCAUTH on every call, none retried."""
    from brpc_tpu_torch.rpc import (ChannelOptions, ClusterChannel,
                                    Controller, errno_codes as berr)
    ch = ClusterChannel(
        "list://" + ",".join(r.addr for r in replicas), "la",
        ChannelOptions(timeout_ms=120000, retry_budget=True,
                       auth_token=CLUSTER_TOKEN, name="cluster-auth"))
    bad = ClusterChannel(f"list://{replicas[2].addr}", "rr",
                         ChannelOptions(timeout_ms=20000,
                                        auth_token="not-the-token",
                                        name="cluster-auth-bad"))
    handlers = _HandlerSpy(replicas)
    codecs = _ResponseCodecs()
    try:
        results, errors, latency, cntls = {}, [], [], []
        lock = threading.Lock()

        def client(idx):
            for p in prompts[idx::CLUSTER_THREADS]:
                c = Controller()
                c.compress_type = COMPRESS_SNAPPY
                t0 = time.perf_counter()
                c = ch.call_sync("GenerateService", "Generate", json.dumps(
                    {"prompt": p, "max_tokens": MAX_TOKENS}).encode(),
                    cntl=c)
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    cntls.append((p, c))
                    if c.failed():
                        errors.append((p, c.error_code, c.error_text))
                    else:
                        latency.append(ms)
                        results[p] = json.loads(c.response)["tokens"]
        ts = [threading.Thread(target=client, args=(i,))
              for i in range(CLUSTER_THREADS)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        _check_burst("cluster (e)", results, errors, oracle)
        served = _by_replica(cntls, replicas)
        check(served[2] > 0, f"cluster (e): calls by replica {served}")
        body = json.dumps({"prompt": prompts[0],
                           "max_tokens": MAX_TOKENS}).encode()
        bad_rows, bad_ms = [], []
        for _ in range(AUTH_BAD_CALLS):
            t0 = time.perf_counter()
            c = bad.call_sync("GenerateService", "Generate", body)
            bad_ms.append((time.perf_counter() - t0) * 1e3)
            bad_rows.append((c.error_code, c.retried_count()))
    finally:
        handlers.restore()
        codecs.restore()
        ch.close()
        bad.close()
    check(all(r == (berr.ERPCAUTH, 0) for r in bad_rows),
          f"cluster (e): wrong-token calls {bad_rows}")
    seen = handlers.seen
    check(len(seen) >= len(cntls)
          and all(ct == COMPRESS_SNAPPY for _, ct, _ in seen),
          f"cluster (e): request codecs on the servers {seen}")
    check(all(user == "token-peer" for i, _, user in seen if i == 2),
          f"cluster (e): replica 2's verified users {seen}")
    check(len(codecs.seen) == len(cntls)
          and set(codecs.seen) == {COMPRESS_SNAPPY},
          f"cluster (e): response codecs {codecs.seen}")
    return {"calls": len(cntls), "by_replica": served, "wall_s": wall,
            "retried": sum(c.current_try for _, c in cntls),
            "requests_compressed": len(seen),
            "responses_compressed": len(codecs.seen),
            "replica2_authenticated": sum(1 for i, _, _ in seen if i == 2),
            "wrong_token": {"calls": len(bad_rows),
                            "erpcauth": sum(1 for r in bad_rows
                                            if r[0] == berr.ERPCAUTH),
                            "retried": sum(r[1] for r in bad_rows),
                            **_p50_p99(bad_ms)},
            **_p50_p99(latency)}


def _cluster_backup(dev, rng, counted) -> dict:
    """(d) Attend (a split decode and its combine) on two cuda://
    servers, one 50 ms slow; rr with a 5 ms backup request."""
    import torch

    from brpc_tpu_torch.fiber import sleep
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, ClusterChannel,
                                    backend_stats as bs, client_dispatch)
    fa = _fa_module()
    spec = _device_spec(dev)
    b, L, d = 4, 4096, 128
    # each server's requests: arrived, answered, the last arrival
    seen = {"slow": [0, 0, 0.0], "fast": [0, 0, 0.0]}

    def attend(tag, delay):
        async def Attend(cntl, request):
            seen[tag][0] += 1
            seen[tag][2] = time.monotonic()
            if delay:
                await sleep(delay)
            q, k, v, lengths = cntl.request_device_arrays
            cntl.response_device_arrays = [fa.decode_attention(q, k, v,
                                                               lengths)]
            seen[tag][1] += 1
            return tag.encode()
        return Attend

    def settled() -> bool:
        """Every request answered, none for 0.2 s: the late backups
        have all run (and their answers were dropped)."""
        return all(a == f and time.monotonic() - t > 0.2
                   for a, f, t in seen.values())
    slow, slow_addr = _combo_server(f"cuda://cluster-slow:1#device={spec}",
                                    "Part", {"Attend": attend("slow",
                                                              SLOW_DELAY_S)})
    fast, fast_addr = _combo_server(f"cuda://cluster-fast:1#device={spec}",
                                    "Part", {"Attend": attend("fast", 0)})
    # rr's first pick is the list's second server: the first call goes
    # to the slow one
    ch = ClusterChannel(f"list://{fast_addr},{slow_addr}", "rr",
                        ChannelOptions(timeout_ms=30000,
                                       backup_request_ms=BACKUP_MS,
                                       name="cluster-backup"))
    direct = Channel(fast_addr, ChannelOptions(timeout_ms=30000))
    lengths = torch.tensor([0, 1, 4096, 3000], dtype=torch.int32,
                           device=dev)
    try:
        inputs = [(_rand(rng, (b, d), torch.bfloat16, dev),
                   _rand(rng, (b, L, d), torch.bfloat16, dev),
                   _rand(rng, (b, L, d), torch.bfloat16, dev))
                  for _ in range(4)]
        _sync(dev)

        def calls():
            rows, outs, fast_ms = [], [], []
            for i in range(BACKUP_CALLS):
                q, k, v = inputs[i % len(inputs)]
                done = []
                t0 = time.perf_counter()
                c = ch.call("Part", "Attend", b"", done=done.append,
                            request_device_arrays=[q, k, v, lengths])
                check(c.join(30), "cluster (d): a call never completed")
                (o,) = c.response_device_arrays
                _sync(dev)
                ms = (time.perf_counter() - t0) * 1e3
                check(not c.failed(), f"cluster (d): {c.error_code} "
                                      f"{c.error_text}")
                rows.append((c.tried_servers[0].host, c.used_backup,
                             c.response, ms, len(done)))
                outs.append((i % len(inputs), o))
                t0 = time.perf_counter()
                r = direct.call_sync("Part", "Attend", b"",
                                     request_device_arrays=[q, k, v,
                                                            lengths])
                _sync(dev)
                check(not r.failed(), "cluster (d): the direct call failed")
                fast_ms.append((time.perf_counter() - t0) * 1e3)
            check(_wait_for_value(settled, True, 10.0),
                  f"cluster (d): requests still running {seen}")
            return rows, outs, fast_ms, sum(v[1] for v in seen.values())
        rows, outs, fast_ms, _ = counted("d_backup", calls)
        slow_first = [r for r in rows if r[0] == "cluster-slow"]
        check(slow_first and all(r[1] and r[2] == b"fast"
                                 for r in slow_first),
              f"cluster (d): calls first sent to the slow server {slow_first}")
        check(all(r[4] == 1 for r in rows), "cluster (d): a done ran twice")
        cells = {k: bs.global_stats().cell("cluster-backup", k).get_value()
                 for k in (bs.ep_key(ch.servers()[0]),
                           bs.ep_key(ch.servers()[1]))}
        check(all(c["inflight"] == 0
                  and c["attempts"] == c["completed"] + c["abandoned"]
                  for c in cells.values()) and
              sum(c["completed"] for c in cells.values()) == len(rows),
              f"cluster (d): backend cells {cells}")
        check(not client_dispatch.inflight_attempts(),
              "cluster (d): attempts left in flight")
        worst = max_err = 0.0
        for idx, o in outs:
            q, k, v = inputs[idx]
            want = fa._flash_plain(q[:, None].float(), k.float(), v.float(),
                                   d ** -0.5, True, 64,
                                   q_offset=lengths - 1)[:, 0]
            diff = (o.float() - want).abs()
            worst = max(worst, float((diff / fa._rounding_bound(
                want, torch.bfloat16)).max()))
            max_err = max(max_err, float(diff.max()))
        check(worst <= 1.0, f"cluster (d): O off the plain version by "
                            f"{worst:.3f} x its rounding bound")
        lat = [r[3] for r in rows]
        p50, fast_p50 = _median(lat), _median(fast_ms)
        check(p50 <= fast_p50 + 2 * BACKUP_MS,
              f"cluster (d): p50 {p50:.2f} ms against the fast server's "
              f"{fast_p50:.2f}")
        return {"calls": len(rows), "slow_first": len(slow_first),
                "used_backup": sum(1 for r in rows if r[1]),
                "requests": {k: v[0] for k, v in seen.items()},
                "cells": {
                    k: {f: c[f] for f in ("attempts", "completed",
                                          "abandoned", "inflight")}
                    for k, c in cells.items()},
                "worst_over_bound": worst, "max_abs_err": max_err,
                **_p50_p99(lat), "fast_direct": _p50_p99(fast_ms)}
    finally:
        ch.close()
        direct.close()
        for srv in (slow, fast):
            srv.stop()
            srv.join()


def phase_cluster(dev):
    """The cluster client and overload control on the card: three
    GenerateService replicas behind one ClusterChannel ("la"): (a) the
    spread, (b) a shedding replica, (c) a replica killed and restarted;
    (d) backup requests on a tensor RPC; (e) a replica that verifies a
    token, snappy-compressed calls, and a wrong token refused. Launch
    counts zeroed before each part and read after it."""
    import numpy as np

    from brpc_tpu_torch.butil.endpoint import str2endpoint
    from brpc_tpu_torch.rpc import (ChannelOptions, ClusterChannel,
                                    TokenAuthenticator)
    from brpc_tpu_torch.serving import TinyDecoder, TinyDecoderConfig

    fa = _fa_module()
    prompts = _cluster_prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    launches = {}
    out = {}
    fleet, replicas = [], []
    ch = None

    def serving_part(part, fn, *args, **kw):
        """Counts zeroed just before, read just after: flash_decode once
        a decode step or warm-up of every replica, and nothing else."""
        progress(f"cluster {part}")
        fa.reset_launches()
        before = sum(r.steps() for r in fleet)
        r = fn(*args, **kw)
        _sync(dev)
        got = dict(fa.launches)
        steps = sum(r_.steps() for r_ in fleet) - before
        launches[part] = dict(got, steps=steps)
        check(got["flash_decode"] == steps > 0 and
              sum(got.values()) == got["flash_decode"],
              f"cluster {part}: launched {got}, {steps} decode steps and "
              f"warm-ups")
        return r

    def start():
        replicas.extend(_Replica(fleet) for _ in range(CLUSTER_REPLICAS))

    def restart(i, **opts):
        """Replica ``i`` stopped and started again on its port: the
        channel sees its socket fail, then the health checker revives
        it."""
        old = replicas[i]
        ep = str2endpoint(old.addr)
        old.stop()

        def gone():
            s = ch._sockets.get(ep)
            return s is None or s.failed
        check(_wait_for_value(gone, True, 10.0),
              f"cluster: the channel never saw replica {i} stop")
        replicas[i] = _Replica(fleet, old.port, **opts)
        check(_wait_for_value(lambda: not ch._health.dead_set(), True,
                              10.0), f"cluster: replica {i} not revived")

    try:
        # the replicas start inside the count: their warm-ups count
        serving_part("a_start", start)
        ch = ClusterChannel(
            "list://" + ",".join(r.addr for r in replicas), "la",
            ChannelOptions(timeout_ms=120000, retry_budget=True))
        out["a"] = serving_part("a_spread", _cluster_spread, replicas, ch,
                                oracle, prompts)
        serving_part("b_restart", restart, 0, max_concurrency=2,
                     max_waiting=2)
        out["b"] = serving_part("b_shed", _cluster_shed, replicas, ch,
                                oracle, prompts)
        serving_part("c_restart", restart, 0)
        out["c"] = serving_part("c_failover", _cluster_failover, replicas,
                                fleet, ch, oracle, prompts)
        serving_part("e_restart", restart, 2,
                     auth=TokenAuthenticator(CLUSTER_TOKEN))
        out["e"] = serving_part("e_auth", _cluster_auth, replicas, oracle,
                                prompts)
    finally:
        if ch is not None:
            ch.close()
        for r in replicas:
            r.stop()

    def counted(part, fn):
        progress(f"cluster {part}")
        fa.reset_launches()
        r = fn()
        _sync(dev)
        got = dict(fa.launches)
        launches[part] = got
        n = r[3]
        check(got["flash_decode"] == got["flash_decode_combine"] == n
              and sum(got.values()) == 2 * n,
              f"cluster {part}: launched {got}, {n} Attend handlers")
        return r
    out["d"] = _cluster_backup(dev, np.random.RandomState(20261020),
                               counted)
    for part in "abcde":
        emit({"phase": "cluster", "part": part, part: out[part]})
    emit({"phase": "cluster", "launches": launches})
    out["launches"] = launches
    return out


# -------------------------------------------------------- phase incident

INCIDENT_A_BURSTS = 3           # (a): phase 3's burst, cold then warm
INCIDENT_FIRST_CALLS = 32       # (b): fresh Channels, one first call each
INCIDENT_PROFILE_S = 4.0        # (b): the on-demand profile's window
INCIDENT_LATER_CALLS = 8        # (b): later calls on one Channel
INCIDENT_BURST = 24             # (c): concurrent calls at max_concurrency 2
INCIDENT_IN_WINDOW = 4          # (c): calls made inside the capture window
INCIDENT_PAIRS = 3              # (d): turns of each setting against off
INCIDENT_FLAGS = {"anomaly_watch_filter": "server_limit_shed",
                  "anomaly_warmup_ticks": 3, "anomaly_close_ticks": 3,
                  "incident_capture_enabled": True,
                  "incident_window_ticks": 3, "rpcz_enabled": True}


def _generate_body(prompt: str) -> bytes:
    return json.dumps({"prompt": prompt, "max_tokens": MAX_TOKENS}).encode()


def _flags_set(values: dict) -> dict:
    """Set the port's flags; returns the old values, to restore."""
    from brpc_tpu_torch.butil.flags import flag, set_flag
    old = {k: flag(k) for k in values}
    for k, v in values.items():
        check(set_flag(k, v), f"cannot set flag {k}={v!r}")
    return old


def _ring(name: str) -> dict:
    from brpc_tpu_torch.bvar.series import global_series
    return global_series().dump_series(names=[name]).get(
        name, {"kind": None, "sec": [], "min": [], "live_sec": 0})


def _settled_tick(name: str) -> dict:
    """One series tick that stored, and ``name``'s ring after it: a tick
    by hand skips while the sampler's own runs, which then stores within
    a second."""
    from brpc_tpu_torch.bvar.series import series_sample_tick
    p0 = _ring_pushes(_ring(name))
    series_sample_tick()
    _wait_for_value(lambda: _ring_pushes(_ring(name)) > p0, True, 3.0)
    return _ring(name)


def _ring_pushes(ser: dict) -> int:
    """Buckets pushed into a ring so far (exact for its first hour): the
    seconds ring slides, so new buckets are counted, not found."""
    return len(ser["min"]) * 60 + ser["live_sec"]


def _folded_frames(folded: dict, top: int = 15) -> dict:
    """Top self and cumulative frames of folded stacks (``label;root;...;
    leaf``): self counts a stack's leaf, cumulative each frame once a
    stack."""
    from collections import Counter
    selfc, cum = Counter(), Counter()
    for stack, n in folded.items():
        frames = stack.split(";")[1:]
        if not frames:
            continue
        selfc[frames[-1]] += n
        for f in set(frames):
            cum[f] += n
    return {"self": selfc.most_common(top),
            "cumulative": cum.most_common(top)}


def _incident_rings_profile(port: int, prompts, oracle) -> dict:
    """(a) Phase 3's burst with the trend rings on and the recorder at its
    default rate: the one-second ring of ``server_processed`` sums to the
    calls served, ``serving_ttft_p99_us`` has a ring, and the continuous
    profile gives busy samples to the Generate method's label."""
    from brpc_tpu_torch.builtin import flight_recorder as fr
    from brpc_tpu_torch.butil.flags import flag
    from brpc_tpu_torch.bvar.series import series_enabled
    check(series_enabled() and flag("continuous_profiler_hz") == 20 and
          fr.global_recorder().running(),
          "incident a: the rings or the 20 Hz recorder are off")
    # the baseline of the burst: two ticks that stored since the start
    _settled_tick("server_processed")
    ring0 = _settled_tick("server_processed")
    fr.global_recorder().clear()
    lat, walls = [], []
    for k in range(INCIDENT_A_BURSTS):
        results, errors, wall, lat_k, _ = _burst(port, prompts, MAX_TOKENS)
        _check_burst(f"incident a {k}", results, errors, oracle)
        lat += lat_k
        walls.append(wall)
    time.sleep(0.3)                     # a few more samples at 20 Hz
    calls = INCIDENT_A_BURSTS * len(prompts)
    # until a tick that collected after the burst has stored
    t_end = time.monotonic() + 3.0
    while True:
        ring1 = _settled_tick("server_processed")
        new = _ring_pushes(ring1) - _ring_pushes(ring0)
        check(0 < new <= 60, f"incident a: {new} buckets over the burst")
        served = sum(v for _, v in ring1["sec"][-new:])
        if served == calls or time.monotonic() > t_end:
            break
    check(served == calls,
          f"incident a: server_processed's ring sums to {served}, "
          f"{calls} calls served")
    status, body = _http_page(port, "/vars?series=serving_ttft_p99_us")
    check(status == 200, f"incident a: /vars?series= answered {status}")
    ttft_ring = json.loads(body)["serving_ttft_p99_us"]
    check(ttft_ring["kind"] == "max" and ttft_ring["sec"],
          f"incident a: serving_ttft_p99_us ring {ttft_ring}")
    status, body = _http_page(port, "/timeline?name=server_processed")
    check(status == 200, f"incident a: /timeline answered {status}")
    tl = json.loads(body)["series"]["server_processed"]
    check(tl["kind"] == "delta" and ring1["sec"][-1] in tl["sec"],
          "incident a: /timeline's ring is not the collector's")
    status, body = _http_page(port,
                              "/hotspots?mode=continuous&format=json")
    check(status == 200, f"incident a: /hotspots answered {status}")
    prof = json.loads(body)
    labels = prof["labels"]
    gen = labels.get("rpc:GenerateService.Generate", 0)
    check(gen > 0, f"incident a: no busy sample labelled Generate: {labels}")
    nbusy = prof["nbusy"] or 1
    tokens = sum(len(t) for t in results.values())
    return {"calls": calls, "ring_sum": served,
            "ring_buckets": new, "burst_wall_s": walls,
            "ttft_p99_buckets": len(ttft_ring["sec"]),
            "tokens_per_s": [tokens / w for w in walls], **_p50_p99(lat),
            "samples": prof["nsamples"], "busy": prof["nbusy"],
            "span_s": prof["span_s"],
            "busy_share_by_label": {k: round(v / nbusy, 4) for k, v in
                                    sorted(labels.items(),
                                           key=lambda kv: -kv[1])},
            "top_folded": sorted(prof["folded"].items(),
                                 key=lambda kv: -kv[1])[:8]}


def _incident_way_in(port: int, prompts, oracle) -> dict:
    """(b) An on-demand /hotspots profile at 1 ms while INCIDENT_FIRST_CALLS
    fresh Channels in this process make their first unary Generate call,
    one after another: one profile holds both sides of the connection.
    Each first call's Channel construction is timed apart from its
    call."""
    from brpc_tpu_torch.builtin import flight_recorder as fr
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    seconds = INCIDENT_PROFILE_S
    got = {}

    def profile():
        got["page"] = _http_page(
            port, f"/hotspots?seconds={seconds}&interval_ms=1"
                  "&format=json")
    # the page's own client thread waits in a socket read the sampler
    # counts as busy: its samples are left out below
    th = threading.Thread(target=profile, name="hotspots_client")
    th.start()
    check(_wait_for_value(fr.global_recorder().profiling, True, 10.0),
          "incident b: the profile never started")
    first_ms, ctor_ms, t_calls = [], [], time.monotonic()
    for i in range(INCIDENT_FIRST_CALLS):
        p = prompts[i % len(prompts)]
        t0 = time.perf_counter()
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=120000))
        ctor_ms.append((time.perf_counter() - t0) * 1e3)
        try:
            c = ch.call_sync("GenerateService", "Generate",
                             _generate_body(p))
            first_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            ch.close()
        check(not c.failed() and json.loads(c.response)["tokens"] ==
              oracle[p], f"incident b: first call {i}: {c.error_text}")
    calls_s = time.monotonic() - t_calls
    th.join(seconds + 60)
    check("page" in got and got["page"][0] == 200,
          f"incident b: /hotspots answered {got.get('page', (None,))[0]}")
    prof = json.loads(got["page"][1])
    folded = {k: v for k, v in prof["folded"].items()
              if not k.startswith("thread:hotspots_client;")}
    check(folded, "incident b: the profile has no busy sample")
    later = []
    ch = Channel(f"tcp://127.0.0.1:{port}",
                 ChannelOptions(timeout_ms=120000))
    try:
        for i in range(INCIDENT_LATER_CALLS + 1):
            p = prompts[i % len(prompts)]
            t0 = time.perf_counter()
            c = ch.call_sync("GenerateService", "Generate",
                             _generate_body(p))
            if i:                       # the first is this Channel's own
                later.append((time.perf_counter() - t0) * 1e3)
            check(not c.failed() and json.loads(c.response)["tokens"] ==
                  oracle[p], f"incident b: later call {i}")
    finally:
        ch.close()
    labels = {}
    for stack, n in folded.items():
        lbl = stack.split(";", 1)[0]
        labels[lbl] = labels.get(lbl, 0) + n
    # the stacks off the decode path: where the way in could spend host
    # time (the last frames of each)
    other = sorted(((n, ";".join(k.split(";")[-6:])) for k, n in
                    folded.items() if not k.startswith(
                        "rpc:GenerateService.Generate;")), reverse=True)
    return {"profile_s": seconds, "calls_s": calls_s,
            "calls_inside_profile": calls_s + 0.1 < seconds,
            "first_call_ms": _p50_p99(first_ms),
            "channel_ctor_ms": _p50_p99(ctor_ms),
            "later_call_ms": _p50_p99(later),
            "samples": prof["nsamples"],
            "busy_samples": sum(folded.values()),
            "busy_by_label": dict(sorted(labels.items(),
                                         key=lambda kv: -kv[1])[:10]),
            "idle_by_thread": dict(sorted(prof["idle_by_thread"].items(),
                                          key=lambda kv: -kv[1])[:12]),
            "top_other_stacks": other[:10],
            **_folded_frames(folded)}


def _incident_storm(prompts, oracle, window_oracle, gss: list) -> dict:
    """(c) A shed storm leaves an incident artifact: a server at
    max_concurrency 2, calm calls over the watchdog's warm-up ticks, then
    INCIDENT_BURST concurrent Generate calls; the watchdog opens incident
    #1 on server_limit_shed, calls inside the window are captured, the
    artifact is bundled, listed on /incidents and downloadable, and the
    incident closes after its calm ticks. The ticks are the bvar
    sampler's own, once a second. The server's engine joins ``gss``."""
    from brpc_tpu_torch.builtin import flight_recorder as fr
    from brpc_tpu_torch.butil import resource_census
    from brpc_tpu_torch.bvar.anomaly import global_watchdog
    from brpc_tpu_torch.incident.artifact import read_artifact
    from brpc_tpu_torch.incident.manager import global_manager
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                    ServerOptions)
    from brpc_tpu_torch.rpc import errno_codes as berr
    from brpc_tpu_torch.rpc.span import global_collector
    from brpc_tpu_torch.serving import add_generate_service
    from brpc_tpu_torch.traffic.capture import global_recorder
    wd, mgr = global_watchdog(), global_manager()
    wd.reset()
    server = Server(ServerOptions(max_concurrency=2))
    gs = add_generate_service(server)
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    gss.append(gs)
    port = server.start("tcp://127.0.0.1:0").port
    out = {}
    try:
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=120000, max_retry=0))
        key = "server_limit_shed"

        def warm_ticks():
            st = wd._keys.get(key)
            return st.n if st is not None else 0
        # calm calls while the watchdog learns the key's baseline
        t0 = time.monotonic()
        i = 0
        while warm_ticks() < 4 and time.monotonic() - t0 < 15:
            p = prompts[i % len(prompts)]
            c = ch.call_sync("GenerateService", "Generate",
                             _generate_body(p))
            check(not c.failed() and json.loads(c.response)["tokens"] ==
                  oracle[p], f"incident c: calm call {i}")
            i += 1
        check(warm_ticks() >= 4 and not wd.incident_snapshot(),
              f"incident c: warm-up: {warm_ticks()} ticks, incidents "
              f"{wd.incident_snapshot()}")
        out["calm_calls"] = i
        shed_at = []

        def done(c):
            if c.error_code == berr.ELIMIT and not shed_at:
                shed_at.append(time.monotonic())
        storm = [(prompts[j % len(prompts)],
                  ch.call("GenerateService", "Generate",
                          _generate_body(prompts[j % len(prompts)]),
                          done=done))
                 for j in range(INCIDENT_BURST)]
        for _, c in storm:
            c.join()
        sheds = [c for _, c in storm if c.failed()]
        check(all(c.error_code == berr.ELIMIT for c in sheds) and sheds,
              f"incident c: {len(sheds)} sheds, codes "
              f"{sorted({c.error_code for c in sheds})}")
        for p, c in storm:
            check(c.failed() or json.loads(c.response)["tokens"] ==
                  oracle[p], f"incident c: storm tokens for {p!r}")
        check(_wait_for_value(mgr.window_open_now, 1, 10.0),
              "incident c: no capture window opened")
        opened_at = time.monotonic()
        # the window opens on the sampler's tick, and the recorder starts
        # just after it: calls count as in the window once it records
        rec = global_recorder()
        check(_wait_for_value(lambda: rec.incident_capturing() and
                              rec.capturing(), True, 5.0),
              "incident c: the recorder is not capturing the window")
        in_window = list(window_oracle)
        for p in in_window:
            c = ch.call_sync("GenerateService", "Generate",
                             _generate_body(p))
            check(not c.failed() and json.loads(c.response)["tokens"] ==
                  window_oracle[p], f"incident c: in-window call: "
                                    f"{c.error_text}")
        out["in_window_calls_inside"] = bool(mgr.window_open_now())
        incs = wd.incident_snapshot()
        check(len(incs) == 1 and incs[0]["id"] == 1 and
              incs[0]["keys"] == [key],
              f"incident c: incidents {incs}")

        def closed():
            s = wd.incident_snapshot()
            return bool(s) and s[0]["state"] == "closed"
        rows = []

        def artifact_listed():
            status, body = _http_page(port, "/incidents")
            check(status == 200, f"incident c: /incidents {status}")
            rows[:] = json.loads(body)["artifacts"]
            return bool(rows)
        closed_at = art_at = None
        t_end = time.monotonic() + 20
        while time.monotonic() < t_end and (closed_at is None or
                                            art_at is None):
            if closed_at is None and closed():
                closed_at = time.monotonic()
            if art_at is None and artifact_listed():
                art_at = time.monotonic()
            time.sleep(0.01)
        check(closed_at is not None, "incident c: incident #1 never "
                                     f"closed: {wd.incident_snapshot()}")
        check(art_at is not None, "incident c: no artifact on /incidents")
        check(len(rows) == 1, f"incident c: artifacts {rows}")
        path = rows[0]["path"]
        status, blob = _http_page(
            port, "/incidents?action=download&path=" + path)
        with open(path, "rb") as f:
            on_disk = f.read()
        check(status == 200 and blob == on_disk,
              f"incident c: download {status}, {len(blob)} bytes against "
              f"{len(on_disk)} on disk")
        art = read_artifact(path)
        meta = art["meta"]
        check(meta.get("id") == 1 and key in meta.get("keys", []) and
              meta.get("peak_key") == key,
              f"incident c: the incident document {meta}")
        captured = [json.loads(r.payload)["prompt"] for r in art["corpus"]]
        check(set(in_window) <= set(captured) and all(
            r.method_key == "GenerateService.Generate"
            for r in art["corpus"]),
              f"incident c: captured {captured}, wanted {in_window}")
        spans = [s for s in global_collector.recent(1024)
                 if any("incident #1" in t for _, t in s.annotations)]
        check(spans, "incident c: no rpcz span carries incident #1")
        labels = fr.global_recorder().merged()["labels"]
        marked = [k for k in labels if k.startswith("incident:#1")]
        check(marked, f"incident c: no profile window labelled: {labels}")
        status, body = _http_page(port, "/census")
        census = json.loads(body)
        names = resource_census.registered_names()
        check(status == 200 and set(names) <= set(census["subsystems"])
              and not any("error" in census["subsystems"][n]
                          for n in names),
              f"incident c: /census {census} against {names}")
        out.update({
            "sheds": len(sheds), "served": INCIDENT_BURST - len(sheds),
            "incident": wd.incident_snapshot()[0],
            "first_shed_to_open_s": opened_at - shed_at[0]
            if shed_at else None,
            "close_to_artifact_s": art_at - closed_at,
            "open_to_artifact_s": art_at - opened_at,
            "artifact_bytes": len(on_disk),
            "snapshots": sorted(art["snapshots"]),
            "captured": len(captured), "in_window": len(in_window),
            "spans_marked": len(spans), "profile_labels": marked,
            "census": sorted(census["subsystems"]),
            "census_total_bytes": census["total_bytes"]})
        ch.close()
    finally:
        server.stop()
        server.join(10)
    return out


def _incident_costs(port: int, prompts, oracle, capture_dir: str) -> dict:
    """(d) Phase 3's burst in turns, INCIDENT_PAIRS pairs each, the order
    of a pair alternating: the recorder at 20 Hz with the rings on
    against both off; then capture at rate 1.0 against capture off."""
    from brpc_tpu_torch.traffic.capture import (global_recorder,
                                                start_capture, stop_capture)
    runs = []

    def burst(setting, on, turn):
        res, errs, wall, lat, _ = _burst(port, prompts, MAX_TOKENS)
        _check_burst(f"incident d {setting} {on}", res, errs, oracle)
        tokens = sum(len(t) for t in res.values())
        runs.append({"setting": setting, "on": on, "turn": turn,
                     "tokens_per_s": tokens / wall, **_p50_p99(lat)})
    for turn in range(INCIDENT_PAIRS):
        for on in ((False, True) if turn % 2 == 0 else (True, False)):
            _flags_set({"continuous_profiler_hz": 20 if on else 0,
                        "bvar_series_enabled": on})
            burst("recorder_and_rings", on, turn)
    _flags_set({"continuous_profiler_hz": 20, "bvar_series_enabled": True})
    for turn in range(INCIDENT_PAIRS):
        for on in ((False, True) if turn % 2 == 0 else (True, False)):
            if on:
                start_capture(dir=capture_dir, default_rate=1.0,
                              max_per_second=0)
            burst("capture", on, turn)
            if on:
                snap = stop_capture()
                check(snap["written"] == len(prompts),
                      f"incident d: capture wrote {snap['written']}")
    check(not global_recorder().capturing(), "incident d: capture left on")
    summary = {}
    for r in runs:
        k = f"{r['setting']}_{'on' if r['on'] else 'off'}"
        summary.setdefault(k, []).append(r)
    return {"runs": runs, "summary": {
        k: {"p50_ms_median": _median([r["p50_ms"] for r in v]),
            "p99_ms_median": _median([r["p99_ms"] for r in v]),
            "tokens_per_s_median": _median([r["tokens_per_s"] for r in v])}
        for k, v in sorted(summary.items())}}


def phase_incident(dev):
    """Trend rings, the anomaly watchdog, the flight recorder, capture and
    incidents on the card's Generate path, at phase 3's width: (a) the
    rings and the continuous profile over phase 3's burst, (b) an
    on-demand profile of first calls, (c) a shed storm's incident
    artifact, (d) the cost of the recorder, the rings and capture.
    Launch counts zeroed before each part and read after it:
    ``flash_decode``'s equal to the part's decode steps and warm-ups,
    and nothing else launched."""
    import tempfile

    # the modules that define the phase's flags
    import brpc_tpu_torch.builtin.flight_recorder  # noqa: F401
    import brpc_tpu_torch.incident.manager  # noqa: F401
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)

    fa = _fa_module()
    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    window_oracle = {}                  # (c)'s calls inside the window
    for j in range(INCIDENT_IN_WINDOW):
        p = f"in-window {j}: {prompts[j]}"
        window_oracle[p] = cpu_model.generate(list(p.encode()), MAX_TOKENS)
    launches, out = {}, {}
    gss = []

    def counted(part, fn, *args):
        progress(f"incident {part}")
        fa.reset_launches()
        before = sum(g.batcher.decode_steps + g.engine.warmup_steps
                     for g in gss)
        r = fn(*args)
        _sync(dev)
        got = dict(fa.launches)
        steps = sum(g.batcher.decode_steps + g.engine.warmup_steps
                    for g in gss) - before
        launches[part] = dict(got, steps=steps)
        check(got["flash_decode"] == steps > 0 and
              sum(got.values()) == got["flash_decode"],
              f"incident {part}: launched {got}, {steps} decode steps and "
              f"warm-ups")
        return r

    tmp = tempfile.mkdtemp(prefix="incident-smoke-")
    old = _flags_set(dict(INCIDENT_FLAGS, incident_dir=tmp))
    server = None
    try:
        def start():
            nonlocal server
            server = Server()
            gss.append(add_generate_service(server))
            check(str(gss[-1].device) == "cuda:0",
                  f"service device {gss[-1].device}")
            return server.start("tcp://127.0.0.1:0").port
        port = counted("a_start", start)
        out["a"] = counted("a_rings_profile", _incident_rings_profile, port,
                           prompts, oracle)
        out["b"] = counted("b_way_in", _incident_way_in, port, prompts,
                           oracle)
        # the storm's server starts inside the count: its warm-up counts
        out["c"] = counted("c_storm", _incident_storm, prompts, oracle,
                           window_oracle, gss)
        out["d"] = counted("d_costs", _incident_costs, port, prompts,
                           oracle, os.path.join(tmp, "capture"))
    finally:
        if server is not None:
            server.stop()
            server.join(10)
        _flags_set(old)
    out["phase_s"] = time.monotonic() - phase_t0
    for part in "abcd":
        emit({"phase": "incident", "part": part, part: out[part]})
    emit({"phase": "incident", "launches": launches,
          "phase_s": out["phase_s"]})
    out["launches"] = launches
    return out


def phase_paths(dev, split_inputs):
    """The port's two other paths, each driven through its public entry
    point with every count zeroed just before and read just after:
    long-context attention (examples/long_context's 8 heads x 2048 x 64,
    bf16 to flash_attn_fwd_tc, fp32 to flash_attn_fwd, and 8 x 2048 x 32
    bf16 to flash_attn_fwd_tc, causal and not)
    and a decode step over a long cache (split, then combined)."""
    import numpy as np
    import torch

    fa = _fa_module()
    rng = np.random.RandomState(7)
    out = {}
    fa.reset_launches()
    for dtype, d in ((torch.bfloat16, 64), (torch.float32, 64),
                     (torch.bfloat16, 32)):
        x = [_rand(rng, (8, 2048, d), dtype, dev) for _ in range(3)]
        for causal in (False, True):
            o = fa.flash_attention(*x, causal=causal)
            check(o.shape == x[0].shape and bool(torch.isfinite(o).all()),
                  "long-context attention gave non-finite values")
    torch.cuda.synchronize()
    out["long_context"] = dict(fa.launches)
    check(out["long_context"]["flash_attn_fwd_tc"] == 4
          and out["long_context"]["flash_attn_fwd"] == 2,
          f"long-context path launched {out['long_context']}")

    q, k, v, lengths, plan = split_inputs
    fa.reset_launches()
    o = fa.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    out["long_cache_decode"] = dict(fa.launches)
    check(bool(torch.isfinite(o).all()), "long-cache decode: non-finite")
    check(out["long_cache_decode"]["flash_decode"] == 1
          and out["long_cache_decode"]["flash_decode_combine"] == 1,
          f"long-cache decode launched {out['long_cache_decode']}")
    emit({"phase": "paths", **out, "long_cache_splits": plan.splits})
    return out


# ------------------------------------------------------------- phase 5

def _bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(kernel, plain, library, simt, iters):
    """Device ms per call of each function (CUDA events), in turns
    (kernel, the CUDA-core tile kernel through ``_launch_tile``, plain,
    library), and the profiler's device time per call of the kernel and
    the tile kernel. ``iters``: events iterations of (kernel, simt, plain,
    library); None skips a function."""
    out = {}
    for key, fn, n in (("ms", kernel, iters[0]), ("ms_simt", simt, iters[1]),
                       ("plain_ms", plain, iters[2]),
                       ("library_ms", library, iters[3])):
        out[key] = cuda_time_ms(fn, n)[0] if fn is not None else None
    out["call_ms"] = cuda_time_ms(kernel, 20)[1]
    out["ms_profiled"] = profiled_device_ms(kernel, 50)
    out["ms_simt_profiled"] = (profiled_device_ms(simt, 20)
                               if simt is not None else None)
    return out


def _decode_bound(q, k, lengths):
    """Bytes and FLOPs a decode step needs on this run's data: each valid
    cache row of K and V read once, q and the lengths read, out written."""
    d = k.shape[-1]
    rows = int(lengths.clamp(0, k.shape[1]).sum())
    nbytes = (2 * q.numel() + 2 * rows * d) * q.element_size() \
        + lengths.numel() * 4
    return nbytes, 4.0 * rows * d


def _kind(dtype):
    import torch
    return {torch.float32: "fp32", torch.float16: "fp16",
            torch.bfloat16: "bf16"}[dtype]


def phase_times(decode_inputs, split_inputs):
    import numpy as np
    import torch
    import torch.nn.functional as F

    fa = _fa_module()
    times = {}

    def decode_times(name, q, k, v, lengths, iters, shape):
        b, L, d = k.shape
        scale = d ** -0.5
        nbytes, flops = _decode_bound(q, k, lengths)
        bound_ms, bound_by = _bound(nbytes, flops, _kind(q.dtype))
        mask = (torch.arange(L, device=q.device)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        q4, k4, v4 = q[:, None, None, :], k[:, None], v[:, None]
        t = _timed(
            lambda: fa.decode_attention(q, k, v, lengths, block_k=64),
            lambda: fa._flash_plain(q[:, None], k, v, scale, True, 64,
                                    q_offset=lengths - 1),
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=mask,
                                                   scale=scale),
            lambda: fa._launch_tile("flash_attn_fwd", q[:, None], k, v,
                                    scale, True, q_offset=lengths,
                                    q_offset_add=-1),
            iters)
        t.update(shape=shape, bound_ms=bound_ms, bound_by=bound_by,
                 bytes=nbytes, flops=flops,
                 splits=fa._plan("decode", q.device, q.dtype, d, bh=b,
                                 sk=L).splits)
        emit(dict(phase="kernel_times", case=name, **t))
        return t

    q, k, v, lengths = decode_inputs
    # iteration counts keep each timed run under ~1000 queued launches:
    # past the device's launch queue the host blocks behind the sleep and
    # the events would time the host instead
    times["decode"] = decode_times(
        "decode", q, k, v, lengths, (500, 500, 15, 200),
        "q [8,32], k/v cache [8,160,32] fp32, lengths [8]")
    q, k, v, lengths, plan = split_inputs
    times["split_decode"] = decode_times(
        "split decode", q, k, v, lengths, (300, 30, 5, 100),
        "q [4,128], k/v cache [4,4096,128] bf16, lengths 0/1/4096/3000")

    # each pass alone: the first writes per-split partials, the combine
    # merges them
    nbytes, flops = _decode_bound(q, k, lengths)
    bound_ms, bound_by = _bound(nbytes, flops, "bf16")
    t = _timed(lambda: fa._launch_decode(q, k, v, lengths, 128 ** -0.5,
                                         plan),
               lambda: fa._decode_partials_plain(q, k, v, lengths,
                                                 128 ** -0.5, plan.splits,
                                                 plan.chunk),
               None, None, (300, None, 5, None))
    t.update(shape=times["split_decode"]["shape"], bound_ms=bound_ms,
             bound_by=bound_by, bytes=nbytes, flops=flops)
    emit(dict(phase="kernel_times", case="split decode first pass", **t))
    times["split_first_pass"] = t
    ml, o_part = fa._launch_decode(q, k, v, lengths, 128 ** -0.5, plan)
    out = torch.empty_like(q)
    nbytes = ml.numel() * 4 + o_part.numel() * 4 + out.numel() * 2
    bound_ms, bound_by = _bound(nbytes, 3.0 * o_part.numel(), "fp32")
    t = _timed(lambda: fa._launch_combine(ml, o_part, out),
               lambda: fa._decode_combine_plain(ml[..., 0], ml[..., 1],
                                                o_part, q.dtype),
               None, None, (500, None, 20, None))
    t.update(shape=f"m_l [4,{plan.splits},2], o [4,{plan.splits},128] fp32 "
                   f"-> out [4,128] bf16", bound_ms=bound_ms,
             bound_by=bound_by, bytes=nbytes)
    emit(dict(phase="kernel_times", case="combine", **t))
    times["combine"] = t

    long_cases = []
    rng = np.random.RandomState(1)
    n = 2048
    # 8 heads: examples/long_context's shape, one wave of tc blocks or
    # less; 32 heads: several waves, where the causal tile order pays;
    # every 16-bit head dim goes to flash_attn_fwd_tc, fp32 to
    # flash_attn_fwd (d 128 its other tile shape)
    for heads, d, dtype in ((8, 64, torch.float32), (8, 64, torch.bfloat16),
                            (32, 64, torch.bfloat16),
                            (8, 128, torch.float32),
                            (8, 32, torch.bfloat16),
                            (8, 128, torch.bfloat16),
                            (8, 16, torch.float16)):
        kind = _kind(dtype)
        kernel = fa._plan("attention", q.device, dtype, d).kernel
        x = [_rand(rng, (heads, n, d), dtype, q.device) for _ in range(3)]
        for causal in (False, True):
            pairs = n * (n + 1) / 2 if causal else n * n
            flops = 4.0 * heads * pairs * d
            nbytes = 4 * heads * n * d * x[0].element_size()
            bms, bby = _bound(nbytes, flops, kind)
            # the CUDA-core tile kernel on inputs another kernel serves
            simt = None if kernel == "flash_attn_fwd" else (
                lambda: fa._launch_tile("flash_attn_fwd", *x, d ** -0.5,
                                        causal))
            t = _timed(
                lambda: fa.flash_attention(*x, causal=causal),
                lambda: fa._flash_plain(*x, d ** -0.5, causal, 128),
                lambda: F.scaled_dot_product_attention(
                    *[t[None] for t in x], is_causal=causal),
                simt, (50 if kernel == "flash_attn_fwd_tc" else 20, 20, 3,
                       20))
            t.update(case=f"{heads}x{n}x{d} {kind}"
                          f"{' causal' if causal else ''}",
                     kernel=kernel, bound_ms=bms, bound_by=bby,
                     bytes=nbytes, flops=flops,
                     mufu_ms=heads * pairs / MUFU_PER_S * 1e3)
            long_cases.append(t)
            emit(dict(phase="kernel_times", **t))
    for c in long_cases:
        if c["case"].endswith("causal"):
            base = next(x for x in long_cases
                        if x["case"] == c["case"][:-len(" causal")])
            c["causal_over_noncausal"] = c["ms"] / base["ms"]
    times["long"] = long_cases
    return times


def _row(name, path, launches, serving_launches, per_step, err, t, **kw):
    lib, source = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "library": lib, "replaces": REPLACES, "path": path,
            "launches": launches, "serving_launches": serving_launches,
            "launches_per_decode_step": per_step, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "ms_simt": t.get("ms_simt"), **kw}


def _measured_cases(long_cases, kernel):
    """The long cases ``kernel`` serves, for the kernels line: without
    ``mufu_ms``, a figure worked out from the exponentials' count and not
    measured (the ``kernel_times`` lines keep it)."""
    return [{k: v for k, v in c.items() if k != "mufu_ms"}
            for c in long_cases if c["kernel"] == kernel]


def main(only: str = "") -> int:
    """The whole smoke; ``only`` (``--phase streaming`` or ``--phase
    observability``): the card line and that phase alone (its kernel
    builds at the server's warm-up), to compare two trees' serving in
    one call."""
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a card",
              file=sys.stderr)
        return 2
    # a hang shows every thread's stack and fails, inside the call's
    # time limit, instead of running out silently
    import faulthandler
    faulthandler.dump_traceback_later(1100, exit=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import brpc_tpu_torch  # noqa: F401
        from brpc_tpu_torch.butil.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: brpc_tpu_torch is not beside this script: {e}",
              file=sys.stderr)
        return 2
    try:
        card = card_line()
        dev = resolve_device()
        emit({"phase": "card", "nvidia_smi": card,
              "device": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]})
        if only == "device_lane":
            phase_device_lane(dev)
            return 0
        if only == "combo":
            from brpc_tpu_torch.ops import _build
            # alone, the phase builds its kernels first, so that no call
            # times out on a build
            _build.build_all()
            phase_combo(dev)
            return 0
        if only == "cluster":
            # alone, flash_decode builds at the first replica's warm-up
            phase_cluster(dev)
            return 0
        if only == "incident":
            # alone, flash_decode builds at the first server's warm-up
            phase_incident(dev)
            return 0
        if only:
            {"streaming": phase_streaming,
             "observability": phase_observability}[only]()
            return 0
        progress("phase build")
        phase_build()
        progress("phase kernel_check")
        decode_inputs, split_inputs, errs = phase_kernel_check(dev)
        progress("phase serving")
        serving = phase_serving()
        progress("phase streaming")
        streaming = phase_streaming()
        progress("phase observability")
        observability = phase_observability()
        progress("phase device_lane")
        device_lane = phase_device_lane(dev)
        progress("phase combo")
        combo = phase_combo(dev)
        progress("phase cluster")
        cluster = phase_cluster(dev)
        progress("phase incident")
        incident = phase_incident(dev)
        progress("phase paths")
        paths = phase_paths(dev, split_inputs)
        progress("phase times")
        times = phase_times(decode_inputs, split_inputs)
        progress("done")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    sl = serving["kernel_launches"]
    steps = serving["decode_steps"] + serving["warmup_steps"]
    by_path = {"unary": sl["flash_decode"]}
    by_path.update({name: p["flash_decode"]
                    for name, p in streaming["launches"].items()})
    by_path["observability"] = observability["launches"]["flash_decode"]
    dl = device_lane["launches"]
    by_path["device_lane_attend"] = (dl["d_attend_cuda"]["flash_decode"]
                                     + dl["d_attend_cudad"]["flash_decode"])
    by_path["device_lane_attend_ici"] = dl["g_attend_ici"]["flash_decode"]
    cl = combo["launches"]
    by_path["combo_nested_attend"] = cl["c_nested_attend"]["flash_decode"]
    ul = cluster["launches"]
    by_path["cluster_replicas"] = sum(
        v["flash_decode"] for k, v in ul.items() if k != "d_backup")
    by_path["cluster_backup_attend"] = ul["d_backup"]["flash_decode"]
    by_path["incident"] = sum(v["flash_decode"]
                              for v in incident["launches"].values())
    combine_by_path = {
        "long_cache_decode": paths["long_cache_decode"][
            "flash_decode_combine"],
        "device_lane_attend": (dl["d_attend_cuda"]["flash_decode_combine"]
                               + dl["d_attend_cudad"][
                                   "flash_decode_combine"]),
        "device_lane_attend_ici": dl["g_attend_ici"][
            "flash_decode_combine"],
        "combo_nested_attend": cl["c_nested_attend"][
            "flash_decode_combine"],
        "cluster_backup_attend": ul["d_backup"]["flash_decode_combine"]}
    fwd_by_path = {
        "long_context": paths["long_context"]["flash_attn_fwd"],
        "combo_sequence_parallel": cl["d_sequence_parallel"][
            "flash_attn_fwd"]}
    long_by = {c["case"]: c for c in times["long"]}
    tc, simt = long_by["8x2048x64 bf16"], long_by["8x2048x64 fp32"]
    kernels = [
        _row("flash_decode", "serving: unary, stream and HTTP; device "
             "lanes: Attend; combo: nested Attend; cluster: three "
             "replicas, backup Attend; incident: rings, profiles, a shed "
             "storm, costs",
             sum(by_path.values()), sl["flash_decode"],
             sl["flash_decode"] / steps, errs["serving_decode"],
             times["decode"], launches_by_path=by_path,
             shape=times["decode"]["shape"],
             split_case=dict(times["split_decode"],
                             max_abs_err=errs["split_decode"]),
             split_first_pass=times["split_first_pass"]),
        _row("flash_decode_combine", "long-cache decode; device lanes: "
             "Attend; combo: nested Attend; cluster: backup Attend",
             sum(combine_by_path.values()),
             sl["flash_decode_combine"],
             sl["flash_decode_combine"] / steps,
             errs["flash_decode_combine"], times["combine"],
             shape=times["combine"]["shape"],
             launches_by_path=combine_by_path),
        _row("flash_attn_fwd_tc", "long-context attention",
             paths["long_context"]["flash_attn_fwd_tc"],
             sl["flash_attn_fwd_tc"], sl["flash_attn_fwd_tc"] / steps,
             errs["flash_attn_fwd_tc"], tc, shape="8x2048x64 bf16",
             cases=_measured_cases(times["long"], "flash_attn_fwd_tc")),
        _row("flash_attn_fwd", "long-context attention; combo: the "
             "reference of ring and Ulysses attention",
             sum(fwd_by_path.values()),
             sl["flash_attn_fwd"], sl["flash_attn_fwd"] / steps,
             errs["flash_attn_fwd"], simt, shape="8x2048x64 fp32",
             launches_by_path=fwd_by_path,
             cases=_measured_cases(times["long"], "flash_attn_fwd")),
    ]
    print(card)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:3] == ["--client", "device_lane"]:
        sys.exit(device_lane_client(int(sys.argv[3]),
                                    (sys.argv[4:5] or ["0"])[0]))
    if sys.argv[1:3] == ["--client", "ici"]:
        sys.exit(ici_client(int(sys.argv[3]), sys.argv[4],
                            int(sys.argv[5])))
    if sys.argv[1:2] == ["--client"]:
        sys.exit(client_main(sys.argv[2], int(sys.argv[3]),
                             traced="--rpcz" in sys.argv[4:]))
    if sys.argv[1:2] == ["--phase"]:
        if sys.argv[2:3] not in (["streaming"], ["observability"],
                                 ["device_lane"], ["combo"], ["cluster"],
                                 ["incident"]):
            sys.exit(f"chip_smoke: unknown phase {sys.argv[2:]}")
        sys.exit(main(only=sys.argv[2]))
    sys.exit(main())
