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
   (the error the kernel's own roundings explain), and three controls, a
   split decode with one split dropped and a bf16 and an fp32 attention
   with their last K tile dropped, that these bounds must reject; each
   case names the kernel ``_plan`` chose and checks that it was the one
   launched. ``flash_attn_fwd`` is also held at its 64-row block's edges
   (sq < 64, sq and sk off the tile sizes, head dims 16/32/128, causal
   with sq != sk), in bf16 at d 32 and fp16 at d 16, and through
   ``_launch_tile`` with a per-head device ``q_offset`` (lengths 0, 1, L
   and between, ``q_offset_add`` -1);
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
   burst's decode steps, and no ``serving-decode`` thread or
   ``rpc-handler`` pool may exist; each burst reports the steps by
   group, the worker threads used, the decode lock's misses, the
   control's concurrency, ``os.cpu_count()`` and the scheduler's
   ``saturation_snapshot()``;
   then the two other paths, each with the counts zeroed just before and
   read just after: long-context attention (``flash_attention`` at 8
   heads x 2048 x 64, bf16 and fp32, causal and not) and a long-cache
   decode step (``decode_attention`` at B 4, L 4096, d 128, bf16, split);
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
   inputs as ``ms_simt`` where another kernel serves the call (decode, and
   bf16 at d 64); ``flash_attn_fwd`` itself at 8 x 2048 x 64 and
   x 128 fp32 and 8 x 2048 x 32 bf16, causal and not.

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

``python3 chip_smoke.py --phase streaming`` (or ``--phase
observability``) runs that phase alone (after the card line), so that
two trees' serving can be compared in one call: run each tree's script
in turns.

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
        # the 16-bit inputs the routing table sends to flash_attn_fwd
        ("4x257x32 bf16", (4, 257, 32), 257, torch.bfloat16, False, 64),
        ("4x257x32 bf16 causal", (4, 257, 32), 257, torch.bfloat16, True,
         64),
        ("3x190x16 fp16", (3, 190, 16), 190, torch.float16, False, 64),
        ("3x190x16 fp16 causal", (3, 190, 16), 190, torch.float16, True, 64),
    ]
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
        if name in ("8x2048x64 bf16", "8x2048x64 fp32"):
            control(f"{name} without the last K tile",
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


def _check_no_decode_thread() -> None:
    names = [t.name for t in threading.enumerate()]
    check("serving-decode" not in names and
          not any(n.startswith("rpc-handler") for n in names),
          f"a decode thread or handler pool exists: {sorted(names)}")


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
           "fibers": fibers1, "warm_fibers": fibers2}
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


def phase_paths(dev, split_inputs):
    """The port's two other paths, each driven through its public entry
    point with every count zeroed just before and read just after:
    long-context attention (examples/long_context's 8 heads x 2048 x 64,
    bf16 to flash_attn_fwd_tc, fp32 to flash_attn_fwd, causal and not)
    and a decode step over a long cache (split, then combined)."""
    import numpy as np
    import torch

    fa = _fa_module()
    rng = np.random.RandomState(7)
    out = {}
    fa.reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        x = [_rand(rng, (8, 2048, 64), dtype, dev) for _ in range(3)]
        for causal in (False, True):
            o = fa.flash_attention(*x, causal=causal)
            check(o.shape == x[0].shape and bool(torch.isfinite(o).all()),
                  "long-context attention gave non-finite values")
    torch.cuda.synchronize()
    out["long_context"] = dict(fa.launches)
    check(out["long_context"]["flash_attn_fwd_tc"] == 2
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
    # d 128 fp32 and d 32 bf16 take flash_attn_fwd's other tile shapes
    for heads, d, dtype in ((8, 64, torch.float32), (8, 64, torch.bfloat16),
                            (32, 64, torch.bfloat16),
                            (8, 128, torch.float32),
                            (8, 32, torch.bfloat16)):
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
                     bytes=nbytes, flops=flops)
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
        if only:
            {"streaming": phase_streaming,
             "observability": phase_observability}[only]()
            return 0
        phase_build()
        decode_inputs, split_inputs, errs = phase_kernel_check(dev)
        serving = phase_serving()
        streaming = phase_streaming()
        observability = phase_observability()
        paths = phase_paths(dev, split_inputs)
        times = phase_times(decode_inputs, split_inputs)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    sl = serving["kernel_launches"]
    steps = serving["decode_steps"] + serving["warmup_steps"]
    by_path = {"unary": sl["flash_decode"]}
    by_path.update({name: p["flash_decode"]
                    for name, p in streaming["launches"].items()})
    by_path["observability"] = observability["launches"]["flash_decode"]
    long_by = {c["case"]: c for c in times["long"]}
    tc, simt = long_by["8x2048x64 bf16"], long_by["8x2048x64 fp32"]
    kernels = [
        _row("flash_decode", "serving: unary, stream and HTTP",
             sum(by_path.values()), sl["flash_decode"],
             sl["flash_decode"] / steps, errs["serving_decode"],
             times["decode"], launches_by_path=by_path,
             shape=times["decode"]["shape"],
             split_case=dict(times["split_decode"],
                             max_abs_err=errs["split_decode"]),
             split_first_pass=times["split_first_pass"]),
        _row("flash_decode_combine", "long-cache decode",
             paths["long_cache_decode"]["flash_decode_combine"],
             sl["flash_decode_combine"],
             sl["flash_decode_combine"] / steps,
             errs["flash_decode_combine"], times["combine"],
             shape=times["combine"]["shape"]),
        _row("flash_attn_fwd_tc", "long-context attention",
             paths["long_context"]["flash_attn_fwd_tc"],
             sl["flash_attn_fwd_tc"], sl["flash_attn_fwd_tc"] / steps,
             errs["flash_attn_fwd_tc"], tc, shape="8x2048x64 bf16",
             cases=[c for c in times["long"]
                    if c["kernel"] == "flash_attn_fwd_tc"]),
        _row("flash_attn_fwd", "long-context attention",
             paths["long_context"]["flash_attn_fwd"],
             sl["flash_attn_fwd"], sl["flash_attn_fwd"] / steps,
             errs["flash_attn_fwd"], simt, shape="8x2048x64 fp32",
             cases=[c for c in times["long"]
                    if c["kernel"] == "flash_attn_fwd"]),
    ]
    print(card)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--client"]:
        sys.exit(client_main(sys.argv[2], int(sys.argv[3]),
                             traced="--rpcz" in sys.argv[4:]))
    if sys.argv[1:2] == ["--phase"]:
        if sys.argv[2:3] not in (["streaming"], ["observability"]):
            sys.exit(f"chip_smoke: unknown phase {sys.argv[2:]}")
        sys.exit(main(only=sys.argv[2]))
    sys.exit(main())
