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
   profiler for the device's busy share and its time by kernel;
   then the two other paths, each with the counts zeroed just before and
   read just after: long-context attention (``flash_attention`` at 8
   heads x 2048 x 64, bf16 and fp32, causal and not) and a long-cache
   decode step (``decode_attention`` at B 4, L 4096, d 128, bf16, split);
4. kernel times: device times of each kernel, its plain version and one
   PyTorch call (``scaled_dot_product_attention``, a yardstick the port
   never calls), from CUDA events and from the profiler, beside the bound
   from bytes and operations, and, in the same run, the CUDA-core tile
   kernel (``flash_attn_fwd`` through ``_launch_tile``) on the same
   inputs as ``ms_simt`` where another kernel serves the call (decode, and
   bf16 at d 64); ``flash_attn_fwd`` itself at 8 x 2048 x 64 and
   x 128 fp32 and 8 x 2048 x 32 bf16, causal and not.

The last lines are the card line, the kernels line and the result line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without the
result line. Without CUDA, or without the package beside it, it fails.
"""

from __future__ import annotations

import json
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
    tile. Returns the serving-shape and split-decode inputs (for phase 4)
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

def _burst(port: int, prompts, max_tokens: int):
    """N_CLIENTS threads, one Channel each, the prompts dealt round-robin;
    returns ({prompt: tokens}, [(prompt, errno, text)], wall seconds)."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions

    results, errors = {}, []

    def client(idx):
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=120000))
        try:
            for p in prompts[idx::N_CLIENTS]:
                c = ch.call_sync("GenerateService", "Generate",
                                 json.dumps({"prompt": p,
                                             "max_tokens": max_tokens}
                                            ).encode())
                if c.failed():
                    errors.append((p, c.error_code, c.error_text))
                else:
                    results[p] = json.loads(c.response)["tokens"]
        finally:
            ch.close()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.monotonic() - t0
    check(not any(t.is_alive() for t in threads), "clients hung")
    return results, errors, wall


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

    prompts = [f"request {i:02d}: {'the quick brown fox '[: 3 + i]}"
               for i in range(N_REQUESTS)]
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
        results, errors, wall = _burst(ep.port, prompts, MAX_TOKENS)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
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
        results2, errors2, wall2 = _burst(ep.port, prompts, MAX_TOKENS)
        _check_burst("burst 2", results2, errors2, oracle)
        ttft_warm = gs.ttft_samples()[len(ttft_first):]
        steps2 = gs.batcher.decode_steps - steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            results3, errors3, _ = _burst(ep.port, prompts, MAX_TOKENS)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        _check_burst("burst 3 (profiled)", results3, errors3, oracle)
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
           "warm_ms_per_step": wall2 * 1e3 / steps2}
    emit(out)
    trace = {"phase": "serving_trace", "window_us": window_us}
    trace.update(_device_profile(prof.events(), window_us))
    emit(trace)
    return out


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


# ------------------------------------------------------------- phase 4

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


def main() -> int:
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
        phase_build()
        decode_inputs, split_inputs, errs = phase_kernel_check(dev)
        serving = phase_serving()
        paths = phase_paths(dev, split_inputs)
        times = phase_times(decode_inputs, split_inputs)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    sl = serving["kernel_launches"]
    steps = serving["decode_steps"] + serving["warmup_steps"]
    long_by = {c["case"]: c for c in times["long"]}
    tc, simt = long_by["8x2048x64 bf16"], long_by["8x2048x64 fp32"]
    kernels = [
        _row("flash_decode", "serving", sl["flash_decode"],
             sl["flash_decode"], sl["flash_decode"] / steps,
             errs["serving_decode"], times["decode"],
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
    sys.exit(main())
