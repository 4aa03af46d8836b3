#!/usr/bin/env python3
"""Smoke run of brpc_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each:

1. card and build: the card's name and power limit (nvidia-smi), torch
   and CUDA versions, and the build of the CUDA kernel from the
   checkout's sources (nvcc, sm_90a);
2. kernel check: ``flash_attn_fwd`` against its plain PyTorch version,
   both on the card, at the serving shape and at long, ragged and
   sq != sk shapes, in fp32, fp16 and bf16, each with its tolerance;
3. serving (the main path): a port Server on tcp://127.0.0.1:0 with the
   default GenerateService on cuda:0 answers a burst of 16 unary
   Generate calls from 8 client threads; every token list must equal the
   plain CPU path's ``TinyDecoder.generate``, and the kernel's launch
   count, zeroed just before the server starts and read just after the
   burst, must equal the engine's decode steps plus its warm-up step.
   The same burst then runs warm, and once more under the profiler for
   the device's busy share and its time by kernel;
4. kernel times: device times of the kernel, its plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls),
   from CUDA events and from the profiler, beside the bound from bytes
   and operations.

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
FP32_TOL = 1e-4
LOWP_TOL = 2e-2        # bf16/fp16 against the plain version run in fp32
N_CLIENTS = 8
N_REQUESTS = 16
MAX_TOKENS = 32


def _fa_module():
    # the ops package exports the flash_attention function under the
    # submodule's name, so the module is fetched by its full name
    import importlib
    return importlib.import_module("brpc_tpu_torch.ops.flash_attention")


def _ptxas_summary(text: str):
    """One line per compiled kernel instance: registers, smem, spills."""
    import re
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '.*?kernelI(\w+?)Li(\d+)E", line)
        if m:
            name, spill = f"{m.group(1)} d{m.group(2)}", ""
        elif "spill" in line and name:
            spill = line.strip()
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


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

def phase_build():
    import torch

    from brpc_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.load_flash_attention()
    info = dict(_build.build_info["flash_attention"])
    emit({"phase": "build", "kernel": "flash_attn_fwd",
          "source": "brpc_tpu_torch/ops/csrc/flash_attention.cu",
          "build_s": info["build_s"], "load_s": time.monotonic() - t0,
          "cached": info["cached"],
          "ptxas": _ptxas_summary(info["ptxas"]),
          "torch": torch.__version__, "cuda": torch.version.cuda})


# ------------------------------------------------------------- phase 2

def _rand(rng, shape, dtype, dev):
    import torch
    return torch.from_numpy(rng.randn(*shape).astype("float32")).to(
        dev).to(dtype)


def phase_kernel_check(dev):
    """Each case: the kernel (through the public wrapper) against the
    plain version on the same inputs, on the card."""
    import numpy as np
    import torch

    fa = _fa_module()

    rng = np.random.RandomState(20260803)
    results = []

    def record(case, got, want, tol):
        err = float((got.float() - want.float()).abs().max())
        ok = bool(np.isfinite(err) and err <= tol)
        results.append(ok)
        emit({"phase": "kernel_check", "case": case, "max_abs_err": err,
              "tol": tol, "ok": ok})
        return err

    # the serving shape: 8 slots, 160-row fp32 cache, d 32
    lengths = torch.tensor([0, 1, 160, 37, 80, 5, 159, 100],
                           dtype=torch.int32, device=dev)
    q = _rand(rng, (8, 32), torch.float32, dev)
    k = _rand(rng, (8, 160, 32), torch.float32, dev)
    v = _rand(rng, (8, 160, 32), torch.float32, dev)
    got = fa.decode_attention(q, k, v, lengths, block_k=64)
    want = fa._flash_plain(q[:, None], k, v, 32 ** -0.5, True, 64,
                           q_offset=lengths - 1)[:, 0]
    decode_err = record("decode B8 L160 d32 fp32 lengths 0/1/160",
                        got, want, FP32_TOL)
    check(not got[0].any().item(), "a length-0 slot must give zeros")
    decode_inputs = (q, k, v, lengths)

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
    ]
    for name, qshape, sk, dtype, causal, block_k in cases:
        kshape = qshape[:-2] + (sk, qshape[-1])
        q = _rand(rng, qshape, dtype, dev)
        k = _rand(rng, kshape, dtype, dev)
        v = _rand(rng, kshape, dtype, dev)
        got = fa.flash_attention(q, k, v, causal=causal, block_k=block_k)
        check(got.dtype == dtype and got.shape == q.shape,
              f"{name}: output {got.dtype} {tuple(got.shape)}")
        want = fa._flash_plain(q.float(), k.float(), v.float(),
                               qshape[-1] ** -0.5, causal, block_k)
        record(name, got, want,
               FP32_TOL if dtype == torch.float32 else LOWP_TOL)
    torch.cuda.synchronize()
    check(all(results), "kernel disagrees with its plain version")
    return decode_inputs, decode_err


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
    # launches the kernel once), one burst, counts read just after
    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)           # defaults, on cuda:0
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    ep = server.start("tcp://127.0.0.1:0")
    try:
        results, errors, wall = _burst(ep.port, prompts, MAX_TOKENS)
        torch.cuda.synchronize()
        decode_launches = fa.decode_attention.launches
        flash_launches = fa.flash_attention.launches
        steps = gs.batcher.decode_steps
        warm = gs.engine.warmup_steps
        hist = dict(gs.batcher.batch_hist)
        ttft_first = gs.ttft_samples()
        _check_burst("burst 1", results, errors, oracle)
        check(decode_launches == steps + warm and flash_launches == 0,
              f"kernel launches {decode_launches}+{flash_launches} != "
              f"decode steps {steps} + warm-up {warm}")
        check(decode_launches > 0, "the kernel was never launched")
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
           "kernel_launches": decode_launches,
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


# ------------------------------------------------------------- phase 4

def _bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(decode_inputs):
    import numpy as np
    import torch
    import torch.nn.functional as F

    fa = _fa_module()

    q, k, v, lengths = decode_inputs
    b, L, d = k.shape
    scale = d ** -0.5
    # what this run's data needs: the valid cache rows only
    rows = int(lengths.sum())
    nbytes = (q.numel() + 2 * rows * d + q.numel()) * 4 + lengths.numel() * 4
    flops = 4.0 * rows * d
    bound_ms, bound_by = _bound(nbytes, flops, "fp32")
    mask = (torch.arange(L, device=q.device)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    q4, k4, v4 = q[:, None, None, :], k[:, None], v[:, None]
    # iteration counts keep each timed run under ~1000 queued launches:
    # past the device's launch queue the host blocks behind the sleep and
    # the events would time the host instead
    kernel_ms, kernel_call_ms = cuda_time_ms(
        lambda: fa.decode_attention(q, k, v, lengths, block_k=64), 500)
    plain_ms, plain_call_ms = cuda_time_ms(
        lambda: fa._flash_plain(q[:, None], k, v, scale, True, 64,
                                q_offset=lengths - 1), 15)
    lib_ms, lib_call_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                               scale=scale), 200)
    profiled = {
        "ms_profiled": profiled_device_ms(
            lambda: fa.decode_attention(q, k, v, lengths, block_k=64), 50),
        "plain_ms_profiled": profiled_device_ms(
            lambda: fa._flash_plain(q[:, None], k, v, scale, True, 64,
                                    q_offset=lengths - 1), 20),
        "library_ms_profiled": profiled_device_ms(
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=scale), 50),
    }
    decode = {
        "shape": "q [8,32], k/v cache [8,160,32] fp32, lengths [8]",
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
        "library_call_ms": lib_call_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops, **profiled,
    }
    emit(dict(phase="kernel_times", case="decode", **decode))

    long_cases = []
    rng = np.random.RandomState(1)
    n, d = 2048, 64
    for dtype, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        x = [_rand(rng, (8, n, d), dtype, q.device) for _ in range(3)]
        for causal in (False, True):
            pairs = n * (n + 1) / 2 if causal else n * n
            flops = 4.0 * 8 * pairs * d
            nbytes = 4 * 8 * n * d * x[0].element_size()
            bms, bby = _bound(nbytes, flops, kind)
            case = {
                "case": f"8x{n}x{d} {kind}{' causal' if causal else ''}",
                "ms": cuda_time_ms(lambda: fa.flash_attention(
                    *x, causal=causal), 20)[0],
                "plain_ms": cuda_time_ms(lambda: fa._flash_plain(
                    *x, d ** -0.5, causal, 128), 3)[0],
                "library_ms": cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(
                        *[t[None] for t in x], is_causal=causal), 20)[0],
                "bound_ms": bms, "bound_by": bby,
            }
            long_cases.append(case)
            emit(dict(phase="kernel_times", **case))
    return decode, long_cases


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
        decode_inputs, decode_err = phase_kernel_check(dev)
        serving = phase_serving()
        decode, long_cases = phase_times(decode_inputs)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    launches = serving["kernel_launches"]
    steps = serving["decode_steps"] + serving["warmup_steps"]
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "brpc_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "brpc_tpu/ops/flash_attention.py:104",
        "shape": decode["shape"],
        "launches": launches,
        "launches_per_decode_step": launches / steps,
        "max_abs_err": decode_err,
        "ms": decode["ms"],
        "kernel_ms": decode["ms"],
        "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "long_sequence": long_cases,
    }]
    print(card)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
