"""Times builds of one tile kernel against each other on one card.

    python3 -m brpc_tpu_torch.ops.kernel_ab LIBRARY BUILD [BUILD ...]
        [--shape HEADSxSEQxD:DTYPE ...] [--last-rows N]

Run from a checkout's root, on a card. LIBRARY is ``flash_attention``
(``flash_attn_fwd``) or ``flash_attention_tc`` (``flash_attn_fwd_tc``).
Each BUILD is one argument: a directory holding the library's source and
the headers it includes, then any ``nvcc`` defines, for example

    brpc_tpu_torch/ops/csrc                       the package's library
    scratch_chip/parent/brpc_tpu_torch/ops/csrc   a parent commit's source,
                                                  unpacked by git archive
                                                  into a git-ignored dir
    "brpc_tpu_torch/ops/csrc -DBRPC_TC_WARPGROUPS=2"
                                                  the tc kernel's 128-row
                                                  blocks

All builds use the library's flags, compile in parallel and print their
ptxas lines first. Then, for each shape (``--shape``, or the library's
defaults: the shapes ``chip_smoke.py`` times) without and with the causal
mask, one JSON line: each build's device time twice, in turns (the builds
in order, then in reverse; µs by CUDA events after a device-side sleep
that hides the host's enqueue cost); with ``--last-rows N``, each build's
time for the last N query rows of every head alone (launched through
``q_offset``: under the causal mask, the heaviest q tile); SDPA's time as
a yardstick; and each build's error against ``_flash_plain`` (fp32: the
largest absolute difference, within ``FP32_TOL``; 16-bit: the worst ratio
to ``_rounding_bound``). Then the card line (name, power limit). It exits
1 if a build disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from . import _build

# the ops package exports the function flash_attention under the
# submodule's name, so the module is fetched by its full name
fa = importlib.import_module("brpc_tpu_torch.ops.flash_attention")

FP32_TOL = 1e-4
ENTRY = {"flash_attention": "flash_attn_fwd",
         "flash_attention_tc": "flash_attn_fwd_tc"}
ROUNDS_P = {"flash_attention_tc"}    # rounds P to the inputs' dtype
SHAPES = {  # (heads, seq, head dim, dtype)
    "flash_attention": [(8, 2048, 64, torch.float32),
                        (8, 2048, 128, torch.float32),
                        (8, 2048, 32, torch.bfloat16)],
    "flash_attention_tc": [(8, 2048, 64, torch.bfloat16),
                           (32, 2048, 64, torch.bfloat16),
                           (8, 2048, 128, torch.bfloat16),
                           (2, 1000, 128, torch.float16)],
}


def parse_shape(text: str):
    """``8x2048x64:float32`` -> (8, 2048, 64, torch.float32)."""
    dims, dtype = text.split(":")
    heads, n, d = (int(x) for x in dims.split("x"))
    return heads, n, d, getattr(torch, dtype)


def build(library: str, spec: str):
    """(the library, its ptxas lines) for one BUILD argument. The
    package's own source without defines is the package's library (from
    the cache when ``chip_smoke.py`` built it first, then without ptxas
    lines)."""
    src_dir, *defines = spec.split()
    src_dir = Path(src_dir).resolve()
    if src_dir == _build.CSRC and not defines:
        lib = _build.load(library)
        return lib, _build.build_info[library]["ptxas"].splitlines()
    source = src_dir / _build.LIBRARIES[library][0]
    h = hashlib.sha256(" ".join(defines).encode())
    for f in sorted(src_dir.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    path = _build.BUILD_DIR / f"lib{library}-ab-{h.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *defines,
                           "-o", str(path), str(source)],
                          check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(path))
    entry = ENTRY[library]
    getattr(lib, entry).argtypes = _build.LIBRARIES[library][1][entry]
    getattr(lib, entry).restype = ctypes.c_int
    return lib, proc.stderr.strip().splitlines()


def launch(fn, name, q, k, v, causal, q_offset=None):
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    fa._raise_on(fn(fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(out),
                    fa._ptr(q_offset), 0, bh, sq, k.shape[1], d, d ** -0.5,
                    int(causal), fa._DTYPE_CODES[q.dtype], fa._stream(q)),
                 name)
    return out


def device_us(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)      # ~0.1 s: the launches queue behind
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m brpc_tpu_torch.ops.kernel_ab",
        description="Times builds of one tile kernel against each other.")
    ap.add_argument("library", choices=sorted(ENTRY))
    ap.add_argument("builds", nargs="+", metavar="BUILD",
                    help="a source directory, then any nvcc defines")
    ap.add_argument("--shape", action="append", type=parse_shape,
                    help="HEADSxSEQxD:DTYPE, e.g. 8x2048x64:float32")
    ap.add_argument("--last-rows", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    entry = ENTRY[args.library]
    with ThreadPoolExecutor(len(args.builds)) as pool:
        built = list(pool.map(lambda s: build(args.library, s), args.builds))
    fns = {}
    for spec, (lib, ptxas) in zip(args.builds, built):
        fns[spec] = getattr(lib, entry)
        print(json.dumps({"build": spec, "ptxas": ptxas}), flush=True)
    rng = np.random.RandomState(3)
    ok = True
    for heads, n, d, dtype in args.shape or SHAPES[args.library]:
        q, k, v = (torch.from_numpy(rng.randn(heads, n, d).astype(np.float32))
                   .cuda().to(dtype) for _ in range(3))
        qf, kf, vf = q.float(), k.float(), v.float()
        for causal in (False, True):
            want = fa._flash_plain(qf, kf, vf, d ** -0.5, causal, 128)
            if dtype == torch.float32:
                bound = FP32_TOL
            else:
                pv_abs = (fa._flash_plain(qf, kf, vf.abs(), d ** -0.5,
                                          causal, 128)
                          if args.library in ROUNDS_P else None)
                bound = fa._rounding_bound(want, dtype, pv_abs)
            row = {"shape": f"{heads}x{n}x{d}", "dtype": str(dtype)[6:],
                   "causal": causal, "err": {}, "us": {s: [] for s in fns}}
            for spec, fn in fns.items():
                diff = (launch(fn, entry, q, k, v, causal).float()
                        - want).abs()
                worst = float((diff / bound).max())
                row["err"][spec] = (worst * bound if dtype == torch.float32
                                    else worst)
                ok &= bool(np.isfinite(worst) and worst <= 1.0)
            for spec in [*fns, *reversed(fns)]:
                row["us"][spec].append(device_us(
                    lambda: launch(fns[spec], entry, q, k, v, causal)))
            if args.last_rows:
                first = (n - 1) // args.last_rows * args.last_rows
                off = torch.full((heads,), first, dtype=torch.int32,
                                 device=q.device)
                q_last = q[:, first:].contiguous()
                row["last_rows_us"] = {spec: device_us(
                    lambda: launch(fn, entry, q_last, k, v, causal, off))
                    for spec, fn in fns.items()}
            row["sdpa_us"] = device_us(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal))
            print(json.dumps(row), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
