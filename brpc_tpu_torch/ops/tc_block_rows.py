"""Times ``flash_attn_fwd_tc``'s two block shapes on one card.

    python3 -m brpc_tpu_torch.ops.tc_block_rows    # from a checkout's root

The library is built with one consumer warpgroup a block (64 query rows);
``-DBRPC_TC_WARPGROUPS=2`` builds blocks of 128 rows (two warpgroups
sharing each K/V tile). This script compiles both from
``csrc/flash_attention_tc.cu`` with the library's flags, and for each
shape prints one JSON line: the device time of each build (CUDA events,
after a device-side sleep that hides the host's enqueue cost), the time
of the heaviest q tile of each head alone (the same block, launched
through ``q_offset`` with nothing else on the card), SDPA's time as a
yardstick, and each build's error against ``_flash_plain`` over its
``_rounding_bound``. Then the card line (name, power limit). It exits 1 if
a build disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys

import numpy as np
import torch

from . import _build

# the ops package exports the function flash_attention under the
# submodule's name, so the module is fetched by its full name
fa = importlib.import_module("brpc_tpu_torch.ops.flash_attention")

SHAPES = [  # (heads, seq, head dim, dtype)
    (8, 2048, 64, torch.bfloat16),
    (32, 2048, 64, torch.bfloat16),
    (8, 2048, 128, torch.bfloat16),
    (2, 1000, 128, torch.float16),
]


def build(warpgroups: int) -> ctypes.CDLL:
    src = _build.CSRC / "flash_attention_tc.cu"
    path = _build.BUILD_DIR / f"libflash_attention_tc_wg{warpgroups}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    f"-DBRPC_TC_WARPGROUPS={warpgroups}", "-o", str(path),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(path))
    lib.flash_attn_fwd_tc.argtypes = _build.LIBRARIES["flash_attention_tc"][
        1]["flash_attn_fwd_tc"]
    lib.flash_attn_fwd_tc.restype = ctypes.c_int
    return lib


def launch(lib, q, k, v, causal, q_offset=None):
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    err = lib.flash_attn_fwd_tc(
        fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(out), fa._ptr(q_offset),
        0, bh, sq, k.shape[1], d, d ** -0.5, int(causal),
        fa._DTYPE_CODES[q.dtype], fa._stream(q))
    fa._raise_on(err, "flash_attn_fwd_tc")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("tc_block_rows: needs a CUDA card", file=sys.stderr)
        return 2
    libs = {wg: build(wg) for wg in (1, 2)}
    rng = np.random.RandomState(12)
    ok = True
    for heads, n, d, dtype in SHAPES:
        q, k, v = (torch.from_numpy(rng.randn(heads, n, d).astype(np.float32))
                   .cuda().to(dtype) for _ in range(3))
        qf, kf, vf = q.float(), k.float(), v.float()
        for causal in (False, True):
            want = fa._flash_plain(qf, kf, vf, d ** -0.5, causal, 128)
            bound = fa._rounding_bound(want, dtype, fa._flash_plain(
                qf, kf, vf.abs(), d ** -0.5, causal, 128))
            row = {"shape": f"{heads}x{n}x{d}", "dtype": str(dtype)[6:],
                   "causal": causal}
            for wg, lib in libs.items():
                got = launch(lib, q, k, v, causal)
                worst = float(((got.float() - want).abs() / bound).max())
                ok &= worst <= 1.0
                rows = 64 * wg
                first = (n - 1) // rows * rows      # the last q tile
                off = torch.full((heads,), first, dtype=torch.int32,
                                 device=q.device)
                q_last = q[:, first:].contiguous()
                row[f"wg{wg}_rows{rows}"] = {
                    "us": device_us(lambda: launch(lib, q, k, v, causal)),
                    "last_tile_alone_us": device_us(
                        lambda: launch(lib, q_last, k, v, causal, off)),
                    "worst_over_bound": worst}
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
