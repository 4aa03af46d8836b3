"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` into a shared
library of its own with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, and a compile error in one
library does not block the others). Libraries land in
``brpc_tpu_torch/_build/`` under a name keyed on a hash of the source, the
headers it includes and the flags, so an edited source rebuilds and an
unchanged one loads from the cache. Nothing is built at import: the first
launch builds, or ``build_all`` builds every library at once, one ``nvcc``
process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HEADERS = [CSRC / "tile_order.cuh"]

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the tile kernels' C signature: q, k, v, o, q_offset, q_offset_add, bh,
# sq, sk, d, scale, causal, dtype, stream
_TILE_ARGS = [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i, _i, _p]
# library -> (source, {C function: argtypes})
LIBRARIES = {
    "flash_attention": ("flash_attention.cu",
                        {"flash_attn_fwd": _TILE_ARGS}),
    "flash_attention_tc": ("flash_attention_tc.cu",
                           {"flash_attn_fwd_tc": _TILE_ARGS}),
    # q, k, v, lengths, out, m_l, o_part, b, L, d, splits, chunk, scale,
    # dtype, stream; then m_l, o_part, out, b, d, splits, dtype, stream
    "flash_decode": ("flash_decode.cu",
                     {"flash_decode": [_p, _p, _p, _p, _p, _p, _p, _i, _i,
                                       _i, _i, _i, _f, _i, _p],
                      "flash_decode_combine": [_p, _p, _p, _i, _i, _i, _i,
                                               _p]}),
}
LIBRARY_OF = {fn: lib for lib, (_, fns) in LIBRARIES.items() for fn in fns}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per-library build record: seconds spent, whether it came from the
# cache, what ptxas said about registers and shared memory, and the path
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str, sources: List[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *HEADERS]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` into ``lib<name>-<hash>.so`` unless it
    exists."""
    sources = [CSRC / LIBRARIES[name][0]]
    path = _lib_path(name, sources)
    if path.exists():
        # keep the record of a build made earlier in this process
        build_info.setdefault(name, {"build_s": 0.0, "cached": True,
                                     "ptxas": "", "path": str(path)})
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources]]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    build_info[name] = {"build_s": time.monotonic() - t0, "cached": False,
                        "ptxas": proc.stderr.strip(), "path": str(path)}
    return path


def load(name: str) -> ctypes.CDLL:
    """Library ``name`` of ``LIBRARIES``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build every library in parallel (one nvcc each), then load them.
    Raises on the first library that fails, after all builds ended."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        futures = [pool.submit(build, name) for name in LIBRARIES]
    for fut in futures:
        fut.result()
    return {name: load(name) for name in LIBRARIES}
