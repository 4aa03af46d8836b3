"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries land in
``brpc_tpu_torch/_build/`` under a name keyed on a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads from
the cache. Nothing is built at import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per-library build record: seconds spent, whether it came from the
# cache, and what ptxas said about registers and shared memory
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
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: List[Path]) -> Path:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` unless it exists."""
    path = _lib_path(name, sources)
    if path.exists():
        build_info[name] = {"build_s": 0.0, "cached": True, "ptxas": ""}
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources]]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    build_info[name] = {"build_s": time.monotonic() - t0, "cached": False,
                        "ptxas": proc.stderr.strip()}
    return path


def load_flash_attention() -> ctypes.CDLL:
    """The flash-attention library, built at first use."""
    with _lock:
        lib = _libs.get("flash_attention")
        if lib is None:
            path = build("flash_attention", [CSRC / "flash_attention.cu"])
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.flash_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                           ctypes.c_float, i, i, p]
            lib.flash_attn_fwd.restype = i
            _libs["flash_attention"] = lib
        return lib
