"""Build the port's native host core from ``src/`` with ``g++`` (the port
of brpc_tpu/native/build.py, without its sanitizer modes).

Two outputs:

- the ctypes library (``block_pool.cc framing.cc hash.cc nbuf.cc
  queues.cc respool.cc snappy.cc``), a plain C ABI loaded by
  ``brpc_tpu_torch.native``;
- the ``_brpc_fastcore`` CPython extension (``fastcore.cc respool.cc
  queues.cc httpparse.cc ring.cc``), built against ``sysconfig``'s
  include directory and loaded by ``brpc_tpu_torch.native.fastcore``.
  ``ring.cc`` rides along because ``fastcore.cc`` registers its type
  and reads the syscall counters it defines.

Each lands in ``brpc_tpu_torch/_build/`` under a name keyed on a hash of
its sources and flags, as ``ops/_build.py`` keys the CUDA kernels: an
edited source rebuilds, an unchanged one loads from the cache. The build
is serialized across processes by an ``fcntl.flock`` on a lock file
there, and writes to a temporary name that ``os.replace`` moves into
place, so several processes starting at once leave one whole library. A
failed build raises with the compiler's stderr and leaves no library.

    python -m brpc_tpu_torch.native.build    # builds both, prints paths
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import Dict, List, Sequence

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

CXX = os.environ.get("CXX", "g++")
CXXFLAGS = ["-O2", "-g", "-std=c++17", "-fPIC", "-shared", "-pthread",
            "-Wall", "-Wextra", "-fno-exceptions"]

# the C-ABI library: every source but the extension's own three
LIB_SRCS = ("block_pool.cc", "framing.cc", "hash.cc", "nbuf.cc",
            "queues.cc", "respool.cc", "snappy.cc")
FASTCORE_SRCS = ("fastcore.cc", "respool.cc", "queues.cc", "httpparse.cc",
                 "ring.cc")

# per-output build record: seconds, whether the cache served it, path
build_info: Dict[str, dict] = {}


def _python_include() -> str:
    return sysconfig.get_paths()["include"]


def _output_path(name: str, srcs: Sequence[str], flags: List[str]) -> Path:
    h = hashlib.sha256(" ".join([CXX, *flags]).encode())
    for s in srcs:
        h.update(s.encode())
        h.update((SRC_DIR / s).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, srcs: Sequence[str], extra: List[str]) -> Path:
    flags = CXXFLAGS + extra
    out = _output_path(name, srcs, flags)
    if out.exists():
        build_info.setdefault(name, {"build_s": 0.0, "cached": True,
                                     "path": str(out)})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        # one compiler run across processes: the others wait here, then
        # find the library in place
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                build_info[name] = {"build_s": time.monotonic() - t0,
                                    "cached": True, "path": str(out)}
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [CXX, *flags, "-o", str(tmp),
                   *[str(SRC_DIR / s) for s in srcs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"native build of {name} failed ({proc.returncode}):\n"
                    f"$ {' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    build_info[name] = {"build_s": time.monotonic() - t0, "cached": False,
                        "path": str(out)}
    return out


def build() -> Path:
    """The ctypes library's path, compiled if its cache entry is
    missing. Raises with the compiler's stderr on failure."""
    return _build("libbrpc_tpu_torch_native", LIB_SRCS, [])


def build_fastcore() -> Path:
    """The ``_brpc_fastcore`` extension's path, compiled against this
    interpreter's headers if its cache entry is missing."""
    inc = _python_include()
    if not (Path(inc) / "Python.h").exists():
        raise RuntimeError(f"Python.h not found under {inc}: the fastcore "
                           "extension cannot be built here")
    return _build("_brpc_fastcore", FASTCORE_SRCS, [f"-I{inc}"])


if __name__ == "__main__":
    print(build())
    print(build_fastcore())
    sys.exit(0)
