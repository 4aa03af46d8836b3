"""Build the port's native host core from ``src/`` with ``g++`` (the port
of brpc_tpu/native/build.py, its sanitizer modes included).

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

Sanitizer modes: with ``BRPC_TPU_TORCH_SANITIZE`` set (the port's name
for the reference's ``BRPC_TPU_SANITIZE``; ``address``, ``undefined``,
``thread``, comma-separated), both outputs build instrumented, with
``-fno-omit-frame-pointer -fno-sanitize-recover=all``, under names of
their own (``<name>-<hash>.san.so``: the flags are in the hash, and
``.san`` tells a reader which is which), so a plain build and a
sanitized one never take each other's place. An unknown token raises
(``sanitize_mode``). The loaders latch the mode at their first call and
raise if it changes after (``sanitize_changed_error``), if
``BRPC_TPU_TORCH_NO_NATIVE`` is set beside it
(``check_no_native_conflict``), and if a sanitized output fails to build
or to load (``sanitized_load_failure``): never a silent pure-Python
lane that claims sanitizer coverage. The sanitized outputs build with
the compiler that finds the modes' runtimes (``sanitizer_cxx``: ``CXX``,
or else the system's ``g++``). An instrumented library loads only
into an interpreter whose first libraries are the sanitizer runtimes:
run it with ``sanitizer_env()`` (``LD_PRELOAD`` of ``libasan.so`` and
``libubsan.so``, as ``g++ -print-file-name`` finds them, in the mode's
order, before any earlier preload; leak detection off, since CPython's
arenas are never all freed; ``protect_shadow_gap=0``, since libcuda
maps memory in ASan's shadow gap; any report aborts). Build in a
process without that environment: a compiler run under ASan's preload
is slow and reports the compiler's own leaks.
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
from typing import Dict, List, Optional, Sequence, Tuple

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

SANITIZE_ENV = "BRPC_TPU_TORCH_SANITIZE"
# the modes' tokens -> their compiler flags
_SANITIZERS = {
    "address": ["-fsanitize=address"],
    "undefined": ["-fsanitize=undefined"],
    "thread": ["-fsanitize=thread"],
}
_SAN_COMMON = ["-fno-omit-frame-pointer", "-fno-sanitize-recover=all"]
# a token -> the runtime the interpreter must preload
_SAN_RUNTIMES = {"address": "libasan.so", "undefined": "libubsan.so",
                 "thread": "libtsan.so"}

# per-output build record: seconds, whether the cache served it, path
build_info: Dict[str, dict] = {}


def sanitize_mode(env: Optional[str] = None) -> Tuple[str, ...]:
    """``BRPC_TPU_TORCH_SANITIZE`` (or ``env``) as a tuple of tokens,
    each once, in their order; an unknown token raises ValueError, so a
    typo cannot run the plain lane while claiming sanitizer coverage."""
    raw = os.environ.get(SANITIZE_ENV, "") if env is None else env
    out: List[str] = []
    for tok in raw.replace(";", ",").split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        if tok not in _SANITIZERS:
            raise ValueError(
                f"{SANITIZE_ENV}: unknown sanitizer {tok!r} "
                f"(known: {', '.join(sorted(_SANITIZERS))})")
        if tok not in out:
            out.append(tok)
    return tuple(out)


def check_no_native_conflict(san: Sequence[str]) -> None:
    """Raise when ``BRPC_TPU_TORCH_NO_NATIVE`` would drop an active
    sanitize mode: pure Python under an environment that claims
    sanitizer coverage."""
    if san:
        raise RuntimeError(
            f"{SANITIZE_ENV}={','.join(san)} conflicts with "
            "BRPC_TPU_TORCH_NO_NATIVE: disabling the native lanes would "
            "run pure Python while the environment claims sanitizer "
            "coverage")


def sanitized_load_failure(san: Sequence[str], what: str) -> RuntimeError:
    """The error for a sanitized output that failed to build or load,
    raised in place of the pure-Python fallback."""
    return RuntimeError(
        f"{SANITIZE_ENV}={','.join(san)} is set but the sanitized {what} "
        "failed to build or load; refusing the uninstrumented pure-Python "
        "fallback. Run the interpreter with the environment of "
        "brpc_tpu_torch.native.build.sanitizer_env() (LD_PRELOAD of the "
        "sanitizer runtimes).")


def sanitize_changed_error(latched: Optional[str]) -> RuntimeError:
    """The error for ``BRPC_TPU_TORCH_SANITIZE`` changed after a loader
    latched: the loaded output is not the instrumentation asked for."""
    cur = os.environ.get(SANITIZE_ENV, "")
    return RuntimeError(
        f"{SANITIZE_ENV} changed to {cur!r} after the native loader "
        f"latched under {latched or ''!r}: the loaded output no longer "
        "matches the requested instrumentation; set it before the first "
        "native use, or restart the process")


def _san_flags(san: Sequence[str]) -> List[str]:
    flags: List[str] = []
    for tok in san:
        flags.extend(_SANITIZERS[tok])
    return flags + _SAN_COMMON if san else flags


def _python_include() -> str:
    return sysconfig.get_paths()["include"]


def _output_path(name: str, srcs: Sequence[str], flags: List[str],
                 san: Sequence[str] = (), cxx: str = "") -> Path:
    h = hashlib.sha256(" ".join([cxx or CXX, *flags]).encode())
    for s in srcs:
        h.update(s.encode())
        h.update((SRC_DIR / s).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}{'.san' if san else ''}.so"


def _build(name: str, srcs: Sequence[str], extra: List[str],
           san: Sequence[str] = ()) -> Path:
    flags = CXXFLAGS + _san_flags(san) + extra
    cxx = (sanitizer_cxx(san) or CXX) if san else CXX
    out = _output_path(name, srcs, flags, san, cxx)
    key = name + (".san" if san else "")
    if out.exists():
        build_info.setdefault(key, {"build_s": 0.0, "cached": True,
                                    "path": str(out)})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    with open(BUILD_DIR / f"{key}.lock", "w") as lock:
        # one compiler run across processes: the others wait here, then
        # find the library in place
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                build_info[key] = {"build_s": time.monotonic() - t0,
                                   "cached": True, "path": str(out)}
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *flags, "-o", str(tmp),
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
    build_info[key] = {"build_s": time.monotonic() - t0, "cached": False,
                       "path": str(out)}
    return out


def _mode(sanitize: Optional[Sequence[str]]) -> Tuple[str, ...]:
    return sanitize_mode() if sanitize is None else \
        sanitize_mode(",".join(sanitize))


def build(sanitize: Optional[Sequence[str]] = None) -> Path:
    """The ctypes library's path, compiled if its cache entry is
    missing; ``sanitize`` defaults to ``BRPC_TPU_TORCH_SANITIZE``. Raises
    with the compiler's stderr on failure."""
    return _build("libbrpc_tpu_torch_native", LIB_SRCS, [],
                  _mode(sanitize))


def build_fastcore(sanitize: Optional[Sequence[str]] = None) -> Path:
    """The ``_brpc_fastcore`` extension's path, compiled against this
    interpreter's headers if its cache entry is missing."""
    inc = _python_include()
    if not (Path(inc) / "Python.h").exists():
        raise RuntimeError(f"Python.h not found under {inc}: the fastcore "
                           "extension cannot be built here")
    return _build("_brpc_fastcore", FASTCORE_SRCS, [f"-I{inc}"],
                  _mode(sanitize))


def _runtime_lib(name: str, cxx: Optional[str] = None) -> Optional[str]:
    """The absolute path of a sanitizer runtime (``libasan.so``,
    ``libubsan.so``) as the compiler ``cxx`` (default ``CXX``) finds it,
    or None."""
    try:
        proc = subprocess.run([cxx or CXX, f"-print-file-name={name}"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    path = proc.stdout.strip()
    return path if path and os.path.isabs(path) and os.path.exists(path) \
        else None


def sanitizer_cxx(san: Sequence[str] = ("address", "undefined")
                  ) -> Optional[str]:
    """The compiler of the sanitized builds: ``CXX`` when it finds every
    mode's runtime, else the first ``g++`` on ``PATH``, or the system's
    ``/usr/bin/g++``, that does (a toolchain installed apart from the
    system's may ship no sanitizer runtimes); None when none does."""
    import shutil
    seen = set()
    for cand in (CXX, shutil.which("g++"), "/usr/bin/g++"):
        path = shutil.which(cand) if cand else None
        if path is None or os.path.realpath(path) in seen:
            continue
        seen.add(os.path.realpath(path))
        if all(_runtime_lib(_SAN_RUNTIMES[t], path) for t in san):
            return path
    return None


def sanitizer_toolchain_missing(
        san: Sequence[str] = ("address", "undefined")) -> List[str]:
    """What an instrumented build and run lack (empty: ready): a
    compiler, and each mode's runtime (``sanitizer_cxx``)."""
    import shutil
    if shutil.which(CXX) is None:
        return [CXX]
    if sanitizer_cxx(san) is not None:
        return []
    return [_SAN_RUNTIMES[t] for t in san
            if _runtime_lib(_SAN_RUNTIMES[t]) is None]


def sanitizer_env(san: Optional[Sequence[str]] = None) -> dict:
    """The environment to add for running Python on sanitized outputs
    (the module's doc); {} when no mode is set."""
    san = _mode(san)
    if not san:
        return {}
    cxx = sanitizer_cxx(san)
    preload = []
    for tok in san:
        p = _runtime_lib(_SAN_RUNTIMES[tok], cxx)
        if p:
            preload.append(p)
    env = {
        SANITIZE_ENV: ",".join(san),
        "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1:"
                        "allocator_may_return_null=1:protect_shadow_gap=0",
        "UBSAN_OPTIONS": "halt_on_error=1:abort_on_error=1:"
                         "print_stacktrace=1",
    }
    if preload:
        prior = os.environ.get("LD_PRELOAD", "")
        env["LD_PRELOAD"] = " ".join(preload + ([prior] if prior else []))
    return env


if __name__ == "__main__":
    print(build())
    print(build_fastcore())
    if sanitize_mode():
        print("sanitizers:", ",".join(sanitize_mode()))
    sys.exit(0)
