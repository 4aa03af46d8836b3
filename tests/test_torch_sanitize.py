"""The native core's sanitizer modes in the port
(``brpc_tpu_torch/native/build.py`` and the two loaders' latch), against
brpc_tpu's on the CPU.

Tier 1, one collected test over the cases (``_run_cases`` of
test_torch_cluster.py), no compiler run:

- ``sanitize_mode`` reads the same tokens as brpc_tpu's and refuses an
  unknown one; a typo raises from both loaders on every call;
- ``BRPC_TPU_TORCH_NO_NATIVE`` beside a mode raises from both loaders;
- a mode set after the loaders latched raises on their next calls;
- a sanitized output that fails to build raises on every call and never
  falls back to pure Python;
- a sanitized output and a plain one get different names in ``_build/``
  (``.san`` in the sanitized name, the flags in the hash);
- ``sanitizer_env`` preloads the runtimes in brpc_tpu's order (the
  mode's), before an earlier ``LD_PRELOAD``, with brpc_tpu's ASan and
  UBSan options and ``protect_shadow_gap=0`` beside them.

Tier 2, marked ``slow`` as tests/test_sanitizer_lane.py is: both outputs
rebuilt under ``address,undefined``, then tests/test_torch_native.py's
cases and test_torch_rtmp.py's decoder cases in a child whose
interpreter preloads the runtimes; the child must pass, map only the
``.san`` outputs and print no sanitizer report.

    python -m pytest tests/test_torch_sanitize.py -m slow
"""

import os
import subprocess
import sys

import pytest

from brpc_tpu.native import build as ref_build

from brpc_tpu_torch.native import build

from test_torch_cluster import ROOT, _run_cases

SAN = ("address", "undefined")


def _child(code: str, env: dict, timeout_s: float = 120):
    full = dict(os.environ)
    full.pop(build.SANITIZE_ENV, None)
    full.pop("BRPC_TPU_TORCH_NO_NATIVE", None)
    full.update(env)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=timeout_s)
    assert proc.returncode == 0 and "ok" in proc.stdout, \
        proc.stdout + proc.stderr[-3000:]


_LOADERS = ("from brpc_tpu_torch.native import fastcore\n"
            "import brpc_tpu_torch.native as native\n")


def case_mode_parsing():
    for raw in ("", "address", "address, undefined", "ADDRESS;thread",
                "undefined,address,undefined", " , ,address"):
        assert build.sanitize_mode(raw) == ref_build.sanitize_mode(raw)
    for bad in ("adress", "address,memory", "asan"):
        for mod in (build, ref_build):
            with pytest.raises(ValueError):
                mod.sanitize_mode(bad)
    os.environ.pop(build.SANITIZE_ENV, None)
    assert build.sanitize_mode() == ()
    _child("import os\n"
           f"os.environ[{build.SANITIZE_ENV!r}] = 'adress'\n" + _LOADERS +
           "for loader in (fastcore.get, fastcore.get, native.lib,\n"
           "               native.lib):\n"
           "    try:\n"
           "        loader()\n"
           "    except ValueError:\n"
           "        continue\n"
           "    raise SystemExit('a typo swallowed by ' + repr(loader))\n"
           "print('ok')\n", {})


def case_no_native_conflict():
    with pytest.raises(RuntimeError):
        build.check_no_native_conflict(("address",))
    build.check_no_native_conflict(())
    _child(_LOADERS +
           "for loader in (fastcore.get, native.lib, native.lib):\n"
           "    try:\n"
           "        loader()\n"
           "    except RuntimeError as e:\n"
           "        assert 'BRPC_TPU_TORCH_NO_NATIVE' in str(e), e\n"
           "        continue\n"
           "    raise SystemExit('a silent fallback in ' + repr(loader))\n"
           "print('ok')\n",
           {build.SANITIZE_ENV: "address", "BRPC_TPU_TORCH_NO_NATIVE": "1"})
    # NO_NATIVE alone latches the pure lanes, quietly
    _child(_LOADERS +
           "assert fastcore.get() is None and native.lib() is None\n"
           "assert fastcore.get() is None\n"
           "print('ok')\n", {"BRPC_TPU_TORCH_NO_NATIVE": "1"})


def case_changed_after_latch():
    _child("import os\n" + _LOADERS +
           "fastcore.get(); native.lib()\n"
           f"os.environ[{build.SANITIZE_ENV!r}] = 'address'\n"
           "for loader in (fastcore.get, fastcore.get, native.lib):\n"
           "    try:\n"
           "        loader()\n"
           "    except RuntimeError as e:\n"
           "        assert 'changed' in str(e), e\n"
           "        continue\n"
           "    raise SystemExit('a stale output served by ' + repr(loader))\n"
           "print('ok')\n", {"BRPC_TPU_TORCH_NO_NATIVE": "1"})


def case_failed_build_raises():
    _child("import brpc_tpu_torch.native.build as b\n"
           "calls = []\n"
           "def boom(name, srcs, extra, san=()):\n"
           "    calls.append(san)\n"
           "    raise RuntimeError('sabotaged build')\n"
           "b._build = boom\n" + _LOADERS +
           "for loader in (fastcore.get, fastcore.get, native.lib,\n"
           "               native.lib):\n"
           "    try:\n"
           "        loader()\n"
           "    except RuntimeError as e:\n"
           "        assert 'BRPC_TPU_TORCH_SANITIZE' in str(e), e\n"
           "        assert 'sabotaged' in str(e.__cause__), e.__cause__\n"
           "        continue\n"
           "    raise SystemExit('a silent fallback in ' + repr(loader))\n"
           "assert calls == [('address', 'undefined')] * 4, calls\n"
           "assert fastcore.load_error is None and native.load_error is None\n"
           "print('ok')\n", {build.SANITIZE_ENV: "address,undefined"})


def case_output_names():
    for name, srcs, extra in (
            ("libbrpc_tpu_torch_native", build.LIB_SRCS, []),
            ("_brpc_fastcore", build.FASTCORE_SRCS, ["-I/x"])):
        plain = build._output_path(name, srcs, build.CXXFLAGS + extra)
        san = build._output_path(
            name, srcs, build.CXXFLAGS + build._san_flags(SAN) + extra, SAN)
        undefined = build._output_path(
            name, srcs,
            build.CXXFLAGS + build._san_flags(("undefined",)) + extra,
            ("undefined",))
        assert plain.parent == san.parent == build.BUILD_DIR
        assert plain.name.endswith(".so") and \
            not plain.name.endswith(".san.so")
        assert san.name.endswith(".san.so") and \
            undefined.name.endswith(".san.so")
        assert len({plain.name, san.name, undefined.name}) == 3
        assert san.name.startswith(name + "-")
    assert build._san_flags(SAN) == ["-fsanitize=address",
                                     "-fsanitize=undefined",
                                     "-fno-omit-frame-pointer",
                                     "-fno-sanitize-recover=all"]
    assert build._san_flags(()) == []


def case_sanitizer_env():
    saved = os.environ.get("LD_PRELOAD")
    try:
        for prior in (None, "/opt/x/libfoo.so"):
            if prior is None:
                os.environ.pop("LD_PRELOAD", None)
            else:
                os.environ["LD_PRELOAD"] = prior
            for san in (SAN, ("undefined", "address"), ("address",)):
                mine = build.sanitizer_env(san)
                ref = ref_build.sanitizer_env(san)
                assert mine["LD_PRELOAD"] == ref["LD_PRELOAD"]
                libs = mine["LD_PRELOAD"].split()
                assert [os.path.basename(p) for p in libs[:len(san)]] == \
                    [build._SAN_RUNTIMES[t] for t in san]
                if prior:
                    assert libs[-1] == prior
                assert mine[build.SANITIZE_ENV] == ",".join(san) == \
                    ref["BRPC_TPU_SANITIZE"]
                opts = mine["ASAN_OPTIONS"].split(":")
                assert set(ref["ASAN_OPTIONS"].split(":")) <= set(opts)
                assert "protect_shadow_gap=0" in opts
                assert mine["UBSAN_OPTIONS"] == ref["UBSAN_OPTIONS"]
        os.environ.pop(build.SANITIZE_ENV, None)
        assert build.sanitizer_env() == {} == build.sanitizer_env(())
        assert build.sanitizer_toolchain_missing(SAN) == \
            ref_build.sanitizer_toolchain_missing(SAN)
        for name in ("libasan.so", "libubsan.so", "no-such-runtime.so"):
            assert build._runtime_lib(name) == ref_build._runtime_lib(name)
    finally:
        if saved is None:
            os.environ.pop("LD_PRELOAD", None)
        else:
            os.environ["LD_PRELOAD"] = saved


CASES = [
    ("mode parsing", case_mode_parsing, ()),
    ("NO_NATIVE beside a mode", case_no_native_conflict, ()),
    ("a mode changed after the latch", case_changed_after_latch, ()),
    ("a failed sanitized build", case_failed_build_raises, ()),
    ("output names", case_output_names, ()),
    ("sanitizer_env", case_sanitizer_env, ()),
]


def test_sanitize_modes():
    _run_cases(CASES)


# ------------------------------------------------------------ tier 2

# cases whose subject is the plain lane's switch or its build record
NATIVE_SKIP = ("switch in a subprocess", "four builds at once")
RTMP_DECODERS = ("AMF0 against brpc_tpu's", "AMF3 decode against brpc_tpu's",
                 "garbage read alike", "chunks against brpc_tpu's",
                 "aggregate split", "FLV and TS")
_LANE = """
import sys
sys.path.insert(0, "tests")
import test_torch_native as native_t
import test_torch_rtmp as rtmp_t
from test_torch_cluster import _run_cases
_run_cases([c for c in native_t.CASES if c[0] not in {skip!r}]
           + [c for c in rtmp_t.CASES if c[0] in {rtmp!r}])
with open("/proc/self/maps") as f:
    mapped = sorted({{line.split()[-1] for line in f
                     if "_brpc_fastcore-" in line
                     or "libbrpc_tpu_torch_native-" in line}})
print("mapped", mapped)
print("ok")
"""


@pytest.mark.slow
@pytest.mark.sanitize
def test_native_lanes_and_decoders_under_asan_ubsan():
    missing = build.sanitizer_toolchain_missing(SAN)
    assert not missing, f"the toolchain lacks {missing}"
    lib, fast = build.build(SAN), build.build_fastcore(SAN)
    assert lib.name.endswith(".san.so") and fast.name.endswith(".san.so")
    env = dict(os.environ)
    env.pop("BRPC_TPU_TORCH_NO_NATIVE", None)
    env.update(build.sanitizer_env(SAN))
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c",
         _LANE.format(skip=NATIVE_SKIP, rtmp=RTMP_DECODERS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = (proc.stdout + proc.stderr)[-4000:]
    assert "ERROR: AddressSanitizer" not in proc.stderr and \
        "runtime error:" not in proc.stderr, tail
    assert proc.returncode == 0 and "ok" in proc.stdout, tail
    mapped = [line for line in proc.stdout.splitlines()
              if line.startswith("mapped")][-1]
    assert str(lib) in mapped and str(fast) in mapped, mapped
    assert mapped.count(".so") == mapped.count(".san.so") == 2, mapped
