"""The port stands alone: no file of brpc_tpu_torch, and not
chip_smoke.py, imports jax, brpc_tpu or google.protobuf (the machine with
the card has none of them), and the port's native core builds from its
own sources only (``brpc_tpu_torch/native/src``), never from
``brpc_tpu/native``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "brpc_tpu", "google")
# in sys.modules: the interpreter's site setup may itself register the
# empty `google` namespace package, so only protobuf counts there
FORBIDDEN_MODULES = ("jax", "jaxlib", "brpc_tpu", "google.protobuf")


def _port_files():
    files = sorted((ROOT / "brpc_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


def test_port_files_exist():
    files = _port_files()
    assert all(f.exists() for f in files)
    assert len(files) > 15


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), (path, sorted(roots))


def test_import_leaves_jax_and_brpc_tpu_out():
    code = (
        "import sys\n"
        "import brpc_tpu_torch, brpc_tpu_torch.rpc, brpc_tpu_torch.ops\n"
        "import brpc_tpu_torch.serving, brpc_tpu_torch.serving.convert\n"
        "import brpc_tpu_torch.ops._build\n"
        "import brpc_tpu_torch.builtin.flight_recorder\n"
        "import brpc_tpu_torch.incident, brpc_tpu_torch.traffic\n"
        "import brpc_tpu_torch.fiber.stacks, brpc_tpu_torch.butil.logging\n"
        "import brpc_tpu_torch.native, brpc_tpu_torch.native.fastcore\n"
        "import brpc_tpu_torch.native.build\n"
        "import brpc_tpu_torch.butil.malloc_tune\n"
        "import brpc_tpu_torch.transport.syscall_stats\n"
        "import brpc_tpu_torch.rpc.lane_ab\n"
        "import brpc_tpu_torch.transport.ring_lane\n"
        "import brpc_tpu_torch.transport.socket_map\n"
        "import brpc_tpu_torch.transport.ssl\n"
        "import brpc_tpu_torch.butil.containers\n"
        "import brpc_tpu_torch.butil.timekeeping\n"
        "import brpc_tpu_torch.rpc.rpc_dump, brpc_tpu_torch.traffic.replay\n"
        "import brpc_tpu_torch.chaos, brpc_tpu_torch.chaos.plan\n"
        "import brpc_tpu_torch.chaos.inject, brpc_tpu_torch.incident.replay\n"
        "import brpc_tpu_torch.tools.rpc_press, brpc_tpu_torch.tools.rpc_replay\n"
        "import brpc_tpu_torch.tools.rpc_view\n"
        "import brpc_tpu_torch.tools.incident_replay\n"
        "import brpc_tpu_torch.protocol.hpack, brpc_tpu_torch.protocol.h2\n"
        "import brpc_tpu_torch.protocol.http_client\n"
        "import brpc_tpu_torch.tools.parallel_http\n"
        "import brpc_tpu_torch.protocol.pbrpc_variants\n"
        "import brpc_tpu_torch.protocol.thrift, brpc_tpu_torch.protocol.redis\n"
        "import brpc_tpu_torch.protocol.memcache\n"
        "import brpc_tpu_torch.protocol.nshead, brpc_tpu_torch.protocol.mcpack\n"
        "import brpc_tpu_torch.protocol.public_pbrpc_meta\n"
        "import brpc_tpu_torch.protocol.nshead_pbrpc\n"
        "import brpc_tpu_torch.protocol.bson, brpc_tpu_torch.protocol.mongo\n"
        "import brpc_tpu_torch.protocol.esp\n"
        "import brpc_tpu_torch.transport.pipelined\n"
        "import brpc_tpu_torch.transport.ipc_probe\n"
        "import brpc_tpu_torch.protocol.amf, brpc_tpu_torch.protocol.flv\n"
        "import brpc_tpu_torch.protocol.ts, brpc_tpu_torch.protocol.rtmp\n"
        "import brpc_tpu_torch.rpc.trackme, brpc_tpu_torch.tools.chaos\n"
        "from brpc_tpu_torch.protocol.registry import get_protocols\n"
        "assert [p.name for p in get_protocols()] == "
        "['tpu_std', 'hulu_pbrpc', 'sofa_pbrpc', 'http', 'h2', 'thrift', "
        "'nshead', 'esp', 'mongo', 'rtmp', 'redis', 'memcache']\n"
        f"forbidden = {FORBIDDEN_MODULES!r}\n"
        "bad = sorted(m for m in sys.modules if any(\n"
        "    m == f or m.startswith(f + '.') for f in forbidden))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chaos_cli_leaves_jax_and_brpc_tpu_out():
    """``python3 -m brpc_tpu_torch.tools.chaos`` imports none of them:
    its parser and every module its storms use, loaded as the CLI loads
    them."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['chaos', '--help']\n"
        "try:\n"
        "    runpy.run_module('brpc_tpu_torch.tools.chaos',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import brpc_tpu_torch.tools.chaos as c\n"
        "assert callable(c.mixed_storm) and callable(c.deadline_storm)\n"
        f"forbidden = {FORBIDDEN_MODULES!r}\n"
        "bad = sorted(m for m in sys.modules if any(\n"
        "    m == f or m.startswith(f + '.') for f in forbidden))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the trace, load and cluster tools, the smokes, the preflight and the
# pod smoke: those with a parser print their help, the others are imported
TOOLS = {"trace": True, "chain_server": True, "bench_echo_server": False,
         "pipeline_runner": False, "qps_client": False, "soak": True,
         "fiber_stacks": False, "cluster_top": True,
         "shard_server": True, "smoke_util": False,
         "timeline_smoke": False, "flight_smoke": True,
         "traffic_smoke": False, "incident_smoke": False,
         "perf_smoke": False, "fabric_smoke": False,
         "serving_obs_smoke": True, "serving_smoke": True,
         "device_obs_smoke": True, "device_perf_smoke": True,
         "ici_smoke": True, "ring_smoke": True, "preflight": True,
         "pod_smoke": True}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_leaves_jax_and_brpc_tpu_out(tool):
    """``brpc_tpu_torch.tools.<tool>`` imports none of them, its parser
    included."""
    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module('brpc_tpu_torch.tools.{tool}')\n"
        f"if {TOOLS[tool]!r}:\n"
        f"    sys.argv = [{tool!r}, '--help']\n"
        "    try:\n"
        "        m.main()\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        f"forbidden = {FORBIDDEN_MODULES!r}\n"
        "bad = sorted(n for n in sys.modules if any(\n"
        "    n == f or n.startswith(f + '.') for f in forbidden))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


NATIVE_SRC = ROOT / "brpc_tpu_torch" / "native" / "src"


def test_native_build_reads_the_ports_sources():
    from brpc_tpu_torch.native import build
    assert build.SRC_DIR.resolve() == NATIVE_SRC.resolve()
    assert build.BUILD_DIR.resolve() == (ROOT / "brpc_tpu_torch"
                                         / "_build").resolve()
    for name in build.LIB_SRCS + build.FASTCORE_SRCS:
        assert (NATIVE_SRC / name).is_file(), name
    # no string of the build's code (its docstrings aside) names the
    # reference's directory: no command, flag or path can reach it
    for path in sorted((ROOT / "brpc_tpu_torch" / "native").glob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef,
                                  ast.ClassDef)) and n.body
                and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and id(node) not in docs:
                v = node.value.replace("brpc_tpu_torch", "")
                assert "brpc_tpu/native" not in v and \
                    "brpc_tpu.native" not in v, (path, node.value)


def test_native_sources_include_nothing_outside_their_directory():
    sources = sorted(NATIVE_SRC.glob("*"))
    assert len(sources) == 10
    for src in sources:
        for line in src.read_text().splitlines():
            line = line.strip()
            if not line.startswith("#include"):
                continue
            target = line[len("#include"):].strip()
            if target.startswith("<"):
                continue            # the system's and Python's headers
            name = target.strip('"')
            assert "/" not in name and (NATIVE_SRC / name).is_file(), \
                (src.name, line)
