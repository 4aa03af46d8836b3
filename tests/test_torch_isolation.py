"""The port stands alone: no file of brpc_tpu_torch, and not
chip_smoke.py, imports jax, brpc_tpu or google.protobuf (the machine with
the card has none of them)."""

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
