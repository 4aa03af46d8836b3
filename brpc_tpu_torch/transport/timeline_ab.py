"""Two trees' stitched stage timelines, in turns, on one card.

    python3 -m brpc_tpu_torch.transport.timeline_ab PARENT CHANGE [--pairs N]

Runs ``chip_smoke.py --phase observability`` of each tree (a directory
holding its ``chip_smoke.py`` and ``brpc_tpu_torch/``) in the order
A B B A A B ..., N pairs, each run a process of its own whose working
directory is the tree. Each run's ``observability_timeline`` lines get
one more field, ``ab``, computed by this module from the same rows for
both trees: the later calls' (a client's calls after its first on a
connection) way in and arrival -> handler, p50 and p99, and the first
calls' way in p50, in microseconds. Prints one JSON line per run and
transport, then one summary line with each tree's medians over its
runs. A run that fails stops the comparison with a non-zero exit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from statistics import median

# imports the tree's own chip_smoke.py and wraps its _timeline_line
_RUNNER = r"""
import importlib.util, sys
tree = sys.argv[1]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              tree + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
orig = cs._timeline_line

def pct(xs, q):
    xs = sorted(x for x in xs if x is not None)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None

def wrapped(kind, rows):
    out = orig(kind, rows)
    later = [r for r in rows if not r["first_on_connection"]]
    first = [r for r in rows if r["first_on_connection"]]
    out["ab"] = {
        "later_calls": len(later),
        "later_way_in_p50": pct([r["way_in"] for r in later], 0.5),
        "later_way_in_p99": pct([r["way_in"] for r in later], 0.99),
        "later_received_to_handler_p50": pct(
            [r["received_to_handler"] for r in later], 0.5),
        "later_received_to_handler_p99": pct(
            [r["received_to_handler"] for r in later], 0.99),
        "received_to_handler_p50": pct(
            [r["received_to_handler"] for r in rows], 0.5),
        "received_to_handler_p99": pct(
            [r["received_to_handler"] for r in rows], 0.99),
        "first_way_in_p50": pct([r["way_in"] for r in first], 0.5)}
    return out

cs._timeline_line = wrapped
sys.exit(cs.main(only="observability"))
"""


def run_tree(tree: Path, timeout_s: float = 900) -> list:
    out = subprocess.run([sys.executable, "-c", _RUNNER, str(tree)],
                         cwd=str(tree), capture_output=True, text=True,
                         timeout=timeout_s)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: exit {out.returncode}: "
                           f"{out.stderr[-3000:]}")
    lines = []
    for ln in out.stdout.splitlines():
        if ln.startswith("{"):
            doc = json.loads(ln)
            if doc.get("phase") in ("observability_timeline", "card"):
                lines.append(doc)
    return lines


def main(argv) -> int:
    pairs = 3
    if "--pairs" in argv:
        i = argv.index("--pairs")
        pairs = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    trees = {"parent": Path(argv[0]).resolve(),
             "change": Path(argv[1]).resolve()}
    order = []
    for i in range(pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    got = {"parent": [], "change": []}
    for turn, name in enumerate(order):
        for doc in run_tree(trees[name]):
            if doc["phase"] == "card":
                continue
            row = {"tree": name, "turn": turn,
                   "transport": doc["transport"], **doc["ab"],
                   "way_in_p50": doc["way_in"]["p50"],
                   "way_in_p99": doc["way_in"]["p99"]}
            got[name].append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for name, rows in got.items():
        for kind in sorted({r["transport"] for r in rows}):
            mine = [r for r in rows if r["transport"] == kind]
            summary[f"{name}/{kind}"] = {
                k: median(v for v in (r[k] for r in mine) if v is not None)
                if any(r[k] is not None for r in mine) else None
                for k in ("later_way_in_p50", "later_way_in_p99",
                          "received_to_handler_p50",
                          "received_to_handler_p99",
                          "later_received_to_handler_p50",
                          "first_way_in_p50")}
    print(json.dumps({"summary": summary, "runs": len(order)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
