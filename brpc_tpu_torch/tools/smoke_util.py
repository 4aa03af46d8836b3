"""What the smokes share: the perf switch, their echo servers, and the
price of a layer measured with its on and off servers loaded at once.

``BRPC_TPU_TORCH_PERF_SMOKE=0`` turns off every smoke's perf criterion
(an overhead bound or a floor) and leaves its other invariants on: the
port's name for the reference's ``BRPC_TPU_PERF_SMOKE``.

The reference prices a layer with on and off windows in turns (best-of,
or the median over order-balanced pairs). On a shared host qps drifts
by tens of percent from one second to the next, so windows in turns read
that drift: ``cluster_top``'s check once read 12.09% and 48.27% on the
card for a cost of about 2%. ``simultaneous_overhead`` loads the on server and
the off server at the same time, so that the drift falls on both, and
averages the rounds. Where the price is a latency inside one process
(the device cells, the serving flight deck), ``paired_children_cost``
runs two children at once, each switching the layer on and off window
by window in opposite phase, so that one runs with it while the other
runs without.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

OVERHEAD_PCT_MAX = 5.0
OVERHEAD_ROUNDS = 6
OVERHEAD_WINDOW_S = 1.5
COST_ROUNDS = 3


def perf_off() -> bool:
    """True when ``BRPC_TPU_TORCH_PERF_SMOKE=0``: perf criteria skip."""
    return os.environ.get("BRPC_TPU_TORCH_PERF_SMOKE", "1") == "0"


def lane_device(device):
    """``device`` (``cuda:0`` when None) resolved, and the ``#device=``
    extra of a device-lane address that names it: (torch.device, str).
    Raises without a card unless ``device`` is ``cpu``."""
    from brpc_tpu_torch.butil.device import resolve_device
    dev = resolve_device(device)
    return dev, "cpu" if dev.type == "cpu" else str(dev.index or 0)


def spawn_echo_servers(envs: Dict[str, dict], wall_s: float = 30.0,
                       argv=None) -> Tuple[list, Dict[str, int]]:
    """One ``tools.bench_echo_server`` (or ``argv``) child per entry of
    ``envs``, each with those variables over this environment (a None
    value removes one): (the processes, {tag: port}). Raises when one
    never announced."""
    from brpc_tpu_torch.tools.spawn_util import (package_root,
                                                 spawn_port_server)
    procs: list = []
    ports: Dict[str, int] = {}
    try:
        for tag, extra in envs.items():
            env = dict(os.environ)
            for k, v in extra.items():
                if v is None:
                    env.pop(k, None)
                else:
                    env[k] = v
            proc, port = spawn_port_server(
                argv or ["-m", "brpc_tpu_torch.tools.bench_echo_server"],
                wall_s=wall_s, env=env, cwd=package_root())
            if port is None:
                raise RuntimeError(f"{tag} server spawn failed")
            procs.append(proc)
            ports[tag] = port
    except BaseException:
        stop_all(procs)
        raise
    return procs, ports


def stop_all(procs) -> None:
    for p in procs:
        try:
            p.terminate()
            p.wait(10)
        except Exception:
            try:
                p.kill()
            except Exception:
                pass


def _window_at_once(on_port, off_port, seconds: float, method: str,
                    nprocs: int) -> Tuple[float, float]:
    from brpc_tpu_torch.tools.qps_client import drive_multiproc
    got: Dict[str, float] = {}

    def drive(key, port):
        got[key] = drive_multiproc(str(port), nprocs=nprocs,
                                   seconds=seconds, conns=2, inflight=8,
                                   method=method)["qps"]
    threads = [threading.Thread(target=drive, args=a)
               for a in (("on", on_port), ("off", off_port))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return got["on"], got["off"]


def simultaneous_overhead(on_port, off_port,
                          rounds: int = OVERHEAD_ROUNDS,
                          window_s: float = OVERHEAD_WINDOW_S,
                          method: str = "PyEcho",
                          nprocs: Optional[int] = None) -> dict:
    """The layer's cost in qps: ``rounds`` windows of pipelined load
    from worker processes on the on server and the off server at once,
    averaged; a reading over the bound earns as many rounds again (the
    drift against a real cost, which fails both). ``{"qps_on",
    "qps_off", "overhead_pct", "rounds"}``."""
    if nprocs is None:
        nprocs = min(4, max(2, (os.cpu_count() or 2) // 4))
    on: List[float] = []
    off: List[float] = []
    more = rounds
    while True:
        for _ in range(more):
            a, b = _window_at_once(on_port, off_port, window_s, method,
                                   nprocs)
            on.append(a)
            off.append(b)
        pct = round(max(0.0, (1.0 - sum(on) / sum(off)) * 100), 2) \
            if sum(off) else 100.0
        if pct <= OVERHEAD_PCT_MAX or len(on) > rounds:
            break
    return {"qps_on": round(sum(on) / len(on), 1),
            "qps_off": round(sum(off) / len(off), 1),
            "overhead_pct": pct, "rounds": len(on)}


def cost_child_windows(first_on: bool, windows: int,
                       switch: Callable[[bool], None],
                       window: Callable[[], float]) -> None:
    """The child's half of ``paired_children_cost``, once warmed:
    ``ready`` on stdout, then on a line from stdin ``windows`` windows,
    ``switch(on)`` before each, on first when ``first_on`` and in turns
    after; each window's ``window()`` by setting on one JSON line. It
    exits with its parent, and without a line."""
    from brpc_tpu_torch.tools.spawn_util import parent_death_watchdog_loop
    threading.Thread(target=parent_death_watchdog_loop, daemon=True,
                     name="cost child watchdog").start()
    print("ready", flush=True)
    if not sys.stdin.readline():
        return
    got: Dict[str, List[float]] = {"on": [], "off": []}
    for i in range(windows):
        on = (i % 2 == 0) == first_on
        switch(on)
        got["on" if on else "off"].append(window())
    print(json.dumps(got), flush=True)


def _paired_round(module: str, device, timeout_s: float):
    """One round of ``paired_children_cost``: both children's on and off
    windows, and the excess of each child's on window over its adjacent
    off one (%)."""
    from brpc_tpu_torch.tools.spawn_util import package_root
    procs = []
    on: List[float] = []
    off: List[float] = []
    pcts: List[float] = []
    try:
        for side in ("on", "off"):
            argv = [sys.executable, "-m", module, "--cost-child", side]
            if device:
                argv += ["--device", str(device)]
            procs.append(subprocess.Popen(
                argv, cwd=package_root(), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True))
        for p in procs:
            line = p.stdout.readline().strip()
            if line != "ready":
                raise RuntimeError(f"{module} cost child: {line!r}")
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            got = json.loads(out.strip().splitlines()[-1])
            on += got["on"]
            off += got["off"]
            pcts += [(a - b) / b * 100.0
                     for a, b in zip(got["on"], got["off"])]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return on, off, pcts


def paired_children_cost(module: str, device=None,
                         timeout_s: float = 240.0) -> dict:
    """Two ``python3 -m <module> --cost-child on|off [--device D]``
    children, released together once both are warm, each running
    ``cost_child_windows`` in opposite phase. The cost is the median,
    over each child's adjacent on and off windows, of the on window's
    excess over the off one's: the reference's pair-wise estimator,
    its order balanced by the two phases, so that one window a stall
    lands on moves it little. As in the reference, a median over the
    bound earns another round, up to ``COST_ROUNDS``, its pairs added to the
    earlier ones'. ``{"on", "off", "windows", "rounds",
    "overhead_pct"}``: the means of the on and off windows, their
    count, the rounds run and the median."""
    on: List[float] = []
    off: List[float] = []
    pcts: List[float] = []
    for n in range(1, COST_ROUNDS + 1):
        got = _paired_round(module, device, timeout_s)
        on += got[0]
        off += got[1]
        pcts = sorted(pcts + got[2])
        pct = round(max(0.0, pcts[len(pcts) // 2]), 2)
        if pct <= OVERHEAD_PCT_MAX:
            break
    return {"on": sum(on) / len(on), "off": sum(off) / len(off),
            "windows": len(on) + len(off), "rounds": n,
            "overhead_pct": pct}
