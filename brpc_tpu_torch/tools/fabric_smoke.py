"""The fabric storm: the overload-control loop under chaos (the port of
tools/fabric_smoke.py; the gate ``fabric_smoke`` of ``tools.preflight
--gate``)::

    python3 -m brpc_tpu_torch.tools.fabric_smoke --smoke --shards 2 \
        --corpus auto
    python3 -m brpc_tpu_torch.tools.fabric_smoke --overhead

Three backend nodes behind locality-aware ClusterChannels with retry
budgets and budget-aware hedging, driven by pipelined done-callback
clients through a seeded storm:

  baseline  all three nodes healthy (the fault-free goodput);
  fault     one node SIGKILLed mid-burst, another stalled (its handler
            latency raised through the node's SetDelay RPC): retries
            move the kills elsewhere, hedges rescue the stall; the
            survivors' error rate must be 0 and goodput at least 0.7x
            the baseline's;
  outage    every node SIGKILLed: the retry token buckets throttle, so
            attempts a call stay at most 1.2x;
  recover   the nodes respawn on their old ports; health checks revive
            them and the tail serves cleanly.

Every armed hedge carries a ``hedge_armed remaining_ms=R p50_ms=P``
rpcz annotation, and R >= P must hold for all (no hedge past budget).

With ``--corpus`` (``auto``: a seeded mix of sizes and priorities) the
storm grows a press tail: every node stalled while the lanes double,
and the priority admission loop must hold the top class's goodput at
0.9 once converged, order goodput by class, and move at least half of
the doomed low-priority sends client-side.

  --node PORT   one backend node (the storm spawns three); with
                ``--shards N`` a shard group
  --smoke       the storm with its checks, one JSON line, exit 1 on a
                problem
  --bench       the storm and its JSON line
  --overhead    no storm: the admission layer's cost, an admission-on
                and an admission-off node loaded at once
                (``smoke_util.simultaneous_overhead``; the reference
                alternates windows); ``admission_overhead_pct`` <= 5%
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import sys
import threading
import time

NODES = 3


# ------------------------------------------------------------- node
def run_node(port: int, shards: int = 1) -> None:
    from brpc_tpu_torch import fiber
    from brpc_tpu_torch.rpc import Server, ServerOptions, Service

    state = {"delay_s": 0.0}
    # adaptive limiter sized so ONE surviving node can admit the whole
    # storm's shifted load (the client drives 32 pipelined lanes +
    # hedges); the queue-delay gate stays armed via the auto spec
    server = Server(ServerOptions(enable_builtin_services=False,
                                  max_concurrency="auto:64:16:1024"))
    svc = Service("Bench")

    @svc.method()
    async def PyEcho(cntl, request):
        d = state["delay_s"]
        if d > 0:
            # the "stalled node" of the storm: a slow-but-alive
            # backend, the tail-at-scale scenario hedges exist for
            await fiber.sleep(d)
        return bytes(request)

    @svc.method()
    def SetDelay(cntl, request):
        state["delay_s"] = float(bytes(request) or b"0") / 1e3
        return b"ok"

    server.add_service(svc)
    # --shards N: the node is a REAL shard group (reuseport workers
    # behind one port, supervised restarts) — the ROADMAP's ask that
    # the storm run over the deployment shape production uses. The
    # supervisor prints the port; SIGKILLing it orphans the shards,
    # which notice within a dump tick and drain (the storm's kill is
    # then a whole-NODE death, exactly the blast radius it models).
    ep = server.start(f"tcp://127.0.0.1:{port}",
                      num_shards=shards if shards > 1 else None)
    print(f"PORT {ep.port}", flush=True)
    from brpc_tpu_torch.tools.spawn_util import parent_death_watchdog_loop
    parent_death_watchdog_loop()


# ------------------------------------------------------------ storm
class PhaseStats:
    def __init__(self, name: str):
        self.name = name
        self.lock = threading.Lock()
        self.ok = 0
        self.errors = 0
        self.error_codes: dict = {}
        self.samples: list = []
        self.attempts = 0           # 1 + retries + hedge per call
        self.lat_ms: list = []
        self.by_priority: dict = {}   # prio -> [ok, errors]
        self.shed_by_priority: dict = {}   # prio -> [server, client]
        self.t0 = time.perf_counter()
        self.elapsed = 0.0

    def record(self, failed, attempts: int, lat_ms: float,
               priority: int = 0, shed=None) -> None:
        with self.lock:
            row = self.by_priority.get(priority)
            if row is None:
                row = self.by_priority[priority] = [0, 0]
            if failed:
                self.errors += 1
                row[1] += 1
                self.error_codes[failed] = \
                    self.error_codes.get(failed, 0) + 1
                if shed is not None:
                    # EPRIORITYSHED split: at the server's door vs
                    # failed fast locally against the piggybacked
                    # threshold — the press gate's convergence evidence
                    srow = self.shed_by_priority.get(priority)
                    if srow is None:
                        srow = self.shed_by_priority[priority] = [0, 0]
                    srow[1 if shed == "client" else 0] += 1
            else:
                self.ok += 1
                row[0] += 1
                self.lat_ms.append(lat_ms)
            self.attempts += attempts

    def close(self) -> None:
        self.elapsed = time.perf_counter() - self.t0

    def summary(self) -> dict:
        calls = self.ok + self.errors
        lat = sorted(self.lat_ms)
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else None
        return {
            "phase": self.name, "calls": calls, "ok": self.ok,
            "errors": self.errors,
            "qps": round(self.ok / self.elapsed, 1) if self.elapsed else 0.0,
            "amplification": round(self.attempts / calls, 3) if calls
            else None,
            "p99_ms": round(p99, 2) if p99 is not None else None,
            "error_codes": dict(self.error_codes),
            "error_samples": list(self.samples),
            # per-priority goodput: the corpus-fed storm's evidence
            # that no class silently starved (per-class qps needs the
            # phase window, stitched in by the report)
            "per_priority": {str(p): {"ok": row[0], "errors": row[1]}
                             for p, row in sorted(
                                 self.by_priority.items())},
            "priority_sheds": {str(p): {"server": row[0],
                                        "client": row[1]}
                               for p, row in sorted(
                                   self.shed_by_priority.items())},
        }


def _spawn_node(port: int = 0, shards: int = 1, env: dict = None):
    from brpc_tpu_torch.tools.spawn_util import (package_root,
                                                 spawn_port_server)
    argv = ["-m", "brpc_tpu_torch.tools.fabric_smoke", "--node", str(port)]
    if shards > 1:
        argv += ["--shards", str(shards)]
    proc, got = spawn_port_server(
        argv, wall_s=60.0, cwd=package_root(),
        env=dict(os.environ, **env) if env else None)
    if proc is None:
        raise RuntimeError("fabric node spawn failed")
    return proc, got


def _set_delay(port: int, delay_ms: float, fanout: int = 1) -> None:
    """``fanout`` > 1 for shard-group nodes: the kernel balances each
    fresh connection onto SOME reuseport shard, so repeating the
    control RPC over fresh connections reaches every shard with high
    probability (the delay state is per-process)."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    for _ in range(fanout):
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=2000,
                                    share_connections=False,
                                    name="fabric-control"))
        try:
            cntl = ch.call_sync("Bench", "SetDelay",
                                str(delay_ms).encode())
            if cntl.failed():
                raise RuntimeError(f"SetDelay failed: {cntl.error_text}")
        finally:
            ch.close()


def load_storm_corpus(arg: str):
    """--corpus records for the storm. 'auto' synthesizes a seeded
    mixed-size mixed-priority corpus; anything else reads a .brpccap
    file/dir (a /capture download). The storm nodes serve the echo
    fabric, so records are RE-TARGETED onto Bench.PyEcho — what the
    corpus contributes is the realistic payload-size/priority/
    deadline MIX, which is exactly what synthetic uniform echo never
    had."""
    from brpc_tpu_torch.traffic.replay import parse_mix, synthesize_records
    if arg == "auto":
        return synthesize_records(
            2048, parse_mix("16:0.5,512:0.3,4096:0.2"),
            parse_mix("1:0.6,5:0.3,9:0.1"), qps=1000.0, mode="poisson",
            seed=23, service="Bench", method="PyEcho")
    from brpc_tpu_torch.traffic.corpus import read_corpus
    recs = read_corpus(arg)
    if not recs:
        raise RuntimeError(f"empty corpus {arg!r}")
    return recs


def run_storm(seed: int = 7, conns: int = 4, inflight: int = 8,
              windows=(1.5, 2.0, 0.8, 1.0), verbose: bool = True,
              shards: int = 1, corpus_records=None,
              press_s: float = 2.2) -> dict:
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.rpc import ChannelOptions, ClusterChannel
    from brpc_tpu_torch.rpc.span import global_collector

    set_flag("rpcz_enabled", True)      # hedge-arming evidence trail

    procs = {}
    ports = []
    for _ in range(NODES):
        proc, port = _spawn_node(shards=shards)
        procs[port] = proc
        ports.append(port)
    naming = "list://" + ",".join(f"tcp://127.0.0.1:{p}" for p in ports)
    chs = [ClusterChannel(naming, "la",
                          ChannelOptions(timeout_ms=1500, max_retry=3,
                                         backup_request_ms=50,
                                         retry_budget=True,
                                         share_connections=False,
                                         name=f"fabric-{i}"))
           for i in range(conns)]
    # the storm script is a pure function of the seed: victim choice
    # only (the phase schedule is fixed wall-clock windows)
    kill_node = ports[seed % NODES]
    stall_node = ports[(seed + 1) % NODES]

    stats = {n: PhaseStats(n) for n in
             ("warm", "baseline", "fault", "outage", "recover",
              "press1", "press2", "drain")}
    current = ["warm"]
    stop = [False]
    live = [conns * inflight]
    done_ev = threading.Event()

    corpus_idx = itertools.count()

    def issue(i: int) -> None:
        ch = chs[i]
        t0 = time.perf_counter()
        payload = b"q"
        prio = 0
        cntl = None
        if corpus_records is not None:
            rec = corpus_records[next(corpus_idx)
                                 % len(corpus_records)]
            payload = rec.payload
            prio = rec.priority
            if prio:
                from brpc_tpu_torch.rpc.controller import Controller
                cntl = Controller()
                cntl.request_priority = prio

        def _done(cntl) -> None:
            # attribute to the phase the call COMPLETED in: a call
            # issued moments before a phase boundary fails/succeeds
            # under the NEXT phase's conditions (an in-flight call at
            # the outage kill is an outage casualty, not a "survivor
            # error" of the fault window)
            ph = stats[current[0]]
            # WIRE attempts: a client-local doomed-send shed
            # (_adm_local_sheds) consumed a retry slot in microseconds
            # without touching the cluster — amplification gauges load
            # on the brown-out, so local sheds subtract
            attempts = max(1, 1 + cntl.current_try
                           + (1 if cntl.used_backup else 0)
                           - cntl.__dict__.get("_adm_local_sheds", 0))
            if cntl.failed() and len(ph.samples) < 8:
                ph.samples.append(
                    f"{cntl.error_code}:{cntl.error_text[:90]}:"
                    f"tries={cntl.current_try}:bk={cntl.used_backup}")
            shed = None
            if cntl.error_code == 2008:     # berr.EPRIORITYSHED
                # the client-local fail-fast stamps "client-side" in
                # its error text (Channel._issue_rpc); a server-door
                # shed carries the dispatch lanes' message instead
                shed = "client" if "client-side" in cntl.error_text \
                    else "server"
            ph.record(cntl.error_code if cntl.failed() else False,
                      attempts, (time.perf_counter() - t0) * 1e3,
                      priority=prio, shed=shed)
            if not stop[0]:
                issue(i)
            else:
                with stats["drain"].lock:
                    live[0] -= 1
                    if live[0] <= 0:
                        done_ev.set()

        try:
            ch.call("Bench", "PyEcho", payload, cntl=cntl, done=_done)
        except Exception:
            stats[current[0]].record("issue", 1, 0.0, priority=prio)
            with stats["drain"].lock:
                live[0] -= 1
                if live[0] <= 0:
                    done_ev.set()

    def enter(phase: str) -> None:
        stats[current[0]].close()
        current[0] = phase
        stats[phase].t0 = time.perf_counter()
        if verbose:
            print(f"# phase {phase}", file=sys.stderr, flush=True)

    # warm every channel (first-call setup cost must not pollute the
    # baseline window) and seed the backend p50 cells for hedging
    for ch in chs:
        for _ in range(6):
            ch.call_sync("Bench", "PyEcho", b"w")
    for i in range(conns):
        for _ in range(inflight):
            issue(i)

    enter("baseline")
    time.sleep(windows[0])

    # ---- fault: kill one node mid-burst, stall another (the phase
    # flips FIRST: the kill's in-flight casualties belong to the fault
    # window, not to a baseline that was already over)
    enter("fault")
    _set_delay(stall_node, 150.0, fanout=shards * 4 if shards > 1 else 1)
    procs[kill_node].send_signal(signal.SIGKILL)
    time.sleep(windows[1])
    # hedge evidence BEFORE later phases can age it out of the ring
    hedge_pairs = []
    for sp in global_collector.recent(5000):
        for _us, text in getattr(sp, "annotations", ()):
            if text.startswith("hedge_armed"):
                fields = dict(kv.split("=") for kv in text.split()[1:])
                try:
                    hedge_pairs.append((float(fields["remaining_ms"]),
                                        float(fields["p50_ms"])))
                except (KeyError, ValueError):
                    pass    # inf/na: unknown budget or p50 — ungated arm

    # ---- outage: every node down; the retry budget must throttle
    enter("outage")
    for port, proc in procs.items():
        if port != kill_node:
            proc.send_signal(signal.SIGKILL)
    time.sleep(windows[2])

    # ---- recover: respawn all three on their OLD ports
    for port in ports:
        procs[port].wait(5)
        # same topology as the original nodes: a --shards storm must
        # recover onto shard-group nodes, not single-process stand-ins
        proc, got = _spawn_node(port, shards=shards)
        if got != port:
            raise RuntimeError(f"respawn moved port {port} -> {got}")
        procs[port] = proc
    enter("recover")
    probe_deadline = time.monotonic() + 8.0
    revived = False
    while time.monotonic() < probe_deadline:
        c = chs[0].call_sync("Bench", "PyEcho", b"p")
        if not c.failed():
            revived = True
            break
        time.sleep(0.1)
    # measured tail: post-revival traffic must serve cleanly
    stats["recover"].close()
    stats["recover"] = PhaseStats("recover")
    current[0] = "recover"
    time.sleep(windows[3])

    # ---- press (corpus storms only): the healthy cluster
    # stalled node-wide while the lane count doubles — offered load
    # >= 2x what the latency-inflated limiters will admit, so every
    # node's overload organs fire and the DAGOR admission loop takes
    # over: thresholds rise, low-priority work sheds at the door, the
    # piggybacked threshold moves the shedding to the CLIENT, and the
    # highest class keeps serving. Two equal halves so convergence is
    # observable: press1 is the ramp, press2 the converged regime.
    if corpus_records is not None:
        fan = shards * 4 if shards > 1 else 1
        for port in ports:
            _set_delay(port, 80.0, fanout=fan)
        # lane budget scales with the cluster's shard fan-out: every
        # reuseport shard runs its OWN limiter (floor 16), so offered
        # per-shard inflight must beat the shrunken per-shard limit by
        # ~2x for the overload organs to fire at all
        extra = max(conns * inflight, NODES * shards * 48
                    - conns * inflight)
        with stats["drain"].lock:
            live[0] += extra
        enter("press1")
        for j in range(extra):
            issue(j % conns)
        time.sleep(press_s)
        enter("press2")
        time.sleep(press_s)
        for port in ports:
            # un-stall so the drain tail completes promptly; a node
            # wedged by the storm must not hang the teardown
            try:
                _set_delay(port, 0.0, fanout=fan)
            except Exception:
                pass
    enter("drain")
    stop[0] = True
    done_ev.wait(10)
    stats["drain"].close()

    phase_names = ["baseline", "fault", "outage", "recover"]
    if corpus_records is not None:
        phase_names += ["press1", "press2"]
    out = {n: stats[n].summary() for n in phase_names}
    base_qps = out["baseline"]["qps"] or 1.0
    report = {
        "seed": seed,
        "ports": ports,
        "shards": shards,
        "corpus_records": len(corpus_records)
        if corpus_records is not None else 0,
        "killed": kill_node,
        "stalled": stall_node,
        "revived": revived,
        "phases": out,
        "fault_goodput_ratio": round(out["fault"]["qps"] / base_qps, 3),
        "fault_p99_ms": out["fault"]["p99_ms"],
        "outage_amplification": out["outage"]["amplification"],
        "hedges_armed": len(hedge_pairs),
        "hedges_past_budget": sum(1 for r, p in hedge_pairs if r < p),
    }
    # per-priority goodput ratios, fault vs baseline (the corpus-fed
    # storm's per-class evidence; uniform-priority storms show {"0"})
    base_el = stats["baseline"].elapsed or 1.0
    fault_el = stats["fault"].elapsed or 1.0
    ratios = {}
    for p, row in out["baseline"]["per_priority"].items():
        bq = row["ok"] / base_el
        fq = out["fault"]["per_priority"].get(
            p, {"ok": 0})["ok"] / fault_el
        if bq > 0:
            ratios[p] = round(fq / bq, 3)
    report["per_priority_goodput_ratio"] = ratios
    if corpus_records is not None:
        report.update(_press_report(out))
    for ch in chs:
        ch.close()
    for proc in procs.values():
        try:
            proc.kill()
            proc.wait(5)
        except Exception:
            pass
    return report


def _press_report(out: dict) -> dict:
    """The press tail's priority-admission evidence:
    per-class goodput rate in the converged half, the headline
    highest-class ratio, and the low-class client-side shed fraction
    per half (the 'increasingly client-side' trajectory)."""

    def _rates(ph: dict) -> dict:
        rates = {}
        for p, row in ph["per_priority"].items():
            n = row["ok"] + row["errors"]
            if n:
                rates[int(p)] = round(row["ok"] / n, 3)
        return rates

    def _client_frac(ph: dict, prio: int):
        row = ph["priority_sheds"].get(str(prio))
        if not row:
            return None
        n = row["server"] + row["client"]
        return round(row["client"] / n, 3) if n else None

    p1, p2 = out["press1"], out["press2"]
    rates2 = _rates(p2)
    prios = sorted(rates2)
    shed_total = sum(r["server"] + r["client"]
                     for ph in (p1, p2)
                     for r in ph["priority_sheds"].values())
    rep = {
        "press_goodput_rates": {str(p): rates2[p] for p in prios},
        "press_priority_sheds": shed_total,
    }
    if prios:
        hi, lo = prios[-1], prios[0]
        rep["priority_goodput_hi_ratio"] = rates2[hi]
        rep["press_client_shed_frac"] = [_client_frac(p1, lo),
                                         _client_frac(p2, lo)]
    return rep


def assert_press(rep: dict) -> list:
    """The press tail's acceptance bars: admission engaged,
    the top class held >= 0.9 goodput once converged, per-priority
    goodput ordered by class, and the doomed low-priority flow moved
    client-side (>= 50% of its sheds in the converged half, and not
    receding from the ramp half)."""
    problems = []
    if not rep.get("press_priority_sheds"):
        problems.append("press never engaged priority admission "
                        "(zero EPRIORITYSHED)")
        return problems
    hi_ratio = rep.get("priority_goodput_hi_ratio")
    if hi_ratio is None or hi_ratio < 0.9:
        problems.append(
            f"converged high-priority goodput {hi_ratio} < 0.9")
    rates = {int(p): r for p, r in
             rep.get("press_goodput_rates", {}).items()}
    prios = sorted(rates)
    for a, b in zip(prios, prios[1:]):
        # small epsilon: two classes both near-fully served may jitter
        if rates[b] < rates[a] - 0.05:
            problems.append(
                f"press goodput not ordered by class: "
                f"prio {b} {rates[b]} < prio {a} {rates[a]}")
    fracs = rep.get("press_client_shed_frac") or [None, None]
    f1, f2 = fracs[0], fracs[1]
    if f2 is None:
        problems.append("converged press half shed nothing low-priority")
    else:
        if f2 < 0.5:
            problems.append(
                f"only {f2:.0%} of converged low-priority sheds were "
                "client-side (piggyback threshold not propagating)")
        if f1 is not None and f2 < f1 and f2 < 0.75:
            problems.append(
                f"client-side shed fraction receded: {f1} -> {f2}")
    return problems


def assert_storm(rep: dict) -> list:
    """The gate's acceptance bars."""
    problems = []
    ph = rep["phases"]
    if ph["baseline"]["errors"]:
        problems.append(f"baseline errors: {ph['baseline']['errors']}")
    if not ph["baseline"]["calls"]:
        problems.append("baseline served nothing")
    # survivor errors: in a corpus-fed priority storm the degraded
    # window MAY shed below-top-class work with EPRIORITYSHED — the
    # saturated survivor protecting its top class is the designed
    # DAGOR outcome, not a casualty. Everything else (and ANY shed of
    # the top class, which the threshold clamp must never allow) still
    # counts; uniform storms have no priority sheds, so the original
    # zero-error bar is unchanged for them.
    fault = ph["fault"]
    classes = [int(p) for p in fault["per_priority"]]
    top = max(classes) if classes else 0
    low_sheds = sum(r["server"] + r["client"]
                    for p, r in fault["priority_sheds"].items()
                    if int(p) < top)
    if fault["errors"] - low_sheds:
        problems.append(
            f"survivor error rate not 0: "
            f"{fault['errors'] - low_sheds} non-shed errors "
            f"({fault['errors']} total) with 2 of 3 nodes degraded")
    if rep["fault_goodput_ratio"] < 0.7:
        problems.append(
            f"fault goodput {rep['fault_goodput_ratio']} < 0.7x baseline")
    amp = rep["outage_amplification"]
    if amp is not None and amp > 1.2:
        problems.append(f"outage retry amplification {amp} > 1.2x")
    if rep["hedges_past_budget"]:
        problems.append(
            f"{rep['hedges_past_budget']} hedge(s) armed past budget")
    if not rep["hedges_armed"]:
        problems.append("no hedge was ever armed during the stall")
    if not rep["revived"]:
        problems.append("cluster never revived after respawn")
    # recover tail: post-revival traffic must serve cleanly — but an
    # EPRIORITYSHED here is the admission layer doing its job, not a
    # failed recovery: the freshly respawned node warms up with small
    # limits, briefly arms admission under the resuming full-blast
    # lanes, and low-priority work sheds (increasingly client-side)
    # until the limiter grows back. The per-priority press criteria
    # gate shed BEHAVIOR; this check gates hard failures only.
    rec_hard = ph["recover"]["errors"] \
        - ph["recover"]["error_codes"].get(2008, 0)
    if rec_hard:
        problems.append(f"recover-tail errors: {rec_hard}")
    if "press2" in ph:
        problems.extend(assert_press(rep))
    return problems


# --------------------------------------------------- admission cost
def run_overhead() -> dict:
    """``admission_overhead_pct``: qps through an admission-on node
    against an admission-off node (``BRPC_TPU_ADMISSION``), with no
    priorities and no request costs configured: what a server pays for
    the layer it does not use. The two nodes are loaded at once
    (``smoke_util.simultaneous_overhead``; the reference alternates
    windows)."""
    from brpc_tpu_torch.tools.smoke_util import (OVERHEAD_PCT_MAX,
                                                 simultaneous_overhead,
                                                 stop_all)
    nodes = []
    try:
        ports = {}
        for tag, flagval in (("on", "1"), ("off", "0")):
            proc, port = _spawn_node(env={"BRPC_TPU_ADMISSION": flagval})
            nodes.append(proc)
            ports[tag] = port
        got = simultaneous_overhead(ports["on"], ports["off"])
    finally:
        stop_all(nodes)
    out = {"admission_overhead_pct": got["overhead_pct"],
           "overhead_qps": got}
    out["ok"] = got["overhead_pct"] <= OVERHEAD_PCT_MAX
    return out


def main() -> int:
    args = sys.argv[1:]
    shards = int(args[args.index("--shards") + 1]) \
        if "--shards" in args else 1
    if args and args[0] == "--node":
        run_node(int(args[1]) if len(args) > 1 else 0, shards=shards)
        return 0
    seed = int(os.environ.get("BRPC_TPU_TORCH_FABRIC_SEED", "7"))
    if "--seed" in args:
        seed = int(args[args.index("--seed") + 1])
    if "--overhead" in args:
        rep = run_overhead()
        print(json.dumps(rep), flush=True)
        return 0 if rep["ok"] else 1
    corpus_records = None
    if "--corpus" in args:
        corpus_records = load_storm_corpus(
            args[args.index("--corpus") + 1])
    kw = dict(seed=seed, shards=shards, corpus_records=corpus_records)
    if "--smoke" in args:
        rep = run_storm(verbose=False, **kw)
        problems = assert_storm(rep)
        rep["problems"] = problems
        print(json.dumps(rep), flush=True)
        return 1 if problems else 0
    if "--bench" in args:
        rep = run_storm(verbose=False, **kw)
        rep["problems"] = assert_storm(rep)
        print(json.dumps(rep), flush=True)
        return 0
    rep = run_storm(**kw)
    print(json.dumps(rep, indent=2), flush=True)
    problems = assert_storm(rep)
    for p in problems:
        print(f"PROBLEM: {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)    # skip the runtime threads' teardown
