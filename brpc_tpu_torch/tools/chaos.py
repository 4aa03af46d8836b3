"""The chaos CLI: a loopback cluster through seeded fault storms, and
the robustness invariants checked after each (the port of
tools/chaos.py, over the port's ``brpc_tpu_torch.chaos``).

1. ``deadline_storm``: a burst of tiny-budget calls against a slow
   handler: at least 99% of the requests whose budget expired before
   their handler are shed by the server (``server_deadline_shed``), and
   none of them reaches the handler.
2. ``mixed_storm``: delay, drop, corrupt, partial, refuse and flap from
   a fixed seed against a 3-peer ``ClusterChannel``: every call reaches a
   verdict (no hang), the flapped peer is isolated (breaker or health
   check) and revived once the flap ends, and the storm leaks no socket,
   fiber or stream (``leak_snapshot``, ``settle_to``).

The fault schedule is a function of the seed alone (a ``FaultPlan``
addresses faults by connection index and byte offset, not by the
clock); ``--seed N`` replays it. Which calls fail can vary with thread
interleaving; the invariants hold regardless.

    python3 -m brpc_tpu_torch.tools.chaos --smoke         # mem://, ~10 s
    python3 -m brpc_tpu_torch.tools.chaos --seed 7        # the full storm
    python3 -m brpc_tpu_torch.tools.chaos --scheme tcp    # over sockets

It prints one JSON document, with ``"ok": true`` and each storm's report,
or ``"ok": false`` and the invariant that failed, and then exits 1.
"""

from __future__ import annotations

import argparse
import json
import random
import time
from typing import List, Optional

from brpc_tpu_torch import chaos
from brpc_tpu_torch.chaos import Fault, FaultPlan
from brpc_tpu_torch.fiber import global_control
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller, Server,
                                ServerOptions, Service)
from brpc_tpu_torch.rpc.cluster_channel import ClusterChannel
from brpc_tpu_torch.rpc.retry_policy import RetryBackoffPolicy
from brpc_tpu_torch.rpc.server_dispatch import nshed

_seq = iter(range(100000))


def _addr(scheme: str, name: str) -> str:
    if scheme == "mem":
        return f"mem://{name}-{next(_seq)}"
    return "tcp://127.0.0.1:0"


def _stop(server) -> None:
    server.stop()
    server.join(2)


# ----------------------------------------------------------- leak probe
def leak_snapshot() -> dict:
    """Live sockets, fibers and streams of this process."""
    from brpc_tpu_torch.rpc import stream as _stream
    from brpc_tpu_torch.transport import socket as _socket
    return {
        "sockets": _socket._pool.live(),
        "fibers": global_control().nfibers.get_value(),
        "streams": len(_stream._registry._streams),
    }


def settle_to(baseline: dict, timeout_s: float = 10.0) -> dict:
    """Poll until the counts are back at ``baseline`` or below (closing
    is asynchronous), for up to ``timeout_s``; the last snapshot."""
    deadline = time.monotonic() + timeout_s
    snap = leak_snapshot()
    while time.monotonic() < deadline:
        snap = leak_snapshot()
        if all(snap[k] <= baseline[k] for k in baseline):
            break
        time.sleep(0.05)
    return snap


# -------------------------------------------------------- deadline storm
def deadline_storm(scheme: str = "mem", n: int = 300,
                   timeout_ms: float = 40.0,
                   handler_ms: float = 10.0) -> dict:
    """A slow sync handler clogs the workers; the requests queued past
    their budget must be shed before their handler."""
    server = Server(ServerOptions(enable_builtin_services=False))
    svc = Service("Storm")
    entered: List[bool] = []

    @svc.method()
    def Slow(cntl, request):
        entered.append(cntl.deadline_expired())
        time.sleep(handler_ms / 1e3)
        return b"ok"

    server.add_service(svc)
    addr = str(server.start(_addr(scheme, "deadline")))
    try:
        ch = Channel(addr, ChannelOptions(timeout_ms=3000,
                                          share_connections=False))
        c = ch.call_sync("Storm", "Slow", b"warm")
        assert not c.failed(), f"warm call failed: {c.error_text}"
        base_shed = nshed.get_value()
        cntls = []
        for _ in range(n):
            cn = Controller()
            cn.timeout_ms = timeout_ms
            cn.max_retry = 0
            cntls.append(ch.call("Storm", "Slow", b"x", cntl=cn))
        for cn in cntls:
            assert cn.join(30.0), "call never reached a verdict (hang)"
        # the server goes on judging after the clients gave up: wait
        # until every request is shed or served
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if nshed.get_value() - base_shed + len(entered) >= n + 1:
                break
            time.sleep(0.05)
        shed = nshed.get_value() - base_shed
        served = entered[1:]            # the warm call aside
        served_ok = sum(1 for expired in served if not expired)
        served_expired = sum(1 for expired in served if expired)
        ch.close()
    finally:
        _stop(server)
    expired_total = shed + served_expired
    ratio = shed / expired_total if expired_total else 1.0
    report = {
        "requests": n,
        "shed": shed,
        "served_within_budget": served_ok,
        "served_expired": served_expired,
        "expired_shed_ratio": round(ratio, 4),
    }
    assert expired_total > 0, \
        f"storm produced no expired requests (tune n/handler_ms): {report}"
    assert ratio >= 0.99, f"expired-shed ratio below 99%: {report}"
    return report


# ----------------------------------------------------------- mixed storm
def mixed_storm(seed: int = 7, scheme: str = "mem",
                n_calls: int = 120) -> dict:
    """The seeded storm against a 3-peer cluster, and its three
    invariants (the module's doc)."""
    baseline = leak_snapshot()
    rng = random.Random(seed)
    servers = []
    addrs = []
    for name in ("a", "b", "c"):
        s = Server(ServerOptions(enable_builtin_services=False))
        svc = Service("S")

        @svc.method()
        def Echo(cntl, request):
            return bytes(request)

        s.add_service(svc)
        servers.append(s)
        addrs.append(str(s.start(_addr(scheme, f"storm{name}"))))

    flapped = addrs[0]
    # byte-stream noise on the healthy peers, and a scripted flap on
    # peer A: its first connection dies mid-stream, its next connects
    # are refused (health probes too), then the link is back
    plan = (FaultPlan.random(seed, addrs[1:], conns=12,
                             kinds=("delay", "corrupt", "drop"))
            .at(flapped, 0, Fault("drop", at_byte=400))
            .flap(flapped, at_conn=1, refuse_next=4)
            .at(flapped, 6, Fault("partial_stall", at_byte=16)))
    chaos.install(plan)
    verdicts = {"ok": 0, "failed": 0}
    saw_excluded = False
    try:
        cluster = ClusterChannel(
            "list://" + ",".join(addrs), "rr",
            ChannelOptions(
                timeout_ms=400, max_retry=3,
                retry_policy=RetryBackoffPolicy(
                    base_ms=2.0, max_ms=20.0,
                    rng=random.Random(seed + 1))))
        try:
            flapped_ep = next((ep for ep in cluster.servers()
                               if str(ep) == flapped), None)
            assert flapped_ep is not None, (flapped, cluster.servers())
            inflight = []
            for i in range(n_calls):
                inflight.append(cluster.call("S", "Echo", b"m%d" % i))
                if len(inflight) >= rng.randrange(2, 8):
                    for c in inflight:
                        assert c.join(30.0), "call hung"
                        verdicts["ok" if not c.failed() else "failed"] += 1
                    inflight = []
                if not saw_excluded:
                    breaker = cluster._breakers.breaker(flapped_ep)
                    if breaker.isolated() or \
                            flapped_ep in cluster._health.dead_set():
                        saw_excluded = True
            for c in inflight:
                assert c.join(30.0), "call hung"
                verdicts["ok" if not c.failed() else "failed"] += 1
            assert saw_excluded, \
                "flapped peer was never isolated (breaker) nor health-dead"
            # once the flap's refusals are spent, probes connect again
            # and the peer must come back into service
            revive_deadline = time.monotonic() + 20.0
            revived = False
            while time.monotonic() < revive_deadline:
                if flapped_ep not in cluster._health.dead_set() and \
                        not cluster._breakers.breaker(flapped_ep).isolated():
                    probe = Channel(flapped, ChannelOptions(
                        timeout_ms=400, max_retry=0,
                        share_connections=False))
                    pc = probe.call_sync("S", "Echo", b"revived?")
                    probe.close()
                    if not pc.failed():
                        revived = True
                        break
                time.sleep(0.1)
            assert revived, "flapped peer never revived after the storm"
        finally:
            cluster.close()
    finally:
        chaos.uninstall()
        for s in servers:
            _stop(s)
    snap = settle_to(baseline)
    leaks = {k: snap[k] - baseline[k] for k in baseline
             if snap[k] > baseline[k]}
    assert not leaks, f"storm leaked live objects: {leaks} " \
                      f"(baseline {baseline}, after {snap})"
    report = {
        "seed": seed,
        "scheme": scheme,
        "calls": n_calls,
        "verdicts": verdicts,
        "flapped_peer": flapped,
        "isolated_then_revived": True,
        "injected": {k: v.get_value()
                     for k, v in chaos.chaos_counters.items()},
        "fired_schedule_len": len(plan.fired()),
        "leaks": leaks,
    }
    assert verdicts["ok"] > 0, f"no call ever succeeded: {report}"
    return report


def smoke(seed: int = 7) -> dict:
    """One seeded storm of each kind over mem://, about 10 s."""
    t0 = time.monotonic()
    out = {
        "deadline": deadline_storm("mem", n=150),
        "mixed": mixed_storm(seed, "mem", n_calls=60),
    }
    out["elapsed_s"] = round(time.monotonic() - t0, 2)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="one seeded mem:// storm of each kind (~10 s)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--scheme", default="mem", choices=("mem", "tcp"))
    p.add_argument("--calls", type=int, default=120)
    args = p.parse_args(argv)
    try:
        if args.smoke:
            report = {"smoke": smoke(args.seed)}
        else:
            report = {
                "deadline": deadline_storm(args.scheme),
                "mixed": mixed_storm(args.seed, args.scheme, args.calls),
            }
    except AssertionError as e:
        print(json.dumps({"ok": False, "invariant": str(e)}, indent=2))
        return 1
    report["ok"] = True
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
