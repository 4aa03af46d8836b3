"""cluster_top: one merged per-backend table over N nodes (the port of
tools/cluster_top.py). It scrapes each admin endpoint's ``/backends`` and
``/status``; ``/device``, ``/serving`` and ``/timeline`` decorate the node
lines (device GB/s; serving tok/s, TTFT p99, KV occupancy and queue
depth; qps, p99 and error sparklines).

Each node's ``/backends`` is its own channels' view of the cluster (per
backend: qps, percentiles, errors, in flight, breaker). Across nodes the
counters and the in-flight counts sum, and the percentiles come from the
pooled latency samples every row carries, never from averaged
percentiles, as the shard aggregator merges its shards.

    python3 -m brpc_tpu_torch.tools.cluster_top host:port [host:port ...]
    python3 -m brpc_tpu_torch.tools.cluster_top host:port --once --json
    python3 -m brpc_tpu_torch.tools.cluster_top --smoke

``--smoke`` starts two echo backends (``tools.bench_echo_server``), bursts
a ClusterChannel at them from this process and checks that the
``/backends`` scraped over HTTP equals the channel's own cells (every
attempt on a backend row, none left in flight), that the merge across
nodes gives the channel's totals, and, unless
``BRPC_TPU_TORCH_PERF_SMOKE=0``, that the stat cells cost at most 5% of
qps (``BRPC_TPU_BACKEND_STATS`` on against off, averaged over rounds in
which the on and the off load run at once, each at a pair of backends of
its own, so that the box's drift falls on both). One JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.tools.spawn_util import package_root

OVERHEAD_PCT_MAX = 5.0
# the cells' cost: rounds of two loads run at once, each window long
# enough that the skew of the workers' starts (tens of milliseconds) is
# small beside it
OVERHEAD_ROUNDS = 10
OVERHEAD_WINDOW_S = 3.0

# counters that sum across nodes; the percentiles are computed again
# from the pooled samples, which every row carries
_SUM_KEYS = ("attempts", "completed", "abandoned", "connect_errors",
             "inflight", "errors", "count", "qps", "bytes_in",
             "bytes_out")


def fetch_json(hostport: str, path: str,
               timeout_s: float = 5.0) -> Optional[dict]:
    """GET host:port/path as JSON; None on any failure (a dead node
    shows in ``nodes_down`` and does not take the top down)."""
    import http.client
    host, _, port = hostport.partition(":")
    try:
        conn = http.client.HTTPConnection(host, int(port or 80),
                                          timeout=timeout_s)
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        if resp.status != 200:
            return None
        return json.loads(body)
    except Exception:
        return None


def merge_backends(pages: List[dict]) -> Dict[str, dict]:
    """N nodes' /backends merged into {backend: row}: the counters sum,
    the percentiles come from the pooled samples, and a backend isolated
    by any node's breaker shows isolated."""
    from brpc_tpu_torch.rpc.shard_group import _percentile
    merged: Dict[str, dict] = {}
    pooled: Dict[str, List[float]] = {}
    for page in pages:
        for ch in (page or {}).get("channels", {}).values():
            for backend, row in ch.get("backends", {}).items():
                m = merged.setdefault(backend, {"nodes": 0})
                m["nodes"] += 1
                for k in _SUM_KEYS:
                    v = row.get(k)
                    if isinstance(v, (int, float)):
                        m[k] = round(m.get(k, 0) + v, 3)
                pooled.setdefault(backend, []).extend(
                    row.get("latency_samples") or ())
                state = row.get("state") or {}
                br = state.get("breaker") or {}
                if br.get("isolated"):
                    m["isolated"] = True
                if state.get("health_dead"):
                    m["health_dead"] = True
    for backend, samples in pooled.items():
        samples.sort()
        if samples:
            m = merged[backend]
            m["latency_p50_us"] = round(_percentile(samples, 0.5), 1)
            m["latency_p99_us"] = round(_percentile(samples, 0.99), 1)
    for m in merged.values():
        observed = (m.get("completed", 0) or 0) \
            + (m.get("connect_errors", 0) or 0)
        m["error_ratio"] = round((m.get("errors", 0) or 0) / observed, 4) \
            if observed else 0.0
    return merged


def _device_summary(page: Optional[dict]) -> Optional[dict]:
    """One node's /device as the top's row: the lane, the transfer
    counters and the cells' decayed GB/s."""
    if not page:
        return None
    totals = page.get("totals") or {}
    bps = 0.0
    for row in (page.get("cells") or {}).values():
        v = row.get("bytes_per_second")
        if isinstance(v, (int, float)):
            bps += v
    return {
        "lane": page.get("transfer_lane"),
        "transfers": totals.get("transfers", 0),
        "recv_transfers": totals.get("recv_transfers", 0),
        "failed": totals.get("failed", 0),
        "staged_fallbacks": totals.get("staged_fallbacks", 0),
        "GBps": round(bps / 1e9, 4),
        "leaked_bytes": (page.get("leaks") or {}).get("leaked_bytes", 0),
    }


def _serving_summary(page: Optional[dict]) -> Optional[dict]:
    """One node's /serving as the top's row: tok/s over the last 10 s,
    the pooled TTFT p99, KV occupancy and queue depth. A shard group's
    supervisor answers with its shards merged, so one scrape covers the
    group."""
    if not page or not page.get("enabled"):
        return None
    stats = page.get("stats") or {}
    ttft = stats.get("ttft") or {}
    return {
        "tokens_per_s": round(
            float(stats.get("tokens_per_second_10s", 0) or 0), 2),
        "ttft_p99_ms": round((ttft.get("p99_us", 0) or 0) / 1000.0, 2),
        "kv_occupancy": page.get("kv_occupancy", 0),
        "waiting": page.get("waiting", 0),
        "running": len(page.get("running") or ()),
        "tokens_out": page.get("tokens_out", 0),
        "completed": page.get("completed", 0),
        "shed": page.get("shed", 0),
        "evicted": page.get("evicted", 0),
    }


def _timeline_trends(page: Optional[dict]) -> Optional[dict]:
    """One node's /timeline as the top's three trends: qps (processed a
    second), p99 and errors, the last minute's buckets of a second."""
    if not page or not page.get("series"):
        return None
    out = {}
    ser = page["series"]
    for var, track in (("server_processed", "qps"),
                       ("server_errors", "errors"),
                       ("server_latency_p99_us", "p99_us")):
        buckets = (ser.get(var) or {}).get("sec") or []
        vals = [v for _, v in buckets
                if isinstance(v, (int, float))]
        if vals:
            out[track] = vals
    if not out:
        return None
    incidents = [i for i in (page.get("incidents") or ())
                 if i.get("state") == "open"]
    if incidents:
        out["open_incidents"] = len(incidents)
    return out


def scrape(nodes: List[str]) -> dict:
    pages = []
    statuses = {}
    devices = {}
    servings = {}
    timelines = {}
    down = []
    for node in nodes:
        page = fetch_json(node, "/backends")
        if page is None:
            down.append(node)
            continue
        pages.append(page)
        st = fetch_json(node, "/status")
        if st is not None:
            statuses[node] = {"processed": st.get("processed"),
                              "errors": st.get("errors"),
                              "concurrency": st.get("concurrency")}
        dev = _device_summary(fetch_json(node, "/device"))
        # either direction counts: a node that only receives device
        # payloads is active too
        if dev is not None and (dev["transfers"] or
                                dev["recv_transfers"]):
            devices[node] = dev
        srv = _serving_summary(fetch_json(node, "/serving"))
        # any serving activity shows the node: finished, queued or
        # refused work (a node that only queues or sheds is the one an
        # operator needs to see)
        if srv is not None and (srv["tokens_out"] or srv["waiting"]
                                or srv["running"] or srv["completed"]
                                or srv["shed"] or srv["evicted"]):
            servings[node] = srv
        # the trends: the node's own qps, p99 and error rings (absent
        # when it runs no series). A prefix, not ?names=: a node that
        # lacks one var answers the prefix with what it has, not a 400.
        tl = _timeline_trends(fetch_json(node,
                                         "/timeline?prefix=server_"))
        if tl is not None:
            timelines[node] = tl
    return {"backends": merge_backends(pages), "nodes": statuses,
            "device": devices, "serving": servings,
            "timeline": timelines,
            "nodes_down": down, "nodes_up": len(pages)}


def render(view: dict) -> str:
    cols = ("backend", "nodes", "qps", "p50_us", "p99_us", "err%",
            "inflight", "state")
    rows = []
    for backend in sorted(view["backends"]):
        m = view["backends"][backend]
        state = "ISOLATED" if m.get("isolated") else (
            "DEAD" if m.get("health_dead") else "ok")
        rows.append((backend, str(m.get("nodes", 0)),
                     f"{m.get('qps', 0):.0f}",
                     f"{m.get('latency_p50_us', 0):.0f}",
                     f"{m.get('latency_p99_us', 0):.0f}",
                     f"{100 * m.get('error_ratio', 0):.2f}",
                     str(m.get("inflight", 0)), state))
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    out = ["  ".join(c.ljust(widths[i]) for i, c in enumerate(cols))]
    out += ["  ".join(cell.ljust(widths[i]) for i, cell in enumerate(r))
            for r in rows]
    srv = view.get("nodes", {})
    dev = view.get("device", {})
    trends = view.get("timeline", {})
    out.append("")
    for node, st in sorted(srv.items()):
        line = (f"node {node}: processed={st.get('processed')} "
                f"errors={st.get('errors')} "
                f"concurrency={st.get('concurrency')}")
        tl = trends.get(node)
        if tl is not None:
            # the last minute's qps, p99 and error sparklines from the
            # node's /timeline, open incidents flagged
            from brpc_tpu_torch.bvar.series import sparkline
            for track, tag in (("qps", "qps"), ("p99_us", "p99"),
                               ("errors", "err")):
                vals = tl.get(track)
                if vals:
                    line += f"  {tag} {sparkline(vals, 20)}"
            if tl.get("open_incidents"):
                line += f"  INCIDENTS={tl['open_incidents']}"
        d = dev.get(node)
        if d is not None:
            # the node's lane and decayed GB/s from /device (absent
            # when it moved no device payload)
            line += (f"  device[{d.get('lane')}]: "
                     f"{d.get('GBps')} GB/s "
                     f"transfers={d.get('transfers')}"
                     + (f" failed={d['failed']}" if d.get("failed")
                        else "")
                     + (f" staged={d['staged_fallbacks']}"
                        if d.get("staged_fallbacks") else "")
                     + (f" leaked={d['leaked_bytes']}B"
                        if d.get("leaked_bytes") else ""))
        s = view.get("serving", {}).get(node)
        if s is not None:
            # tok/s, TTFT p99, KV occupancy and queue depth from
            # /serving (absent when the node serves no generation)
            line += (f"  serving: {s.get('tokens_per_s')} tok/s "
                     f"ttft_p99={s.get('ttft_p99_ms')}ms "
                     f"kv={s.get('kv_occupancy')} "
                     f"waiting={s.get('waiting')}"
                     + (f" shed={s['shed']}" if s.get("shed") else "")
                     + (f" evicted={s['evicted']}"
                        if s.get("evicted") else ""))
        out.append(line)
    for node in view.get("nodes_down", []):
        out.append(f"node {node}: DOWN")
    return "\n".join(out)


def run_top(nodes: List[str], interval: float, once: bool,
            as_json: bool) -> int:
    while True:
        view = scrape(nodes)
        if as_json:
            print(json.dumps(view, default=str), flush=True)
        else:
            if not once:
                sys.stdout.write("\x1b[2J\x1b[H")   # clear, home
            stamp = time.strftime("%H:%M:%S")
            print(f"cluster_top  {stamp}  nodes={view['nodes_up']}"
                  f"/{len(nodes)}")
            print(render(view), flush=True)
        if once:
            return 0 if view["nodes_up"] else 1
        time.sleep(interval)


# ---------------------------------------------------------------- smoke

def _burst(ch, calls: int, seconds: float) -> int:
    """Sync calls within ``seconds``: how many succeeded."""
    ok = 0
    stop_at = time.perf_counter() + seconds
    for _ in range(calls):
        if time.perf_counter() >= stop_at:
            break
        if not ch.call_sync("Bench", "PyEcho", b"q").failed():
            ok += 1
    return ok


def _overhead_window(on_ports: List[int], off_ports: List[int],
                     seconds: float) -> Tuple[float, float]:
    """One round of the cells' cost: two pipelined windows from worker
    processes through ClusterChannels, the cells on at ``on_ports`` and
    off at ``off_ports``, run at once. Each is the shape the overhead
    figure is defined on (a sync loop on one connection is more
    sensitive to the box's drift than the cells are costly); running
    them side by side puts the drift of a shared host, which moves qps
    by tens of percent from one second to the next, on both. The switch
    rides the environment into the workers. (qps on, qps off)."""
    from brpc_tpu_torch.tools.qps_client import drive_multiproc
    nprocs = min(4, max(2, (os.cpu_count() or 2) // 4))
    env_on = {k: v for k, v in os.environ.items()
              if k != "BRPC_TPU_BACKEND_STATS"}
    env_off = dict(env_on, BRPC_TPU_BACKEND_STATS="0")
    got = {}

    def drive(key, ports, env):
        got[key] = drive_multiproc(
            ",".join(str(p) for p in ports), nprocs=nprocs,
            seconds=seconds, conns=2, inflight=8, method="PyEcho",
            env=env)["qps"]
    threads = [threading.Thread(target=drive, args=a) for a in
               (("on", on_ports, env_on), ("off", off_ports, env_off))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return got["on"], got["off"]


def run_smoke(out: dict) -> None:
    from brpc_tpu_torch.rpc import (ChannelOptions, ClusterChannel, Server,
                                    ServerOptions)
    from brpc_tpu_torch.rpc import backend_stats as bs
    from brpc_tpu_torch.tools.smoke_util import perf_off
    from brpc_tpu_torch.tools.spawn_util import (http_get_local,
                                                 spawn_port_server)

    procs = []
    ch = None
    admin = None
    try:
        def backends(n):
            got = []
            for _ in range(n):
                proc, port = spawn_port_server(
                    ["-m", "brpc_tpu_torch.tools.bench_echo_server"],
                    wall_s=20.0, cwd=package_root())
                if port is None:
                    return None
                procs.append(proc)
                got.append(port)
            return got

        ports = backends(2)
        if ports is None:
            out["error"] = "echo server spawn failed"
            return
        # this process's own admin endpoint: its /backends is scraped
        # over HTTP
        admin = Server(ServerOptions(enable_builtin_services=True))
        admin_ep = admin.start("tcp://127.0.0.1:0")
        naming = "list://" + ",".join(
            f"tcp://127.0.0.1:{p}" for p in ports)
        ch = ClusterChannel(naming, "rr",
                            ChannelOptions(timeout_ms=4000, max_retry=2,
                                           name="smoke_cluster"))
        calls = _burst(ch, 80, 10.0)
        out["calls"] = calls
        if calls < 40:
            out["error"] = f"burst mostly failed ({calls}/80)"
            return

        # 1. the scraped /backends equals the channel's own cells
        _, body = http_get_local(admin_ep.port, "/backends")
        scraped = json.loads(body)
        local = bs.backends_page_payload()
        s_rows = scraped["channels"]["smoke_cluster"]["backends"]
        l_rows = local["channels"]["smoke_cluster"]["backends"]
        out["backends"] = len(s_rows)
        agree = set(s_rows) == set(l_rows) and all(
            s_rows[k]["attempts"] == l_rows[k]["attempts"]
            and s_rows[k]["completed"] == l_rows[k]["completed"]
            for k in s_rows)
        out["scrape_matches_bvars"] = agree

        # 2. every attempt on one backend row, none left in flight
        attempts = sum(r["attempts"] for r in s_rows.values())
        settled = sum(r["completed"] + r["abandoned"]
                      for r in s_rows.values())
        inflight = sum(r["inflight"] for r in s_rows.values())
        out["attempts"] = attempts
        out["attributed"] = bool(
            len(s_rows) == 2 and attempts >= calls
            and settled == attempts and inflight == 0
            and scraped["unattributed_errors"] == 0)

        # 3. the merge across nodes gives the channel's totals (the
        # echo backends' /backends pages are empty)
        nodes = [f"127.0.0.1:{admin_ep.port}"] + \
            [f"127.0.0.1:{p}" for p in ports]
        view = scrape(nodes)
        out["nodes_up"] = view["nodes_up"]
        merged = view["backends"]
        out["merge_matches"] = bool(
            view["nodes_up"] == 3 and set(merged) == set(s_rows)
            and all(merged[k]["attempts"] >= s_rows[k]["attempts"]
                    for k in merged))

        # 4. the cells' cost, on against off over rounds whose two
        # loads run at once (a reading over 5% earns one more round, the
        # box's drift against a real cost). The drift then falls on both
        # sides of a round, and what is left differs from one round to
        # the next, so the rounds are averaged: the best of each side
        # would be one round's reading. Its four backends are fresh (a
        # backend the checks scraped has started its fiber workers and
        # serves a few percent slower), the two pairs trading sides from
        # one round to the next.
        skip_perf = perf_off()
        if not skip_perf:
            cost_ports = backends(4)
            if cost_ports is None:
                out["error"] = "echo server spawn failed"
                return
            qps_on: List[float] = []
            qps_off: List[float] = []
            rounds = OVERHEAD_ROUNDS
            while True:
                for _ in range(rounds):
                    a, b = cost_ports[:2], cost_ports[2:]
                    if len(qps_on) % 2:
                        a, b = b, a
                    on, off = _overhead_window(a, b, OVERHEAD_WINDOW_S)
                    qps_on.append(on)
                    qps_off.append(off)
                out["qps_on"] = round(sum(qps_on) / len(qps_on), 1)
                out["qps_off"] = round(sum(qps_off) / len(qps_off), 1)
                out["backend_stats_overhead_pct"] = round(
                    max(0.0, (1.0 - sum(qps_on) / sum(qps_off))
                        * 100), 2) if sum(qps_off) else 100.0
                if rounds == 1 or out["backend_stats_overhead_pct"] \
                        <= OVERHEAD_PCT_MAX:
                    break
                rounds = 1
        ok = bool(out["scrape_matches_bvars"] and out["attributed"]
                  and out["merge_matches"]
                  and (skip_perf
                       or out.get("backend_stats_overhead_pct", 100.0)
                       <= OVERHEAD_PCT_MAX))
        out["ok"] = ok
        if not ok:
            out["invariant"] = ("scrape/attribution/merge/overhead "
                                "check failed")
    finally:
        try:
            if ch is not None:
                ch.close()
        except Exception:
            pass
        try:
            if admin is not None:
                admin.stop()
                admin.join(2)
        except Exception:
            pass
        for p in procs:
            try:
                p.terminate()
            except Exception:
                pass


def main() -> int:
    ap = argparse.ArgumentParser(
        description="live merged per-backend view over N nodes' "
                    "/backends + /status")
    ap.add_argument("nodes", nargs="*", help="host:port admin endpoints")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="one scrape, then exit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--smoke", action="store_true",
                    help="self-contained gate: 2 backends + a cluster "
                         "burst; asserts scrape/attribution/merge/"
                         "overhead invariants")
    args = ap.parse_args()
    if args.smoke:
        out: dict = {}
        try:
            run_smoke(out)
        except Exception as e:  # noqa: BLE001 - one JSON line either way
            out["ok"] = False
            out["error"] = f"{type(e).__name__}: {e}"[:300]
        print(json.dumps(out))
        sys.stdout.flush()
        return 0 if out.get("ok") else 1
    if not args.nodes:
        ap.error("need at least one host:port (or --smoke)")
    return run_top(args.nodes, args.interval, args.once, args.as_json)


if __name__ == "__main__":
    rc = main()
    os._exit(rc)   # skip the runtime threads' teardown
