"""The serving lane's smoke and bench (the port of
tools/serving_smoke.py; the gate ``serving_smoke`` of ``tools.preflight
--gate``): a shard group of GenerateService under a mixed client load.

    python3 -m brpc_tpu_torch.tools.serving_smoke --serve [--shards N]
        [--port P] [--max-batch B] [--max-waiting W] [--cache-len L]
        [--device D]

prints ``ADMIN <port>``, then ``PORT <port>``, and serves; each shard
builds its engine (the port's TinyDecoder) on ``--device``, ``cuda:0``
unless given, and runs its decode in its own process.

``--smoke``: a 2-shard group with a tiny engine (2 KV slots and 2 queue
entries a shard) under streaming completers, HTTP chunked readers,
deadline evictees and an overflow wave:

  1. every request ends in exactly one of completed, evicted or shed;
  2. the time to the first token is well below the full generation's
     (streaming is incremental, not buffered);
  3. deadline evictees end with ERPCTIMEDOUT (an ``e1008`` frame);
  4. the supervisor's merged ``/serving`` accounts for the whole set.

The report adds each shard's decode steps, warm-up steps and
``flash_decode`` launches, read from its own dump.

``--bench``: a continuous pipelined client mix with seeded connection
flap; ``tokens_per_s`` and ``ttft_p99_ms`` in one JSON line.

One JSON line; exit 1 with ``{"invariant": ...}`` on the first violated
invariant.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time


# ------------------------------------------------------------------ serve

def serve(shards: int, port: int, max_batch: int, max_waiting: int,
          cache_len: int, device=None) -> None:
    from brpc_tpu_torch.rpc import Server, Service
    from brpc_tpu_torch.rpc.shard_group import ShardGroupOptions
    from brpc_tpu_torch.serving import add_generate_service

    server = Server()
    svc = Service("Bench")

    @svc.method()
    def Pid(cntl, request):
        # the shard the kernel routed this connection to
        return str(os.getpid()).encode()

    server.add_service(svc)
    # each shard builds its engine on ``device``; this process, a
    # group's supervisor, makes no CUDA call
    add_generate_service(server, max_batch=max_batch,
                         max_waiting=max_waiting, cache_len=cache_len,
                         device=device)
    if shards > 1:
        ep = server.start(f"tcp://127.0.0.1:{port}", num_shards=shards,
                          shard_options=ShardGroupOptions(
                              dump_interval_s=0.2))
        print(f"ADMIN {server._shard_group.admin_endpoint.port}",
              flush=True)
    else:
        ep = server.start(f"tcp://127.0.0.1:{port}")
        print(f"ADMIN {ep.port}", flush=True)
    print(f"PORT {ep.port}", flush=True)
    server.run_until_asked_to_quit()


# ----------------------------------------------------------------- client

class StreamGen:
    """One streaming Generate call; collects tagged frames + timings."""

    def __init__(self, ch, prompt: str, max_tokens: int,
                 timeout_ms: float = 30000):
        import json as _json

        from brpc_tpu_torch.rpc.controller import Controller
        from brpc_tpu_torch.rpc.stream import StreamOptions
        self.tokens = 0
        self.t0 = time.monotonic_ns()
        self.first_ns = 0
        self.last_ns = 0
        self.done = None        # ("d"|"e", detail) once terminal
        cntl = Controller()
        cntl.timeout_ms = timeout_ms
        self.cntl = ch.call_sync(
            "GenerateService", "Generate",
            _json.dumps({"prompt": prompt,
                         "max_tokens": max_tokens}).encode(),
            cntl=cntl,
            stream_options=StreamOptions(on_received=self._on_frame))
        self.stream = getattr(self.cntl, "stream", None)

    def _on_frame(self, s, msg):
        p = bytes(msg.payload)
        tag = p[:1]
        now = time.monotonic_ns()
        if tag == b"t":
            self.tokens += 1
            self.last_ns = now
            if not self.first_ns:
                self.first_ns = now
        elif tag == b"d":
            self.done = ("d", json.loads(p[1:].decode()))
        elif tag == b"e":
            self.done = ("e", int(p[1:].decode()))

    def wait(self, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while self.done is None and time.monotonic() < deadline:
            time.sleep(0.003)
        return self.done is not None

    def ttft_ms(self):
        return (self.first_ns - self.t0) / 1e6 if self.first_ns else None

    def total_ms(self):
        return (self.last_ns - self.t0) / 1e6 if self.last_ns else None


def _pctl(xs, ratio):
    if not xs:
        return None
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(ratio * len(xs)))], 2)


class SmokeFailure(AssertionError):
    pass


def _check(ok: bool, invariant: str) -> None:
    if not ok:
        raise SmokeFailure(invariant)


def _spawn_server(args_extra, device=None, wall_s=120.0):
    from brpc_tpu_torch.tools.spawn_util import (package_root,
                                                 spawn_announcing_server)
    argv = ["-m", "brpc_tpu_torch.tools.serving_smoke", "--serve",
            *args_extra]
    if device:
        argv += ["--device", str(device)]
    proc, got = spawn_announcing_server(argv, wall_s, keys=("ADMIN", "PORT"),
                                        cwd=package_root())
    if got is None:
        raise RuntimeError("serving server spawn failed")
    return proc, got["ADMIN"], got["PORT"]


def _page(admin: int, path: str):
    from brpc_tpu_torch.tools.spawn_util import http_get_local
    status, body = http_get_local(admin, path, timeout_s=5.0)
    _check(status == 200, f"{path}: HTTP {status}")
    return body


def shard_counts(admin: int, nshards: int, timeout_s: float = 10.0):
    """Each shard's decode steps, warm-up steps and flash_decode launches
    from its own dump (``?shard=i`` on the supervisor's pages), once two
    reads a dump interval apart agree (a dump lags its shard)."""
    def read():
        rows = []
        for i in range(nshards):
            s = json.loads(_page(admin, f"/serving?shard={i}"))
            launches = None
            for ln in _page(admin, f"/vars?prefix=flash_decode_launches"
                                   f"&shard={i}").decode().splitlines():
                n, _, v = ln.partition(" : ")
                if n == "flash_decode_launches":
                    launches = json.loads(v)
            rows.append({"decode_steps": s["decode_steps"],
                         "warmup_steps": s["engine"]["warmup_steps"],
                         "flash_decode": launches})
        return rows
    deadline = time.monotonic() + timeout_s
    last = read()
    while time.monotonic() < deadline:
        time.sleep(0.5)
        now = read()
        if now == last:
            break
        last = now
    return last


# ------------------------------------------------------------------ smoke

def spread_channels(addr: str, shards: int, per_shard: int,
                    timeout_s: float = 30.0) -> list:
    """``per_shard`` private connections on each of ``shards`` shards:
    dial, ask the shard's pid, keep a connection while its shard has
    fewer than ``per_shard``."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    by_pid: dict = {}
    deadline = time.monotonic() + timeout_s
    while (len(by_pid) < shards
           or any(len(v) < per_shard for v in by_pid.values())):
        _check(time.monotonic() < deadline,
               f"connections never spread over {shards} shards: "
               f"{ {p: len(v) for p, v in by_pid.items()} }")
        ch = Channel(addr, ChannelOptions(share_connections=False))
        c = ch.call_sync("Bench", "Pid", b"")
        _check(not c.failed(), f"Pid call failed: {c.error_text}")
        got = by_pid.setdefault(int(c.response), [])
        if len(got) < per_shard:
            got.append(ch)
        else:
            ch.close()
    return [ch for chans in by_pid.values() for ch in chans]


def _warm_until_serving(addr: str, timeout_s: float = 120.0):
    """The supervisor announces PORT before its forked shards finish
    their bring-up (each builds its engine and warms up before it
    serves): redial until a warm generation completes. Returns the
    warmed Channel."""
    from brpc_tpu_torch.rpc import Channel
    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        ch = Channel(addr)
        w = StreamGen(ch, "warm", 2)
        if not w.cntl.failed() and w.wait(10) and w.done[0] == "d":
            return ch
        last = w.cntl.error_text if w.cntl.failed() else str(w.done)
        ch.close()
        time.sleep(0.5)
    raise SmokeFailure(f"server never served a warm stream: {last}")


def run_smoke(device=None) -> dict:
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    from brpc_tpu_torch.rpc import errno_codes as berr

    report: dict = {}
    t_start = time.monotonic()
    proc, admin, port = _spawn_server(
        ["--shards", "2", "--max-batch", "2", "--max-waiting", "2",
         "--cache-len", "4096"], device)
    outcomes = {"completed": 0, "evicted": 0, "shed": 0}
    try:
        addr = f"tcp://127.0.0.1:{port}"
        warm_ch = _warm_until_serving(addr)

        # 1) streaming completers: TTFT must beat full generation; three
        # connections on each shard, so that none holds more than its 2
        # slots and 2 queue entries (the kernel's pick alone puts five of
        # six on one shard about one time in five)
        comp_ch = spread_channels(addr, 2, 3)
        comps = [StreamGen(ch, f"stream-{i}", 48)
                 for i, ch in enumerate(comp_ch)]
        ttfts, totals = [], []
        for i, c in enumerate(comps):
            _check(not c.cntl.failed(),
                   f"completer {i} rpc failed: {c.cntl.error_text}")
            _check(c.wait(30), f"completer {i} never finished")
            _check(c.done == ("d", {"n": 48, "status": "completed"}),
                   f"completer {i} bad terminal {c.done}")
            outcomes["completed"] += 1
            ttfts.append(c.ttft_ms())
            totals.append(c.total_ms())
        report["ttft_p50_ms"] = _pctl(ttfts, 0.5)
        report["full_gen_p50_ms"] = _pctl(totals, 0.5)
        _check(report["ttft_p50_ms"] < report["full_gen_p50_ms"] * 0.6,
               f"streaming not incremental: ttft p50 "
               f"{report['ttft_p50_ms']}ms vs full "
               f"{report['full_gen_p50_ms']}ms")

        # 2) deadline evictees: budget dies mid-generation -> e1008
        evs = [StreamGen(Channel(addr), f"evict-{i}", 4000,
                         timeout_ms=400) for i in range(2)]
        for i, c in enumerate(evs):
            _check(not c.cntl.failed(),
                   f"evictee {i} rpc failed: {c.cntl.error_text}")
            _check(c.wait(30), f"evictee {i} never reached a verdict")
            _check(c.done == ("e", berr.ERPCTIMEDOUT),
                   f"evictee {i} terminal {c.done}, want e1008")
            _check(0 < c.tokens < 4000,
                   f"evictee {i} not evicted MID-stream ({c.tokens})")
            outcomes["evicted"] += 1

        # 3) overflow wave: 2 shards x (2 slots + 2 queue) = 8 capacity;
        # 14 long generations must split into accepted + shed, nothing
        # lost, nothing hung
        wave_ch = [Channel(addr, ChannelOptions(share_connections=False))
                   for _ in range(14)]
        wave = [StreamGen(ch, f"wave-{i}", 600) for i, ch in
                enumerate(wave_ch)]
        accepted = []
        for i, c in enumerate(wave):
            if c.cntl.failed():
                _check(c.cntl.error_code == berr.ELIMIT,
                       f"wave {i} failed {c.cntl.error_code}, not shed")
                outcomes["shed"] += 1
            else:
                accepted.append((i, c))
        _check(outcomes["shed"] > 0, "overflow wave never shed")
        _check(accepted, "overflow wave all shed")
        for i, c in accepted:
            _check(c.wait(60), f"wave {i} never finished")
            _check(c.done[0] in ("d", "e"), f"wave {i} terminal {c.done}")
            outcomes["completed" if c.done[0] == "d" else "evicted"] += 1

        # 4) HTTP chunked path, mixed in after the wave drained
        import http.client
        for i in range(2):
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=30)
            conn.request("POST", "/GenerateService/Generate",
                         body=json.dumps({"prompt": f"http-{i}",
                                          "max_tokens": 24}))
            resp = conn.getresponse()
            _check(resp.status == 200, f"http {i} status {resp.status}")
            body = resp.read()
            payload, _, footer = body.rpartition(b"\n#")
            _check(footer == b"completed n=24",
                   f"http {i} footer {footer!r}")
            _check(len(payload) == 24, f"http {i} body {len(payload)}")
            outcomes["completed"] += 1
            conn.close()

        # every request reached exactly one verdict (the counters above
        # were incremented exactly once per request by construction;
        # assert the totals line up with what we sent)
        sent = 6 + 2 + 14 + 2
        _check(sum(outcomes.values()) == sent,
               f"verdicts {outcomes} != sent {sent}")

        # 5) the supervisor's merged /serving accounts for the group
        from brpc_tpu_torch.tools.spawn_util import http_get_local
        deadline = time.monotonic() + 10
        page = None
        want_done = outcomes["completed"] + outcomes["evicted"] - 1
        while time.monotonic() < deadline:
            status, body = http_get_local(admin, "/serving",
                                          timeout_s=5.0)
            if status != 200:
                time.sleep(0.3)
                continue
            page = json.loads(body)
            if page.get("enabled") and \
                    page.get("shards_reporting") == 2 and \
                    (page.get("completed", 0) + page.get("evicted", 0)
                     + page.get("canceled", 0)) >= want_done:
                break
            time.sleep(0.3)
        _check(page is not None and page.get("enabled"),
               f"merged /serving never enabled: {page}")
        _check(page.get("shards_reporting") == 2,
               f"shards_reporting {page.get('shards_reporting')}")
        _check(page.get("completed", 0) + page.get("evicted", 0)
               + page.get("canceled", 0) >= want_done,
               f"merged /serving lost requests: {page}")
        report["merged_serving"] = {
            k: page.get(k) for k in ("completed", "evicted", "canceled",
                                     "tokens_out", "shards_reporting")}
        # each shard's own counts: on a card, its flash_decode launches
        # against its steps (the plain path on the CPU counts none)
        report["shards"] = shard_counts(admin, 2)
        for ch in comp_ch + wave_ch:
            ch.close()
        warm_ch.close()
    finally:
        try:
            proc.terminate()
            proc.wait(5)
        except Exception:
            pass
    report["outcomes"] = outcomes
    report["elapsed_s"] = round(time.monotonic() - t_start, 2)
    return report


# ------------------------------------------------------------------ bench

def run_bench(seconds: float, clients: int, shards: int,
              flap_p: float, seed: int, device=None) -> dict:
    """Continuous client mix with seeded flap; headline tokens_per_s +
    ttft_p99_ms."""
    import random

    from brpc_tpu_torch.rpc import Channel, ChannelOptions

    proc, admin, port = _spawn_server(
        ["--shards", str(shards), "--max-batch", "8",
         "--max-waiting", "32", "--cache-len", "512"], device)
    addr = f"tcp://127.0.0.1:{port}"
    stop = threading.Event()
    lock = threading.Lock()
    stats = {"tokens": 0, "completed": 0, "flapped": 0, "errors": 0,
             "ttft_ms": [], "total_ms": []}

    def client_loop(idx: int) -> None:
        rng = random.Random(seed + idx)
        # shards may still be mid-bring-up: redial until served
        deadline = time.monotonic() + 60
        ch = Channel(addr, ChannelOptions(share_connections=False))
        while not stop.is_set() and time.monotonic() < deadline:
            warm = StreamGen(ch, "w", 2)
            if not warm.cntl.failed() and warm.wait(10) \
                    and warm.done[0] == "d":
                break
            ch.close()
            time.sleep(0.5)
            ch = Channel(addr, ChannelOptions(share_connections=False))
        while not stop.is_set():
            flap = rng.random() < flap_p
            g = StreamGen(ch, f"bench-{idx}", 48, timeout_ms=30000)
            if g.cntl.failed():
                with lock:
                    stats["errors"] += 1
                time.sleep(0.05)
                continue
            if flap:
                # drop the transport mid-stream, then redial
                while g.tokens < 3 and g.done is None \
                        and not stop.is_set():
                    time.sleep(0.002)
                if g.stream is not None and g.stream.conn is not None:
                    g.stream.conn.set_failed(
                        ConnectionError("bench flap"))
                ch.close()
                with lock:
                    stats["flapped"] += 1
                    stats["tokens"] += g.tokens
                ch = Channel(addr,
                             ChannelOptions(share_connections=False))
                continue
            if not g.wait(60):
                with lock:
                    stats["errors"] += 1
                continue
            with lock:
                stats["tokens"] += g.tokens
                if g.done[0] == "d":
                    stats["completed"] += 1
                    stats["ttft_ms"].append(g.ttft_ms())
                    stats["total_ms"].append(g.total_ms())
                else:
                    stats["errors"] += 1
        ch.close()

    threads = [threading.Thread(target=client_loop, args=(i,),
                                daemon=True) for i in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(30)
    elapsed = time.monotonic() - t0
    try:
        proc.terminate()
        proc.wait(5)
    except Exception:
        pass
    return {
        "seconds": round(elapsed, 2),
        "clients": clients,
        "shards": shards,
        "flap_p": flap_p,
        "tokens_per_s": round(stats["tokens"] / elapsed, 1),
        "completed": stats["completed"],
        "flapped": stats["flapped"],
        "errors": stats["errors"],
        "ttft_p50_ms": _pctl(stats["ttft_ms"], 0.5),
        "ttft_p99_ms": _pctl(stats["ttft_ms"], 0.99),
        "full_gen_p50_ms": _pctl(stats["total_ms"], 0.5),
        "full_gen_p99_ms": _pctl(stats["total_ms"], 0.99),
    }


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--serve", action="store_true")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--bench", action="store_true")
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-waiting", type=int, default=32)
    p.add_argument("--cache-len", type=int, default=512)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--flap-p", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=20260803)
    p.add_argument("--device", default=None,
                   help="the engines' device: cuda:0 unless given")
    args = p.parse_args(argv)
    if args.serve:
        serve(args.shards, args.port, args.max_batch, args.max_waiting,
              args.cache_len, args.device)
        return 0
    if args.bench:
        print(json.dumps(run_bench(args.seconds, args.clients,
                                   args.shards, args.flap_p, args.seed,
                                   args.device)))
        return 0
    if args.smoke:
        try:
            report = run_smoke(args.device)
        except SmokeFailure as e:
            print(json.dumps({"ok": False, "invariant": str(e)}))
            return 1
        except Exception as e:  # noqa: BLE001 - structured failure out
            print(json.dumps({"ok": False,
                              "invariant": f"{type(e).__name__}: {e}"}))
            return 1
        report["ok"] = True
        print(json.dumps({"smoke": report, "ok": True}))
        return 0
    p.print_help()
    return 2


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)    # skip the runtime threads' teardown
