"""Phase 3's unary Generate burst, one host lane against another, in
turns: where a sync call's time goes on each.

    python3 -m brpc_tpu_torch.rpc.lane_ab [--parent TREE] [--rounds N]
        [--device cuda:0] [--out DIR]
    python3 -m brpc_tpu_torch.rpc.lane_ab --held [--rounds N]
        [--device cuda:0]

Each variant is a Generate server process (``add_generate_service``,
TinyDecoder, phase 3's width) and, for each turn, a fresh client
process that sends phase 3's burst: 8 threads, one Channel each, 16
calls of 32 tokens, two calls a thread, so the first call of each thread
opens its connection. The variants:

- ``parent``: the tree at ``--parent`` on both sides (a ``git archive``
  of the parent commit), if given;
- ``native``: this tree, the native lanes, the sync pluck lane on;
- ``nopluck``: as ``native``, with the client's pluck lane off (the
  client child replaces ``Socket.pluck_preclaim`` by a refusal);
- ``lazyload``: as ``native``, with the core loaded by the first call
  instead of by the Channel's construction (the client child replaces
  ``client_dispatch.warm`` by a no-op);
- ``pure``: this tree with ``BRPC_TPU_TORCH_NO_NATIVE=1`` on both sides;
- ``native_nodl``, ``pure_nodl``: as ``native`` and ``pure``, with no
  deadline in the request meta (the turbo lane's traffic; the others
  carry phase 3's 120 s deadline, which the turbo scan defers).

The plan runs the variants in order, then reversed, ``--rounds`` times.
Each call is stamped on the wall clock in the client (issue, completion
by the response's path, return to the caller) and in the server (the
handler's start and end), which splits a call into the way in, the
handler, the way out and the wake. Calls are split by wave: a thread's
first call (it pays the connection) and its second. Every turn's tokens
must equal the first turn's. Prints one JSON line a turn and, last, the
medians a variant; ``--out`` keeps each turn's calls.

``--held`` runs the held-connection turns instead: phase 3's unary
client on held connections, its process on the selector
(``held_selector``) or on the ring's batch backend (``held_batch``),
against one server of this tree (and with ``--parent`` the same turns of
the parent tree against a server of its own, ``parent_held_*``). The
client's code is this file's, run on the tree's package. Each thread
opens its connection with a first call, then makes ``HELD_LATER`` later
calls on it (the steady state). A turn reports the first-call and
later-call p50, and for the steady state the dispatcher's
``pause_read``/``resume_read`` calls a sync call (the client process
counts them by wrapping the two methods: an instrument of this harness,
not a bvar) and the ring's ``ring_read_barriers``,
``ring_barrier_waits`` and ``ring_barrier_wait_us``. With the sticky
pause a steady sync call pauses and resumes no reads and fences no tick.

"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

N_THREADS = 8
N_CALLS = 16
MAX_TOKENS = 32
DEADLINE_MS = 120000
NO_NATIVE = {"BRPC_TPU_TORCH_NO_NATIVE": "1"}
# --held: later calls a thread makes on its held connection
HELD_LATER = 8
HELD_LANES = {"held_selector": 0, "held_batch": 1}


def _prompts():
    # phase 3's prompts (chip_smoke.py's _prompts)
    return [f"request {i:02d}: {'the quick brown fox '[: 3 + i]}"
            for i in range(N_CALLS)]


def _serve(tree: str, device: str) -> int:
    """A Generate server from ``tree``; its port, then on each line of
    stdin the handler stamps since the last line, CPU seconds, decode
    steps and turbo requests."""
    sys.path.insert(0, tree)
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import add_generate_service
    server = Server()
    gs = add_generate_service(server, device=device)
    ep = server.start("tcp://127.0.0.1:0")
    m = server.find_method("GenerateService", "Generate")
    real, stamps = m.handler, []

    async def stamped(cntl, request):
        t0 = time.time_ns()
        out = await real(cntl, request)
        stamps.append((json.loads(bytes(request))["prompt"], t0,
                       time.time_ns()))
        return out
    m.handler = stamped
    try:
        from brpc_tpu_torch.rpc.server_dispatch import nturbo_requests
    except ImportError:             # a tree without the turbo lane
        nturbo_requests = None
    print(json.dumps({"port": ep.port}), flush=True)
    try:
        while sys.stdin.readline():
            out = {"cpu_s": time.process_time(), "stamps": stamps[:],
                   "steps": gs.batcher.decode_steps,
                   "turbo": 0 if nturbo_requests is None
                   else nturbo_requests.get_value()}
            stamps.clear()
            print(json.dumps(out), flush=True)
    finally:
        server.stop()
        server.join(10)
    return 0


def _client(tree: str, port: int, mode: str, timeout_ms: int) -> int:
    """One burst from ``tree``'s Channel; prints the calls' stamps.
    ``mode``: ``nopluck`` or ``lazyload`` turn that part off."""
    sys.path.insert(0, tree)
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, client_dispatch
    from brpc_tpu_torch.rpc.controller import Controller
    from brpc_tpu_torch.transport import socket as sk
    if mode == "nopluck":
        sk.Socket.pluck_preclaim = lambda self: False
    elif mode == "lazyload":
        client_dispatch.warm = lambda: None
    complete = Controller._complete

    def stamped_complete(self, *a, **k):
        self.__dict__["_ab_done_ns"] = time.time_ns()
        return complete(self, *a, **k)
    Controller._complete = stamped_complete
    prompts = _prompts()
    results, errors, calls = {}, [], []

    def thread(idx):
        # a connection a thread, as phase 3's burst
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=timeout_ms or None,
                                    share_connections=False))
        try:
            for seq, p in enumerate(prompts[idx::N_THREADS]):
                t0 = time.time_ns()
                c = ch.call_sync("GenerateService", "Generate", json.dumps(
                    {"prompt": p, "max_tokens": MAX_TOKENS}).encode())
                t1 = time.time_ns()
                if c.failed():
                    errors.append((p, c.error_code, c.error_text))
                    continue
                results[p] = json.loads(c.response)["tokens"]
                calls.append((p, seq, t0, c.__dict__.get("_ab_done_ns", 0),
                              t1))
        finally:
            ch.close()
    cpu0 = time.process_time()
    threads = [threading.Thread(target=thread, args=(i,))
               for i in range(N_THREADS)]
    w0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.monotonic() - w0
    plucked = getattr(sk, "npluck_fast", None)
    print(json.dumps({"results": results, "errors": errors, "calls": calls,
                      "wall_s": wall, "cpu_s": time.process_time() - cpu0,
                      "plucked": 0 if plucked is None
                      else plucked.get_value()}), flush=True)
    return 0


def _held_client(tree: str, port: int, backend: int) -> int:
    """The held-connection turn (``--held``) from ``tree``'s Channel, its
    process on the selector (``backend`` 0) or the ring's batch backend
    (1); prints the latencies, the tokens and the steady state's
    counts."""
    sys.path.insert(0, tree)
    from brpc_tpu_torch.transport import event_dispatcher as ed, ring_lane
    if backend:
        ed._global = ring_lane.RingDispatcher(backend=backend)
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    from brpc_tpu_torch.transport import socket as sk
    d = ed.global_dispatcher()
    flips = {"pause_read": 0, "resume_read": 0}
    for name in flips:
        real = getattr(d, name)

        def counted(fd, _real=real, _name=name):
            flips[_name] += 1
            return _real(fd)
        setattr(d, name, counted)
    prompts = _prompts()
    chans = [Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=DEADLINE_MS,
                                    share_connections=False))
             for _ in range(N_THREADS)]
    results, errors = {}, []
    lat = {"first": [], "later": []}

    def run(idx, wave, n):
        for k in range(n):
            p = prompts[(idx + k * N_THREADS) % len(prompts)]
            t0 = time.perf_counter()
            c = chans[idx].call_sync("GenerateService", "Generate",
                                     json.dumps({"prompt": p,
                                                 "max_tokens": MAX_TOKENS}
                                                ).encode())
            if c.failed():
                errors.append((p, c.error_code, c.error_text))
                continue
            lat[wave].append((time.perf_counter() - t0) * 1e3)
            results[p] = json.loads(c.response)["tokens"]

    def wave(name, n):
        threads = [threading.Thread(target=run, args=(i, name, n))
                   for i in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)

    def snap():
        return dict(flips, **ring_lane.counters(),
                    plucked=sk.npluck_fast.get_value())
    try:
        wave("first", 1)
        a = snap()
        wave("later", HELD_LATER)
        b = snap()
    finally:
        for ch in chans:
            ch.close()
    calls = len(lat["later"])
    steady = {k: b[k] - a[k] for k in b}
    print(json.dumps({
        "lane": [type(d).__name__, getattr(d, "backend", "selector")],
        "results": results, "errors": errors,
        "first_p50_ms": _median(lat["first"]),
        "later_p50_ms": _median(lat["later"]), "later_calls": calls,
        "pause_read_per_call": steady["pause_read"] / max(1, calls),
        "resume_read_per_call": steady["resume_read"] / max(1, calls),
        "steady": {k: steady[k] for k in (
            "pause_read", "resume_read", "plucked", "ring_read_barriers",
            "ring_barrier_waits", "ring_barrier_wait_us")}}), flush=True)
    return 0


def _median(xs):
    return statistics.median(xs) if xs else None


def _turn_row(doc, a, b) -> dict:
    """One turn's medians from the client's stamps and the server's."""
    srv = {p: (t0, t1) for p, t0, t1 in b["stamps"]}
    parts = {k: [] for k in ("lat", "first", "later", "in", "handler",
                             "out", "wake")}
    for p, seq, t0, done, t1 in doc["calls"]:
        s0, s1 = srv[p]
        lat = (t1 - t0) / 1e6
        parts["lat"].append(lat)
        parts["first" if seq == 0 else "later"].append(lat)
        if seq:                     # the split of a call on a live
            parts["in"].append((s0 - t0) / 1e6)     # connection
            parts["handler"].append((s1 - s0) / 1e6)
            parts["out"].append((done - s1) / 1e6)
            parts["wake"].append((t1 - done) / 1e6)
    lat = sorted(parts["lat"])
    row = {"p50_ms": _median(lat), "p99_ms": lat[-1] if lat else None,
           "first_p50_ms": _median(parts["first"]),
           "later_p50_ms": _median(parts["later"])}
    for k in ("in", "handler", "out", "wake"):
        row[f"later_{k}_ms"] = _median(parts[k])
    n = len(doc["calls"])
    tokens = sum(len(t) for t in doc["results"].values())
    row.update(tokens_per_s=tokens / doc["wall_s"],
               client_cpu_ms_per_call=doc["cpu_s"] * 1e3 / n,
               server_cpu_ms_per_call=(b["cpu_s"] - a["cpu_s"]) * 1e3 / n,
               decode_steps=b["steps"] - a["steps"],
               turbo_requests=b["turbo"] - a["turbo"],
               plucked=doc["plucked"])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a second tree (the parent commit)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", help="a directory for each turn's calls")
    ap.add_argument("--held", action="store_true",
                    help="the held-connection turns on the selector and "
                         "the ring's batch backend instead")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parents[2])
    me = str(Path(__file__).resolve())
    # server key: (tree, environment); variant: (server, client mode,
    # deadline)
    servers = {"this": (here, None), "pure": (here, NO_NATIVE)}
    variants = {"native": ("this", "native", DEADLINE_MS),
                "nopluck": ("this", "nopluck", DEADLINE_MS),
                "lazyload": ("this", "lazyload", DEADLINE_MS),
                "pure": ("pure", "native", DEADLINE_MS),
                "native_nodl": ("this", "native", 0),
                "pure_nodl": ("pure", "native", 0)}
    if args.held:
        servers = {"this": (here, None)}
        variants = {"native": ("this", "native", DEADLINE_MS),
                    **{v: ("this", v, DEADLINE_MS) for v in HELD_LANES}}
        if args.parent:
            servers["parent"] = (str(Path(args.parent).resolve()), None)
            variants.update({f"parent_{v}": ("parent", v, DEADLINE_MS)
                             for v in HELD_LANES})
    elif args.parent:
        servers["parent"] = (str(Path(args.parent).resolve()), None)
        variants = {"parent": ("parent", "native", DEADLINE_MS),
                    **variants}
    out_dir = Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)

    def env_of(extra):
        return None if extra is None else dict(os.environ, **extra)

    procs, ports = {}, {}

    def step(k):
        p = procs[k]
        p.stdin.write("\n")
        p.stdin.flush()
        return json.loads(p.stdout.readline())

    def burst(v):
        s, mode, tmo = variants[v]
        tree, env = servers[s]
        # -P: the script's own directory must not shadow the tree's
        argv = [sys.executable, "-P", me, "--client", tree, str(ports[s]),
                mode, str(tmo)]
        if mode in HELD_LANES:
            argv = [sys.executable, "-P", me, "--held-client", tree,
                    str(ports[s]), str(HELD_LANES[mode])]
        out = subprocess.run(argv, capture_output=True, text=True,
                             timeout=300, env=env_of(env))
        if out.returncode != 0:
            raise RuntimeError(f"{v} client failed: {out.stderr[-3000:]}")
        doc = json.loads(out.stdout.strip().splitlines()[-1])
        if doc["errors"]:
            raise RuntimeError(f"{v}: failed calls {doc['errors'][:3]}")
        return doc

    try:
        for k, (tree, env) in servers.items():
            procs[k] = subprocess.Popen(
                [sys.executable, "-P", me, "--serve", tree, args.device],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                env=env_of(env))
        for k in servers:
            ports[k] = json.loads(procs[k].stdout.readline())["port"]
        oracle, warmed = None, set()
        for v, (s, _, _) in variants.items():   # a warm-up a server
            if s in warmed:
                continue
            warmed.add(s)
            doc = burst(v)
            oracle = oracle or doc["results"]
            if doc["results"] != oracle:
                raise RuntimeError(f"{v} warm-up: tokens differ")
        order = [v for v in variants
                 if not args.held or variants[v][1] in HELD_LANES]
        plan = []
        for r in range(args.rounds):
            plan += order if r % 2 == 0 else order[::-1]
        rows = {v: [] for v in variants}
        for i, v in enumerate(plan):
            s = variants[v][0]
            a = step(s)
            doc = burst(v)
            b = step(s)
            if doc["results"] != oracle:
                raise RuntimeError(f"{v} turn {i}: tokens differ")
            if variants[v][1] in HELD_LANES:
                row = {k: doc[k] for k in (
                    "lane", "first_p50_ms", "later_p50_ms", "later_calls",
                    "pause_read_per_call", "resume_read_per_call",
                    "steady")}
                row["decode_steps"] = b["steps"] - a["steps"]
                rows[v].append(row)
                print(json.dumps({"turn": i, "variant": v, **row}),
                      flush=True)
                continue
            row = _turn_row(doc, a, b)
            rows[v].append(row)
            print(json.dumps({"turn": i, "variant": v, **row}), flush=True)
            if out_dir is not None:
                (out_dir / f"turn{i:02d}_{v}.json").write_text(json.dumps(
                    {"calls": doc["calls"], "stamps": b["stamps"]}))
        medians = {v: {m: _median([r[m] for r in rs if r[m] is not None])
                       for m in rs[0]
                       if isinstance(rs[0][m], (int, float))}
                   for v, rs in rows.items() if rs}
        print(json.dumps({"rounds": args.rounds, "order": order,
                          "medians": medians}), flush=True)
    finally:
        for p in procs.values():
            try:
                p.stdin.close()
                p.wait(30)
            except Exception:           # stops it whatever state it is in
                p.kill()
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--serve":
        sys.exit(_serve(sys.argv[2], sys.argv[3]))
    if len(sys.argv) > 1 and sys.argv[1] == "--held-client":
        sys.exit(_held_client(sys.argv[2], int(sys.argv[3]),
                              int(sys.argv[4])))
    if len(sys.argv) > 1 and sys.argv[1] == "--client":
        sys.exit(_client(sys.argv[2], int(sys.argv[3]), sys.argv[4],
                         int(sys.argv[5])))
    sys.exit(main())
