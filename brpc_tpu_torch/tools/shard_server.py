"""A shard group behind one SO_REUSEPORT port (the port of
tools/shard_server.py)::

    python3 -m brpc_tpu_torch.tools.shard_server [--shards N] [--port P]
        [--group] [--generate [--device cpu|cuda:0]] [--dump-interval S]
        [--heartbeat-timeout S] [--restart-backoff S] [--shard-dir DIR]

prints ``ADMIN <port>`` (the supervisor's merged pages), then, once
every shard has written its first dump (it serves by then),
``PORT <port>`` (the data plane), and serves until SIGINT, SIGTERM or
its parent's death (``Server.run_until_asked_to_quit``). A group whose
shards do not all come up within ``READY_TIMEOUT_S``, or that fails
(``ShardGroup.failed``), is stopped and the tool exits 1. ``--shards 1``
is a plain server unless ``--group`` puts the one shard under a
supervisor too, as a larger group's shards run. ``--smoke`` (the gate
``shard_smoke`` of ``tools.preflight --gate``) starts a 2-shard group:
connections spread over both shards, a SIGKILLed shard restarts with no
error on the survivors' channels and its own channels' calls retried
elsewhere, and the merged ``/vars`` equals the sum of the shards' dumps;
one JSON line. Every shard
serves the ``Bench`` service: ``Echo`` and ``PyEcho`` as
``tools.bench_echo_server`` defines them, and ``Pid``, which answers the pid
of the shard the kernel routed the connection to. ``--generate`` adds
``GenerateService`` (``serving.add_generate_service``) on ``--device``,
``cuda:0`` by default: each shard builds its own engine there, and this
process, the supervisor, makes no CUDA call.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

# a cold start builds the native core and flash_decode before the forks,
# then every shard makes its context and warms up
READY_TIMEOUT_S = 120.0


def make_template_server(generate: bool = False, device=None):
    """The Server every shard starts from: the Bench service, and with
    ``generate`` the serving lane on ``device``."""
    from brpc_tpu_torch.rpc import Server, Service
    from brpc_tpu_torch.tools.bench_echo_server import add_echo_methods

    server = Server()
    svc = Service("Bench")
    add_echo_methods(svc)

    @svc.method()
    def Pid(cntl, request):
        # reuseport routes a connection, so the answer holds for a
        # channel's life
        return str(os.getpid()).encode()

    server.add_service(svc)
    if generate:
        from brpc_tpu_torch.serving import add_generate_service
        add_generate_service(server, device=device)
    return server


# ------------------------------------------------------------------ smoke

class SmokeFailure(AssertionError):
    pass


def _check(ok: bool, invariant: str) -> None:
    if not ok:
        raise SmokeFailure(invariant)


def run_smoke() -> dict:
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.shard_group import ShardGroupOptions

    report: dict = {}
    server = make_template_server()
    ep = server.start("tcp://127.0.0.1:0", num_shards=2,
                      shard_options=ShardGroupOptions(
                          dump_interval_s=0.15, restart_backoff_s=0.2))
    grp = server._shard_group
    chans = []
    try:
        pids0 = set(grp.shard_pids())
        _check(len(pids0) == 2, "expected 2 live shards after start")

        def new_chan():
            ch = Channel(f"tcp://127.0.0.1:{ep.port}",
                         ChannelOptions(timeout_ms=3000, max_retry=3,
                                        share_connections=False))
            chans.append(ch)
            return ch

        def pid_of(ch) -> int:
            c = ch.call_sync("Bench", "Pid", b"")
            _check(not c.failed(), f"Pid call failed: {c.error_text}")
            return int(c.response)

        # connections must spread over both shards (kernel 4-tuple
        # hashing: a handful of ephemeral ports covers 2 shards fast)
        by_pid: dict = {}
        deadline = time.monotonic() + 10.0
        while len(by_pid) < 2 and time.monotonic() < deadline:
            ch = new_chan()
            by_pid.setdefault(pid_of(ch), []).append(ch)
        _check(len(by_pid) == 2, "connections never spread to 2 shards")
        report["conn_spread"] = {str(p): len(v) for p, v in by_pid.items()}

        victim = next(iter(by_pid))
        survivors = [c for p, v in by_pid.items() if p != victim for c in v]
        victims = by_pid[victim]
        os.kill(victim, signal.SIGKILL)
        t_kill = time.monotonic()

        # survivors: their connections live in other processes — ZERO
        # errors allowed while the victim is down and restarting
        errs = 0
        calls = 0
        while time.monotonic() - t_kill < 1.5:
            for c in survivors:
                calls += 1
                if c.call_sync("Bench", "Echo", b"s").failed():
                    errs += 1
        report["survivor_calls"] = calls
        _check(errs == 0, f"{errs} errors on surviving shards' channels")

        # the victim's channels: the broken connection re-dials and the
        # kernel routes it to a live shard — retried calls succeed
        for c in victims:
            r = c.call_sync("Bench", "Echo", b"v")
            _check(not r.failed(),
                   f"retried call on killed shard's channel failed: "
                   f"{r.error_text}")

        # supervisor restart within the backoff budget
        restarted = False
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            pids = grp.shard_pids()
            if len(pids) == 2 and victim not in pids:
                restarted = True
                break
            time.sleep(0.05)
        _check(restarted, "killed shard not restarted within 10s")
        report["restart_s"] = round(time.monotonic() - t_kill, 2)

        # merged /vars sanity: with traffic stopped, the merged counter
        # equals the sum of the per-shard dumps (allow one dump
        # interval for the restarted shard's first write)
        time.sleep(0.5)
        agg = grp.aggregator
        key = "server_processed" if "server_processed" in \
            agg.merged_vars() else "socket_read_bytes"
        ok_sum = False
        for _ in range(5):
            dumps = agg.read_dumps()
            merged = agg.merged_vars(key).get(key)
            parts = [d["vars"].get(key) for d in dumps
                     if key in d.get("vars", {})]
            if len(dumps) == 2 and merged == sum(parts):
                ok_sum = True
                break
            time.sleep(0.3)
        _check(ok_sum, f"merged /vars {key} != sum of shard dumps")
        report["merged_var"] = {key: merged, "shards": parts}
        st = agg.merged_status()
        _check(st.get("mode") == "shard_group"
               and st.get("shards_reporting") == 2,
               f"merged status malformed: {st.get('mode')}/"
               f"{st.get('shards_reporting')}")
        report["processed"] = st["processed"]
        return report
    finally:
        for c in chans:
            try:
                c.close()
            except Exception:
                pass
        server.stop()
        server.join(5)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("::")[0])
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--group", action="store_true")
    p.add_argument("--generate", action="store_true")
    p.add_argument("--device", default=None)
    p.add_argument("--dump-interval", type=float, default=None)
    p.add_argument("--heartbeat-timeout", type=float, default=None)
    p.add_argument("--restart-backoff", type=float, default=None)
    p.add_argument("--shard-dir", default=None)
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)
    if args.smoke:
        t0 = time.monotonic()
        try:
            report = run_smoke()
        except SmokeFailure as e:
            print(json.dumps({"invariant": str(e)}))
            return 1
        report["elapsed_s"] = round(time.monotonic() - t0, 2)
        print(json.dumps({"smoke": report}))
        return 0
    from brpc_tpu_torch.rpc.shard_group import ShardGroupOptions

    server = make_template_server(args.generate, args.device)
    # an option not given keeps the group's default
    given = {k: v for k, v in (
        ("dump_interval_s", args.dump_interval),
        ("heartbeat_timeout_s", args.heartbeat_timeout),
        ("restart_backoff_s", args.restart_backoff)) if v is not None}
    opts = ShardGroupOptions(shard_dir=args.shard_dir, **given)
    address = f"tcp://127.0.0.1:{args.port}"
    if args.group:
        ep = server.start_group(address, args.shards, opts)
    else:
        ep = server.start(address, num_shards=args.shards,
                          shard_options=opts)
    grp = server._shard_group
    if grp is not None:
        print(f"ADMIN {grp.admin_endpoint.port}", flush=True)
        deadline = time.monotonic() + READY_TIMEOUT_S
        while len(grp.aggregator.read_dumps()) < args.shards:
            why = grp.failed or (
                f"the shards did not all come up in {READY_TIMEOUT_S} s"
                if time.monotonic() > deadline else None)
            if why:
                print(f"shard_server: {why}", file=sys.stderr)
                server.stop()
                server.join()
                return 1
            time.sleep(0.05)
    print(f"PORT {ep.port}", flush=True)
    server.run_until_asked_to_quit()
    if grp is not None and grp.failed:
        print(f"shard_server: {grp.failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)
