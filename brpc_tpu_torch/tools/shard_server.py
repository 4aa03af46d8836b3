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
supervisor too, as a larger group's shards run. Every shard
serves the ``Bench`` service: ``Echo`` and ``PyEcho`` as
``tools.bench_echo_server`` defines them, and ``Pid``, which answers the pid
of the shard the kernel routed the connection to. ``--generate`` adds
``GenerateService`` (``serving.add_generate_service``) on ``--device``,
``cuda:0`` by default: each shard builds its own engine there, and this
process, the supervisor, makes no CUDA call.
"""

from __future__ import annotations

import argparse
import os
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
    args = p.parse_args(argv)
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
