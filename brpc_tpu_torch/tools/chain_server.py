"""A hop of a call chain for traces across processes (the port of
tools/chain_server.py): it serves ``Chain.Hop`` and, with ``--next``,
forwards each call to the next hop, so that a client -> A -> B call
leaves spans in three processes' stores, which ``tools.trace`` joins
into one tree::

    python3 -m brpc_tpu_torch.tools.chain_server PORT
        [--next tcp://host:port] [--rpcz-dir DIR]

prints ``PORT <n>`` once it listens, and exits on SIGTERM or SIGINT
after flushing its span store.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("port", type=int)
    p.add_argument("--next", dest="next_addr", default="",
                   help="forward Hop to this endpoint (tcp://host:port)")
    p.add_argument("--rpcz-dir", default="",
                   help="enable rpcz + persist spans here")
    args = p.parse_args(argv)

    from brpc_tpu_torch.butil.flags import set_flag
    if args.rpcz_dir:
        set_flag("rpcz_enabled", True)
        set_flag("rpcz_dir", args.rpcz_dir)

    from brpc_tpu_torch.rpc import Channel, Server, ServerOptions, Service
    from brpc_tpu_torch.rpc.span import global_store

    next_ch = Channel(args.next_addr) if args.next_addr else None
    svc = Service("Chain")

    def hop(cntl, request):
        if next_ch is None:
            return b"leaf:" + bytes(request)
        r = next_ch.call_sync("Chain", "Hop", bytes(request))
        if r.failed():
            cntl.set_failed(r.error_code, r.error_text)
            return b""
        return b"hop:" + r.response

    svc.register_method("Hop", hop)
    server = Server(ServerOptions(enable_builtin_services=False))
    server.add_service(svc)
    ep = server.start(f"tcp://127.0.0.1:{args.port}")
    print(f"PORT {ep.port}", flush=True)
    try:
        server.run_until_asked_to_quit()
    finally:
        if next_ch is not None:
            next_ch.close()
        global_store.flush()   # the spans are this tool's product
    return 0


if __name__ == "__main__":
    sys.exit(main())
