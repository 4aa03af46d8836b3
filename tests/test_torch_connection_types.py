"""Connection types and the global socket map of the port's Channel
(``ChannelOptions.connection_type``, ``share_connections``,
``transport/socket_map.py``) against brpc_tpu's, on the CPU.

Each case runs the same calls four ways: port Channel -> port Server,
brpc_tpu -> brpc_tpu, and both ways across the wire, and wants the same
counts from all four: the connections the server accepted (the client
endpoints its handler saw), those open at each step, whether two
channels hold one socket, and the pooled channel's freelist.

- ``single`` with sharing (the default): two channels, one connection;
  the first ``close`` keeps it for the other, the last closes it.
- ``share_connections=False``: a connection a channel.
- A failed shared socket is replaced at the next call.
- The credential is in the key: channels with one token share, a
  channel with another token dials its own.
- ``pooled``: 4 overlapping calls open 4 connections, the next 4 reuse
  them, sequential calls reuse one; a call that completes after
  ``close`` closes its connection instead of refilling the pool.
- ``short``: a connection a call, closed when the call completes.
- The sticky pause: a sync socket left with reads off sees the server's
  close before it is reused, so a ``max_retry=0`` call after it still
  succeeds on a new connection.

The port alone (brpc_tpu keeps the fault, ROADMAP section 3):

- A credential's connection is not handed to another credential that
  got a freed one's ``id``, and a channel collected without ``close``
  gives its lease back: in 50 loops, a channel with the right token
  makes a call and is dropped and collected, then a channel with a
  wrong token makes one, which must fail with ERPCAUTH every time.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py, which also fails a case that leaves a lease on a
shared connection).
"""

import gc
import time

import brpc_tpu.fiber as ref_fiber
import brpc_tpu.rpc as ref_rpc

import brpc_tpu_torch.fiber as port_fiber
import brpc_tpu_torch.rpc as port_rpc

from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.transport.socket_map import global_socket_map

from test_torch_cluster import _run_cases, _wait_for

WIRINGS = (("port", "port"), ("ref", "ref"), ("port", "ref"),
           ("ref", "port"))


class _Server:
    """A server whose ``Svc.Who`` echoes and notes the client endpoint;
    ``b"slow"`` answers after 0.3 s without holding a worker."""

    def __init__(self, kind):
        self.kind, self.seen = kind, set()
        rpc = port_rpc if kind == "port" else ref_rpc
        fiber = port_fiber if kind == "port" else ref_fiber
        seen = self.seen

        async def Who(cntl, request):
            seen.add(str(cntl.remote_side))
            if bytes(request) == b"slow":
                await fiber.sleep(0.3)
            return bytes(request)

        svc = rpc.Service("Svc")
        svc.method()(Who)
        if kind == "port":
            self.srv = rpc.Server()
        else:
            self.srv = rpc.Server(rpc.ServerOptions(
                enable_builtin_services=False))
        self.srv.add_service(svc)
        ep = self.srv.start("tcp://127.0.0.1:0")
        self.addr = f"tcp://127.0.0.1:{ep.port}"

    def live(self) -> int:
        return sum(1 for s in self.srv.connections() if not s.failed)

    def close(self):
        self.srv.stop()
        self.srv.join(5)


class _Client:
    def __init__(self, kind):
        self.kind = kind
        self.rpc = port_rpc if kind == "port" else ref_rpc
        self.chans = []

    def channel(self, addr, **opts):
        ch = self.rpc.Channel(addr, self.rpc.ChannelOptions(
            timeout_ms=5000, **opts))
        self.chans.append(ch)
        return ch

    def body(self, c) -> bytes:
        if c.failed():
            raise AssertionError(f"{c.error_code}: {c.error_text}")
        if self.kind == "port":
            return bytes(c.response)
        return c.response_payload.to_bytes()

    def call(self, ch, req=b"x") -> bytes:
        return self.body(ch.call_sync("Svc", "Who", req))

    def close(self):
        for ch in self.chans:
            ch.close()


def _shared(cli, srv) -> dict:
    a, b = cli.channel(srv.addr), cli.channel(srv.addr)
    cli.call(a, b"one")
    cli.call(b, b"two")
    s = a._socket
    out = {"same": s is b._socket, "live": srv.live()}
    a.close()
    out["kept_after_first_close"] = not s.failed
    out["answers_after_first_close"] = cli.call(b, b"still") == b"still"
    b.close()
    out["closed_with_last"] = _wait_for(lambda: s.failed)
    out["live_at_end"] = srv.live() if _wait_for(
        lambda: srv.live() == 0) else srv.live()
    out["accepted"] = len(srv.seen)
    return out


def _opt_out(cli, srv) -> dict:
    a = cli.channel(srv.addr, share_connections=False)
    b = cli.channel(srv.addr, share_connections=False)
    cli.call(a)
    cli.call(b)
    return {"same": a._socket is b._socket, "live": srv.live(),
            "accepted": len(srv.seen)}


def _replaced(cli, srv) -> dict:
    ch = cli.channel(srv.addr)
    cli.call(ch)
    old = ch._socket
    old.set_failed(ConnectionError("induced"))
    ok = cli.call(ch, b"after") == b"after"
    return {"answers": ok, "new_socket": ch._socket is not old,
            "accepted": len(srv.seen)}


def _credential(cli, srv) -> dict:
    a1 = cli.channel(srv.addr, auth_token="tok-a")
    a2 = cli.channel(srv.addr, auth_token="tok-a")
    b = cli.channel(srv.addr, auth_token="tok-b")
    for ch in (a1, a2, b):
        cli.call(ch)
    return {"same_token_shares": a1._socket is a2._socket,
            "other_token_apart": a1._socket is not b._socket,
            "accepted": len(srv.seen)}


def _overlapping(cli, ch, n) -> list:
    cntls = [ch.call("Svc", "Who", b"slow") for _ in range(n)]
    for c in cntls:
        c.join(10)
    return [cli.body(c) for c in cntls]


def _pooled(cli, srv) -> dict:
    ch = cli.channel(srv.addr, connection_type="pooled")
    out = {"first_four": _overlapping(cli, ch, 4) == [b"slow"] * 4,
           "accepted_after_4": len(srv.seen)}
    out["pool_after_4"] = len(ch._conn_pool)
    _overlapping(cli, ch, 4)
    out["accepted_after_8"] = len(srv.seen)
    for _ in range(4):
        cli.call(ch)
    out["accepted_after_12"] = len(srv.seen)
    out["pool_after_12"] = len(ch._conn_pool)
    late = ch.call("Svc", "Who", b"slow")
    time.sleep(0.05)
    ch.close()
    late.join(10)
    out["late_answer"] = cli.body(late)
    out["pool_after_close"] = len(ch._conn_pool)
    out["all_closed"] = _wait_for(lambda: srv.live() == 0)
    return out


def _short(cli, srv) -> dict:
    ch = cli.channel(srv.addr, connection_type="short")
    for i in range(3):
        cli.call(ch, b"%d" % i)
    return {"accepted": len(srv.seen),
            "all_closed": _wait_for(lambda: srv.live() == 0)}


def _against_reference(scenario):
    def run():
        got = {}
        for ck, sk in WIRINGS:
            srv, cli = _Server(sk), _Client(ck)
            try:
                got[(ck, sk)] = scenario(cli, srv)
            finally:
                cli.close()
                srv.close()
        want = got[("ref", "ref")]
        for wiring, counts in got.items():
            assert counts == want, (wiring, counts, want)
        return want
    return run


def _peer_close_before_reuse(cli, srv) -> dict:
    """The sticky pause leaves nothing watching an idle sync socket, so
    the server's close of it must be seen before the next call is
    issued into it: with ``max_retry=0`` that call still succeeds, on a
    new connection (the probe before reuse;
    tests/test_hotpath_batching.py's sticky case, both packages)."""
    ch = cli.channel(srv.addr, max_retry=0)
    first = cli.call(ch, b"a")
    s0 = ch._get_socket()
    for s in list(srv.srv.connections()):
        s.set_failed(ConnectionError("server idle close"))
    seen = _wait_for(lambda: s0.conn.peek_closed(), 3.0)
    time.sleep(0.02)                    # past the probe's 5 ms gate
    second = cli.call(ch, b"b")
    return {"answers": (first, second), "fin_seen": seen,
            "old_failed": s0.failed, "accepted": len(srv.seen)}


def _credential_not_reused():
    """The re-anchor's reproduction of the shared-credential fault: the
    server accepts only ``alice-secret``; a collected channel's
    Authenticator may hand its ``id`` to the next one."""
    leases0 = global_socket_map().leases()

    async def Who(cntl, request):
        return cntl.auth_context.user.encode()
    svc = port_rpc.Service("Svc")
    svc.method()(Who)
    srv = port_rpc.Server(port_rpc.ServerOptions(
        auth=port_rpc.TokenAuthenticator("alice-secret", user="alice")))
    srv.add_service(svc)
    ep = srv.start("tcp://127.0.0.1:0")
    addr = f"tcp://127.0.0.1:{ep.port}"
    wrong = []
    # the collections below walk only what this case allocates: a long
    # test process's older heap would make each one take a large share
    # of a second
    gc.freeze()
    try:
        for i in range(50):
            ch = port_rpc.Channel(addr, port_rpc.ChannelOptions(
                timeout_ms=5000, max_retry=0,
                auth=port_rpc.TokenAuthenticator("alice-secret")))
            c = ch.call_sync("Svc", "Who", b"")
            assert not c.failed() and c.response == b"alice", c.error_text
            del ch, c
            gc.collect()
            ch = port_rpc.Channel(addr, port_rpc.ChannelOptions(
                timeout_ms=5000, max_retry=0,
                auth=port_rpc.TokenAuthenticator("mallory-wrong")))
            c = ch.call_sync("Svc", "Who", b"")
            if c.error_code != berr.ERPCAUTH:
                wrong.append((i, c.error_code, c.response))
            del ch, c
            gc.collect()
        assert not wrong, wrong
        assert _wait_for(lambda: global_socket_map().leases() == leases0), \
            (global_socket_map().leases(), leases0)
    finally:
        gc.unfreeze()
        srv.stop()
        srv.join(5)


CASES = [
    ("single, shared", _against_reference(_shared), ()),
    ("share_connections=False", _against_reference(_opt_out), ()),
    ("a failed socket is replaced", _against_reference(_replaced), ()),
    ("the credential in the key", _against_reference(_credential), ()),
    ("pooled: reuse and close", _against_reference(_pooled), ()),
    ("short", _against_reference(_short), ()),
    ("a sticky socket sees a peer's close before reuse",
     _against_reference(_peer_close_before_reuse), ()),
    ("a collected credential's connection is not reused",
     _credential_not_reused, ()),
]


def test_connection_types():
    _run_cases(CASES)
