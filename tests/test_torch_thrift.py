"""Framed thrift of the port (``protocol/thrift.py`` on
``transport/pipelined.py``) against brpc_tpu's, on the CPU.

- The TBinary codec: the cases of tests/test_thrift.py (scalars,
  containers, a message, garbage, the depth cap) give the same bytes and
  the same reads in both packages, and so do 300 structs made from a
  seed (nested structs, lists, sets, maps of every scalar type); random
  and cut frames are refused by both readers alike.
- Clients and servers: the cases of tests/test_thrift.py (echo, add,
  void, an exception reply, a handler crash, an unknown method, oneway,
  async handlers pipelined from 8 threads, ``call_async`` from more
  fibers than workers, no thrift_service) port to port on tcp:// and
  mem://, the port's client to brpc_tpu's server and brpc_tpu's client
  to the port's server; a thrift call shares its port with tpu_std.
- A server with ``auth_token`` refuses a thrift call, both packages'
  clients, with no handler run and ``server_auth_refused`` counted,
  where brpc_tpu's server runs it (ROADMAP section 3).
- The leak check fails a case that leaves a ``PipelinedClient``'s
  socket open.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import struct
import threading

import numpy as np
import pytest

from brpc_tpu.fiber import sleep as ref_sleep
from brpc_tpu.protocol import thrift as ref_th
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions

import brpc_tpu_torch.fiber as port_fiber
from brpc_tpu_torch.protocol import thrift as th
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                ServerOptions, Service)
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.rpc import server as port_server_mod
from brpc_tpu_torch.transport import pipelined

from test_torch_cluster import _run_cases

SEED = 20261018
_SCALARS = (th.T_BOOL, th.T_BYTE, th.T_I16, th.T_I32, th.T_I64, th.T_DOUBLE,
            th.T_STRING)


# ------------------------------------------------------------------ codec

def _value(rng, ttype, mod, depth):
    if ttype == th.T_BOOL:
        return bool(rng.integers(2))
    if ttype == th.T_BYTE:
        return int(rng.integers(-128, 128))
    if ttype == th.T_I16:
        return int(rng.integers(-(1 << 15), 1 << 15))
    if ttype == th.T_I32:
        return int(rng.integers(-(1 << 31), 1 << 31))
    if ttype == th.T_I64:
        return int(rng.integers(-(1 << 62), 1 << 62))
    if ttype == th.T_DOUBLE:
        return float(rng.standard_normal())
    if ttype == th.T_STRING:
        return rng.bytes(int(rng.integers(0, 20)))
    if ttype == th.T_STRUCT:
        return _struct(rng, mod, depth + 1)
    if ttype in (th.T_LIST, th.T_SET):
        et = int(rng.choice(_SCALARS))
        return mod.TList(et, [_value(rng, et, mod, depth)
                              for _ in range(int(rng.integers(0, 5)))])
    kt = int(rng.choice((th.T_I32, th.T_I64, th.T_STRING)))
    vt = int(rng.choice(_SCALARS))
    return mod.TMap(kt, vt, {_value(rng, kt, mod, depth):
                             _value(rng, vt, mod, depth)
                             for _ in range(int(rng.integers(0, 4)))})


def _struct(rng, mod, depth=0):
    kinds = _SCALARS + ((th.T_STRUCT, th.T_LIST, th.T_SET, th.T_MAP)
                        if depth < 3 else ())
    out = {}
    for fid in rng.choice(200, size=int(rng.integers(0, 6)), replace=False):
        t = int(rng.choice(kinds))
        out[int(fid) + 1] = mod.TVal(t, _value(rng, t, mod, depth))
    return out


def _same_struct(mine, ref):
    """A port struct read against brpc_tpu's (the NamedTuples differ)."""
    assert set(mine) == set(ref)
    for fid in mine:
        assert mine[fid].ttype == ref[fid].ttype
        _same_value(mine[fid].value, ref[fid].value)


def _same_value(a, b):
    if isinstance(a, dict):
        _same_struct(a, b)
    elif isinstance(a, th.TList):
        assert a.elem_ttype == b.elem_ttype and len(a.values) == \
            len(b.values)
        for x, y in zip(a.values, b.values):
            _same_value(x, y)
    elif isinstance(a, th.TMap):
        assert (a.key_ttype, a.val_ttype) == (b.key_ttype, b.val_ttype)
        assert list(a.items) == list(b.items)
        for k in a.items:
            _same_value(a.items[k], b.items[k])
    else:
        assert a == b or (a != a and b != b)


def _write(mod, fields):
    w = mod.TBinaryWriter()
    w.write_struct(fields)
    return w.bytes()


def case_codec():
    # tests/test_thrift.py's inputs
    scalars = {1: (th.T_BOOL, True), 2: (th.T_BYTE, -3), 3: (th.T_I16, 1234),
               4: (th.T_I32, -56789), 5: (th.T_I64, 1 << 40),
               6: (th.T_DOUBLE, 2.5), 7: (th.T_STRING, b"hello")}
    for mod_a, mod_b in ((th, ref_th), (ref_th, th)):
        fields = {k: mod_a.TVal(*v) for k, v in scalars.items()}
        ref_fields = {k: mod_b.TVal(*v) for k, v in scalars.items()}
        assert _write(mod_a, fields) == _write(mod_b, ref_fields)
        assert mod_a.TBinaryReader(_write(mod_b, ref_fields)).read_struct() \
            == fields
    containers = {
        1: th.TVal(th.T_LIST, th.TList(th.T_I32, [1, 2, 3])),
        2: th.TVal(th.T_MAP, th.TMap(th.T_STRING, th.T_I64,
                                     {b"a": 1, b"b": 2})),
        3: th.TVal(th.T_STRUCT, {1: th.TVal(th.T_STRING, b"nested")}),
        4: th.TVal(th.T_SET, th.TList(th.T_BYTE, [7, 8]))}
    ref_containers = {
        1: ref_th.TVal(th.T_LIST, ref_th.TList(th.T_I32, [1, 2, 3])),
        2: ref_th.TVal(th.T_MAP, ref_th.TMap(th.T_STRING, th.T_I64,
                                             {b"a": 1, b"b": 2})),
        3: ref_th.TVal(th.T_STRUCT, {1: ref_th.TVal(th.T_STRING,
                                                    b"nested")}),
        4: ref_th.TVal(th.T_SET, ref_th.TList(th.T_BYTE, [7, 8]))}
    wire = _write(th, containers)
    assert wire == _write(ref_th, ref_containers)
    _same_struct(th.TBinaryReader(wire).read_struct(),
                 ref_th.TBinaryReader(wire).read_struct())
    msg = th.pack_message("Echo", th.MSG_CALL, 77,
                          {1: th.TVal(th.T_STRING, b"payload")})
    assert msg == ref_th.pack_message(
        "Echo", th.MSG_CALL, 77, {1: ref_th.TVal(th.T_STRING, b"payload")})
    assert struct.unpack(">I", msg[:4])[0] == len(msg) - 4
    m = th.unpack_message(msg[4:])
    assert (m.method, m.msg_type, m.seqid) == ("Echo", th.MSG_CALL, 77)
    for bad in (b"\x00\x00\x00\x00nope",):
        with pytest.raises(th.BadWire):
            th.unpack_message(bad)
        with pytest.raises(ref_th._BadWire):
            ref_th.unpack_message(bad)
    deep = (b"\x0c\x00\x01" * 100) + b"\x00" * 101
    with pytest.raises(th.BadWire, match="deep"):
        th.TBinaryReader(deep).read_struct()
    with pytest.raises(ref_th._BadWire, match="deep"):
        ref_th.TBinaryReader(deep).read_struct()
    # seeded structs: the same bytes from both writers, the same reads;
    # cut and flipped frames refused alike
    rng = np.random.default_rng(SEED)
    for i in range(300):
        state = rng.bit_generator.state
        mine = _struct(rng, th)
        rng.bit_generator.state = state
        ref = _struct(rng, ref_th)
        wire = th.pack_message(f"M{i}", th.MSG_REPLY, i, mine)
        assert wire == ref_th.pack_message(f"M{i}", th.MSG_REPLY, i, ref)
        got = th.unpack_message(wire[4:])
        want = ref_th.unpack_message(wire[4:])
        assert (got.method, got.msg_type, got.seqid) == \
            (want.method, want.msg_type, want.seqid)
        _same_struct(got.fields, want.fields)
        junk = bytearray(wire[4:])
        junk = bytes(junk[:int(rng.integers(0, len(junk)))])
        if rng.random() < 0.5 and junk:
            pos = int(rng.integers(len(junk)))
            junk = junk[:pos] + bytes([junk[pos] ^ 0xFF]) + junk[pos + 1:]
        outcomes = []
        for mod, err in ((th, th.BadWire), (ref_th, ref_th._BadWire)):
            try:
                outcomes.append(repr(mod.unpack_message(junk)[:3]))
            except err:
                outcomes.append("refused")
        assert outcomes[0] == outcomes[1], (i, outcomes)


# ------------------------------------------------------------------- e2e

def make_service(mod, sleep):
    svc = mod.ThriftService()
    svc.seen_oneway = threading.Event()
    svc.calls = []

    @svc.method("Echo")
    def echo(sock, args):
        svc.calls.append("Echo")
        return {0: mod.TVal(th.T_STRING, args[1].value)}

    @svc.method("Add")
    def add(sock, args):
        return mod.TVal(th.T_I64, args[1].value + args[2].value)

    @svc.method("Void")
    def void(sock, args):
        return None

    @svc.method("Fail")
    def fail(sock, args):
        raise mod.ThriftError("deliberate failure", 6)

    @svc.method("Crash")
    def crash(sock, args):
        raise RuntimeError("oops")

    @svc.method("Notify")
    def notify(sock, args):
        svc.seen_oneway.set()

    @svc.method("SlowEcho")
    async def slow(sock, args):
        await sleep(0.005)
        return {0: args[1]}

    return svc


def _server(kind, address="tcp://127.0.0.1:0", **opts):
    if kind == "port":
        svc = make_service(th, port_fiber.sleep)
        bench = Service("Bench")
        bench.register_method("Echo", lambda cntl, req: bytes(req))
        srv = Server(ServerOptions(thrift_service=svc, **opts))
        srv.add_service(bench)
    else:
        svc = make_service(ref_th, ref_sleep)
        srv = RefServer(RefServerOptions(thrift_service=svc, **opts))
    ep = srv.start(address)
    return srv, svc, ep


def _calls(c, mod, svc, fiber_mod, countdown):
    tv = mod.TVal
    assert c.call("Echo", {1: tv(th.T_STRING, b"ping")})[0].value == b"ping"
    out = c.call("Add", {1: tv(th.T_I64, 40), 2: tv(th.T_I64, 2)})
    assert out[0].value == 42
    assert c.call("Void") == {}
    for method, match, etype in (("Fail", "deliberate", 6),
                                 ("Crash", "handler error", 6),
                                 ("Nope", "unknown method", 1)):
        with pytest.raises(Exception, match=match) as ei:
            c.call(method)
        assert ei.value.type == etype
    c.call_oneway("Notify")
    assert svc.seen_oneway.wait(5)
    assert c.call("Echo", {1: tv(th.T_STRING, b"x")})[0].value == b"x"
    outs, errs = [], []

    def worker(i):
        try:
            out = c.call("SlowEcho", {1: tv(th.T_STRING, f"m{i}".encode())})
            outs.append((i, out[0].value))
        except Exception as e:      # pragma: no cover
            errs.append(e)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not errs and sorted(outs) == [(i, f"m{i}".encode())
                                         for i in range(8)]
    n = fiber_mod.global_control().concurrency + 8
    done = countdown(n)
    bad = []

    async def one(i):
        try:
            out = await c.call_async("Add", {1: tv(th.T_I64, i),
                                             2: tv(th.T_I64, 100)})
            if out[0].value != i + 100:
                bad.append(i)
        except Exception as e:  # noqa: BLE001
            bad.append((i, str(e)))
        finally:
            done.signal()
    for i in range(n):
        fiber_mod.spawn(one, i)
    assert done.wait_pthread(30) and not bad, bad[:3]


def case_e2e(client_kind, server_kind, scheme):
    address = "mem://port-thrift-e2e" if scheme == "mem" \
        else "tcp://127.0.0.1:0"
    srv, svc, ep = _server(server_kind, address)
    try:
        if client_kind == "port":
            c = th.ThriftClient(ep if scheme == "mem" else
                                f"127.0.0.1:{ep.port}")
            mod, fib = th, port_fiber
            from brpc_tpu_torch.fiber.sync import CountdownEvent as cd
        else:
            import brpc_tpu.fiber as fib
            from brpc_tpu.fiber.sync import CountdownEvent as cd
            c = ref_th.ThriftClient(f"127.0.0.1:{ep.port}")
            mod = ref_th
        try:
            _calls(c, mod, svc, fib, cd)
        finally:
            c.close()
        if server_kind == "port" and scheme == "tcp":
            # tpu_std on the same port
            ch = Channel(f"tcp://127.0.0.1:{ep.port}",
                         ChannelOptions(share_connections=False))
            try:
                assert ch.call_sync("Bench", "Echo", b"both").response == \
                    b"both"
            finally:
                ch.close()
            assert srv.method_status["thrift.Echo"].count() >= 2
    finally:
        srv.stop()
        srv.join(5)


def case_no_thrift_service():
    srv = Server(ServerOptions())
    ep = srv.start("mem://port-thrift-none")
    c = th.ThriftClient(ep)
    try:
        with pytest.raises(th.ThriftError, match="no thrift_service"):
            c.call("Echo")
    finally:
        c.close()
        srv.stop()
        srv.join(2)


def case_auth_refuses_thrift():
    before = port_server_mod.nauth_refused.get_value()
    srv, svc, ep = _server("port", auth_token="secret")
    try:
        for c in (th.ThriftClient(f"127.0.0.1:{ep.port}"),
                  ref_th.ThriftClient(f"127.0.0.1:{ep.port}")):
            try:
                with pytest.raises(Exception, match="credential"):
                    c.call("Echo", {1: th.TVal(th.T_STRING, b"no")})
            finally:
                c.close()
        assert svc.calls == []
        assert port_server_mod.nauth_refused.get_value() == before + 2
        # tpu_std on the same port: the token opens it, its absence not
        for token, code in (("secret", 0), ("", berr.ERPCAUTH)):
            ch = Channel(f"tcp://127.0.0.1:{ep.port}", ChannelOptions(
                auth_token=token, share_connections=False))
            try:
                assert ch.call_sync("Bench", "Echo", b"x").error_code == code
            finally:
                ch.close()
    finally:
        srv.stop()
        srv.join(5)
    # brpc_tpu's server runs the call: the gap the port does not copy
    rsrv, rsvc, rep = _server("ref", auth_token="secret")
    try:
        c = ref_th.ThriftClient(f"127.0.0.1:{rep.port}")
        try:
            assert c.call("Echo", {1: ref_th.TVal(th.T_STRING, b"in")})[0] \
                .value == b"in"
        finally:
            c.close()
        assert rsvc.calls == ["Echo"]
    finally:
        rsrv.stop()
        rsrv.join(5)


def case_leak_check_sees_a_client():
    """A case that leaves a PipelinedClient's socket open fails
    ``_run_cases``, on mem:// too, where no fd is registered; closing it
    passes."""
    srv, _, ep = _server("port", "mem://port-thrift-leak")
    try:
        left = []

        def leaky():
            c = th.ThriftClient(ep)
            c.call("Void")
            left.append(c)
        with pytest.raises(AssertionError, match="pipelined"):
            _run_cases([("leaky", leaky, ())], limit_s=20.0)
        assert pipelined.live_sockets() == 1
        left[0].close()
        assert pipelined.live_sockets() == 0
    finally:
        srv.stop()
        srv.join(5)


CASES = ([("codec against brpc_tpu's", case_codec, ())]
         + [(f"e2e {c} client, {s} server, {sch}", case_e2e, (c, s, sch))
            for c, s, sch in (("port", "port", "tcp"),
                              ("port", "port", "mem"),
                              ("port", "ref", "tcp"),
                              ("ref", "port", "tcp"))]
         + [("no thrift_service", case_no_thrift_service, ()),
            ("an auth server refuses thrift", case_auth_refuses_thrift, ()),
            ("the leak check sees a client", case_leak_check_sees_a_client,
             ())])


def test_thrift():
    _run_cases(CASES, limit_s=60.0)
