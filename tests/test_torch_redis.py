"""Redis's RESP2 in the port (``protocol/redis.py`` on
``transport/pipelined.py``) against brpc_tpu's, on the CPU.

- The codec: the cases of tests/test_redis.py (commands, replies of every
  type, round trips, every cut of a reply, inline commands, bad wire,
  bools, the nesting cap) give the same bytes and the same parses in both
  packages, and so do 300 replies and commands made from a seed; random
  and cut byte strings are read alike (a value, more bytes wanted, or
  refused).
- Clients and servers: the cases of tests/test_redis.py (SET/GET, INCR,
  a pipeline with error replies in place, the default PING, an unknown
  command, a handler error, an async handler, a 1,000-command pipeline in
  FIFO order, concurrent clients, 8 threads on one shared client,
  ``execute_async`` from more fibers than workers, no redis_service)
  port to port on mem:// and tcp://, the port's client to brpc_tpu's
  server and brpc_tpu's client to the port's server; RESP shares its port
  with tpu_std and thrift.
- Inline commands only on a connection that spoke RESP; AUTH is the
  service's own command (``ServerOptions.auth`` does not gate RESP, as in
  brpc_tpu); a corrupt stream fails the connection and the server serves
  on.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import socket as pysocket
import threading
import time

import numpy as np
import pytest

import brpc_tpu.fiber as ref_fiber
from brpc_tpu.fiber.sync import CountdownEvent as RefCountdown
from brpc_tpu.protocol import redis as ref_r
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions

import brpc_tpu_torch.fiber as port_fiber
from brpc_tpu_torch.fiber.sync import CountdownEvent
from brpc_tpu_torch.protocol import redis as r
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                ServerOptions, Service)

from test_torch_cluster import _run_cases

SEED = 20261018


# ------------------------------------------------------------------ codec

def _outcome(mod, data, inline_ok=False):
    """What ``parse_value`` makes of ``data``, comparable across the two
    packages."""
    try:
        v, used = mod.parse_value(data, 0, inline_ok=inline_ok)
    except mod._NeedMore:
        return "more"
    except (r.BadWire if mod is r else ref_r._BadWire):
        return "bad"
    return _plain(v), used


def _plain(v):
    if isinstance(v, (r.RedisError, ref_r.RedisError)):
        return ("error", v.args)
    if isinstance(v, (r.RedisStatus, ref_r.RedisStatus)):
        return ("status", str(v))
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


def _reply(rng, mod, depth=0):
    k = int(rng.integers(0, 7 if depth < 3 else 5))
    if k == 0:
        return mod.RedisStatus("OK" if rng.random() < .5 else "PONG")
    if k == 1:
        return mod.RedisError(f"ERR e{int(rng.integers(100))}")
    if k == 2:
        return int(rng.integers(-(1 << 40), 1 << 40))
    if k == 3:
        return None
    if k == 4:
        return rng.bytes(int(rng.integers(0, 40)))
    return [_reply(rng, mod, depth + 1)
            for _ in range(int(rng.integers(0, 5)))]


def case_codec():
    for mod in (r, ref_r):
        assert mod.encode_command(["SET", "k", 1]) == \
            b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$1\r\n1\r\n"
        assert mod.encode_command([b"PING"]) == b"*1\r\n$4\r\nPING\r\n"
        assert mod.encode_command(["X", True, False]) == \
            b"*3\r\n$1\r\nX\r\n$1\r\n1\r\n$1\r\n0\r\n"
        assert mod.encode_reply(mod.RedisStatus("OK")) == b"+OK\r\n"
        assert mod.encode_reply(mod.RedisError("ERR nope")) == \
            b"-ERR nope\r\n"
        assert mod.encode_reply(7) == b":7\r\n"
        assert mod.encode_reply(None) == b"$-1\r\n"
        assert mod.encode_reply(b"hi") == mod.encode_reply("hi") == \
            b"$2\r\nhi\r\n"
        assert mod.encode_reply([1, b"a", None]) == \
            b"*3\r\n:1\r\n$1\r\na\r\n$-1\r\n"
        for v in [mod.RedisStatus("OK"), 42, None, b"payload",
                  [1, 2, b"three", None, [b"nested"]]]:
            data = mod.encode_reply(v)
            assert mod.parse_value(data, 0) == (v, len(data))
        full = mod.encode_reply([b"abc", 5])
        for cut in range(len(full)):
            assert _outcome(mod, full[:cut]) == "more"
        assert mod.parse_value(b"SET key value\r\n", 0, inline_ok=True) == \
            ([b"SET", b"key", b"value"], 15)
        for bad in [b"SET key\r\n", b"$x\r\n", b":notint\r\n",
                    b"*2\r\n:1\r\n$abc\r\n", b"$3\r\nabcd\r\n",
                    b"*1\r\n" * 200]:
            assert _outcome(mod, bad) == "bad", bad[:20]
    e, _ = r.parse_value(b"-ERR boom\r\n", 0)
    assert isinstance(e, r.RedisError) and e.args == ("ERR boom",)
    rng = np.random.default_rng(SEED)
    for i in range(300):
        state = rng.bit_generator.state
        mine = _reply(rng, r)
        rng.bit_generator.state = state
        ref = _reply(rng, ref_r)
        wire = r.encode_reply(mine)
        assert wire == ref_r.encode_reply(ref)
        assert _outcome(r, wire) == _outcome(ref_r, wire) == \
            (_plain(mine), len(wire))
        args = [rng.bytes(int(rng.integers(0, 10)))
                for _ in range(int(rng.integers(1, 5)))]
        assert r.encode_command(args) == ref_r.encode_command(args)
        # cut or flipped: read alike
        junk = wire[:int(rng.integers(0, len(wire) + 1))]
        if junk and rng.random() < 0.5:
            pos = int(rng.integers(len(junk)))
            junk = junk[:pos] + bytes([int(rng.integers(256))]) + \
                junk[pos + 1:]
        inline = bool(rng.integers(2))
        assert _outcome(r, junk, inline) == _outcome(ref_r, junk, inline), \
            (i, junk)


# ------------------------------------------------------------------- e2e

def make_kv_service(mod, sleep):
    svc = mod.RedisService()
    store = {}
    lock = threading.Lock()

    @svc.command("SET")
    def set_(sock, args):
        if len(args) != 3:
            return mod.RedisError("ERR wrong number of arguments for 'set'")
        with lock:
            store[args[1]] = args[2]
        return mod.RedisStatus("OK")

    @svc.command("GET")
    def get(sock, args):
        with lock:
            return store.get(args[1])

    @svc.command("INCR")
    def incr(sock, args):
        with lock:
            v = int(store.get(args[1], b"0")) + 1
            store[args[1]] = str(v).encode()
        return v

    @svc.command("BOOM")
    def boom(sock, args):
        raise RuntimeError("kaput")

    @svc.command("SLOWECHO")
    async def slowecho(sock, args):
        await sleep(0.005)
        return args[1]

    @svc.command("AUTH")
    def auth(sock, args):
        if args[1:] == [b"pw"]:
            return mod.RedisStatus("OK")
        return mod.RedisError("ERR invalid password")

    return svc


def _server(kind, address, **opts):
    if kind == "port":
        srv = Server(ServerOptions(
            redis_service=make_kv_service(r, port_fiber.sleep), **opts))
        bench = Service("Bench")
        bench.register_method("Echo", lambda cntl, req: bytes(req))
        srv.add_service(bench)
    else:
        srv = RefServer(RefServerOptions(
            redis_service=make_kv_service(ref_r, ref_fiber.sleep), **opts))
    return srv, srv.start(address)


def _calls(mod, make_client, fiber_mod, countdown):
    c = make_client()
    try:
        assert c.execute("SET", "k", "v") == "OK"
        assert c.execute("GET", "k") == b"v"
        assert c.execute("GET", "missing") is None
        assert c.execute("SLOWECHO", "deferred") == b"deferred"
        assert [c.execute("INCR", "n") for _ in range(3)] == [1, 2, 3]
        out = c.pipeline([["SET", "a", "1"], ["SET", "only-two"], ["GET", "a"],
                          ["BOOM"], ["PING"]])
        assert out[0] == "OK" and out[2] == b"1" and out[4] == "PONG"
        assert isinstance(out[1], mod.RedisError)
        assert isinstance(out[3], mod.RedisError) and "kaput" in \
            out[3].args[0]
        with pytest.raises(mod.RedisError, match="unknown command"):
            c.execute("NOPE")
        with pytest.raises(mod.RedisError, match="kaput"):
            c.execute("BOOM")
        n = 1000
        out = c.pipeline([["SET", f"p{i}", i] if i % 2 == 0
                          else ["GET", f"p{i - 1}"] for i in range(n)])
        assert out == [("OK" if i % 2 == 0 else str(i - 1).encode())
                       for i in range(n)]
        errs = []

        def own(i):
            try:
                cc = make_client()
                try:
                    for _ in range(50):
                        cc.execute("INCR", f"t{i}")
                    assert cc.execute("GET", f"t{i}") == b"50"
                finally:
                    cc.close()
            except Exception as e:      # pragma: no cover
                errs.append(e)

        def shared(i):
            try:
                for _ in range(50):
                    assert c.execute("SLOWECHO", f"v{i}") == f"v{i}".encode()
            except Exception as e:      # pragma: no cover
                errs.append(e)
        threads = [threading.Thread(target=own, args=(i,)) for i in range(4)]
        threads += [threading.Thread(target=shared, args=(i,))
                    for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs, errs[:2]
        nf = fiber_mod.global_control().concurrency + 8
        done = countdown(nf)
        bad = []

        async def one(i):
            try:
                if await c.execute_async("SET", f"ak{i}", f"av{i}") != "OK":
                    bad.append(i)
                elif await c.execute_async("GET", f"ak{i}") != \
                        f"av{i}".encode():
                    bad.append(i)
            except Exception as e:  # noqa: BLE001
                bad.append((i, str(e)))
            finally:
                done.signal()
        for i in range(nf):
            fiber_mod.spawn(one, i)
        assert done.wait_pthread(30) and not bad, bad[:3]
    finally:
        c.close()


def case_e2e(client_kind, server_kind, scheme):
    address = "mem://port-redis-e2e" if scheme == "mem" \
        else "tcp://127.0.0.1:0"
    srv, ep = _server(server_kind, address)
    target = ep if scheme == "mem" else f"127.0.0.1:{ep.port}"
    try:
        if client_kind == "port":
            _calls(r, lambda: r.RedisClient(target), port_fiber,
                   CountdownEvent)
        else:
            _calls(ref_r, lambda: ref_r.RedisClient(f"127.0.0.1:{ep.port}"),
                   ref_fiber, RefCountdown)
        if server_kind == "port":
            assert srv.method_status["redis.SET"].count() > 500
    finally:
        srv.stop()
        srv.join(5)


def case_no_redis_service():
    srv = Server(ServerOptions())
    ep = srv.start("mem://port-redis-none")
    c = r.RedisClient(ep)
    try:
        with pytest.raises(r.RedisError, match="no redis_service"):
            c.execute("GET", "k")
    finally:
        c.close()
        srv.stop()
        srv.join(2)


def _raw(port, data, want=None):
    """Send ``data`` on a fresh connection; (the bytes read, whether the
    server closed it) once ``want`` bytes came, or the close, or 5 s."""
    s = pysocket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        s.sendall(data)
        got = b""
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and \
                (want is None or len(got) < len(want)):
            try:
                chunk = s.recv(4096)
            except pysocket.timeout:
                break
            if not chunk:
                return got, True
            got += chunk
        return got, False
    finally:
        s.close()


def case_wire_rules():
    srv, ep = _server("port", "tcp://127.0.0.1:0", auth_token="secret")
    try:
        # an inline command once the connection spoke RESP; a first inline
        # line is no protocol's, and the connection drops once it is past
        # nshead's 28-byte probe (a shorter one waits, as in brpc_tpu)
        pong2 = b"+PONG\r\n+PONG\r\n"
        assert _raw(ep.port, b"*1\r\n$4\r\nPING\r\nPING\r\n", pong2) == \
            (pong2, False)
        assert _raw(ep.port, b"PING now please, and the rest\r\n") == \
            (b"", True)
        # AUTH is the service's command; ServerOptions.auth leaves RESP
        with r.RedisClient(f"127.0.0.1:{ep.port}", password="pw") as c:
            assert c.execute("SET", "x", "1") == "OK"
        with pytest.raises(r.RedisError, match="invalid password"):
            r.RedisClient(f"127.0.0.1:{ep.port}", password="bad") \
                .execute("GET", "x")
        # a corrupt stream fails its connection, the commands of its read
        # with it (as in brpc_tpu), and the server serves on
        assert _raw(ep.port, b"*1\r\n$4\r\nPING\r\n$x\r\n") == \
            (b"", True)
        assert _raw(ep.port, b"*1\r\n" * 200) == (b"", True)
        with r.RedisClient(f"127.0.0.1:{ep.port}") as c:
            assert c.execute("GET", "x") == b"1"
        # RESP and tpu_std on one port
        ch = Channel(f"tcp://127.0.0.1:{ep.port}", ChannelOptions(
            auth_token="secret", share_connections=False))
        try:
            assert ch.call_sync("Bench", "Echo", b"t").response == b"t"
        finally:
            ch.close()
    finally:
        srv.stop()
        srv.join(5)


CASES = ([("codec against brpc_tpu's", case_codec, ())]
         + [(f"e2e {c} client, {s} server, {sch}", case_e2e, (c, s, sch))
            for c, s, sch in (("port", "port", "mem"),
                              ("port", "port", "tcp"),
                              ("port", "ref", "tcp"),
                              ("ref", "port", "tcp"))]
         + [("no redis_service", case_no_redis_service, ()),
            ("inline, AUTH, corruption", case_wire_rules, ())])


def test_redis():
    _run_cases(CASES, limit_s=60.0)
