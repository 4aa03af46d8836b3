"""The port's auth, compression, session data, usercode pool and
PeriodicTask against brpc_tpu's, on the CPU.

- gzip, zlib and snappy give the same bytes as
  ``brpc_tpu.rpc.compress.compress`` for the same payloads (brpc_tpu's
  snappy is its native codec here), each side decompresses the other's,
  and an unknown ``compress_type`` is an error on both. The port's pure
  snappy also equals brpc_tpu's pure one, in a process with
  ``BRPC_TPU_NO_NATIVE=1``.
- ``RpcMeta.compress_type`` (field 3) and ``RpcRequestMeta.auth_token``
  (field 5) encode as protobuf does.
- A compressed call both ways across the wire: the server sees the
  request's codec and answers in the same kind.
- Token auth and an interceptor's reject both ways, with the reference's
  error codes: a wrong credential fails ERPCAUTH, before the method
  lookup, and is not retried; the HTTP path wants the credential
  everywhere but ``/health``.
- ``PeriodicTask``'s fixed delay on an injected clock, and
  ``SimpleDataPool``'s borrow, reset and return, as brpc_tpu's.
- ``usercode_in_pthread`` runs a blocking sync handler off the fiber
  workers.

The cases run inside one collected test (``_run_cases`` of
test_torch_cluster.py), each under a time limit of its own.
"""

import gzip
import http.client
import json
import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

from brpc_tpu.butil import snappy_codec as ref_snappy
from brpc_tpu.protocol.proto import tpu_rpc_meta_pb2 as pb
from brpc_tpu.rpc import client_dispatch as ref_cd
from brpc_tpu.rpc import compress as ref_compress
from brpc_tpu.rpc import data_pool as ref_pool
from brpc_tpu.rpc import errno_codes as ref_berr
from brpc_tpu.rpc import periodic_task as ref_periodic

import brpc_tpu_torch.fiber as port_fiber
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu_torch.butil import snappy_codec as port_snappy
from brpc_tpu_torch.protocol import tpu_std as port_std
from brpc_tpu_torch.rpc import client_dispatch as port_cd
from brpc_tpu_torch.rpc import compress as port_compress
from brpc_tpu_torch.rpc import data_pool as port_pool
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.rpc import periodic_task as port_periodic

from test_torch_cluster import _b, _FakeClock, _run_cases, _Side, _wait_for

ROOT = Path(__file__).resolve().parent.parent
SEED = 20260803
CODECS = (1, 2, 3)
TOKEN = "s3cret"
PAIRS = (("port", "port"), ("port", "ref"), ("ref", "port"), ("ref", "ref"))


def _payloads():
    rng = random.Random(SEED)
    words = [b"token", b"decode", b"replica", b"\x00\x01", b"{\"prompt\": "]
    return [
        b"x",
        b"abcd",
        b"hello world " * 3,
        bytes(rng.getrandbits(8) for _ in range(5000)),
        b"".join(rng.choice(words) for _ in range(20000)),
        # matches that reach across the 64 KB fragment boundary
        bytes(rng.getrandbits(8) for _ in range(300)) * 700,
        json.dumps({"tokens": list(range(256)) * 4}).encode(),
    ]


# -------------------------------------------------------------- the codecs

def _codec_bytes():
    # gzip stamps the time into its header: one fixed time for both sides
    with mock.patch("time.time", return_value=1_700_000_000.0):
        for data in _payloads():
            for ctype in CODECS:
                mine = port_compress.compress(data, ctype)
                want = ref_compress.compress(data, ctype)
                assert mine == want, (ctype, len(data))
                assert port_compress.decompress(want, ctype) == data
                assert ref_compress.decompress(mine, ctype) == data
        assert gzip.decompress(port_compress.compress(b"zz" * 99, 1)) \
            == b"zz" * 99
    assert port_compress.compress(b"", 3) == b""
    assert port_compress.compress(b"raw", 0) == b"raw"
    for side in (port_compress, ref_compress):
        for fn in (side.compress, side.decompress):
            try:
                fn(b"data", 9)
            except ValueError as e:
                assert "unknown compress_type 9" in str(e)
            else:
                raise AssertionError("an unknown codec must raise")
    for bad in (b"\x05\x08ab", b"\x80", b"\x02\x09\x00"):
        for dec in (port_snappy.decompress, ref_snappy.decompress):
            try:
                dec(bad)
            except ValueError:
                continue
            raise AssertionError(f"{bad!r} must not decode")


def _snappy_without_native():
    """brpc_tpu's snappy with its native library off: its pure path
    gives the port's bytes too."""
    prog = (
        "import json, sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "sys.path.insert(0, sys.argv[1] + '/tests')\n"
        "from brpc_tpu import native\n"
        "from brpc_tpu.butil import snappy_codec\n"
        "from test_torch_auth_compress import _payloads\n"
        "assert native.snappy_compress(b'abcabcabc') is None\n"
        "print(json.dumps([snappy_codec.compress_auto(p).hex()\n"
        "                  for p in _payloads()]))\n")
    env = dict(os.environ, BRPC_TPU_NO_NATIVE="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", prog, str(ROOT)],
                         env=env, capture_output=True, text=True,
                         timeout=25)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    mine = [port_snappy.compress(p).hex() for p in _payloads()]
    assert mine == want


def _meta_fields():
    for ctype in CODECS:
        m = pb.RpcMeta()
        m.request.service_name = "GenerateService"
        m.request.method_name = "Generate"
        m.request.timeout_ms = 1000
        m.request.auth_token = TOKEN
        m.compress_type = ctype
        m.correlation_id = 77
        mine = port_std.RpcMeta(
            request=port_std.RpcRequestMeta(
                "GenerateService", "Generate", timeout_ms=1000,
                auth_token=TOKEN),
            compress_type=ctype, correlation_id=77)
        assert mine.encode() == m.SerializeToString()
        assert port_std.RpcMeta.decode(m.SerializeToString()) == mine
        r = pb.RpcMeta()
        r.response.error_code = 0
        r.compress_type = ctype
        r.correlation_id = 5
        mine = port_std.RpcMeta(response=port_std.RpcResponseMeta(),
                                compress_type=ctype, correlation_id=5)
        assert mine.encode() == r.SerializeToString()


# ------------------------------------------------------------- the wire

def _server(side, seen=None, **opts):
    """``Svc.Echo`` answers ``echo:`` and the request; ``seen`` gets the
    codec, the auth user and the token each request came with."""
    def Echo(cntl, request):
        if seen is not None:
            ctx = cntl.auth_context
            seen.append((cntl.compress_type,
                         ctx.user if ctx is not None else None,
                         cntl.auth_token))
        return b"echo:" + _b(request)
    opts.setdefault("enable_builtin_services", False)
    srv = side.rpc.Server(side.rpc.ServerOptions(**opts))
    svc = side.rpc.Service("Svc")
    svc.register_method("Echo", Echo)
    srv.add_service(svc)
    ep = srv.start("tcp://127.0.0.1:0")

    class _Srv:
        def close(self):
            srv.stop()
            srv.join(2)
    side.items.append(_Srv())
    return srv, ep


def _response_codecs(kind):
    """Records each response's ``RpcMeta.compress_type`` on the client
    of ``kind`` (a patch of its ``_fill_response``)."""
    mod = port_cd if kind == "port" else ref_cd
    got = []
    orig = mod._fill_response

    def spy(cntl, msg, socket):
        got.append(msg.meta.compress_type)
        return orig(cntl, msg, socket)
    return mod, orig, spy, got


def _compressed_calls():
    data = _payloads()[4]
    for ckind, skind in PAIRS:
        with _Side(ckind) as cli, _Side(skind) as srv_side:
            seen = []
            _, ep = _server(srv_side, seen)
            ch = cli.channel(f"tcp://127.0.0.1:{ep.port}")
            mod, orig, spy, got = _response_codecs(ckind)
            mod._fill_response = spy
            try:
                for ctype in (0,) + CODECS:
                    cntl = cli.controller()
                    cntl.compress_type = ctype
                    c = ch.call_sync("Svc", "Echo", data, cntl=cntl)
                    assert not c.failed(), (ckind, skind, c.error_text)
                    assert _b(cli.body(c)) == b"echo:" + data
            finally:
                mod._fill_response = orig
            assert [s[0] for s in seen] == [0, 1, 2, 3], (ckind, skind)
            assert got == [0, 1, 2, 3], (ckind, skind, got)


def _auth_calls():
    """Codes, texts and retries of every call, by (client, server)."""
    out = {}
    for ckind, skind in PAIRS:
        with _Side(ckind) as cli, _Side(skind) as srv_side:
            seen = []
            _, ep = _server(srv_side, seen,
                            auth=srv_side.rpc.TokenAuthenticator(TOKEN))
            _, ep2 = _server(srv_side, auth_token=TOKEN)
            addr = f"tcp://127.0.0.1:{ep.port}"
            good = cli.channel(addr, auth_token=TOKEN)
            by_auth = cli.channel(
                addr, auth=cli.rpc.TokenAuthenticator(TOKEN))
            sugar = cli.channel(f"tcp://127.0.0.1:{ep2.port}",
                                auth_token=TOKEN)
            bad = cli.channel(addr, auth_token="wrong")
            none = cli.channel(addr)
            rows = []
            for ch, svc, method in ((good, "Svc", "Echo"),
                                    (good, "Svc", "Echo"),
                                    (by_auth, "Svc", "Echo"),
                                    (sugar, "Svc", "Echo"),
                                    (bad, "Svc", "Echo"),
                                    (bad, "Nope", "Echo"),
                                    (none, "Svc", "Missing")):
                c = ch.call_sync(svc, method, b"q")
                rows.append((c.error_code, c.error_text, c.current_try,
                             _b(cli.body(c))))
            out[(ckind, skind)] = (rows, seen)
    want = out[("ref", "ref")]
    ok = (0, "", 0, b"echo:q")
    rauth = (ref_berr.ERPCAUTH, "authentication failed", 0, b"")
    assert want[0] == [ok, ok, ok, ok, rauth, rauth, rauth], want
    assert want[1] == [(0, "token-peer", TOKEN)] * 3, want
    assert berr.ERPCAUTH == ref_berr.ERPCAUTH
    for pair, got in out.items():
        assert got == want, (pair, got)


def _interceptor_calls():
    """An interceptor that rejects by the request's priority."""
    def make(side):
        def icpt(cntl):
            p = cntl.request_priority
            if p == 5:
                return (4001, "priority 5 refused")
            if p == 6:
                raise side.rpc.InterceptorError(4002, "raised")
            if p == 7:
                raise ValueError("broken")
            return None
        return icpt
    out = {}
    for ckind, skind in PAIRS:
        with _Side(ckind) as cli, _Side(skind) as srv_side:
            _, ep = _server(srv_side, interceptor=make(srv_side))
            ch = cli.channel(f"tcp://127.0.0.1:{ep.port}")
            rows = []
            for prio in (0, 5, 6, 7):
                cntl = cli.controller()
                cntl.request_priority = prio
                c = ch.call_sync("Svc", "Echo", b"i", cntl=cntl)
                rows.append((c.error_code, c.error_text, c.current_try))
            out[(ckind, skind)] = rows
    want = out[("ref", "ref")]
    assert want[:3] == [(0, "", 0), (4001, "priority 5 refused", 0),
                        (4002, "raised", 0)], want
    assert want[3][0] == ref_berr.EINTERNAL, want
    for pair, got in out.items():
        assert got == want, (pair, got)


def _http_auth():
    def status(port, path, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        try:
            conn.request("GET", path, headers=headers or {})
            r = conn.getresponse()
            r.read()
            return r.status
        finally:
            conn.close()
    out = {}
    for kind in ("port", "ref"):
        with _Side(kind) as side:
            _, ep = _server(side, auth=side.rpc.TokenAuthenticator(TOKEN),
                            enable_builtin_services=True)
            out[kind] = [
                status(ep.port, "/status"),
                status(ep.port, "/health"),
                status(ep.port, f"/status?token={TOKEN}"),
                status(ep.port, "/vars",
                       {"Authorization": f"Bearer {TOKEN}"}),
                status(ep.port, "/vars", {"Authorization": "Bearer x"}),
            ]
    assert out["port"] == out["ref"] == [403, 200, 200, 200, 403], out


# ------------------------------------------------ PeriodicTask, data pool

class _FakeTimer:
    """``global_timer()`` on a fake clock: the test fires the entries."""

    def __init__(self, clock):
        self.clock = clock
        self.q = []
        self.n = 0

    def schedule_after(self, delay_s, fn):
        self.n += 1
        self.q.append((self.clock.t + delay_s, self.n, fn))
        return self.n

    def unschedule(self, tid):
        self.q = [e for e in self.q if e[1] != tid]

    def fire_next(self) -> bool:
        if not self.q:
            return False
        self.q.sort(key=lambda e: (e[0], e[1]))
        at, _, fn = self.q.pop(0)
        self.clock.t = max(self.clock.t, at)
        fn()
        return True


def _periodic_trace(mod):
    clock = _FakeClock(100.0)
    timer = _FakeTimer(clock)
    saved = mod.global_timer
    mod.global_timer = lambda: timer
    try:
        trace = []
        for immediate, interval, cost in (
                (False, 1.0, {2: 0.3, 4: 2.5}),
                (True, lambda: 0.5 + 0.25 * len(trace), {}),
                (False, 0.2, {1: "raise"})):
            runs = []

            def fn():
                runs.append(round(clock.t, 6))
                c = cost.get(len(runs))
                if c == "raise":
                    raise RuntimeError("a failing run keeps its turn")
                clock.t += c or 0.0
            task = mod.PeriodicTask(fn, interval,
                                    run_immediately=immediate)
            while len(runs) < 6 and timer.fire_next():
                pass
            task.destroy()
            while timer.fire_next():
                pass
            trace.append(runs)
        return trace, timer.q
    finally:
        mod.global_timer = saved


def _periodic_fixed_delay():
    before = port_periodic.live_tasks()
    mine, want = _periodic_trace(port_periodic), _periodic_trace(ref_periodic)
    assert mine == want, (mine, want)
    # a slow run pushes the next one back: the delay counts from its end
    assert mine[0][0][:4] == [101.0, 102.0, 103.3, 104.3], mine[0][0]
    assert mine[1] == []                # destroyed: nothing scheduled
    assert port_periodic.live_tasks() == before
    # on the real timer: runs, then stops
    n = []
    t = port_periodic.PeriodicTask(lambda: n.append(1), 0.01)
    assert _wait_for(lambda: len(n) >= 3)
    t.destroy()
    k = len(n)
    time.sleep(0.05)
    assert len(n) <= k + 1


def _pool_trace(mod):
    made = []

    def factory():
        made.append({"id": len(made), "n": 0})
        return made[-1]

    def reset(obj):
        if obj["n"] < 0:
            raise ValueError("broken object")
        obj["n"] = 0
    pool = mod.SimpleDataPool(factory, reset=reset, max_free=2)
    steps = []
    a, b, c = pool.borrow(), pool.borrow(), pool.borrow()
    a["n"], b["n"], c["n"] = 3, 4, -1
    for obj in (a, b, c):
        pool.give_back(obj)
        steps.append((pool.ncreated, pool.free_count, obj["n"]))
    d = pool.borrow()
    steps.append((d["id"], d["n"], pool.free_count))
    pool.give_back(None)
    pool.give_back(d)
    pool.give_back(pool.borrow())
    steps.append((pool.ncreated, pool.free_count))
    return steps


def _session_data():
    assert _pool_trace(port_pool) == _pool_trace(ref_pool)
    assert _pool_trace(port_pool)[:3] == [(3, 1, 0), (3, 2, 0), (3, 2, -1)]
    for kind in ("port", "ref"):
        with _Side(kind) as side:
            def Count(cntl, request):
                d = cntl.session_local_data()
                d["n"] += 1
                return b"%d" % d["n"]
            made = []
            srv = side.rpc.Server(side.rpc.ServerOptions(
                enable_builtin_services=False,
                session_local_data_factory=lambda: made.append(1) or
                {"n": 0},
                session_local_data_reset=lambda d: d.update(n=0)))
            svc = side.rpc.Service("Svc")
            svc.register_method("Count", Count)
            srv.add_service(svc)
            ep = srv.start("tcp://127.0.0.1:0")

            class _Srv:
                def close(self):
                    srv.stop()
                    srv.join(2)
            side.items.append(_Srv())
            ch = side.channel(f"tcp://127.0.0.1:{ep.port}")
            got = [_b(side.body(ch.call_sync("Svc", "Count", b"")))
                   for _ in range(4)]
            assert got == [b"1"] * 4, (kind, got)
            assert len(made) == 1 and srv.session_local_pool.ncreated == 1


# ---------------------------------------------------------------- usercode

def _usercode_off_workers():
    """Three blocking sync handlers on a server of two fiber workers: on
    the usercode pool all three block at once, and the workers still
    run a fiber meanwhile."""
    control = port_fiber.TaskControl(concurrency=2, name="uc_test")
    gate = threading.Event()
    entered = []

    def Block(cntl, request):
        entered.append(threading.current_thread().name)
        gate.wait(5.0)
        return b"done"

    async def Ping(cntl, request):
        return threading.current_thread().name.encode()
    srv = port_rpc.Server(port_rpc.ServerOptions(
        enable_builtin_services=False, usercode_in_pthread=True),
        control=control)
    svc = port_rpc.Service("Svc")
    svc.register_method("Block", Block)
    svc.register_method("Ping", Ping)
    srv.add_service(svc)
    ep = srv.start("tcp://127.0.0.1:0")
    # a connection a call: one connection's requests wait for its last
    # in-place handler
    chans = [port_rpc.Channel(f"tcp://127.0.0.1:{ep.port}",
                              port_rpc.ChannelOptions(
                                  timeout_ms=8000, share_connections=False))
             for _ in range(4)]
    try:
        cntls = [ch.call("Svc", "Block", b"") for ch in chans[:3]]
        assert _wait_for(lambda: len(entered) == 3), entered
        assert all(n.startswith("usercode") for n in entered), entered
        ran = []

        async def fiber_work():
            ran.append(threading.current_thread().name)
        control.spawn(fiber_work)
        assert _wait_for(lambda: ran), "the fiber workers are held"
        ping = chans[3].call_sync("Svc", "Ping", b"")
        assert not ping.failed(), ping.error_text
        assert not bytes(ping.response).startswith(b"usercode")
        gate.set()
        for c in cntls:
            assert c.join(5.0) and not c.failed(), c.error_text
            assert bytes(c.response) == b"done"
    finally:
        gate.set()
        for ch in chans:
            ch.close()
        srv.stop()
        srv.join(2)
        control.stop_and_join()


CASES = [
    ("gzip, zlib and snappy bytes", _codec_bytes, ()),
    ("snappy without the native library", _snappy_without_native, ()),
    ("compress_type and auth_token in the meta", _meta_fields, ()),
    ("compressed calls both ways", _compressed_calls, ()),
    ("token auth both ways", _auth_calls, ()),
    ("an interceptor's reject both ways", _interceptor_calls, ()),
    ("auth on the HTTP path", _http_auth, ()),
    ("PeriodicTask on an injected clock", _periodic_fixed_delay, ()),
    ("SimpleDataPool and session-local data", _session_data, ()),
    ("usercode_in_pthread", _usercode_off_workers, ()),
]


def test_auth_compression_and_user_hooks():
    _run_cases(CASES)
