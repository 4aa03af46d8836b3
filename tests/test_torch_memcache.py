"""The memcached binary protocol client of the port
(``protocol/memcache.py`` on ``transport/pipelined.py``) against
brpc_tpu's, on the CPU, with tests/test_memcache.py's mock memcached.

- The codec: the request layout and the cut and bad responses of
  tests/test_memcache.py, and 300 requests and responses made from a
  seed, give the same bytes and the same parses in both packages.
- The client against the mock: the cases of tests/test_memcache.py (set,
  get, delete; add and replace; a cas conflict; incr and decr; append
  and prepend; version, noop, flush; a pipelined get; 4 threads on one
  client; SASL PLAIN with good, bad and no credentials; a password
  without a user; ``set_async``/``get_async`` from more fibers than
  workers); the same operations from both packages' clients put the
  same bytes on the wire.
- The opaque tripwire: a reply with another request's opaque fails the
  call and the connection. On a server's connection the protocol
  disclaims every byte.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import struct
import threading

import numpy as np
import pytest

from brpc_tpu.protocol import memcache as ref_mc

import brpc_tpu_torch.fiber as port_fiber
from brpc_tpu_torch.butil.iobuf import IOPortal
from brpc_tpu_torch.fiber.sync import CountdownEvent
from brpc_tpu_torch.protocol import memcache as mc
from brpc_tpu_torch.protocol.registry import find_protocol

from test_memcache import _Handler, _MockMemcached
from test_torch_cluster import _run_cases

SEED = 20261018


class _Mock:
    """The mock memcached on a thread; ``sasl_plain``: the credential it
    wants; ``recorded``: every request's bytes, in order."""

    def __init__(self, sasl_plain=None, handler=None):
        self.server = _MockMemcached()
        if handler is not None:
            self.server.RequestHandlerClass = handler
        self.server.sasl_plain = sasl_plain
        self.server.recorded = []
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        host, port = self.server.server_address
        self.addr = f"tcp://{host}:{port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class _Recording(_Handler):
    def _dispatch(self, store, opcode, extras, key, value, opaque, cas):
        self.server.recorded.append(mc._HDR.pack(
            mc.MAGIC_REQUEST, opcode, len(key), len(extras), 0, 0,
            len(extras) + len(key) + len(value), opaque, cas)
            + extras + key + value)
        super()._dispatch(store, opcode, extras, key, value, opaque, cas)


class _WrongOpaque(_Handler):
    def _reply(self, opcode, opaque, *a, **kw):
        super()._reply(opcode, opaque + 1000, *a, **kw)


# ------------------------------------------------------------------ codec

def case_codec():
    for mod in (mc, ref_mc):
        wire = mod.pack_request(mod.OP_SET, b"key", b"val",
                                struct.pack(">II", 7, 0), opaque=9, cas=3)
        assert len(wire) == 24 + 8 + 3 + 3
        assert mod._HDR.unpack(wire[:24])[:4] + \
            mod._HDR.unpack(wire[:24])[6:] == (0x80, mod.OP_SET, 3, 8, 14,
                                               9, 3)
        full = mod._HDR.pack(mod.MAGIC_RESPONSE, mod.OP_GET, 0, 4, 0, 0, 9,
                             1, 5) + struct.pack(">I", 2) + b"hello"
        for cut in range(len(full)):
            assert mod.parse_response(full[:cut], 0) is None
        resp, used = mod.parse_response(full, 0)
        assert used == len(full) and resp.value == b"hello" and \
            resp.cas == 5 and resp.extras == struct.pack(">I", 2)
        with pytest.raises(ValueError):
            mod.parse_response(b"\x80" + full[1:], 0)
    rng = np.random.default_rng(SEED)
    ops = [mc.OP_GET, mc.OP_SET, mc.OP_ADD, mc.OP_DELETE, mc.OP_INCREMENT,
           mc.OP_APPEND, mc.OP_VERSION, mc.OP_SASL_AUTH]
    for _ in range(300):
        args = (int(rng.choice(ops)), rng.bytes(int(rng.integers(0, 30))),
                rng.bytes(int(rng.integers(0, 100))),
                rng.bytes(int(rng.choice([0, 4, 8, 20]))))
        kw = {"opaque": int(rng.integers(0, 1 << 32)),
              "cas": int(rng.integers(0, 1 << 63))}
        assert mc.pack_request(*args, **kw) == ref_mc.pack_request(*args,
                                                                   **kw)
        key, value, extras = args[1:]
        resp = mc._HDR.pack(
            mc.MAGIC_RESPONSE, args[0], len(key), len(extras), 0,
            int(rng.integers(0, 0x30)), len(extras) + len(key) + len(value),
            kw["opaque"], kw["cas"]) + extras + key + value
        cut = resp[:int(rng.integers(0, len(resp) + 1))]
        for data in (resp, cut, b"\x80" + resp[1:]):
            outs = []
            for mod in (mc, ref_mc):
                try:
                    got = mod.parse_response(data, 0)
                    outs.append(None if got is None else
                                (tuple(got[0]), got[1]))
                except ValueError:
                    outs.append("bad")
            assert outs[0] == outs[1]
    # on a server's connection: another protocol's bytes
    portal = IOPortal()
    portal.append(mc.pack_request(mc.OP_GET, b"k"))

    class _Sock:
        user_data = {"server": object()}
    assert find_protocol("memcache").parse(portal, _Sock())[0] == \
        "try_others"


# ------------------------------------------------------------- the client

def _ops(c):
    cas = c.set("k", "v", flags=42)
    got = c.get("k")
    assert cas > 0 and got.value == b"v" and got.flags == 42 and \
        got.cas == cas
    assert c.get("missing") is None
    assert c.delete("k") is True and c.delete("k") is False
    assert c.get("k") is None
    c.add("a", "1")
    with pytest.raises(Exception) as ei:
        c.add("a", "2")
    assert ei.value.status == mc.STATUS_KEY_EXISTS
    c.replace("a", "3")
    assert c.get("a").value == b"3"
    with pytest.raises(Exception):
        c.replace("nope", "x")
    cas = c.set("c", "v1")
    c.set("c", "v2")
    with pytest.raises(Exception) as ei:
        c.set("c", "v3", cas=cas)
    assert ei.value.status == mc.STATUS_KEY_EXISTS
    assert c.incr("n", 5, initial=10) == 10
    assert c.incr("n", 5) == 15 and c.decr("n", 3) == 12
    c.set("s", "mid")
    c.append("s", ">")
    c.prepend("s", "<")
    assert c.get("s").value == b"<mid>"
    assert c.version() == "1.6.0-mock"
    c.noop()
    for i in range(20):
        c.set(f"k{i}", f"v{i}")
    out = c.pipeline_get([f"k{i}" for i in range(20)] + ["nope"])
    assert [g.value for g in out[:20]] == [f"v{i}".encode()
                                           for i in range(20)]
    assert out[20] is None
    c.set("f", "x")
    c.flush_all()
    assert c.get("f") is None


def case_client_and_wire_bytes():
    recorded = []
    for mod in (mc, ref_mc):
        m = _Mock(handler=_Recording)
        c = mod.MemcacheClient(m.addr)
        try:
            _ops(c)
        finally:
            c.close()
            m.close()
        recorded.append(m.server.recorded)
    assert recorded[0] == recorded[1] and len(recorded[0]) > 40


def case_shared_and_async():
    m = _Mock()
    c = mc.MemcacheClient(m.addr)
    try:
        errs = []

        def worker(i):
            try:
                for j in range(30):
                    c.set(f"t{i}.{j}", f"val{i}.{j}")
                    assert c.get(f"t{i}.{j}").value == \
                        f"val{i}.{j}".encode()
            except Exception as e:      # pragma: no cover
                errs.append(e)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs
        n = port_fiber.global_control().concurrency + 8
        done = CountdownEvent(n)
        failures = []

        async def one(i):
            try:
                await c.set_async(f"k{i}", f"v{i}")
                got = await c.get_async(f"k{i}")
                if got is None or got.value != f"v{i}".encode():
                    failures.append(i)
            except Exception as e:  # noqa: BLE001
                failures.append((i, str(e)))
            finally:
                done.signal()
        for i in range(n):
            port_fiber.spawn(one, i)
        assert done.wait_pthread(30) and not failures, failures[:3]
    finally:
        c.close()
        m.close()


def case_sasl():
    m = _Mock(sasl_plain=b"\x00bucket\x00sekrit")
    try:
        with mc.MemcacheClient(m.addr, username="bucket",
                               password="sekrit") as c:
            c.set("k", "v")
            assert c.get("k").value == b"v"
        c = mc.MemcacheClient(m.addr, username="bucket", password="wrong")
        try:
            with pytest.raises(mc.MemcacheError) as ei:
                c.set("k", "v")
            assert ei.value.status == mc.STATUS_AUTH_ERROR
        finally:
            c.close()
    finally:
        m.close()
    m = _Mock()
    try:
        with mc.MemcacheClient(m.addr) as c:
            c.set("k2", "v2")
            assert c.get("k2").value == b"v2"
    finally:
        m.close()
    with pytest.raises(ValueError):
        mc.MemcacheClient("tcp://127.0.0.1:1", password="lonely")


def case_opaque_tripwire():
    m = _Mock(handler=_WrongOpaque)
    c = mc.MemcacheClient(m.addr)
    try:
        with pytest.raises(mc.MemcacheError, match="desync"):
            c.get("k")
        assert c._socket is None        # the connection failed
        with pytest.raises(mc.MemcacheError, match="desync"):
            c.pipeline_get(["a", "b"])
    finally:
        c.close()
        m.close()


CASES = [("codec against brpc_tpu's", case_codec, ()),
         ("the client, and its bytes against brpc_tpu's",
          case_client_and_wire_bytes, ()),
         ("a shared client, fibers", case_shared_and_async, ()),
         ("SASL PLAIN", case_sasl, ()),
         ("the opaque tripwire", case_opaque_tripwire, ())]


def test_memcache():
    _run_cases(CASES, limit_s=60.0)
