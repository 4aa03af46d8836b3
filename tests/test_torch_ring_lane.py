"""The port's ring lane (``brpc_tpu_torch/transport/ring_lane.py``)
against brpc_tpu's, on the CPU.

- The native ring (fastcore's ``Ring``, the port's copy of ring.cc) with
  the batch backend forced: a partial batch, a peer closing mid-batch, a
  reset, a dribbling peer, a short gather write and its rest, an accept
  burst (tests/test_ring_lane.py's cases); the auto backend and the
  forced-uring verdict.
- ``RingDispatcher``: sink delivery then EOF; pause, barrier and resume
  (bytes sent after the barrier stay in the kernel until the resume),
  with the barrier counted.
- A seeded framed-echo corpus (sequential calls across the small-frame
  and short-read sizes, then a pipelined phase folded in issue order):
  the digests of the port's ring lane (auto backend and batch forced),
  the port's selector lane, brpc_tpu's ring lane and both ways across
  the wire on the ring (brpc_tpu Channel -> port Server, port Channel ->
  brpc_tpu Server) are all equal. Each runs in a process of its own (the
  lane is chosen when the process's dispatcher is built). On the batch
  backend the port's sync calls are plucked behind the fence, and the
  in-place handlers' responses leave through the tick's flush.
- Generate on a ring-lane server (unary, stream, HTTP) equal to
  brpc_tpu's ``TinyDecoder.generate``.
- A forked child (in a subprocess that imports no jax) abandons the
  parent's ring and serves on one of its own; the parent's ring serves
  on after the child has gone.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py): no case may leave an fd registered, a lease on a
shared connection or a ring dispatcher's thread.
"""

import errno
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from brpc_tpu.serving import TinyDecoder as RefDecoder
from brpc_tpu.serving import TinyDecoderConfig as RefConfig

from brpc_tpu_torch.native import fastcore
from brpc_tpu_torch.protocol.tpu_std import SMALL_FRAME_MAX
from brpc_tpu_torch.transport import ring_lane

from test_torch_cluster import _run_cases

ROOT = Path(__file__).resolve().parent.parent
BATCH = 1
URING = 2
# the framed echo's request sizes: across the small-frame limit and the
# short-read size
PARITY_SIZES = [0, 1, 7, 64, 255, 1024, 4096, 8192, 65536, 262144]


def _fc():
    fc = fastcore.get()
    assert fc is not None and hasattr(fc, "Ring"), fastcore.load_error
    return fc


def _pair():
    a, b = socket.socketpair()
    a.setblocking(False)
    b.setblocking(False)
    return a, b


def _wait_all(ring, want_fds, timeout=5.0, op=None):
    """Completions until every fd of ``want_fds`` showed: {fd: comp}."""
    got = {}
    deadline = time.monotonic() + timeout
    while set(want_fds) - set(got) and time.monotonic() < deadline:
        for comp in ring.wait(100):
            if comp[0] in want_fds and (op is None or comp[1] == op):
                got.setdefault(comp[0], comp)
    return got


def _with_ring(fn):
    def run():
        ring = _fc().Ring(BATCH)
        try:
            assert ring.backend_name() == "batch"
            fn(ring)
        finally:
            ring.close()
    return run


# ------------------------------------------------------------ the ring

def case_backend_probe():
    fc = _fc()
    auto = fc.Ring()
    try:
        assert auto.backend_name() in ("batch", "uring")
        try:
            forced = fc.Ring(URING)
        except OSError as e:
            assert e.errno in (errno.ENOSYS, errno.EPERM, errno.ENOMEM)
            assert auto.backend_name() == "batch"
        else:
            assert forced.backend_name() == "uring"
            forced.close()
    finally:
        auto.close()


def case_partial_batch(ring):
    pairs = [_pair() for _ in range(3)]
    fds = [a.fileno() for a, _ in pairs]
    try:
        for fd in fds:
            ring.register_fd(fd, 0)
        pairs[0][1].send(b"alpha")
        pairs[2][1].send(b"gamma")
        got = _wait_all(ring, {fds[0], fds[2]}, op=ring_lane.OP_RECV)
        assert set(got) == {fds[0], fds[2]}
        assert bytes(got[fds[0]][3]) == b"alpha"
        assert bytes(got[fds[2]][3]) == b"gamma"
        assert got[fds[0]][2] == 5 and got[fds[2]][2] == 5
        assert all(c[0] != fds[1] for c in ring.wait(50))
    finally:
        for a, b in pairs:
            a.close()
            b.close()


def case_mid_batch_close(ring):
    (a1, b1), (a2, b2) = _pair(), _pair()
    try:
        ring.register_fd(a1.fileno(), 0)
        ring.register_fd(a2.fileno(), 0)
        b1.send(b"live-bytes")
        b2.close()
        got = _wait_all(ring, {a1.fileno(), a2.fileno()},
                        op=ring_lane.OP_RECV)
        assert bytes(got[a1.fileno()][3]) == b"live-bytes"
        assert got[a2.fileno()][2] == 0
    finally:
        a1.close()
        b1.close()
        a2.close()


def case_reset(ring):
    a, b = _pair()
    try:
        ring.register_fd(a.fileno(), 0)
        b.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     b"\x01\x00\x00\x00\x00\x00\x00\x00")
        b.close()
        got = _wait_all(ring, {a.fileno()}, op=ring_lane.OP_RECV)
        assert got[a.fileno()][2] <= 0     # EOF or -errno, never nothing
    finally:
        a.close()


def case_dribble(ring):
    a, b = _pair()
    try:
        ring.register_fd(a.fileno(), 0)
        seen = bytearray()
        for i in range(20):
            b.send(bytes([i]))
            comp = _wait_all(ring, {a.fileno()},
                             op=ring_lane.OP_RECV)[a.fileno()]
            assert comp[2] > 0, comp
            seen += bytes(comp[3])
        assert bytes(seen) == bytes(range(20))
        assert all(c[0] != a.fileno() for c in ring.wait(50))
    finally:
        a.close()
        b.close()


def case_short_write(ring):
    a, b = _pair()
    try:
        ring.register_fd(a.fileno(), 0)
        payload = bytes(range(256)) * 4096          # 1 MiB
        sent, received, saw_short = 0, bytearray(), False
        deadline = time.monotonic() + 30

        def drain_peer():
            try:
                while True:
                    data = b.recv(65536)
                    if not data:
                        break
                    received.extend(data)
            except BlockingIOError:
                pass

        while sent < len(payload) and time.monotonic() < deadline:
            chunk = payload[sent:]
            (fd, res, err), = ring.flush_writes([(a.fileno(), (chunk,))])
            assert fd == a.fileno() and not (res < 0 and err == 0)
            if res >= 0:
                saw_short |= 0 < res < len(chunk)
                sent += res
            else:
                assert err in (errno.EAGAIN, errno.EWOULDBLOCK), (res, err)
            drain_peer()
        assert sent == len(payload) and saw_short
        drain_peer()
        assert bytes(received) == payload
    finally:
        a.close()
        b.close()


def case_accept_burst(ring):
    lst = socket.socket()
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lst.bind(("127.0.0.1", 0))
    lst.listen(16)
    lst.setblocking(False)
    clients, accepted = [], []
    try:
        ring.register_fd(lst.fileno(), 1)
        for _ in range(5):
            clients.append(socket.create_connection(
                ("127.0.0.1", lst.getsockname()[1])))
        deadline = time.monotonic() + 5
        while len(accepted) < 5 and time.monotonic() < deadline:
            for comp in ring.wait(100):
                if comp[0] == lst.fileno() and \
                        comp[1] == ring_lane.OP_ACCEPT:
                    assert comp[2] >= 0, comp
                    accepted.append(comp[2])
        assert len(accepted) == 5
        clients[0].send(b"hi")
        got = b""
        for afd in accepted:
            s = socket.socket(fileno=afd)
            s.setblocking(False)
            try:
                got += s.recv(16)
            except BlockingIOError:
                pass
            finally:
                s.close()
        accepted = []
        assert got == b"hi"
    finally:
        for c in clients:
            c.close()
        for afd in accepted:
            os.close(afd)
        lst.close()


# ------------------------------------------------------ the dispatcher

def case_sink_then_eof():
    d = ring_lane.RingDispatcher(name="test_ring_disp", backend=BATCH)
    a, b = _pair()
    got, evt = [], threading.Event()

    def sink(data, eof, err):
        got.append((bytes(data) if data is not None else None, eof, err))
        evt.set()
    try:
        d.add_consumer(a.fileno(), lambda: None, ring_recv=sink)
        b.send(b"payload")
        assert evt.wait(5)
        assert got[0] == (b"payload", False, 0)
        evt.clear()
        b.close()
        assert evt.wait(5)
        assert got[-1][1] is True
        d.remove_consumer(a.fileno())
    finally:
        d.close()
        a.close()


def case_pause_barrier_resume():
    d = ring_lane.RingDispatcher(name="test_ring_disp", backend=BATCH)
    a, b = _pair()
    got, evt = [], threading.Event()

    def sink(data, eof, err):
        if data is not None:
            got.append(bytes(data))
            evt.set()
    try:
        d.add_consumer(a.fileno(), lambda: None, ring_recv=sink)
        n0 = ring_lane.nbarriers.get_value()
        d.pause_read(a.fileno())
        d.read_barrier()
        assert ring_lane.nbarriers.get_value() == n0 + 1
        b.send(b"fenced")
        assert not evt.wait(0.3), got
        d.resume_read(a.fileno())
        assert evt.wait(5)
        assert got == [b"fenced"]
        d.remove_consumer(a.fileno())
    finally:
        d.close()
        a.close()
        b.close()


# ------------------------------------------------------ across processes

def _child(code: str, args, flag: str, timeout: float = 120):
    env = dict(os.environ, BRPC_TPU_FLAG_EVENT_RING_LANE=flag,
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc, timeout: float = 120) -> dict:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (out + err)[-3000:]
    return json.loads(out.strip().splitlines()[-1])


_PARITY = r"""
import hashlib, json, os, sys, threading
sys.path.insert(0, os.getcwd())
server_side, client_side, backend = sys.argv[1], sys.argv[2], int(sys.argv[3])
if backend:
    from brpc_tpu_torch.transport import event_dispatcher as ped, ring_lane
    ped._global = ring_lane.RingDispatcher(backend=backend)


def lane(kind):
    if kind == "port":
        from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher
    else:
        from brpc_tpu.transport.event_dispatcher import global_dispatcher
    d = global_dispatcher()
    return [type(d).__name__, getattr(d, "backend", "selector")]


def Frame(cntl, request):
    b = bytes(request)
    return len(b).to_bytes(4, "big") + b[::-1]


async def Echo(cntl, request):
    return bytes(request)


if server_side == "port":
    from brpc_tpu_torch.rpc import Server, Service
    server = Server()
else:
    from brpc_tpu.rpc import Server, ServerOptions, Service
    server = Server(ServerOptions(enable_builtin_services=False))
svc = Service("P")
svc.method()(Frame)
svc.method()(Echo)
server.add_service(svc)
ep = server.start("tcp://127.0.0.1:0")
addr = f"tcp://127.0.0.1:{ep.port}"
if client_side == "port":
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    body = lambda c: bytes(c.response or b"")
else:
    from brpc_tpu.rpc import Channel, ChannelOptions
    body = lambda c: (c.response_payload.to_bytes()
                      if c.response_payload is not None else b"")
ch = Channel(addr, ChannelOptions(timeout_ms=20000, share_connections=False))
h = hashlib.sha256()
sizes = json.loads(sys.argv[4])
for i in range(60):
    sz = sizes[i % len(sizes)]
    req = (bytes((i + j) % 256 for j in range(min(sz, 512)))
           * (1 if sz <= 512 else sz // 512))[:sz]
    c = ch.call_sync("P", "Frame", req)
    assert not c.failed(), c.error_text
    resp = body(c)
    assert resp == len(req).to_bytes(4, "big") + req[::-1], (i, sz)
    h.update(resp)
slots, left, done = [None] * 128, [128], threading.Event()
lock = threading.Lock()


def issue(i):
    def cb(c, i=i):
        slots[i] = b"FAILED" if c.failed() else body(c)
        with lock:
            left[0] -= 1
            if not left[0]:
                done.set()
    ch.call("P", "Echo", (b"%06d" % i) * (1 + i % 17), done=cb)


for i in range(128):
    issue(i)
assert done.wait(60), "the pipelined phase hung"
for i, resp in enumerate(slots):
    assert resp == (b"%06d" % i) * (1 + i % 17), i
    h.update(resp)
out = {"server": lane(server_side), "client": lane(client_side),
       "digest": h.hexdigest()}
if "port" in (server_side, client_side):
    from brpc_tpu_torch.transport import ring_lane, socket as sk
    out.update({n: v.get_value() for n, v in ring_lane._VARS})
    out["plucked"] = sk.npluck_fast.get_value()
ch.close()
server.stop()
print(json.dumps(out))
"""


def case_echo_digests():
    runs = {
        "port ring": ("port", "port", 0, "1"),
        "port ring batch": ("port", "port", BATCH, "1"),
        "port selector": ("port", "port", 0, "0"),
        "brpc_tpu ring": ("ref", "ref", 0, "1"),
        "ref client -> port server, ring": ("port", "ref", BATCH, "1"),
        "port client -> ref server, ring": ("ref", "port", BATCH, "1"),
    }
    procs = {k: _child(_PARITY, [*v[:3], json.dumps(PARITY_SIZES)], v[3])
             for k, v in runs.items()}
    got = {k: _result(p) for k, p in procs.items()}
    digests = {k: r["digest"] for k, r in got.items()}
    assert len(set(digests.values())) == 1, digests
    for k, (srv, cli, backend, flag) in runs.items():
        r = got[k]
        want = "RingDispatcher" if flag == "1" else "EventDispatcher"
        assert r["server"][0] == want and r["client"][0] == want, (k, r)
        if backend == BATCH:
            side = r["server"] if srv == "port" else r["client"]
            assert side[1] == "batch", (k, r)
    ring = got["port ring batch"]
    assert ring["ring_ticks"] > 0 and ring["ring_completions"] > 0, ring
    # every sync call of a small frame was plucked (the two largest
    # sizes take the classic framing). A claim fences the tick only when
    # it finds reads live: after a plucked call the socket sticks, and
    # the next small call's claim takes no fence. The first call fences.
    # A classic frame's write unsticks, so its join's claim fences; when
    # the fenced tick delivers the response's event meanwhile, that
    # claim settles with reads live and the next claim fences too. So at
    # most the first call and two a classic call fence, fewer than the
    # small calls. No fence waited out a tick's timeout
    small = sum(1 for i in range(60)
                if PARITY_SIZES[i % len(PARITY_SIZES)] <= SMALL_FRAME_MAX)
    assert ring["plucked"] == small > 0, ring
    assert 1 <= ring["ring_read_barriers"] <= 1 + 2 * (60 - small), ring
    assert ring["ring_read_barriers"] < small, ring
    assert ring["ring_barrier_wait_us"] < 100000 * ring["ring_barrier_waits"]

    # the async Echo ran in place on the ring thread: its responses left
    # through the tick's flush
    assert ring["ring_flushed_frames"] >= 1 and \
        ring["ring_flush_batches"] >= 1, ring
    assert got["port selector"]["ring_ticks"] == 0


_GENERATE = r"""
import http.client, json, os, sys
sys.path.insert(0, os.getcwd())
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server
from brpc_tpu_torch.serving import StreamOptions, add_generate_service
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher
from brpc_tpu_torch.transport import ring_lane
server = Server()
add_generate_service(server, device="cpu")
ep = server.start("tcp://127.0.0.1:0")
body = lambda p, n: json.dumps({"prompt": p, "max_tokens": n}).encode()
out = {"dispatcher": type(global_dispatcher()).__name__, "unary": {}}
ch = Channel(str(ep), ChannelOptions(timeout_ms=60000))
for p in ("ring one", "ring two", "ring three"):
    c = ch.call_sync("GenerateService", "Generate", body(p, 16))
    assert not c.failed(), c.error_text
    out["unary"][p] = json.loads(c.response)["tokens"]
frames = []
c = ch.call_sync("GenerateService", "Generate", body("ring stream", 16),
                 stream_options=StreamOptions(
                     on_received=lambda s, m: frames.append(bytes(m.payload))))
assert not c.failed(), c.error_text
import time
deadline = time.monotonic() + 30
while not (frames and frames[-1][:1] in (b"d", b"e")) and \
        time.monotonic() < deadline:
    time.sleep(0.01)
out["stream"] = [f[1] for f in frames if f[:1] == b"t"]
out["stream_end"] = frames[-1].decode()
conn = http.client.HTTPConnection("127.0.0.1", ep.port, timeout=30)
conn.request("POST", "/GenerateService/Generate", body=body("ring http", 16))
data = conn.getresponse().read()
conn.close()
payload, _, footer = data.rpartition(b"\n#")
out["http"] = list(payload)
out["http_footer"] = footer.decode()
out["ring_ticks"] = ring_lane.nticks.get_value()
ch.close()
server.stop()
server.join(5)
print(json.dumps(out))
"""


def case_generate_on_the_ring():
    r = _result(_child(_GENERATE, [], "1"))
    assert r["dispatcher"] == "RingDispatcher" and r["ring_ticks"] > 0, r
    oracle = RefDecoder(RefConfig(cache_len=160))
    for p, toks in r["unary"].items():
        assert toks == oracle.generate(list(p.encode()), 16), p
    assert r["stream"] == oracle.generate(list(b"ring stream"), 16)
    assert json.loads(r["stream_end"][1:]) == {"n": 16,
                                              "status": "completed"}
    assert r["http"] == oracle.generate(list(b"ring http"), 16)
    assert r["http_footer"] == "completed n=16"


_STICKY = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
from brpc_tpu_torch.transport import event_dispatcher as ped, ring_lane
ped._global = ring_lane.RingDispatcher(backend=int(sys.argv[1]))
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service
from brpc_tpu_torch.transport import socket as sk

svc = Service("S")


@svc.method()
def Echo(cntl, request):
    return bytes(request)


server = Server()
server.add_service(svc)
ep = server.start("tcp://127.0.0.1:0")
ch = Channel(f"tcp://127.0.0.1:{ep.port}", ChannelOptions(timeout_ms=20000))
for i in range(2):
    assert ch.call_sync("S", "Echo", b"warm").response == b"warm"
sock = ch._socket
v0, p0 = ring_lane.counters(), sk.npluck_fast.get_value()
for i in range(20):
    assert ch.call_sync("S", "Echo", b"%d" % i).response == b"%d" % i
    assert sock._pluck_sticky
v1 = ring_lane.counters()
out = {k: v1[k] - v0[k] for k in ("ring_read_barriers",
                                  "ring_barrier_waits",
                                  "ring_barrier_wait_us")}
out["plucked"] = sk.npluck_fast.get_value() - p0
out["attached"] = sock._ring_attached
ch.close()
server.stop()
print(json.dumps(out))
"""


def case_sticky_claims_take_no_fence():
    """On the batch backend, a plain Channel's steady sync calls claim
    a sticky socket: reads are off already, so no claim fences the
    tick (brpc_tpu/transport/socket.py:1343-1380)."""
    r = _result(_child(_STICKY, [BATCH], "0"))
    assert r == {"ring_read_barriers": 0, "ring_barrier_waits": 0,
                 "ring_barrier_wait_us": 0, "plucked": 20,
                 "attached": True}, r


_TAKEN_OVER = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
from brpc_tpu_torch.transport import event_dispatcher as ped, ring_lane
ped._global = ring_lane.RingDispatcher(backend=int(sys.argv[1]))
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service
from brpc_tpu_torch.transport import socket as sk

svc = Service("S")


@svc.method()
def Echo(cntl, request):
    return bytes(request)


server = Server()
server.add_service(svc)
ep = server.start("tcp://127.0.0.1:0")
ch = Channel(f"tcp://127.0.0.1:{ep.port}", ChannelOptions(timeout_ms=4000))
assert ch.call_sync("S", "Echo", b"warm").response == b"warm"
real, taken = sk.Socket.pluck_until, []


def late_claim(self, pred, deadline_s, fast=None, preclaimed=False):
    # what a fenced tick hands the claim: the whole response already in
    # the portal, and nothing more to come on the fd
    if not preclaimed and not self.pluck_preclaim():
        return pred()
    end = time.monotonic() + 1.0
    while not self.input_portal and time.monotonic() < end:
        time.sleep(0.02)
        self._drain_readable()
    taken.append(bool(self.input_portal))
    return real(self, pred, deadline_s, fast=fast, preclaimed=True)


sk.Socket.pluck_until = late_claim
out = []
for body in (b"first", b"second"):    # small frames: claimed before the write
    t0 = time.monotonic()
    c = ch.call_sync("S", "Echo", body)
    out.append({"ok": not c.failed() and c.response == body,
                "error": c.error_text, "s": time.monotonic() - t0})
sk.Socket.pluck_until = real
ch.close()
server.stop()
print(json.dumps({"calls": out, "taken": taken}))
"""


def case_taken_over_bytes_are_judged():
    """A claim that takes over what the fenced tick read may hold the
    whole response in the portal while the fd stays quiet: the plucker
    judges the portal first, and does not wait for the deadline."""
    r = _result(_child(_TAKEN_OVER, [BATCH], "1"))
    assert r["taken"] == [True, True], r
    for call in r["calls"]:
        assert call["ok"] and call["s"] < 2.0, r


_FORK = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
from brpc_tpu_torch.butil import postfork
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service
from brpc_tpu_torch.transport import event_dispatcher as ed, ring_lane

svc = Service("F")


@svc.method()
def Pid(cntl, request):
    return str(os.getpid()).encode()


def serve_and_call():
    server = Server()
    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    ch = Channel(str(ep), ChannelOptions(timeout_ms=10000,
                                         share_connections=False))
    c = ch.call_sync("F", "Pid", b"")
    ok = not c.failed() and int(c.response) == os.getpid()
    ch.close()
    server.stop()
    server.join(5)
    return ok


parent_d = ed.global_dispatcher()
assert isinstance(parent_d, ring_lane.RingDispatcher), parent_d
assert serve_and_call()
ticks0 = ring_lane.nticks.get_value()
r, w = os.pipe()
pid = os.fork()
if pid == 0:
    os.close(r)
    try:
        doc = {"generation": postfork.generation(),
               "abandoned": ed.peek_dispatcher() is None and parent_d._stop,
               "ticks_after_fork": ring_lane.nticks.get_value()}
        try:
            parent_d._ring.wait(0)
            doc["parent_ring_closed"] = False
        except ValueError:
            doc["parent_ring_closed"] = True
        doc["served"] = serve_and_call()
        d = ed.peek_dispatcher()
        doc["own_ring"] = isinstance(d, ring_lane.RingDispatcher) and \
            d is not parent_d and d.thread.is_alive()
        doc["child_ticks"] = ring_lane.nticks.get_value()
        os.write(w, json.dumps(doc).encode())
    finally:
        os._exit(0)
os.close(w)
child = json.loads(os.read(r, 65536))
_, status = os.waitpid(pid, 0)
out = {"child": child, "child_status": status,
       "parent_serves_after": serve_and_call(),
       "parent_ticks_grew": ring_lane.nticks.get_value() > ticks0,
       "parent_thread_alive": parent_d.thread.is_alive()}
print(json.dumps(out))
"""


def case_forked_child_abandons_the_ring():
    r = _result(_child(_FORK, [], "1"))
    c = r["child"]
    assert r["child_status"] == 0, r
    assert c["generation"] == 1 and c["abandoned"], c
    assert c["parent_ring_closed"], c
    assert c["ticks_after_fork"] == 0 and c["child_ticks"] > 0, c
    assert c["served"] and c["own_ring"], c
    assert r["parent_serves_after"] and r["parent_ticks_grew"], r
    assert r["parent_thread_alive"], r


CASES = [
    ("backend probe", case_backend_probe, ()),
    ("partial batch", _with_ring(case_partial_batch), ()),
    ("peer closes mid-batch", _with_ring(case_mid_batch_close), ()),
    ("reset", _with_ring(case_reset), ()),
    ("dribbling peer", _with_ring(case_dribble), ()),
    ("short write and its rest", _with_ring(case_short_write), ()),
    ("accept burst", _with_ring(case_accept_burst), ()),
    ("sink then EOF", case_sink_then_eof, ()),
    ("pause, barrier, resume", case_pause_barrier_resume, ()),
    ("echo digests across lanes", case_echo_digests, ()),
    ("Generate on the ring", case_generate_on_the_ring, ()),
    ("steady sync claims take no fence", case_sticky_claims_take_no_fence,
     ()),
    ("bytes a claim took over are judged first",
     case_taken_over_bytes_are_judged, ()),
    ("a forked child abandons the ring",
     case_forked_child_abandons_the_ring, ()),
]


def test_ring_lane():
    _run_cases(CASES, limit_s=150.0)
