"""The port's ici:// lane, recv pool and pinned staging against brpc_tpu's,
on the CPU.

- ``round_to_class`` and ``DeviceRecvPool`` against brpc_tpu's for the
  same calls: reserve, exhaustion, an oversized footprint, a blocked
  reserve woken by a release, ``try_reserve``; and the finalizer on a
  received tensor, which a view of it keeps alive (``._base``);
- frames byte for byte against brpc_tpu's ``_HDR``,
  ``_encode_descriptor``, ``_encode_coalesced`` and the staged envelope
  (tpud's ``_encode_device_batch``), for the same values (fp32, bf16,
  int32, a scalar, a zero-size shape), the port's decoders reading
  brpc_tpu's bytes, and the hello with the reference's keys;
- the cuda-ipc record's codec, with handle bytes made up on the CPU, and
  the malformed records it refuses;
- a same-process ``local-d2d`` echo through a Server and a Channel on
  ``#device=cpu`` (the tensors come back by reference);
- on a raw connection pair: the window stalling the sender and the ACK
  resuming it, the byte budget gating it, a batch over the budget going
  alone, an unsendable batch refused, the adaptive grant, the idle ACK,
  a coalesced group (staged and exchange), the staged lane between
  ports, the leak breaker per peer epoch and the grace reclaim under a
  short ``ici_reclaim_grace_s`` (a cuda-ipc registration with a made-up
  handle), and the require-pull switch refusing a host connection;
- between processes, through the staged lane: a port Channel to
  brpc_tpu's ``tests/ici_echo_server.py`` and brpc_tpu's Channel (in a
  subprocess) to a port Server, and a port Channel to a port Server in a
  subprocess. brpc_tpu's ici never starts in this process: its side
  runs in subprocesses with ``BRPC_TPU_ICI_FORCE_STAGED=1`` (no PjRt
  transfer server) and ``BRPC_TPU_NO_NATIVE=1`` (brpc_tpu's pinned
  stager lands a host array into a block it then recycles, so on the CPU
  a batch's small arrays alias one another: ROADMAP section 3);
- the ``PinnedStaging`` freelist, with plain blocks on the CPU, and the
  stager handing a host tensor through on the host.

Inputs come from numpy seeds. The cases run inside one collected test
(``_run_cases``), so every other test file keeps its place in
pytest-xdist's ``--dist loadfile`` queue (see test_torch_iobuf.py).
"""

import gc
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import ml_dtypes
import numpy as np
import torch

from brpc_tpu.butil import device_pool as ref_pool
from brpc_tpu.transport import ici as ref_ici
from brpc_tpu.transport import tpud as ref_tpud
from brpc_tpu_torch.butil import device_pool as port_pool
from brpc_tpu_torch.butil import iobuf
from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.butil.flags import flag, set_flag
from brpc_tpu_torch.rpc import Channel, Server, ServerOptions, Service
from brpc_tpu_torch.rpc.span import Span
from brpc_tpu_torch.transport import cudad, ici
from brpc_tpu_torch.transport import device_stats as ds
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    return cond()


def _run_cases(cases):
    """Run every (name, fn, args) case in order; none may leave an fd
    registered with the port's dispatcher. Every failure is reported,
    each with its traceback."""
    d = global_dispatcher()
    failed = []
    for name, fn, args in cases:
        before = set(d._handlers)
        try:
            fn(*args)
            assert _wait_for(lambda: set(d._handlers) <= before), \
                f"fds left registered: {set(d._handlers) - before}"
        except Exception:
            failed.append(f"--- {name}\n{traceback.format_exc()}")
    assert not failed, "\n".join(failed)


class _flags:
    """Set port flags for a block, restored after it."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: flag(k) for k in self.kv}
        for k, v in self.kv.items():
            assert set_flag(k, v), k

    def __exit__(self, *exc):
        for k, v in self.old.items():
            set_flag(k, v)


# ---------------------------------------------------------------- inputs

def _np_inputs(seed):
    rng = np.random.RandomState(seed)
    return [
        rng.randn(3, 5).astype(np.float32),
        rng.randn(4, 2).astype(np.float32).astype(ml_dtypes.bfloat16),
        rng.randint(-1000, 1000, size=(7,)).astype(np.int32),
        np.array(rng.randn(), dtype=np.float32),
        np.zeros((0, 5), dtype=np.float32),
    ]


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _same(t, a):
    a = np.asarray(a)
    return (str(t.dtype).replace("torch.", "") == str(a.dtype)
            and tuple(t.shape) == a.shape
            and t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
            == a.tobytes())


# ------------------------------------------------------------ recv pool

def _pools(capacity):
    return port_pool.DeviceRecvPool(capacity), \
        ref_pool.DeviceRecvPool(capacity)


def _pool_state(p):
    return (p.used, p.available, list(p.reserved_blocks))


def case_round_to_class():
    assert port_pool.BLOCK_CLASSES == ref_pool.BLOCK_CLASSES
    rng = np.random.RandomState(5)
    sizes = [0, -3, 1, 8 << 10, (8 << 10) + 1, 64 << 10, (2 << 20) - 1,
             2 << 20, (2 << 20) + 1, 7 << 20] + \
        [int(x) for x in rng.randint(1, 9 << 20, size=40)]
    for n in sizes:
        assert port_pool.round_to_class(n) == ref_pool.round_to_class(n), n


def case_pool_against_reference():
    mine, ref = _pools(256 << 10)
    rng = np.random.RandomState(6)
    held = []
    for n in rng.randint(1, 64 << 10, size=12):
        a, b = mine.try_reserve(int(n)), ref.try_reserve(int(n))
        assert a == b, (n, a, b)
        assert _pool_state(mine) == _pool_state(ref)
        if a is not None:
            held.append(a)
    assert held and mine.try_reserve(64 << 10) is None, "never exhausted"
    assert ref.try_reserve(64 << 10) is None
    while True:                         # fill what is left, 8 KiB a time
        a, b = mine.try_reserve(1), ref.try_reserve(1)
        assert a == b
        if a is None:
            break
        held.append(a)
    assert _pool_state(mine) == _pool_state(ref) and mine.available == 0
    # exhaustion: a blocking reserve times out with MemoryError on both
    for p in (mine, ref):
        t0 = time.monotonic()
        try:
            p.reserve(100, timeout_s=0.05)
            raise AssertionError("reserve past the budget returned")
        except MemoryError as e:
            assert "exhausted" in str(e)
        assert time.monotonic() - t0 < 2 and p.available == 0
    # oversized: refused at once
    for p in (mine, ref):
        try:
            p.reserve(1 << 30, timeout_s=5)
            raise AssertionError("oversized reserve returned")
        except MemoryError as e:
            assert "exceeds pool capacity" in str(e)
    for f in held:
        mine.release(f)
        ref.release(f)
    assert _pool_state(mine) == _pool_state(ref) == \
        (0, 256 << 10, [0, 0, 0, 0])
    # a blocked reserve is woken by a release, on both
    for p in (mine, ref):
        fp = p.reserve_group(200 << 10)
        got = []
        t = threading.Thread(target=lambda: got.append(
            p.reserve(50 << 10, timeout_s=5)))
        t.start()
        time.sleep(0.1)
        assert not got, "reserve did not block"
        p.release(fp)
        t.join(5)
        assert not t.is_alive() and got == [64 << 10]
        p.release(got[0])
    assert _pool_state(mine) == _pool_state(ref)


def case_finalizer_with_views():
    """The reservation comes back when the last view of a received
    tensor is dropped, not before."""
    pool = port_pool.DeviceRecvPool(1 << 20)
    t = torch.arange(1000, dtype=torch.float32)
    fp = pool.reserve(t.numel() * 4)
    pool.attach_finalizer(t, fp)
    view = t[10:20]
    flat = t.view(-1)
    del t
    gc.collect()
    assert pool.used == fp, "released while views live"
    del view
    gc.collect()
    assert pool.used == fp, "released while a view lives"
    assert float(flat[15]) == 15.0
    del flat
    gc.collect()
    assert pool.used == 0, "not released after the last view"
    # a group: released when the last tensor of the group dies
    a, b = torch.zeros(4), torch.ones(4)
    res = pool.reserve_group(16 << 10)
    holder = port_pool.GroupReservation(pool, res, 2)
    pool.attach_group_finalizer(a, holder)
    pool.attach_group_finalizer(b, holder)
    del a
    gc.collect()
    assert pool.used == 16 << 10
    del b
    gc.collect()
    assert pool.used == 0


# --------------------------------------------------------- frame bytes

def case_frame_bytes():
    arrays = _np_inputs(11)
    tensors = [_to_torch(a) for a in arrays]
    assert ici._HDR.format == ref_ici._HDR.format
    for vals in ((0, 0, 0), (5, 1 << 40, 12345), (3, 7, 4)):
        assert ici._HDR.pack(*vals) == ref_ici._HDR.pack(*vals)
    assert (ici.F_BYTES, ici.F_DESCRIPTOR, ici.F_HELLO, ici.F_ACK,
            ici.F_STAGED, ici.F_COALESCED) == \
        (ref_ici.F_BYTES, ref_ici.F_DESCRIPTOR, ref_ici.F_HELLO,
         ref_ici.F_ACK, ref_ici.F_STAGED, ref_ici.F_COALESCED)
    uid = 0x0123456789ABCDEF
    mine = ici._encode_descriptor(uid, tensors)
    assert mine == ref_ici._encode_descriptor(uid, arrays)
    assert ici._decode_descriptor(mine) == ref_ici._decode_descriptor(mine)
    batches_np = [arrays[:2], arrays[2:3], arrays[3:]]
    batches = [tensors[:2], tensors[2:3], tensors[3:]]
    for u in (uid, None):
        mine = ici._encode_coalesced(u, batches)
        assert mine == ref_ici._encode_coalesced(u, batches_np), u
        m = ici._decode_coalesced(mine)
        r = ref_ici._decode_coalesced(mine)
        assert (m[0], m[1]) == (r[0], r[1])
        assert [bytes(x) for x in m[2]] == r[2] if u is None \
            else m[2] == r[2]
    blob = cudad._encode_device_batch(tensors)
    assert blob == ref_tpud._encode_device_batch(arrays)
    staged = ici._HDR.pack(ici.F_STAGED, 3, len(blob)) + blob
    assert staged == ref_ici._HDR.pack(ref_ici.F_STAGED, 3,
                                       len(blob)) + blob


class _SinkConn:
    """What an IciConn writes, for reading its hello."""

    def __init__(self):
        self.out = bytearray()

    def write(self, mv):
        self.out += bytes(mv)
        return len(mv)

    def close(self):
        pass


def case_hello_bytes():
    sink = _SinkConn()
    pool = port_pool.DeviceRecvPool(64 << 20)
    conn = ici.IciConn(sink, str2endpoint("ici://127.0.0.1:1"),
                       str2endpoint("ici://127.0.0.1:2"),
                       torch.device("cpu"), window=8, pool=pool)
    # the reference's hello, key for key, as brpc_tpu's IciConn builds
    # it without a transfer server (brpc_tpu/transport/ici.py)
    want = {"proc": ici._PROC_UUID, "transfer_addr": None, "window": 8,
            "budget": min(pool.capacity, 8 * ref_ici.BLOCK_CLASSES[-1]),
            "max_batch": pool.capacity, "device": 0, "can_pull": False}
    body = json.dumps(want).encode()
    assert bytes(sink.out) == ref_ici._HDR.pack(ref_ici.F_HELLO, 0,
                                                len(body)) + body
    conn.close()


def case_ipc_record_codec():
    rng = np.random.RandomState(12)
    tensors = [_to_torch(a) for a in _np_inputs(12)]
    recs = []
    for t in tensors:
        n = t.numel() * t.element_size()
        handle = rng.bytes(64) if n else b""
        recs.append((t, handle, int(rng.randint(0, 1 << 30)) if n else 0))
    event = rng.bytes(64)
    data = ici._encode_ipc(77, event, recs)
    uid, ev, got = ici._decode_ipc(data)
    assert uid == 77 and ev == event and len(got) == len(recs)
    for (t, handle, off), (spec, h, o) in zip(recs, got):
        assert (h, o) == (handle, off)
        assert spec == ici._decode_spec(ici._encode_spec(t), 0)[0]
        assert spec["nbytes"] == t.numel() * t.element_size()
    # the spec inside is the descriptor's spec, byte for byte
    assert ici._encode_spec(tensors[1]) == ref_ici._encode_spec(
        _np_inputs(12)[1])
    uid, ev, got = ici._decode_ipc(ici._encode_ipc(5, b"", recs[:1]))
    assert ev == b""
    # a handle's 64 bytes survive libcuda's struct, zero bytes too
    from brpc_tpu_torch.transport import cuda_ipc
    for raw in (b"\0" * 64, b"ab\0cd" + rng.bytes(59), rng.bytes(64)):
        assert cuda_ipc._handle_bytes(cuda_ipc._handle_struct(raw)) == raw
    try:
        cuda_ipc._handle_struct(b"short")
        raise AssertionError("a short handle was taken")
    except cuda_ipc.CudaIpcError:
        pass
    # malformed records from a peer are refused
    bad = [
        ici._encode_ipc(1, b"x" * 10, recs[:1]),            # event length
        ici._encode_ipc(1, event, [(tensors[0], b"y" * 8, 0)]),  # handle
        ici._encode_ipc(1, event, [(tensors[4], b"y" * 64, 0)]),
        data + b"\0",                                        # trailing
        data[:-3],                                           # short
    ]
    for b in bad:
        try:
            ici._decode_ipc(b)
            raise AssertionError(f"accepted {b[:16]!r}")
        except (ValueError, Exception) as e:
            assert not isinstance(e, AssertionError), e


# ------------------------------------------------- same-process echo

def _echo_server(addr):
    svc = Service("Perf")

    @svc.method()
    def Echo(cntl, request):
        cntl.response_device_arrays = list(cntl.request_device_arrays)
        return request

    @svc.method()
    def Double(cntl, request):
        cntl.response_device_arrays = [t * 2 for t in
                                       cntl.request_device_arrays]
        return b"dev"

    srv = Server(ServerOptions(enable_builtin_services=False))
    srv.add_service(svc)
    return srv, srv.start(addr)


def case_local_echo():
    srv, ep = _echo_server("ici://127.0.0.1:0#device=cpu")
    ch = Channel(str(ep))
    try:
        assert ch.device_lane_kind() == "local-d2d"
        for seed in range(3):
            tensors = [_to_torch(a) for a in _np_inputs(seed)]
            c = ch.call_sync("Perf", "Echo", b"q",
                             request_device_arrays=tensors)
            assert not c.failed(), c.error_text
            out = c.response_device_arrays
            assert len(out) == len(tensors)
            for x, y in zip(tensors, out):
                assert y is x, "the same-process hand-off copied"
            c = ch.call_sync("Perf", "Double", b"",
                             request_device_arrays=tensors[:3])
            assert not c.failed() and c.response == b"dev"
            for x, y in zip(tensors[:3], c.response_device_arrays):
                assert torch.equal(y, x * 2)
    finally:
        ch.close()
        srv.stop()
        srv.join(2)


# ------------------------------------------------ connection harness

class _Harness:
    """A raw ici conn pair with manual pumping (brpc_tpu's test_ici
    idiom)."""

    def __init__(self, window=4, pool=None):
        self.tr = ici.IciTransport(window=window, pool=pool)
        self.server = None
        evt = threading.Event()

        def on_conn(conn):
            self.server = conn
            evt.set()
        self.listener = self.tr.listen(
            str2endpoint("ici://127.0.0.1:0#device=cpu"), on_conn)
        self.client = self.tr.connect(str2endpoint(
            f"ici://127.0.0.1:{self.listener.endpoint.port}#device=cpu"))
        assert evt.wait(5), "no server conn"
        assert _wait_for(lambda: self.pump() or (
            self.client.peer_info is not None
            and self.server.peer_info is not None))

    @staticmethod
    def _pump(conn):
        if conn._closed:
            return
        buf = bytearray(1 << 16)
        try:
            conn.read_into(memoryview(buf))
        except (BlockingIOError, ConnectionError):
            pass

    def pump(self):
        self._pump(self.client)
        self._pump(self.server)

    def pump_until(self, cond, timeout_s=5.0):
        return _wait_for(lambda: self.pump() or cond(), timeout_s)

    def take_all(self, conn, n):
        out = []

        def step():
            self._pump(conn)
            b = conn.take_device_payload()
            if b is not None:
                out.append(b)
            return len(out) == n
        assert _wait_for(step), f"took {len(out)} of {n}"
        return out

    def cross_process(self):
        """Make the client see the server as another process: its
        batches take the staged lane (no cuda_ipc on the host)."""
        self.client.peer_info = dict(self.client.peer_info,
                                     proc="elsewhere")
        self.server.peer_info = dict(self.server.peer_info,
                                     proc="elsewhere-too")

    def close(self):
        self.client.close()
        if self.server is not None:
            self.server.close()
        self.listener.stop()


def _t(n, v=0.0):
    return torch.full((n,), float(v))


def case_window_stall_and_resume():
    h = _Harness(window=2)
    try:
        for i in range(3):
            h.client.write_device_payload([_t(8, i)])
        row = h.client.lane_introspection()
        assert row["outstanding_batches"] == 2 and \
            row["enqueue_depth"] == 1, row
        got = h.take_all(h.server, 2)
        assert [float(b[0][0]) for b in got] == [0.0, 1.0]
        # half the window consumed: a bare ACK reopens it
        assert h.pump_until(lambda: h.client.outstanding_batches <= 1
                            and h.client.lane_introspection()
                            ["enqueue_depth"] == 0)
        (b,) = h.take_all(h.server, 1)
        assert float(b[0][0]) == 2.0
        assert h.pump_until(lambda: h.client.outstanding_batches == 0)
    finally:
        h.close()


def case_budget_gates_sender():
    pool = port_pool.DeviceRecvPool(128 << 10)
    h = _Harness(window=8, pool=pool)
    try:
        assert h.client.peer_info["budget"] == 128 << 10
        for i in range(3):                      # 40 KiB: 64 KiB each
            h.client.write_device_payload([_t(10 << 10, i)])
        row = h.client.lane_introspection()
        assert row["outstanding_batches"] == 2 and \
            row["inflight_bytes"] == 128 << 10 and \
            row["enqueue_depth"] == 1, row
        got = h.take_all(h.server, 2)
        del got
        gc.collect()
        assert h.pump_until(lambda: h.client.lane_introspection()
                            ["enqueue_depth"] == 0)
        h.take_all(h.server, 1)
    finally:
        h.close()


def case_mid_size_goes_alone():
    pool = port_pool.DeviceRecvPool(8 << 20)
    h = _Harness(window=2, pool=pool)
    try:
        assert h.client.peer_info["budget"] == 4 << 20
        h.client.write_device_payload([_t(16)])
        big = _t(5 << 18, 3.0)                  # 5 MiB: over the budget
        h.client.write_device_payload([big])
        row = h.client.lane_introspection()
        assert row["outstanding_batches"] == 1 and \
            row["enqueue_depth"] == 1, row
        h.take_all(h.server, 1)
        assert h.pump_until(lambda: h.client.lane_introspection()
                            ["enqueue_depth"] == 0)
        (b,) = h.take_all(h.server, 1)
        assert b[0] is big
        # over the peer's whole pool: refused at the call
        try:
            h.client.write_device_payload([_t(9 << 18)])
            raise AssertionError("an unsendable batch was queued")
        except ConnectionError as e:
            assert "unsendable" in str(e)
    finally:
        h.close()


def case_adaptive_grant():
    pool = port_pool.DeviceRecvPool(1 << 20)
    h = _Harness(window=4, pool=pool)
    try:
        grants = []
        for hold in (0, 600 << 10, 900 << 10):
            res = pool.reserve_group(hold) if hold else 0
            grants.append(int.from_bytes(h.server._ack_grant_payload(),
                                         "big"))
            if res:
                pool.release(res)
        assert grants == [8, 4, 1], grants
        with _flags(ici_adaptive_window=False):
            assert h.server._ack_grant_payload() == b""
        # a grant the sender rode: its effective window, capped at 4x
        for i in range(2):
            h.client.write_device_payload([_t(4, i)])
        h.take_all(h.server, 2)
        assert h.pump_until(lambda: h.client._peer_grant == 8)
        assert h.client.lane_introspection()["effective_window"] == 8
        h.client._peer_grant = 1000
        assert h.client._effective_window(h.client.peer_info) == 16
    finally:
        h.close()


def case_idle_ack():
    with _flags(ici_idle_ack_ms=1.0):
        h = _Harness(window=16)
        try:
            h.client.write_device_payload([_t(4)])
            h.take_all(h.server, 1)
            # one batch of a 16-wide window: no half-window ACK; the
            # timer acknowledges it
            assert h.pump_until(lambda: h.client.outstanding_batches == 0)
            assert h.server._idle_acks >= 1
        finally:
            h.close()


def case_coalesced_groups():
    for cross in (False, True):
        pool = port_pool.DeviceRecvPool(1 << 20)
        h = _Harness(window=8, pool=pool)
        try:
            if cross:
                h.cross_process()
            # the window (8) fills; the next three wait behind it and
            # coalesce into one frame once the ACK reopens it
            for i in range(11):
                h.client.write_device_payload([_t(16, i), _t(2, -i)])
            row = h.client.lane_introspection()
            assert row["outstanding_batches"] == 8 and \
                row["coalesced_frames"] == 0, row
            first = h.take_all(h.server, 8)
            del first
            gc.collect()
            assert h.pump_until(lambda: h.client.lane_introspection()
                                ["enqueue_depth"] == 0)
            row = h.client.lane_introspection()
            assert row["coalesced_frames"] == 1 and \
                row["coalesced_batches"] == 3, row
            got = h.take_all(h.server, 3)
            for i, b in enumerate(got, 8):
                assert torch.equal(b[0], _t(16, i)) and \
                    torch.equal(b[1], _t(2, -i))
            # one reservation for the group: 6 tensors of 8 KiB classes
            assert pool.used == 6 * (8 << 10)
            del got, b
            gc.collect()
            assert pool.used == 0
        finally:
            h.close()


def case_staged_between_ports():
    h = _Harness(window=8)
    try:
        h.cross_process()
        tensors = [_to_torch(a) for a in _np_inputs(3)]
        t = ds.open_transfer("staged-peer", "staged", 1,
                             parent_span=Span(trace_id=3, span_id=4))
        h.client.write_device_payload(tensors, tracker=t)
        assert t.staged and h.client.lane_kind == "staged"
        (b,) = h.take_all(h.server, 1)
        for x, y in zip(tensors, b):
            assert torch.equal(x, y) and y is not x
        assert h.pump_until(lambda: h.client.outstanding_batches == 0)
        cell = t.cell.get_value()
        assert cell["staged_fallbacks"] == 1 and cell["completed"] == 1
    finally:
        h.close()


def case_leak_breaker_and_grace():
    """A cuda-ipc registration (a made-up handle: the sender side needs
    no card) un-ACKed at close is held for the grace, charged to the
    peer's epoch, and reclaimed after it; the breaker trips per epoch
    and process-wide, and recovers as the bytes come back."""
    saved = (ici.cuda_ipc.export_tensor, ici._LEAK_CAP_BYTES,
             ici._LEAK_GLOBAL_CAP_BYTES)
    ici.cuda_ipc.export_tensor = lambda t: (b"\x01" * 64, 0)
    snap0 = ici.leak_snapshot()
    epoch = f"epoch-{time.monotonic_ns()}"
    with _flags(ici_reclaim_grace_s=0.05):
        h = _Harness(window=8)
        try:
            h.client._pull_reason = None
            h.client.peer_info = dict(h.client.peer_info, proc=epoch,
                                      cuda_ipc={"device": 0})
            assert h.client.lane_kind == "cuda-ipc"
            t = ds.open_transfer(f"lk-{epoch}", "cuda-ipc", 4096,
                                 parent_span=Span(trace_id=7, span_id=9))
            h.client.write_device_payload([_t(1024)], tracker=t)
            assert h.client.lane_introspection()["ipc_registered"] == 1
            h.client.close()
            cell = t.cell.get_value()
            assert cell["failed"] == 1 and cell["leaked_batches"] == 1 \
                and cell["leaked_bytes"] == 4096
            assert any("leak-reclaim" in txt
                       for _, txt in t.span.annotations)
            assert ici._leaked_by_epoch.get(epoch) == 4096
            snap = ici.leak_snapshot()
            assert snap["leaked_bytes"] - snap0["leaked_bytes"] == 4096
            assert snap["unpulled_registrations"] > \
                snap0["unpulled_registrations"]
            assert ici._pull_lane_allowed(epoch)
            ici._LEAK_CAP_BYTES = 4096
            assert not ici._pull_lane_allowed(epoch)
            assert ici._pull_lane_allowed("another-epoch")
            ici._LEAK_GLOBAL_CAP_BYTES = 4096
            assert not ici._pull_lane_allowed("another-epoch")
            assert ici.leak_snapshot()["pull_lane_tripped"]
            # the grace sweep drops the registration and the breaker
            # recovers
            assert _wait_for(lambda: ici._leaked_by_epoch.get(epoch) is None,
                             3.0)
            assert ici._pull_lane_allowed(epoch)
            snap = ici.leak_snapshot()
            assert snap["reclaimed_bytes"] - snap0["reclaimed_bytes"] >= 4096
            assert snap["pinned_bytes_estimate"] == \
                snap0["pinned_bytes_estimate"]
        finally:
            (ici.cuda_ipc.export_tensor, ici._LEAK_CAP_BYTES,
             ici._LEAK_GLOBAL_CAP_BYTES) = saved
            h.close()


def case_exchange_grace():
    """Same-process exchange entries of a closed conn: taken during the
    grace they are delivered (reclaimed credited); after it, gone."""
    with _flags(ici_reclaim_grace_s=0.3):
        h = _Harness(window=8)
        try:
            snap0 = ici.leak_snapshot()
            h.client.write_device_payload([_t(256, 1.0)])
            h.client.close()
            snap = ici.leak_snapshot()
            assert snap["leaked_bytes"] - snap0["leaked_bytes"] == 1024
            (b,) = h.take_all(h.server, 1)
            assert float(b[0][0]) == 1.0
            assert ici.leak_snapshot()["reclaimed_bytes"] - \
                snap0["reclaimed_bytes"] == 1024
        finally:
            h.close()
    with _flags(ici_reclaim_grace_s=0.05):
        h = _Harness(window=8)
        try:
            h.client.write_device_payload([_t(256, 2.0)])
            h.client.close()
            assert _wait_for(lambda: ici.leak_snapshot()["grace_queue"]
                             == 0, 3.0)
            h.pump()
            try:
                h.server.take_device_payload()
                raise AssertionError("a reclaimed entry was taken")
            except ConnectionError as e:
                assert "no longer available" in str(e)
        finally:
            h.close()


def case_require_pull_refuses_host():
    os.environ[ici._ENV_REQUIRE_PULL] = "1"
    try:
        lst = ici.IciTransport().listen(
            str2endpoint("ici://127.0.0.1:0#device=cpu"), lambda c: None)
        try:
            ici.IciTransport().connect(str2endpoint(
                f"ici://127.0.0.1:{lst.endpoint.port}#device=cpu"))
            raise AssertionError("a host conn passed the require switch")
        except ConnectionError as e:
            assert "cannot pull" in str(e)
        finally:
            lst.stop()
    finally:
        del os.environ[ici._ENV_REQUIRE_PULL]


# ------------------------------------------------------ between processes

_REF_ENV = dict(os.environ, JAX_PLATFORMS="cpu",
                BRPC_TPU_ICI_FORCE_STAGED="1", BRPC_TPU_NO_NATIVE="1")

_PORT_SERVER = r"""
import sys
sys.path.insert(0, {repo!r})
from brpc_tpu_torch.rpc import Server, ServerOptions, Service
svc = Service("Perf")

@svc.method()
def Double(cntl, request):
    cntl.response_device_arrays = [t * 2 for t in cntl.request_device_arrays]
    return b"dev"

srv = Server(ServerOptions(enable_builtin_services=False))
srv.add_service(svc)
ep = srv.start("ici://127.0.0.1:0#device=cpu")
print("PORT", ep.port, flush=True)
sys.stdin.read()            # until the test closes it
srv.stop()
srv.join(2)
"""

_REF_CLIENT = r"""
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np, ml_dtypes, jax
jax.config.update("jax_platforms", "cpu")
from brpc_tpu.rpc import Channel
ch = Channel("ici://127.0.0.1:{port}")
out = []
for seed in (21, 22):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(5, 3).astype(np.float32),
              rng.randn(6).astype(np.float32).astype(ml_dtypes.bfloat16),
              rng.randint(-9, 9, size=(4,)).astype(np.int32)]
    c = ch.call_sync("Perf", "Double", b"", request_device_arrays=arrays)
    out.append({{"failed": c.failed(), "text": c.error_text,
                 "same": [bool(np.array_equal(np.asarray(y),
                                              np.asarray(x) * 2))
                          and str(np.asarray(y).dtype) == str(x.dtype)
                          for x, y in zip(arrays,
                                          c.response_device_arrays)]}})
print(json.dumps(out), flush=True)
"""


def _start(args, env=None, stdin=None):
    return subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, stdin=stdin, env=env,
                            text=True, cwd=REPO)


def _port_of(p):
    line = p.stdout.readline()
    assert line.startswith("PORT"), (line, p.stderr.read()[-2000:]
                                     if p.poll() is not None else "")
    return int(line.split()[1])


def case_cross_process_staged():
    echo = _start([sys.executable, "tests/ici_echo_server.py"], _REF_ENV)
    port_srv = _start([sys.executable, "-c",
                       _PORT_SERVER.format(repo=REPO)],
                      stdin=subprocess.PIPE)
    srv, ep = _echo_server("ici://127.0.0.1:0#device=cpu")
    ref_client = _start([sys.executable, "-c",
                         _REF_CLIENT.format(repo=REPO, port=ep.port)],
                        _REF_ENV)
    chans = []
    try:
        # port Channel -> brpc_tpu's ici:// server (EchoDevice doubles)
        ch = Channel(f"ici://127.0.0.1:{_port_of(echo)}#device=cpu")
        chans.append(ch)
        assert ch.device_lane_kind() == "staged"
        assert ch._socket.conn.peer_info["can_pull"] is False
        for seed in (31, 32):
            arrays = _np_inputs(seed)[:4]
            c = ch.call_sync("EchoService", "EchoDevice", b"",
                             request_device_arrays=[_to_torch(a)
                                                    for a in arrays])
            assert not c.failed(), c.error_text
            assert c.response == b"dev"
            for a, y in zip(arrays, c.response_device_arrays):
                want = (np.asarray(a, np.float32) * 2).astype(a.dtype)
                assert _same(y, want), (a.dtype, y)
        # port Channel -> port Server in another process
        ch2 = Channel(f"ici://127.0.0.1:{_port_of(port_srv)}#device=cpu")
        chans.append(ch2)
        assert ch2.device_lane_kind() == "staged"
        tensors = [_to_torch(a) for a in _np_inputs(33)]
        c = ch2.call_sync("Perf", "Double", b"",
                          request_device_arrays=tensors)
        assert not c.failed(), c.error_text
        for x, y in zip(tensors, c.response_device_arrays):
            assert torch.equal(y, x * 2) and y.dtype == x.dtype
        # brpc_tpu's Channel (its own process) -> this port Server
        out, err = ref_client.communicate(timeout=60)
        assert ref_client.returncode == 0, err[-3000:]
        res = json.loads(out.strip().splitlines()[-1])
        assert all(not r["failed"] and all(r["same"]) and len(r["same"])
                   == 3 for r in res), res
    finally:
        for c in chans:
            c.close()
        srv.stop()
        srv.join(2)
        echo.kill()
        port_srv.stdin.close()
        for p in (echo, port_srv, ref_client):
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            for f in (p.stdout, p.stderr):
                f.close()


# ------------------------------------------------------------- staging

def case_pinned_staging_freelist():
    pool = iobuf.PinnedBlockPool()
    a = iobuf.pinned_staging_block(100, pool)
    assert not a.pinned and a.tensor.numel() == 100 and len(a.view) == 100
    a.view[:4] = b"abcd"
    assert bytes(a.tensor[:4].numpy()) == b"abcd"
    a.release()
    a.release()                                  # a second is a no-op
    assert pool.classes == {64 << 10: [pool.classes[64 << 10][0]]}
    b = iobuf.pinned_staging_block(60 << 10, pool)
    assert pool.hits == 1 and pool.misses == 1, "the block was not reused"
    c = iobuf.pinned_staging_block(70 << 10, pool)    # the next class
    big = iobuf.pinned_staging_block(100 << 20, pool)  # past the classes
    for s in (b, c, big):
        s.release()
    assert sorted(pool.classes) == [64 << 10, 128 << 10]
    assert pool.cached_bytes() == (64 << 10) + (128 << 10)
    # at most _PINNED_CACHED_PER_CLASS a class are kept
    blocks = [iobuf.pinned_staging_block(1, pool) for _ in range(12)]
    for s in blocks:
        s.release()
    assert len(pool.classes[64 << 10]) == iobuf._PINNED_CACHED_PER_CLASS
    # the stager on the host hands the tensor through
    st = port_pool.DevicePinnedStager()
    x = torch.arange(5.0)
    assert st.land(x, torch.device("cpu")) is x and st.fallback_count == 1


def case_finalizer_under_the_pools_lock():
    """A collection that starts while ``reserve`` holds the pool's lock
    (any allocation there may start one) fires a dead tensor's
    finalizer, which calls ``release`` on the same thread: it must not
    wait for the lock its own thread holds. (Found by the device
    observatory's smoke, whose pipelined windows hung in ``reserve``.)"""
    pool = port_pool.DeviceRecvPool(1 << 20)
    t = torch.zeros(256)
    t.cycle = t                  # freed by the cyclic collector only
    fp = pool.reserve(1024)
    pool.attach_finalizer(t, fp)
    del t
    real = pool._class_index
    fired = []

    def collecting(footprint):
        # runs with the lock held, as an allocation's collection would
        if not fired:
            fired.append(1)
            gc.collect()
        return real(footprint)

    pool._class_index = collecting
    got = []
    th = threading.Thread(target=lambda: got.append(pool.reserve(2048)),
                          daemon=True)
    th.start()
    th.join(5)
    assert not th.is_alive(), "reserve deadlocked on its own finalizer"
    assert fired and got == [8 << 10], got
    assert pool.used == 8 << 10 and pool.reserved_blocks[0] == 1, \
        (pool.used, pool.reserved_blocks)
    pool.release(got[0])
    assert pool.used == 0


CASES = [
    ("round_to_class", case_round_to_class, ()),
    ("pool against reference", case_pool_against_reference, ()),
    ("finalizer with views", case_finalizer_with_views, ()),
    ("a finalizer under the pool's lock",
     case_finalizer_under_the_pools_lock, ()),
    ("frame bytes", case_frame_bytes, ()),
    ("hello bytes", case_hello_bytes, ()),
    ("ipc record codec", case_ipc_record_codec, ()),
    ("local echo", case_local_echo, ()),
    ("window stall and resume", case_window_stall_and_resume, ()),
    ("budget gates sender", case_budget_gates_sender, ()),
    ("mid-size batch alone", case_mid_size_goes_alone, ()),
    ("adaptive grant", case_adaptive_grant, ()),
    ("idle ack", case_idle_ack, ()),
    ("coalesced groups", case_coalesced_groups, ()),
    ("staged between ports", case_staged_between_ports, ()),
    ("leak breaker and grace", case_leak_breaker_and_grace, ()),
    ("exchange grace", case_exchange_grace, ()),
    ("require pull refuses host", case_require_pull_refuses_host, ()),
    ("cross-process staged", case_cross_process_staged, ()),
    ("pinned staging freelist", case_pinned_staging_freelist, ()),
]


def test_ici_lane():
    _run_cases(CASES)
