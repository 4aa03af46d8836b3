"""The port's device payloads against brpc_tpu's, on the CPU.

Tensors ride a call four ways: inline in the frame (tcp://), by
reference (mem://, and cuda:// with ``#device=cpu``), and staged through
the host (cudad://, brpc_tpu's tpud:// wire). The cases hold the port to
brpc_tpu:

- ``DevicePayloadMeta``/``RpcMeta`` bytes equal protobuf's
  ``SerializeToString`` (fp32, bf16, int32, a scalar, a zero-size shape;
  lane and inline), whole frames equal ``pack_message``'s, and the
  port's decoder reads brpc_tpu's bytes, with the shape packed or not;
- tensors inline over tcp://, port to port and both ways with brpc_tpu;
  a request whose tensor names an unknown dtype gets EREQUEST, and a
  response tensor whose host copy fails gets EINTERNAL (inline and on
  cudad://);
- mem:// and cuda:// echo port to port, the same tensor object back,
  and brpc_tpu's mem:// gives equal arrays for the same calls;
- cudad:// port to port and both ways with brpc_tpu's tpud://: equal
  arrays, batch envelopes equal to brpc_tpu's ``_encode_device_batch``,
  the hello read both ways;
- concurrent device calls on one connection, beside a stream whose
  frames carry tensors: every tensor pairs with its own call or frame;
- a handler that calls back through the same mem:// channel;
- IOBuf device blocks;
- no card: a CUDA address raises;
- a process that sends no tensors imports no torch.

Inputs come from numpy seeds. The cases run inside one collected test
(``_run_cases``), so every other test file keeps its place in
pytest-xdist's ``--dist loadfile`` queue (see test_torch_iobuf.py).
"""

import itertools
import sys
import threading
import time
import traceback

import ml_dtypes
import numpy as np
import torch

from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.protocol import tpu_std as ref_std
from brpc_tpu.protocol.proto import tpu_rpc_meta_pb2 as pb
from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc import Service as RefService
from brpc_tpu.transport import tpud as ref_tpud
from brpc_tpu_torch.butil import tensor_bytes
from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                ServerOptions, Service, StreamOptions,
                                stream_accept)
from brpc_tpu_torch.transport import cudad
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher

_names = itertools.count()


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


# ---------------------------------------------------------------- inputs

def _np_inputs(seed):
    """(name, numpy array) pairs; bf16 as ml_dtypes on brpc_tpu's side."""
    rng = np.random.RandomState(seed)
    return [
        ("fp32", rng.randn(3, 5).astype(np.float32)),
        ("bf16", rng.randn(4, 2).astype(np.float32).astype(
            ml_dtypes.bfloat16)),
        ("int32", rng.randint(-1000, 1000, size=(7,)).astype(np.int32)),
        ("scalar", np.array(rng.randn(), dtype=np.float32)),
        ("zero-size", np.zeros((0, 5), dtype=np.float32)),
    ]


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_np(t):
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same(t, a):
    """A port tensor equals a brpc_tpu array: dtype name, shape, bytes."""
    return (tensor_bytes.dtype_name(t) == str(np.asarray(a).dtype)
            and tuple(t.shape) == np.asarray(a).shape
            and tensor_bytes.host_bytes(t) == np.asarray(a).tobytes())


# -------------------------------------------------------------- meta bytes

def _ref_meta(arrays, inline):
    m = pb.RpcMeta()
    m.request.service_name = "Perf"
    m.request.method_name = "Echo"
    m.correlation_id = 77
    for a in arrays:
        dp = m.device_payloads.add()
        dp.dtype = str(a.dtype)
        dp.shape.extend(int(s) for s in a.shape)
        dp.inline_bytes = inline
        dp.nbytes = int(np.prod(a.shape or (1,))) * a.dtype.itemsize
    return m


def case_meta_bytes():
    inputs = _np_inputs(1)
    for inline in (False, True):
        for name, a in inputs:
            t = _to_torch(a)
            want = _ref_meta([a], inline).device_payloads[0]
            got = tpu_std.DevicePayloadMeta.of(t, inline)
            assert got.encode() == want.SerializeToString(), (name, inline)
            back = tpu_std.DevicePayloadMeta.decode(want.SerializeToString())
            assert back == got, (name, back, got)
        # whole frames: brpc_tpu's pack_message of the same call
        arrays = [a for _, a in inputs]
        tensors = [_to_torch(a) for a in arrays]
        m = _ref_meta([], False)
        att = RefIOBuf()
        att.append(b"user-att")
        want, want_lane = ref_std.pack_message(
            m, b"payload", attachment=att, device_arrays=arrays,
            device_lane=not inline)
        meta = tpu_std.RpcMeta(
            request=tpu_std.RpcRequestMeta("Perf", "Echo"),
            correlation_id=77)
        wire, lane = tpu_std.pack_frame(meta, b"payload", b"user-att",
                                        device_arrays=tensors,
                                        device_lane=not inline)
        assert wire == want.to_bytes(), inline
        assert (lane is None) == (want_lane is None)
        # the port reads brpc_tpu's frame back, inline tensors included
        body_size, meta_size = tpu_std.parse_header(wire[:12])
        got_meta, payload, attachment = tpu_std.unpack_body(wire[12:],
                                                            meta_size)
        assert got_meta.encode() == pb.RpcMeta.FromString(
            wire[12:12 + meta_size]).SerializeToString()
        msg = tpu_std.RpcMessage(got_meta, payload, attachment,
                                 tensors if not inline else None)
        merged = tpu_std.merge_device_arrays(msg)
        assert msg.attachment == b"user-att"
        for t, a in zip(merged, arrays):
            assert _same(t, a)
        if not inline:
            # a lane batch that does not match its frame is refused
            short = tpu_std.RpcMessage(got_meta, payload, b"user-att",
                                       tensors[:-1])
            try:
                tpu_std.merge_device_arrays(short)
            except tpu_std.DecodeError:
                pass
            else:
                raise AssertionError("a short lane batch was accepted")
    # an unpacked shape (a writer that does not pack) decodes the same
    dp = pb.DevicePayloadMeta(dtype="int32", shape=[3, 300, 1], nbytes=3600)
    unpacked = (b"\x0a\x05int32" + b"\x10\x03" + b"\x10\xac\x02"
                + b"\x10\x01" + b"\x20\x90\x1c")
    assert pb.DevicePayloadMeta.FromString(unpacked) == dp
    assert tpu_std.DevicePayloadMeta.decode(unpacked) == \
        tpu_std.DevicePayloadMeta.decode(dp.SerializeToString()) == \
        tpu_std.DevicePayloadMeta("int32", (3, 300, 1), False, 3600)
    # names outside the table are refused, both ways
    for bad in ("torch.float32", "float8"):
        try:
            tensor_bytes.torch_dtype(bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{bad} accepted")
    try:
        tensor_bytes.dtype_name(torch.empty(1, dtype=torch.float8_e5m2))
    except TypeError:
        pass
    else:
        raise AssertionError("float8_e5m2 accepted")


# ------------------------------------------------------------- servers

def _port_server(addr):
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
    ep = srv.start(addr)
    return srv, ep


def _ref_server(addr):
    svc = RefService("Perf")

    @svc.method()
    def Echo(cntl, request):
        cntl.response_device_arrays = list(cntl.request_device_arrays)
        return request

    @svc.method()
    def Double(cntl, request):
        cntl.response_device_arrays = [np.asarray(a) * 2 for a in
                                       cntl.request_device_arrays]
        return b"dev"

    srv = RefServer(RefServerOptions(enable_builtin_services=False))
    srv.add_service(svc)
    ep = srv.start(addr)
    return srv, ep


def _stop(srv):
    srv.stop()
    srv.join(2)


def _port_call(ch, method, tensors):
    c = ch.call_sync("Perf", method, b"req", request_device_arrays=tensors)
    assert not c.failed(), (c.error_code, c.error_text)
    return c


def _ref_call(ch, method, arrays):
    c = ch.call_sync("Perf", method, b"req", request_device_arrays=arrays)
    assert not c.failed(), (c.error_code, c.error_text)
    return c


def _inputs_without_bf16_math(seed):
    # Double multiplies: keep dtypes whose product both sides compute the
    # same way (bf16 * 2 is exact too, but numpy's ml_dtypes promotes)
    return [(n, a) for n, a in _np_inputs(seed) if n != "bf16"]


def case_tcp_inline():
    inputs = _np_inputs(2)
    arrays = [a for _, a in inputs]
    tensors = [_to_torch(a) for a in arrays]
    # port <-> port
    srv, ep = _port_server("tcp://127.0.0.1:0")
    try:
        ch = Channel(str(ep))
        assert ch.device_lane_kind() is None
        c = _port_call(ch, "Echo", tensors)
        assert c.response == b"req"
        assert all(_same(t, a) for t, a in zip(c.response_device_arrays,
                                               arrays))
        # brpc_tpu Channel -> port Server
        rch = RefChannel(f"127.0.0.1:{ep.port}")
        dbl = _inputs_without_bf16_math(3)
        rc = _ref_call(rch, "Double", [a for _, a in dbl])
        for (_, a), got in zip(dbl, rc.response_device_arrays):
            np.testing.assert_array_equal(np.asarray(got), a * 2)
            assert np.asarray(got).dtype == a.dtype
        rc = _ref_call(rch, "Echo", arrays)
        for a, got in zip(arrays, rc.response_device_arrays):
            assert np.asarray(got).tobytes() == a.tobytes()
        rch.close()
        ch.close()
    finally:
        _stop(srv)
    # port Channel -> brpc_tpu Server
    rsrv, rep = _ref_server("tcp://127.0.0.1:0")
    try:
        ch = Channel(f"tcp://127.0.0.1:{rep.port}")
        c = _port_call(ch, "Echo", tensors)
        assert all(_same(t, a) for t, a in zip(c.response_device_arrays,
                                               arrays))
        ch.close()
    finally:
        _stop(rsrv)


def case_bad_request_tensors():
    """A request whose inline tensor names a dtype outside the table is
    answered with EREQUEST, not dropped."""
    import socket as pysocket
    srv, ep = _port_server("tcp://127.0.0.1:0")
    try:
        meta = tpu_std.RpcMeta(
            request=tpu_std.RpcRequestMeta("Perf", "Echo"),
            correlation_id=5,
            device_payloads=[tpu_std.DevicePayloadMeta("float8", (2,),
                                                       True, 2)])
        wire, _ = tpu_std.pack_frame(meta, b"", b"\x01\x02")
        with pysocket.create_connection(("127.0.0.1", ep.port), 5) as s:
            s.sendall(wire)
            data = b""
            while len(data) < 12 or len(data) < 12 + tpu_std.parse_header(
                    data[:12])[0]:
                chunk = s.recv(65536)
                assert chunk, "connection closed without an answer"
                data += chunk
        body_size, meta_size = tpu_std.parse_header(data[:12])
        got, _, _ = tpu_std.unpack_body(data[12:12 + body_size], meta_size)
        assert got.correlation_id == 5
        assert got.response.error_code == 1003, got.response
        assert "float8" in got.response.error_text
    finally:
        _stop(srv)


class _NoHostCopy(torch.Tensor):
    """A tensor whose copy to the host fails, as a failed D2H would."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.cpu:
            raise RuntimeError("host copy failed")
        return super().__torch_function__(func, types, args, kwargs or {})


def case_unsendable_response(addr):
    """A response tensor whose host copy raises (in ``pack_frame`` inline,
    in the lane write on cudad://) fails the call with EINTERNAL at once,
    with no batch sent; the connection goes on serving."""
    svc = Service("Perf")

    @svc.method()
    def Bad(cntl, request):
        cntl.response_device_arrays = [
            torch.arange(4, dtype=torch.float32).as_subclass(_NoHostCopy)]
        return b"never"

    @svc.method()
    def Echo(cntl, request):
        cntl.response_device_arrays = list(cntl.request_device_arrays)
        return request

    srv = Server(ServerOptions(enable_builtin_services=False))
    srv.add_service(svc)
    ep = srv.start(addr)
    try:
        ch = Channel(str(ep), ChannelOptions(timeout_ms=20000))
        t0 = time.monotonic()
        c = ch.call_sync("Perf", "Bad", b"req")
        assert time.monotonic() - t0 < 10, "answered by the timeout"
        assert c.error_code == 2001, (c.error_code, c.error_text)
        assert "host copy failed" in c.error_text
        assert c.response_device_arrays == []
        x = torch.arange(6, dtype=torch.int32)
        c = _port_call(ch, "Echo", [x])
        assert torch.equal(c.response_device_arrays[0], x)
        ch.close()
    finally:
        _stop(srv)


def case_loopback_echo():
    """mem:// and cuda://#device=cpu hand tensors over by reference;
    brpc_tpu's mem:// gives equal arrays for the same calls."""
    inputs = _np_inputs(4)
    arrays = [a for _, a in inputs]
    tensors = [_to_torch(a) for a in arrays]
    results = {}
    for addr in (f"mem://dl-{next(_names)}",
                 f"cuda://dl-{next(_names)}:1#device=cpu"):
        srv, ep = _port_server(addr)
        try:
            ch = Channel(str(ep))
            c = _port_call(ch, "Echo", tensors)
            assert all(got is t for got, t in zip(
                c.response_device_arrays, tensors)), addr
            d = _port_call(ch, "Double", tensors[:1])
            results[addr.split(":")[0]] = [_to_np(t) for t in
                                           d.response_device_arrays]
            if addr.startswith("cuda"):
                assert ch.device_lane_kind() == "loopback-d2d"
            ch.close()
        finally:
            _stop(srv)
    rsrv, rep = _ref_server(f"mem://dl-ref-{next(_names)}")
    try:
        rch = RefChannel(str(rep))
        rc = _ref_call(rch, "Echo", arrays)
        for a, got in zip(arrays, rc.response_device_arrays):
            assert np.asarray(got).tobytes() == a.tobytes()
        rd = _ref_call(rch, "Double", arrays[:1])
        ref_double = np.asarray(rd.response_device_arrays[0])
        rch.close()
    finally:
        _stop(rsrv)
    for lane, got in results.items():
        np.testing.assert_array_equal(got[0], ref_double, err_msg=lane)


def case_cudad_interop():
    inputs = _np_inputs(5)
    arrays = [a for _, a in inputs]
    tensors = [_to_torch(a) for a in arrays]
    # the batch envelope is brpc_tpu's, byte for byte
    assert cudad._encode_device_batch(tensors) == \
        ref_tpud._encode_device_batch(arrays)
    for t, a in zip(cudad._decode_device_batch(
            bytearray(ref_tpud._encode_device_batch(arrays))), arrays):
        assert _same(t, a)
    assert cudad._HDR.pack(cudad._F_DEVICE, 9) == \
        ref_tpud._HDR.pack(ref_tpud._F_DEVICE, 9)
    # port <-> port
    srv, ep = _port_server("cudad://127.0.0.1:0#device=cpu")
    try:
        assert str(ep).startswith("cudad://")
        ch = Channel(str(ep))
        c = _port_call(ch, "Echo", tensors)
        assert all(_same(t, a) for t, a in zip(c.response_device_arrays,
                                               arrays))
        assert ch.device_lane_kind() == "staged-dcn"
        assert ch._socket.conn.peer_info == {"device": 0,
                                             "device_type": "cpu"}
        ch.close()
        # brpc_tpu tpud:// Channel -> port cudad:// Server
        rch = RefChannel(f"tpud://127.0.0.1:{ep.port}")
        rc = _ref_call(rch, "Echo", arrays)
        for a, got in zip(arrays, rc.response_device_arrays):
            assert np.asarray(got).tobytes() == a.tobytes()
            assert np.asarray(got).shape == a.shape
        dbl = _inputs_without_bf16_math(6)
        rc = _ref_call(rch, "Double", [a for _, a in dbl])
        for (_, a), got in zip(dbl, rc.response_device_arrays):
            np.testing.assert_array_equal(np.asarray(got), a * 2)
        # brpc_tpu read the port's hello
        assert rch._socket.conn.peer_info["device"] == 0
        rch.close()
    finally:
        _stop(srv)
    # port cudad:// Channel -> brpc_tpu tpud:// Server
    rsrv, rep = _ref_server("tpud://127.0.0.1:0")
    try:
        ch = Channel(f"cudad://127.0.0.1:{rep.port}#device=cpu")
        c = _port_call(ch, "Echo", tensors)
        assert all(_same(t, a) for t, a in zip(c.response_device_arrays,
                                               arrays))
        assert all(t.device.type == "cpu" for t in c.response_device_arrays)
        d = _port_call(ch, "Double", [tensors[0]])
        np.testing.assert_array_equal(_to_np(d.response_device_arrays[0]),
                                      arrays[0] * 2)
        # the port read brpc_tpu's hello
        assert "device" in ch._socket.conn.peer_info
        ch.close()
    finally:
        _stop(rsrv)


def case_concurrent(addr):
    """Six threads of device calls on one connection while the server
    streams tensors back on it: every response and every frame carries
    its own tensor. A short switch interval makes the threads interleave
    inside the pairs that ``lane_lock`` keeps adjacent."""
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _concurrent(addr)
    finally:
        sys.setswitchinterval(saved)


def _concurrent(addr):
    svc = Service("Perf")
    n_frames = 16

    @svc.method()
    def Double(cntl, request):
        cntl.response_device_arrays = [t * 2 for t in
                                       cntl.request_device_arrays]
        return b"dev"

    @svc.method()
    def Frames(cntl, request):
        st = stream_accept(cntl)

        def send():
            rng = np.random.RandomState(7)
            for i in range(n_frames):
                t = torch.from_numpy(
                    np.full((4096,), i, dtype=np.int32)
                    + rng.randint(0, 1, size=(4096,)).astype(np.int32))
                while not st.write_nowait(b"f%d" % i, device_arrays=[t]):
                    time.sleep(0.001)
        threading.Thread(target=send, daemon=True).start()
        return b"ok"

    srv = Server(ServerOptions(enable_builtin_services=False))
    srv.add_service(svc)
    ep = srv.start(addr)
    errs = []
    frames = []
    done = threading.Event()
    try:
        ch = Channel(str(ep), ChannelOptions(timeout_ms=10000))

        def on_received(stream, msg):
            frames.append((msg.payload, msg.device_arrays))
            if len(frames) == n_frames:
                done.set()

        c = ch.call_sync("Perf", "Frames", b"",
                         stream_options=StreamOptions(
                             on_received=on_received))
        assert not c.failed(), c.error_text

        def worker(i):
            try:
                x = torch.full((256,), i, dtype=torch.int32)
                for _ in range(15):
                    r = _port_call(ch, "Double", [x])
                    got = r.response_device_arrays[0]
                    assert int(got[0]) == i * 2 and int(got[-1]) == i * 2, \
                        f"worker {i} got {int(got[0])}"
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(1, 7)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads), "a caller hung"
        assert not errs, errs
        assert done.wait(10), f"{len(frames)} of {n_frames} frames"
        for i, (payload, arrays) in enumerate(frames):
            assert payload == b"f%d" % i
            assert len(arrays) == 1 and bool((arrays[0] == i).all()), \
                f"frame {i} paired with {int(arrays[0][0])}"
        c.stream.close()
        ch.close()
    finally:
        _stop(srv)


def case_callback_through_channel():
    """Handlers that call back through the same mem:// channel. A handler
    never runs in the writer's context nor under its ``lane_lock``: the
    peer learns of the bytes through the dispatcher. The callback is
    issued while the handler runs and completes once it returned (a
    connection's next request waits for the last one's handler: a
    handler that waited on it would wait on itself, as in the
    reference)."""
    name = f"mem://dl-cb-{next(_names)}"
    svc = Service("Perf")
    holder = {}
    seen = []
    nested = []

    @svc.method()
    def Double(cntl, request):
        cntl.response_device_arrays = [t * 2 for t in
                                       cntl.request_device_arrays]
        return b"dev"

    def _note(cntl):
        seen.append((threading.current_thread().name,
                     holder["ch"]._socket.lane_lock.locked()))
        arrays = [t + 1 for t in cntl.request_device_arrays]

        def call():
            nested.append(holder["ch"].call_sync(
                "Perf", "Double", b"", request_device_arrays=arrays))
        t = threading.Thread(target=call)
        t.start()
        holder.setdefault("threads", []).append(t)

    @svc.method()
    def Outer(cntl, request):
        _note(cntl)
        cntl.response_device_arrays = list(cntl.request_device_arrays)
        return b"outer"

    @svc.method()
    async def AsyncOuter(cntl, request):
        _note(cntl)
        cntl.response_device_arrays = list(cntl.request_device_arrays)
        return b"async-outer"

    srv = Server(ServerOptions(enable_builtin_services=False))
    srv.add_service(svc)
    srv.start(name)
    try:
        ch = Channel(name, ChannelOptions(timeout_ms=5000))
        holder["ch"] = ch
        x = torch.from_numpy(np.random.RandomState(8).randint(
            0, 100, size=(64,)).astype(np.int64))
        me = threading.current_thread().name
        for method in ("Outer", "AsyncOuter", "Outer", "AsyncOuter"):
            c = _port_call(ch, method, [x])
            assert c.response_device_arrays[0] is x
        for t in holder["threads"]:
            t.join(10)
            assert not t.is_alive(), "a callback hung"
        assert len(nested) == 4
        for r in nested:
            assert not r.failed(), r.error_text
            assert torch.equal(r.response_device_arrays[0], (x + 1) * 2)
        assert all(thread != me for thread, _ in seen), seen
        # the first handler ran with no callback in flight: nobody held
        # the lane (later ones may see a callback's own write holding it)
        assert not seen[0][1], seen
        ch.close()
    finally:
        _stop(srv)


def case_iobuf_device_blocks():
    """brpc_tpu test_iobuf.py:94-115 over a uint8 tensor."""
    arr = torch.arange(64, dtype=torch.uint8)
    buf = IOBuf()
    buf.append(b"hdr:")
    buf.append_device_array(arr)
    assert buf.size == 68
    assert buf.has_device_blocks()
    head = buf.cut(4)
    assert head.to_bytes() == b"hdr:" and not head.has_device_blocks()
    mid = buf.cut(10)
    # slicing a device block must not copy the backing tensor
    assert mid.refs()[0].block.array is arr
    assert mid.refs()[0].is_device
    assert mid.to_bytes() == bytes(range(10))
    assert buf.to_bytes() == bytes(range(10, 64))
    assert buf.peek_bytes(3) == bytes(range(10, 13))
    assert [t.data_ptr() for t in buf.device_arrays()] == \
        [arr[10:].data_ptr()]
    try:
        buf.refs()[0].memoryview()
    except TypeError:
        pass
    else:
        raise AssertionError("a device ref gave a host memoryview")
    ref = RefIOBuf()
    ref.append(b"hdr:")
    ref.append_device_array(np.arange(64, dtype=np.uint8))
    assert ref.to_bytes() == b"hdr:" + bytes(range(64))
    for bad in (np.arange(4, dtype=np.uint8),
                torch.arange(4, dtype=torch.int32)):
        try:
            IOBuf().append_device_array(bad)
        except TypeError:
            pass
        else:
            raise AssertionError(f"{type(bad)} accepted as a device block")


def case_no_card():
    """Without a card, every CUDA address raises; no host fallback."""
    if torch.cuda.is_available():
        return
    assert str2endpoint("cuda://x:1#device=0").device == "cuda:0"
    assert str2endpoint("cudad://h:1#device=cpu").device == "cpu"
    assert str2endpoint("tcp://h:1").device is None
    for addr in (f"cuda://dl-{next(_names)}:1#device=0",
                 f"cuda://dl-{next(_names)}:1",
                 "cudad://127.0.0.1:0", "cudad://127.0.0.1:0#device=0"):
        srv = Server(ServerOptions(enable_builtin_services=False))
        try:
            srv.start(addr)
        except RuntimeError as e:
            assert "CUDA is not available" in str(e), e
        else:
            _stop(srv)
            raise AssertionError(f"{addr} served without a card")
    # a client asking for its replies on a card fails at connect
    srv, ep = _port_server(f"cuda://dl-{next(_names)}:1#device=cpu")
    try:
        ch = Channel(f"cuda://{ep.host}:1#device=cpu&reply_device=0")
        try:
            ch.call_sync("Perf", "Echo", b"")
        except RuntimeError:
            pass
        else:
            raise AssertionError("reply_device=0 connected without a card")
    finally:
        _stop(srv)


def case_bytes_path_imports_no_torch():
    """A process that serves and calls over tcp:// and mem:// without
    tensors never imports torch (it costs a client process seconds)."""
    import subprocess
    code = (
        "import sys\n"
        "from brpc_tpu_torch.rpc import Channel, Server, Service\n"
        "svc = Service('S')\n"
        "svc.register_method('Echo', lambda cntl, req: req)\n"
        "for addr in ('tcp://127.0.0.1:0', 'mem://no-torch'):\n"
        "    srv = Server(); srv.add_service(svc); ep = srv.start(addr)\n"
        "    c = Channel(str(ep)).call_sync('S', 'Echo', b'x')\n"
        "    assert c.response == b'x', c.error_text\n"
        "    srv.stop(); srv.join(1)\n"
        "print('torch' in sys.modules)\n")
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False", out.stdout


CASES = [
    ("meta bytes", case_meta_bytes, ()),
    ("tcp inline", case_tcp_inline, ()),
    ("bad request tensors", case_bad_request_tensors, ()),
    ("unsendable response tcp", case_unsendable_response,
     ("tcp://127.0.0.1:0",)),
    ("unsendable response cudad", case_unsendable_response,
     ("cudad://127.0.0.1:0#device=cpu",)),
    ("mem and cuda echo", case_loopback_echo, ()),
    ("cudad interop", case_cudad_interop, ()),
    ("concurrent mem", case_concurrent, ("mem://dl-conc",)),
    ("concurrent cuda", case_concurrent, ("cuda://dl-conc:1#device=cpu",)),
    ("concurrent cudad", case_concurrent,
     ("cudad://127.0.0.1:0#device=cpu",)),
    ("concurrent tcp", case_concurrent, ("tcp://127.0.0.1:0",)),
    ("callback through channel", case_callback_through_channel, ()),
    ("iobuf device blocks", case_iobuf_device_blocks, ()),
    ("no card", case_no_card, ()),
    ("bytes path imports no torch", case_bytes_path_imports_no_torch, ()),
]


def test_device_lanes():
    _run_cases(CASES)
