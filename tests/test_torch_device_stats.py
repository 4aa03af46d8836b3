"""The port's device telemetry against brpc_tpu's, on the CPU.

- ``DeviceCell.get_value()`` keys and values, and the balance
  ``transfers == completed + failed``, against brpc_tpu's ``DeviceCell``
  fed the same stamps;
- a tracker's stage + wire + ack equal its device span's latency, the
  span inherits the owning span's trace, and its ``to_dict`` has the
  keys of brpc_tpu's device span;
- with rpcz off no device span is submitted, and the cells still count;
- the staged fallback annotates the span and counts in the cell;
- ``/device`` over HTTP and the builtin ``device`` method give the same
  payload, with the keys of brpc_tpu's page;
- the Prometheus dump labels each cell by peer and lane, and /vars stays
  JSON;
- ``device_stats_enabled`` off records nothing;
- a ``mem://`` call with tensors: a device span and a ``device-recv``
  span on each side, children of the client and the server span;
- the device poller's waiter threads carry a device label while they
  wait.

Inputs come from numpy seeds. The cases run inside one collected test
(``_run_cases``), so every other test file keeps its place in
pytest-xdist's ``--dist loadfile`` queue (see test_torch_iobuf.py).
Every port flag a case sets is restored; brpc_tpu's flags are not
touched.
"""

import http.client
import json
import threading
import time
import traceback

import numpy as np
import torch

from brpc_tpu.rpc.span import Span as RefSpan
from brpc_tpu.transport import device_stats as ref_ds
from brpc_tpu_torch.butil.flags import flag, set_flag
from brpc_tpu_torch.bvar.prometheus import dump_prometheus
from brpc_tpu_torch.bvar.variable import dump_exposed
from brpc_tpu_torch.fiber import DeviceEventPoller
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                ServerOptions, Service)
from brpc_tpu_torch.rpc.span import Span, global_collector
from brpc_tpu_torch.transport import device_stats as ds
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher

_seq = iter(range(1 << 30))


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
        global_collector.clear()

    def __exit__(self, *exc):
        for k, v in self.old.items():
            set_flag(k, v)


def _server(addr, builtin=False):
    svc = Service("DevSvc")

    @svc.method()
    def EchoDevice(cntl, request):
        cntl.response_device_arrays = list(cntl.request_device_arrays)
        return b"dev"

    srv = Server(ServerOptions(enable_builtin_services=builtin))
    srv.add_service(svc)
    return srv, srv.start(addr)


def _stop(srv):
    srv.stop()
    srv.join(2)


def _device_spans(send: bool):
    """The collector's device spans: sends carry the encode/flush
    stamps, receive spans do not."""
    return [s for s in global_collector.recent(400) if s.side == "device"
            and bool(s.write_done_us or s.first_byte_us) == send]


# ------------------------------------------------------------ the cells

def case_cell_against_reference():
    rng = np.random.RandomState(41)
    mine, ref = ds.DeviceCell(), ref_ds.DeviceCell()
    for _ in range(60):
        nbytes = int(rng.randint(0, 1 << 20))
        for c in (mine, ref):
            c.note_open(nbytes)
        stage, wire, ack = (float(x) for x in rng.uniform(0, 900, 3))
        failed = bool(rng.rand() < 0.2)
        leaked = failed and bool(rng.rand() < 0.5)
        for c in (mine, ref):
            c.note_done(stage, wire, ack, nbytes, failed, leaked=leaked)
        if rng.rand() < 0.5:
            rus, rbytes = float(rng.uniform(0, 300)), int(rng.randint(1, 99))
            for c in (mine, ref):
                c.note_recv(rus, rbytes)
    a, b = mine.get_value(), ref.get_value()
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        if k != "bytes_per_second":      # a window on each one's sampler
            assert a[k] == b[k], (k, a[k], b[k])
    assert a["transfers"] == a["completed"] + a["failed"] == 60
    assert mine.samples(1000) == ref.samples(1000)
    # the registry: one cell per (peer, lane), bounded
    reg = ds.DeviceStats()
    assert reg.device_cell("p", "l") is reg.device_cell("p", "l")
    assert ds.peer_key(type("E", (), {"scheme": "ici", "host": "h",
                                      "port": 9})()) == "ici://h:9"


def case_tracker_stages_sum_and_trace():
    with _flags(rpcz_enabled=True):
        parent = Span(trace_id=0x1234, span_id=0x99, log_id=5)
        peer = f"trk-{next(_seq)}"
        t = ds.open_transfer(peer, "test-lane", 4096, parent_span=parent)
        time.sleep(0.002)
        t.lane_encoded()
        time.sleep(0.002)
        t.lane_flushed()
        time.sleep(0.002)
        t.lane_acked()
        t.lane_acked()                   # a second settle does nothing
        (s,) = [x for x in global_collector.recent(50)
                if x.side == "device" and x.remote_side == peer]
        d = s.to_dict()
        assert d["stage_us"] + d["wire_us"] + d["ack_us"] == \
            d["latency_us"] > 0, d
        assert min(d["stage_us"], d["wire_us"], d["ack_us"]) >= 1000, d
        assert s.trace_id == parent.trace_id and \
            s.parent_span_id == parent.span_id and s.log_id == 5
        assert d["method"] == "test-lane" and d["request_size"] == 4096
        ref = RefSpan(trace_id=1, span_id=2, side="device").to_dict()
        assert set(d) == set(ref), set(d) ^ set(ref)
        cell = t.cell.get_value()
        assert cell["transfers"] == cell["completed"] == 1


def case_no_spans_with_rpcz_off():
    with _flags(rpcz_enabled=False):
        srv, ep = _server("mem://ds-off")
        ch = Channel(str(ep))
        try:
            cell = ds.global_device_stats().device_cell(
                ds.peer_key(ep), "mem")
            n0 = cell.get_value()["transfers"]
            c = ch.call_sync("DevSvc", "EchoDevice", b"",
                             request_device_arrays=[torch.ones(64)])
            assert not c.failed(), c.error_text
            assert global_collector.recent(50) == []
            assert cell.get_value()["transfers"] == n0 + 1
        finally:
            ch.close()
            _stop(srv)


def case_staged_fallback_annotates():
    from brpc_tpu_torch.butil.endpoint import str2endpoint
    from brpc_tpu_torch.transport import ici
    tr = ici.IciTransport(window=4)
    got = []
    lst = tr.listen(str2endpoint("ici://127.0.0.1:0#device=cpu"),
                    got.append)
    client = tr.connect(str2endpoint(
        f"ici://127.0.0.1:{lst.endpoint.port}#device=cpu"))
    try:
        buf = bytearray(1 << 16)
        assert _wait_for(lambda: _pump(client, buf)
                         or client.peer_info is not None)
        # a peer in another process without a pull lane: staged
        client.peer_info = dict(client.peer_info, proc="elsewhere")
        t = ds.open_transfer(f"sf-{next(_seq)}", "staged", 64,
                             parent_span=Span(trace_id=7, span_id=9))
        client.write_device_payload([torch.zeros(16)], tracker=t)
        assert t.staged
        cell = t.cell.get_value()
        assert cell["staged_fallbacks"] == 1
        assert any("staged_fallback" in txt
                   for _, txt in t.span.annotations)
    finally:
        client.close()
        for c in got:
            c.close()
        lst.stop()


def _pump(conn, buf):
    try:
        conn.read_into(memoryview(buf))
    except (BlockingIOError, ConnectionError):
        pass
    return False


# ------------------------------------------------------------ the page

def _http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def case_page_twins_agree():
    srv, ep = _server("tcp://127.0.0.1:0", builtin=True)
    dsrv, dep = _server("ici://127.0.0.1:0#device=cpu")
    ch = Channel(str(dep))
    admin = Channel(str(ep), ChannelOptions(timeout_ms=5000))
    try:
        for _ in range(3):
            c = ch.call_sync("DevSvc", "EchoDevice", b"",
                             request_device_arrays=[torch.ones(512)])
            assert not c.failed(), c.error_text
        # the last batches settle when their ACK comes (the idle ACK)
        assert _wait_for(lambda: all(
            v["transfers"] == v["completed"] + v["failed"]
            for k, v in ds.device_page_payload()["cells"].items()
            if k.endswith("|local-d2d")))
        status, body = _http_get(ep.port, "/device")
        assert status == 200
        page = json.loads(body)
        c = admin.call_sync("builtin", "device", b"")
        assert not c.failed(), c.error_text
        twin = json.loads(bytes(c.response))
        # one function: the same structure and cells (a late ack may move
        # a count between the two reads)
        assert set(page) == set(twin)
        assert page["cells"].keys() == twin["cells"].keys()
        assert page["enabled"] and twin["enabled"]
        assert page["transfer_lane"] == twin["transfer_lane"]
        assert any(r["lane_kind"] == "local-d2d" for r in page["conns"])
        assert {"capacity", "used", "reserved_blocks"} <= \
            set(page["recv_pool"])
        assert "pinned_bytes_estimate" in page["leaks"]
        # brpc_tpu's page has the same keys, less the probe pane that
        # waits for shard groups
        ref = ref_ds.device_page_payload()
        assert set(ref) - {"recv_pool", "leaks", "probe"} <= set(page)
        lane_cells = [v for k, v in page["cells"].items()
                      if k.endswith("|local-d2d")]
        assert lane_cells and all(
            v["transfers"] == v["completed"] + v["failed"]
            for v in lane_cells)
        (any_cell,) = lane_cells[:1]
        assert set(any_cell) - {"latency_samples"} == \
            set(ref_ds.DeviceCell().get_value())
    finally:
        ch.close()
        admin.close()
        _stop(dsrv)
        _stop(srv)


def case_prometheus_labels():
    peer = f"prom-{next(_seq)}"
    ds.global_device_stats().device_cell(peer, "test-lane").note_open(64)
    ds.expose_device_vars()
    lines = [ln for ln in dump_prometheus().splitlines()
             if ln.startswith("device_stats") and f'peer="{peer}"' in ln]
    assert any(ln.startswith("device_stats_transfers{") for ln in lines)
    assert all('lane="test-lane"' in ln for ln in lines), lines
    dumped = json.dumps(dict(dump_exposed("device_stats")), default=str)
    assert f"{peer}|test-lane" in dumped


def case_disabled_records_nothing():
    with _flags(device_stats_enabled=False, rpcz_enabled=True):
        assert ds.open_transfer("x", "y", 1, parent_span=Span(1, 2)) is None
        srv, ep = _server("mem://ds-disabled")
        ch = Channel(str(ep))
        try:
            before = {k: c.get_value()["transfers"]
                      for k, c in ds.global_device_stats().rows()}
            c = ch.call_sync("DevSvc", "EchoDevice", b"",
                             request_device_arrays=[torch.ones(8)])
            assert not c.failed()
            after = {k: c.get_value()["transfers"]
                     for k, c in ds.global_device_stats().rows()}
            assert after == before
            assert not [s for s in global_collector.recent(50)
                        if s.side == "device"]
        finally:
            ch.close()
            _stop(srv)


def case_recv_spans_both_sides():
    with _flags(rpcz_enabled=True):
        srv, ep = _server("mem://ds-recv")
        ch = Channel(str(ep))
        try:
            c = ch.call_sync("DevSvc", "EchoDevice", b"",
                             request_device_arrays=[torch.ones(100)])
            assert not c.failed(), c.error_text
            # the server span is submitted once its response is flushed
            assert _wait_for(lambda: len(_device_spans(False)) >= 2
                             and len(_device_spans(True)) >= 2
                             and any(s.side == "server" for s in
                                     global_collector.recent(400)))
            spans = global_collector.recent(400)
            client = [s for s in spans if s.side == "client"]
            server = [s for s in spans if s.side == "server"]
            assert len(client) == 1 and len(server) == 1
            ids = {"client": client[0].span_id, "server": server[0].span_id}
            recvs = _device_spans(False)
            sends = _device_spans(True)
            # the request: sent under the client span, received under
            # the server span; the response the other way round
            assert {s.parent_span_id for s in recvs} == set(ids.values())
            assert {s.parent_span_id for s in sends} == set(ids.values())
            for s in recvs:
                assert any("device-recv" in t for _, t in s.annotations)
                assert s.request_size == 400 and s.method == "mem"
            for s in sends:
                d = s.to_dict()
                assert d["stage_us"] + d["wire_us"] + d["ack_us"] == \
                    d["latency_us"]
            assert all(s.trace_id == client[0].trace_id
                       for s in recvs + sends)
        finally:
            ch.close()
            _stop(srv)


def case_poller_threads_labelled():
    poller = DeviceEventPoller(name=f"ds_poller_{next(_seq)}")
    release = threading.Event()
    seen = {}

    class _Blocking:
        def query(self):
            return release.is_set()

        def synchronize(self):
            seen["label"] = ds.device_thread_label(threading.get_ident())
            seen["tid"] = threading.get_ident()
            release.wait(5)

    fired = threading.Event()
    poller.watch(_Blocking(), fired.set)
    assert _wait_for(lambda: "label" in seen)
    release.set()
    assert fired.wait(5)
    assert seen["label"] == "device:wait"
    assert _wait_for(lambda: ds.device_thread_label(seen["tid"]) is None)

    class _Polled:
        def query(self):
            seen.setdefault("pump", ds.device_thread_label(
                threading.get_ident()))
            return True

    done = threading.Event()
    poller._pending.append((_Polled(), done.set))
    poller._ensure_thread()
    assert done.wait(5)
    assert seen["pump"] == f"device:{poller._name}"
    poller.stop()


CASES = [
    ("cell against reference", case_cell_against_reference, ()),
    ("tracker stages sum and trace", case_tracker_stages_sum_and_trace, ()),
    ("no spans with rpcz off", case_no_spans_with_rpcz_off, ()),
    ("staged fallback annotates", case_staged_fallback_annotates, ()),
    ("page twins agree", case_page_twins_agree, ()),
    ("prometheus labels", case_prometheus_labels, ()),
    ("disabled records nothing", case_disabled_records_nothing, ()),
    ("recv spans both sides", case_recv_spans_both_sides, ()),
    ("poller threads labelled", case_poller_threads_labelled, ()),
]


def test_device_stats():
    _run_cases(CASES)
