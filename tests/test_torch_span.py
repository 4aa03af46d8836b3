"""The port's rpcz spans against brpc_tpu.rpc.span, on the CPU.

``Span.to_dict`` and ``stage_breakdown`` for the same stamps, the
collector ring, the flush latch in both orders, the on-disk store, the
trace fields of ``RpcMeta`` (8-10) against protobuf's bytes, and traces
across the wire both ways: a brpc_tpu Channel calling a port Server, and
a port Channel calling a brpc_tpu Server.
"""

import importlib
import json
import time
from types import SimpleNamespace

import pytest

from brpc_tpu.protocol.proto import tpu_rpc_meta_pb2 as pb
from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import ChannelOptions as RefChannelOptions
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc import Service as RefService
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service

PACKAGES = {"reference": "brpc_tpu", "port": "brpc_tpu_torch"}


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


def _pkg(root):
    return SimpleNamespace(
        span=importlib.import_module(f"{root}.rpc.span"),
        flags=importlib.import_module(f"{root}.butil.flags"))


@pytest.fixture
def rpcz(monkeypatch, tmp_path):
    """rpcz on in both packages, an empty global ring in each, both
    processes' wall-clock anchors equal; everything restored after."""
    pkgs = {name: _pkg(root) for name, root in PACKAGES.items()}
    for name, p in pkgs.items():
        monkeypatch.setattr(p.span, "_REAL_OFFSET_US", 1_700_000_000_000_000)
        before = {f: p.flags.flag(f) for f in ("rpcz_enabled", "rpcz_dir")}
        p.flags.set_flag("rpcz_enabled", True)
        p.span.global_collector.clear()
        monkeypatch.setattr(p, "restore", before, raising=False)
    yield pkgs
    for p in pkgs.values():
        p.span.global_collector.clear()
        for f, v in p.restore.items():
            p.flags.set_flag(f, v)


def _both(rpcz, case):
    got = {name: case(p) for name, p in rpcz.items()}
    assert got["port"] == got["reference"]
    return got["port"]


# ------------------------------------------------------------- to_dict

STAMPS = {
    "server": dict(start_us=1000, received_us=1000, dispatch_us=1040,
                   parse_done_us=1041, handler_start_us=1050,
                   handler_end_us=1900, serialized_us=1910,
                   flushed_us=1930, end_us=1940),
    "client": dict(start_us=500, write_done_us=560, first_byte_us=2100,
                   parse_done_us=2110, end_us=2120),
    "serving": dict(start_us=1060, write_done_us=1400, first_byte_us=1700,
                    serialized_us=5200, end_us=5300),
}


@pytest.mark.parametrize("side", sorted(STAMPS))
@pytest.mark.parametrize("reached", ["all", "none"])
def test_to_dict_equals_reference(rpcz, side, reached):
    def case(p):
        stamps = STAMPS[side] if reached == "all" else {
            "start_us": STAMPS[side]["start_us"],
            "end_us": STAMPS[side]["end_us"]}
        s = p.span.Span(trace_id=0xABC, span_id=(1 << 64) - 1,
                        parent_span_id=7, side=side, service="S",
                        method="M", remote_side="tcp://1.2.3.4:5",
                        error_code=1008, log_id=9, request_size=11,
                        response_size=13, **stamps)
        s.annotations.append((1234, "note"))
        return s.stage_breakdown(), s.to_dict(), s.latency_us

    breakdown, d, latency = _both(rpcz, case)
    if side == "serving":
        assert d["queue_us"] + d["prefill_us"] + d["decode_us"] + \
            d["emit_us"] == latency
    assert d["base_real_us"] == d["start_us"] + 1_700_000_000_000_000


# ----------------------------------------------------------- collector

def test_collector_ring_and_find_trace(rpcz):
    def case(p):
        c = p.span.SpanCollector(capacity=16)
        for i in range(40):
            c.submit(p.span.Span(trace_id=i % 5 + 1, span_id=i + 1))
        out = {"recent": [s.span_id for s in c.recent(6)],
               "all": len(c.recent(100)),
               "one": [s.span_id for s in c.find_trace(3)],
               "either": sorted(s.span_id for s in c.find_trace({2, 4}))}
        p.flags.set_flag("rpcz_enabled", False)
        c.submit(p.span.Span(trace_id=9, span_id=99))   # off: dropped
        out["off"] = len(c.find_trace(9))
        p.flags.set_flag("rpcz_enabled", True)
        c.clear()
        out["cleared"] = c.recent()
        return out

    out = _both(rpcz, case)
    assert out["recent"] == [35, 36, 37, 38, 39, 40] and out["all"] == 16


@pytest.mark.parametrize("order", ["finish_first", "flush_first",
                                   "flush_failed"])
def test_flush_latch_submits_once(rpcz, order):
    def case(p):
        sp = p.span
        span = sp.start_server_span(
            SimpleNamespace(trace_id=77, span_id=5, remote_side=None,
                            log_id=0), "S", "M")
        cntl = SimpleNamespace(error_code=0, remote_side="tcp://9.9.9.9:1")
        sp.expect_flush(span)
        seen = []
        count = lambda: len(sp.global_collector.find_trace(77))  # noqa: E731
        if order == "finish_first":
            sp.finish_span(span, cntl)
            seen.append(count())
            time.sleep(0.002)
            sp.mark_flushed(span)
        else:
            sp.mark_flushed(span, None if order == "flush_first"
                            else ConnectionError("gone"))
            seen.append(count())
            sp.finish_span(span, cntl)
        seen.append(count())
        sp.mark_flushed(span)       # a late second flush submits nothing
        seen.append(count())
        return {"seen": seen, "flushed": bool(span.flushed_us),
                "covers_flush": span.end_us >= span.flushed_us,
                "parent": span.parent_span_id, "remote": span.remote_side}

    out = _both(rpcz, case)
    assert out["seen"] == [0, 1, 1]


def test_span_store_read_back(rpcz, tmp_path):
    def case(p):
        d = tmp_path / p.span.__name__.split(".")[0]
        assert p.flags.set_flag("rpcz_dir", str(d))
        store = p.span.SpanStore()
        for i in range(10):
            s = p.span.Span(trace_id=100 + i % 3, span_id=i + 1,
                            side="client", start_us=10 * i,
                            end_us=10 * i + 5)
            store.write(s)
        rows = store.read(4)
        by_trace = store.read(100, trace_id=101)
        either = store.read(100, trace_id={100, 102})
        store.flush()
        lines = (d / "rpcz_spans.jsonl").read_text().splitlines()
        strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                           if k != "pid"}
        return {"last4": [strip(r) for r in rows],
                "trace": [r["span_id"] for r in by_trace],
                "either": [r["span_id"] for r in either],
                "lines": len(lines),
                "first": strip(json.loads(lines[0]))}

    out = _both(rpcz, case)
    assert [r["span_id"] for r in out["last4"]] == [
        f"{i:016x}" for i in (7, 8, 9, 10)]
    assert out["trace"] == [f"{i:016x}" for i in (2, 5, 8)]


# Two stores on one rpcz_dir, as the processes of a shard group share
# theirs: (store, spans) batches, each batch written and then flushed.
# "deterministic": B writes, A writes past the cap and rotates, then both
# write again, B's handle still on the renamed file. "alternating": the
# stores take turns every 32 spans.
SHARED_DIR_SEQUENCES = {
    "deterministic": [("B", 32)] + [("A", 32)] * 62 + [("A", 16), ("A", 32),
                                                       ("B", 32)],
    "alternating": [("AB"[i % 2], 32) for i in range(250)],
}


def _store_lines(d):
    n = 0
    for name in ("rpcz_spans.jsonl.1", "rpcz_spans.jsonl"):
        path = d / name
        if path.exists():
            for line in path.read_text().splitlines():
                try:
                    json.loads(line)
                except ValueError:
                    continue
                n += 1
    return n


@pytest.mark.parametrize("sequence", sorted(SHARED_DIR_SEQUENCES))
def test_span_store_shared_dir_keeps_what_one_store_keeps(tmp_path,
                                                          sequence):
    """Two SpanStores on one directory keep what one store keeps given
    the same batches (within one batch of 32): a store whose handle names
    a file that another one rotated away must neither append to it nor
    rotate the other's fresh file over the aged one."""
    from brpc_tpu_torch.butil.flags import flag, set_flag
    from brpc_tpu_torch.rpc import span as sp

    batches = SHARED_DIR_SEQUENCES[sequence]
    before = {f: flag(f) for f in ("rpcz_dir", "rpcz_db_max_bytes")}
    assert set_flag("rpcz_db_max_bytes", 1 << 20)
    kept = {}
    try:
        for how in ("one", "two"):
            d = tmp_path / how
            assert set_flag("rpcz_dir", str(d))
            one = sp.SpanStore()
            stores = {"A": one, "B": one if how == "one" else sp.SpanStore()}
            sid = 0
            for who, n in batches:
                for _ in range(n):
                    sid += 1
                    stores[who].write(sp.Span(
                        trace_id=sid, span_id=sid, parent_span_id=sid >> 1,
                        side="client", service="GenerateService",
                        method="Generate", start_us=sid, end_us=sid + 900,
                        remote_side="tcp://127.0.0.1:54321"))
                stores[who].flush()
            kept[how] = _store_lines(d)
    finally:
        for f, v in before.items():
            set_flag(f, v)
    total = sum(n for _, n in batches)
    if sequence == "deterministic":
        assert kept == {"one": total, "two": total}, kept
    else:
        assert kept["one"] < total
        assert abs(kept["two"] - kept["one"]) <= 32, kept


# ---------------------------------------------------------- RpcMeta 8-10

@pytest.mark.parametrize("trace,span,parent", [
    (1, 2, 3), ((1 << 64) - 1, 1 << 63, 0), (0xDEADBEEF, 0, 12345),
    (0, 0, 0)])
def test_rpc_meta_trace_fields_byte_equal(trace, span, parent):
    m = pb.RpcMeta(correlation_id=42, trace_id=trace, span_id=span,
                   parent_span_id=parent)
    m.request.service_name = "GenerateService"
    m.request.method_name = "Generate"
    m.request.log_id = 9
    mine = tpu_std.RpcMeta(
        request=tpu_std.RpcRequestMeta("GenerateService", "Generate", 9),
        correlation_id=42, trace_id=trace, span_id=span,
        parent_span_id=parent)
    assert mine.encode() == m.SerializeToString()
    back = tpu_std.RpcMeta.decode(m.SerializeToString())
    assert back == mine
    m2 = pb.RpcMeta()
    m2.ParseFromString(mine.encode())
    assert (m2.trace_id, m2.span_id, m2.parent_span_id) == (trace, span,
                                                            parent)


# ------------------------------------------------------------- the wire

def _port_echo_server():
    server = Server()
    svc = Service("Echo")
    svc.register_method("Echo", lambda cntl, req: bytes(req))
    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    return server, f"tcp://127.0.0.1:{ep.port}"


def _ref_echo_server():
    server = RefServer(RefServerOptions(enable_builtin_services=False))
    svc = RefService("Echo")

    @svc.method()
    def Echo(cntl, request):
        return bytes(request)

    server.add_service(svc)
    ep = server.start("tcp://127.0.0.1:0")
    return server, f"tcp://127.0.0.1:{ep.port}"


def _check_linked(client_spans, server_spans):
    assert len(client_spans) == 1 and len(server_spans) == 1
    c, s = client_spans[0], server_spans[0]
    assert c.side == "client" and s.side == "server"
    assert s.trace_id == c.trace_id != 0
    assert s.parent_span_id == c.span_id
    assert (s.service, s.method) == ("Echo", "Echo")
    assert s.received_us and s.handler_start_us <= s.handler_end_us
    # the flush stamp comes from the response write's on_done
    assert s.serialized_us and s.flushed_us >= s.serialized_us
    # both stamped; the write's completion may land after the response
    # (both packages stamp it on the sending side, racing the reader)
    assert c.write_done_us and c.first_byte_us


@pytest.mark.parametrize("calls", [1, 3])
def test_trace_ref_client_to_port_server(rpcz, calls):
    ref, port = rpcz["reference"].span, rpcz["port"].span
    server, address = _port_echo_server()
    ch = RefChannel(address, RefChannelOptions(timeout_ms=5000))
    try:
        for i in range(calls):
            cntl = ch.call_sync("Echo", "Echo", b"hi %d" % i)
            assert not cntl.failed(), cntl.error_text
            tid = cntl.trace_id
            assert _wait_for(lambda: ref.global_collector.find_trace(tid)
                             and port.global_collector.find_trace(tid))
            _check_linked(ref.global_collector.find_trace(tid),
                          port.global_collector.find_trace(tid))
            # the port's server span ends after its flush
            s = port.global_collector.find_trace(tid)[0]
            assert s.flushed_us and s.end_us >= s.flushed_us
    finally:
        ch.close()
        server.stop()
        server.join(2)


@pytest.mark.parametrize("calls", [1, 3])
def test_trace_port_client_to_ref_server(rpcz, calls):
    ref, port = rpcz["reference"].span, rpcz["port"].span
    server, address = _ref_echo_server()
    ch = Channel(address, ChannelOptions(timeout_ms=5000))
    try:
        for i in range(calls):
            cntl = ch.call_sync("Echo", "Echo", b"hi %d" % i)
            assert not cntl.failed(), cntl.error_text
            tid = cntl.trace_id
            assert _wait_for(lambda: ref.global_collector.find_trace(tid)
                             and port.global_collector.find_trace(tid))
            _check_linked(port.global_collector.find_trace(tid),
                          ref.global_collector.find_trace(tid))
            c = port.global_collector.find_trace(tid)[0]
            assert c.parse_done_us >= c.first_byte_us
            assert c.response_size == len(b"hi %d" % i)
    finally:
        ch.close()
        server.stop()
        server.join(2)


def test_rpcz_off_sends_no_trace(rpcz):
    """With the flag off, a call carries no trace and leaves no span."""
    port = rpcz["port"]
    port.flags.set_flag("rpcz_enabled", False)
    server, address = _port_echo_server()
    ch = Channel(address, ChannelOptions(timeout_ms=5000))
    try:
        cntl = ch.call_sync("Echo", "Echo", b"x")
        assert not cntl.failed() and cntl.trace_id == 0
        time.sleep(0.05)
        assert port.span.global_collector.recent() == []
    finally:
        ch.close()
        server.stop()
        server.join(2)
