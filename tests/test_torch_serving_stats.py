"""The port's serving flight deck against brpc_tpu.serving.serving_stats,
on the CPU.

A GenTracker driven with injected times gives the reference's cell
values, reservoirs, span and step records; the panes have the
reference's keys; and a CPU server with rpcz on leaves one serving span
per Generate call (unary, stream and HTTP), whose four stages sum to its
latency and whose trace is the call's.
"""

import http.client
import importlib
import json
import threading
import time
from types import SimpleNamespace

import pytest

from brpc_tpu_torch.butil.flags import flag, set_flag
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, StreamOptions
from brpc_tpu_torch.rpc import span as port_span
from brpc_tpu_torch.serving import add_generate_service

PACKAGES = {"reference": "brpc_tpu", "port": "brpc_tpu_torch"}
T0 = 5_000_000_000          # injected monotonic ns


def _pkg(root):
    return SimpleNamespace(
        ss=importlib.import_module(f"{root}.serving.serving_stats"),
        span=importlib.import_module(f"{root}.rpc.span"),
        flags=importlib.import_module(f"{root}.butil.flags"))


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


@pytest.fixture
def frozen(monkeypatch):
    """Both modules read a clock the case sets; rpcz on, rings empty."""
    clock = {"ns": T0}
    fake = SimpleNamespace(monotonic_ns=lambda: clock["ns"],
                           time_ns=lambda: clock["ns"])
    pkgs = {}
    for name, root in PACKAGES.items():
        p = _pkg(root)
        monkeypatch.setattr(p.ss, "time", fake)
        monkeypatch.setattr(p.span, "_REAL_OFFSET_US", 10 ** 15)
        was = p.flags.flag("rpcz_enabled")
        p.flags.set_flag("rpcz_enabled", True)
        p.span.global_collector.clear()
        p.was = was
        pkgs[name] = p
    yield clock, pkgs
    for p in pkgs.values():
        p.flags.set_flag("rpcz_enabled", p.was)
        p.span.global_collector.clear()


def _drive(p, clock, state, cause, stamps, with_span):
    """One generation through a fresh cell: created at T0, then the
    stamps (admit, prefill, tokens...) at the given offsets in µs."""
    cell = p.ss.ServingCell()
    cell.note_gen_open()
    span = None
    if with_span:
        span = p.span.Span(trace_id=0x77, span_id=0x88, parent_span_id=0x99,
                           side="serving", service="GenerateService",
                           method="Generate", start_us=T0 // 1000)
    tr = p.ss.GenTracker(cell, span, T0)
    if "admit" in stamps:
        tr.gen_admitted(T0 + stamps["admit"] * 1000)
    if "prefill" in stamps:
        tr.gen_prefilled(T0 + stamps["prefill"] * 1000)
    for t in stamps.get("tokens", ()):
        tr.gen_token(T0 + t * 1000)
    clock["ns"] = T0 + stamps["now"] * 1000
    tr.gen_settled(state, cause=cause,
                   finished_ns=T0 + stamps["fin"] * 1000
                   if "fin" in stamps else 0, error_code=stamps.get("err", 0))
    tr.gen_settled("completed")         # a second settle changes nothing
    out = {"cell": cell.get_value(), "ttft": cell.ttft_samples(),
           "tpot": cell.tpot_samples(), "ntokens": tr.ntokens,
           "first": tr.t_first_token}
    if span is not None:
        d = span.to_dict()
        d.pop("pid")
        d["annotations"] = [a["text"] for a in d["annotations"]]
        out["span"] = d
        out["submitted"] = len(p.span.global_collector.find_trace(0x77))
    return out


GENERATIONS = {
    "completed": ("completed", None, dict(admit=300, prefill=900,
                                          tokens=(1500, 2600, 3100, 4700),
                                          fin=4800, now=5000)),
    "evicted": ("evicted", "deadline_expired",
                dict(admit=200, prefill=500, tokens=(900,), fin=2000,
                     now=2100, err=1008)),
    "shed": ("shed", "queue_full", dict(fin=40, now=50, err=2004)),
    "rejected": ("rejected", "prompt_too_long", dict(now=10, err=1003)),
    "canceled_waiting": ("canceled", "client_gone", dict(fin=700, now=750)),
}


@pytest.mark.parametrize("with_span", [False, True])
@pytest.mark.parametrize("gen", sorted(GENERATIONS))
def test_tracker_equals_reference(frozen, gen, with_span):
    clock, pkgs = frozen
    state, cause, stamps = GENERATIONS[gen]
    got = {name: _drive(p, clock, state, cause, stamps, with_span)
           for name, p in pkgs.items()}
    assert got["port"] == got["reference"]
    out = got["port"]
    assert out["cell"]["settled"] == out["cell"]["requests"] == 1
    if with_span:
        d = out["span"]
        assert out["submitted"] == 1
        assert d["queue_us"] + d["prefill_us"] + d["decode_us"] + \
            d["emit_us"] == d["latency_us"] == stamps["now"]


def test_step_ring_and_panes_equal_reference(frozen):
    clock, pkgs = frozen
    recs = [(1000 + i, i % 3, 4, 1, 0, 0, 4, 2, 3, 0.25, 10, 200, 900,
             30, 1140) for i in range(6)]
    got = {}
    for name, p in pkgs.items():
        reg = p.ss.ServingStats()
        for r in recs:
            reg.note_step_record(r)
        glob = p.ss.global_serving_stats()
        glob.serving_cell("GenerateService.Generate")
        pane = p.ss.serving_obs_pane()
        row = next(iter(pane["methods"].values()))
        got[name] = {"steps": reg.step_records(4),
                     "total": reg.steps_recorded(),
                     "pane_keys": sorted(pane), "row_keys": sorted(row),
                     "ttft_keys": sorted(pane["ttft"]),
                     "tpot_keys": sorted(pane["tpot"])}
    assert got["port"] == got["reference"]
    assert got["port"]["total"] == 6 and len(got["port"]["steps"]) == 4


def test_merge_panes_equals_reference():
    panes = [
        {"enabled": True, "tokens_per_second_10s": 10.5, "steps_total": 3,
         "methods": {"S.M": {"requests": 3, "completed": 2, "shed": 1,
                             "max_ttft_us": 900.0, "causes": {"queue_full": 1},
                             "ttft_samples": [100.0, 900.0, 300.0],
                             "tpot_samples": [10.0, 12.0]}},
         "steps": [{"t_ms": 1, "batch": 2}]},
        {"enabled": False, "tokens_per_second_10s": 2.0, "steps_total": 1,
         "methods": {"S.M": {"requests": 1, "completed": 1,
                             "max_ttft_us": 400.0, "causes": {},
                             "ttft_samples": [400.0],
                             "tpot_samples": [11.0] * 300}},
         "steps": [{"t_ms": 2, "batch": 1}]},
    ]
    got = {name: _pkg(root).ss.merge_serving_panes(json.loads(
        json.dumps(panes))) for name, root in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"]["methods"]["S.M"]["requests"] == 4


def test_thread_labels():
    ss = _pkg("brpc_tpu_torch").ss
    ss.stamp_serving_thread("serving:decode")
    try:
        assert ss.serving_thread_label(threading.get_ident()) == \
            "serving:decode"
    finally:
        ss.unstamp_serving_thread()
    assert ss.serving_thread_label(threading.get_ident()) is None


# --------------------------------------------------------- a CPU server

@pytest.fixture
def traced_server():
    was = flag("rpcz_enabled")
    set_flag("rpcz_enabled", True)
    port_span.global_collector.clear()
    server = Server()
    gs = add_generate_service(server, device="cpu")
    ep = server.start("tcp://127.0.0.1:0")
    yield gs, ep
    server.stop()
    server.join(5)
    set_flag("rpcz_enabled", was)
    port_span.global_collector.clear()


def _serving_spans():
    return [s for s in port_span.global_collector.recent(4096)
            if s.side == "serving"]


def test_every_call_leaves_one_serving_span(traced_server):
    gs, ep = traced_server
    ch = Channel(str(ep), ChannelOptions(timeout_ms=30000))
    body = lambda p: json.dumps(  # noqa: E731
        {"prompt": p, "max_tokens": 6}).encode()
    traces = []
    try:
        for i in range(2):                                   # unary
            c = ch.call_sync("GenerateService", "Generate", body(f"u{i}"))
            assert not c.failed(), c.error_text
            traces.append(c.trace_id)
        for i in range(2):                                   # stream
            done = threading.Event()
            c = ch.call_sync(
                "GenerateService", "Generate", body(f"s{i}"),
                stream_options=StreamOptions(
                    on_received=lambda s, m: m.payload[:1] == b"d"
                    and done.set()))
            assert not c.failed() and done.wait(30)
            c.stream.close()
            traces.append(c.trace_id)
    finally:
        ch.close()
    conn = http.client.HTTPConnection("127.0.0.1", ep.port, timeout=30)
    try:
        for i in range(2):                                   # HTTP
            conn.request("POST", "/GenerateService/Generate",
                         body=body(f"h{i}"))
            r = conn.getresponse()
            assert r.status == 200 and r.read().endswith(b"completed n=6")
    finally:
        conn.close()
    assert _wait_for(lambda: len(_serving_spans()) == 6)
    spans = _serving_spans()
    for s in spans:
        d = s.to_dict()
        assert d["queue_us"] + d["prefill_us"] + d["decode_us"] + \
            d["emit_us"] == d["latency_us"] > 0
        assert d["write_done_us"] and d["first_byte_us"]
    by_trace = {s.trace_id: s for s in spans}
    for tid in traces:                  # tpu_std: the call's own trace
        server_span = [s for s in port_span.global_collector.find_trace(tid)
                       if s.side == "server"]
        assert len(server_span) == 1
        assert by_trace[tid].parent_span_id == server_span[0].span_id
    http_spans = [s for s in spans if s.trace_id not in set(traces)]
    assert len(http_spans) == 2 and all(
        s.parent_span_id == 0 for s in http_spans)
    cell = gs._payload()["stats"]["methods"]["GenerateService.Generate"]
    assert cell["completed"] >= 6 and cell["tokens_out"] >= 36


def test_shed_settles_with_its_cause(traced_server):
    """A request refused at the door settles at once: one span, its cause
    in the annotations, all its time in queue_us."""
    gs, ep = traced_server
    ch = Channel(str(ep), ChannelOptions(timeout_ms=30000))
    try:
        c = ch.call_sync("GenerateService", "Generate",
                         json.dumps({"prompt": "x" * 400}).encode())
        assert c.failed() and c.error_code == 1003
    finally:
        ch.close()
    assert _wait_for(lambda: len(_serving_spans()) == 1)
    d = _serving_spans()[0].to_dict()
    assert any("rejected: prompt_too_long" in a["text"]
               for a in d["annotations"])
    assert d["queue_us"] == d["latency_us"] and d["error_code"] == 1003


def test_stats_off_costs_one_flag_check(traced_server):
    gs, ep = traced_server
    set_flag("serving_stats_enabled", False)
    try:
        ch = Channel(str(ep), ChannelOptions(timeout_ms=30000))
        try:
            c = ch.call_sync("GenerateService", "Generate",
                             b'{"prompt": "off", "max_tokens": 3}')
            assert not c.failed()
        finally:
            ch.close()
        time.sleep(0.05)
        assert _serving_spans() == []
        assert gs._payload()["stats"]["enabled"] is False
    finally:
        set_flag("serving_stats_enabled", True)
