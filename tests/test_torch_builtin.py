"""The port's builtin pages and service, on a CPU server.

Every page answers; an unknown one gives 404; ``/vars/<prefix>`` and
``/flags/<name>`` reach their pages, not the method table; Generate
still streams over HTTP beside them; and ``/status``, ``/vars`` and
``/serving`` have brpc_tpu's keys for the same services, less the
entries the port leaves out on purpose (named below).
"""

import http.client
import json

import pytest

from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.serving import add_generate_service as ref_add_generate
from brpc_tpu_torch.butil.flags import flag, set_flag
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server
from brpc_tpu_torch.rpc.server import ServerOptions
from brpc_tpu_torch.serving import add_generate_service

# the reference's entries whose source the port does not have yet
STATUS_LEFT_OUT = set()
SATURATION_LEFT_OUT = set()
CONNECTIONS_LEFT_OUT = set()
BUILTIN_METHODS_LEFT_OUT = set()
# /serving: batcher fields that differ between the two lanes since the
# port's first slices (the port names its device, keeps steps by fiber
# worker group under its own name, and its TTFT window; the reference
# lists the waiting requests)
SERVING_REF_ONLY = {"steps_by_worker_group", "waiting_detail"}
SERVING_PORT_ONLY = {"device", "steps_by_group", "ttft_ms"}
ENGINE_PORT_ONLY = {"warmup_steps"}
# /vars: the families both servers expose; the port's contention
# counters are exposed at import, the reference's when first contended
VAR_FAMILIES = ("fiber_", "serving_", "process_", "system_", "server_")
VARS_LEFT_OUT = set()
# the auth gate's refusals (HTTP, gRPC and thrift), which the reference
# does not count
VARS_PORT_ONLY = {"server_auth_refused"}


def _get(port, path, method="GET", body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _generate_http(port, prompt="hi", n=4):
    status, ctype, body = _get(port, "/GenerateService/Generate", "POST",
                               json.dumps({"prompt": prompt,
                                           "max_tokens": n}).encode())
    assert status == 200, body
    return body


@pytest.fixture(scope="module")
def port_server():
    was = flag("rpcz_enabled")
    set_flag("rpcz_enabled", True)
    server = Server()
    add_generate_service(server, device="cpu")
    ep = server.start("tcp://127.0.0.1:0")
    _generate_http(ep.port)
    ch = Channel(str(ep), ChannelOptions(timeout_ms=30000))
    cntl = ch.call_sync("GenerateService", "Generate",
                        b'{"prompt": "rpc", "max_tokens": 3}')
    assert not cntl.failed()
    ch.close()
    yield server, ep.port, cntl.trace_id
    server.stop()
    server.join(5)
    set_flag("rpcz_enabled", was)


@pytest.fixture(scope="module")
def ref_server():
    server = RefServer(RefServerOptions())
    ref_add_generate(server)
    ep = server.start("tcp://127.0.0.1:0")
    _generate_http(ep.port)
    yield server, ep.port
    server.stop()
    server.join(5)


PAGES = ["/", "/health", "/status", "/vars", "/vars/fiber",
         "/vars?prefix=serving_", "/brpc_metrics", "/metrics", "/flags",
         "/connections", "/serving", "/rpcz", "/rpcz?n=3",
         "/rpcz?history=1", "/contentions", "/contentions?n=5", "/version",
         "/timeline", "/timeline?prefix=server_", "/census", "/capture",
         "/incidents", "/fibers", "/fibers?stacks=1", "/bthreads",
         "/threads", "/vlog", "/hotspots?mode=continuous", "/sockets", "/ids",
         "/hotspots?seconds=0.1&interval_ms=1", "/pprof/profile?seconds=0.1"]


@pytest.mark.parametrize("path", PAGES)
def test_page_answers(port_server, path):
    status, ctype, body = _get(port_server[1], path)
    assert status == 200 and body
    if ctype == "application/json":
        json.loads(body)


@pytest.mark.parametrize("path,status", [
    ("/nope", 404), ("/a/b/c", 404), ("/GenerateService/Nope", 404),
    ("/rpcz?trace_id=zz", 400), ("/rpcz?n=x", 400),
    ("/flags/no_such_flag?setvalue=1", 400)])
def test_unknown_or_bad(port_server, path, status):
    assert _get(port_server[1], path)[0] == status


def test_vars_prefix_reaches_the_page(port_server):
    """``/vars/<prefix>`` has two parts, like a method call."""
    body = _get(port_server[1], "/vars/fiber_")[2].decode()
    names = [ln.split(" : ")[0] for ln in body.splitlines()]
    assert names and all(n.startswith("fiber_") for n in names)
    assert "fiber_wake" in names
    q = _get(port_server[1], "/vars?prefix=serving_")[2].decode()
    assert "serving_requests" in q and "fiber_" not in q


def test_rpcz_by_trace_id(port_server):
    _, port, tid = port_server
    for spelling in (f"{tid:016x}", f"{tid:x}"):
        spans = json.loads(_get(port, f"/rpcz?trace_id={spelling}")[2])
        # the client ran in this process: its span is in the ring too
        assert sorted(s["side"] for s in spans) == ["client", "server",
                                                    "serving"]
        assert {s["trace_id"] for s in spans} == {f"{tid:016x}"}


def test_flags_set_through_the_page(port_server):
    port = port_server[1]
    before = flag("rpcz_max_spans")
    try:
        assert _get(port, "/flags/rpcz_max_spans?setvalue=2048",
                    "POST", b"")[:1] == (200,)
        assert flag("rpcz_max_spans") == 2048
        assert "rpcz_max_spans = 2048" in _get(port, "/flags")[2].decode()
        assert _get(port, "/flags/rpcz_max_spans?setvalue=1")[0] == 400
    finally:
        set_flag("rpcz_max_spans", before)


def test_prometheus_lines_parse(port_server):
    import re
    line = re.compile(r'^[A-Za-z_:][A-Za-z0-9_:]*(\{[^{}]*\})? '
                      r'[-+]?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?$')
    text = _get(port_server[1], "/brpc_metrics")[2].decode()
    lines = text.splitlines()
    assert lines and all(line.match(ln) for ln in lines)
    assert 'serving_stats_requests{method="GenerateService.Generate"}' \
        in text


def test_generate_still_streams(port_server):
    body = _generate_http(port_server[1], "beside the pages", 8)
    payload, _, footer = body.rpartition(b"\n#")
    assert footer == b"completed n=8" and len(payload) == 8


def test_builtin_service_over_tpu_std(port_server):
    server, port, _ = port_server
    ch = Channel(f"tcp://127.0.0.1:{port}", ChannelOptions(timeout_ms=5000))
    try:
        for method in ("status", "serving", "connections"):
            c = ch.call_sync("builtin", method, b"")
            assert not c.failed(), c.error_text
            assert isinstance(json.loads(c.response), dict)
        c = ch.call_sync("builtin", "vars", b"fiber_")
        assert "fiber_wake" in json.loads(c.response)
        assert ch.call_sync("builtin", "health").response == b"OK"
        assert ch.call_sync("builtin", "prometheus_metrics").response
    finally:
        ch.close()


def test_builtin_services_off():
    server = Server(ServerOptions(enable_builtin_services=False))
    ep = server.start("tcp://127.0.0.1:0")
    try:
        assert _get(ep.port, "/status")[0] == 404
        assert _get(ep.port, "/vars/fiber")[0] == 404
        assert "builtin" not in server.services()
    finally:
        server.stop()
        server.join(2)


# ----------------------------------------------- keys against brpc_tpu

def _json_page(port, path):
    status, _, body = _get(port, path)
    assert status == 200
    return json.loads(body)


def test_status_keys_match_reference(port_server, ref_server):
    mine = _json_page(port_server[1], "/status")
    ref = _json_page(ref_server[1], "/status")
    assert set(mine) == set(ref) - STATUS_LEFT_OUT
    assert set(mine["saturation"]) == \
        set(ref["saturation"]) - SATURATION_LEFT_OUT
    assert set(mine["services"]["builtin"]) == \
        set(ref["services"]["builtin"]) - BUILTIN_METHODS_LEFT_OUT
    assert mine["services"]["GenerateService"] == \
        ref["services"]["GenerateService"]
    m = mine["method_status"]["GenerateService.Generate"]
    assert set(m) == set(ref["method_status"]["GenerateService.Generate"])
    assert m["count"] >= 2


def test_connections_keys_match_reference(port_server, ref_server):
    mine = _json_page(port_server[1], "/connections")
    ref = _json_page(ref_server[1], "/connections")
    assert set(mine) == set(ref) - CONNECTIONS_LEFT_OUT


def test_serving_keys_match_reference(port_server, ref_server):
    mine = _json_page(port_server[1], "/serving")
    ref = _json_page(ref_server[1], "/serving")
    assert set(mine) - SERVING_PORT_ONLY == set(ref) - SERVING_REF_ONLY
    assert set(mine["engine"]) - ENGINE_PORT_ONLY == set(ref["engine"])
    assert set(mine["stats"]) == set(ref["stats"])
    key = "GenerateService.Generate"
    assert set(mine["stats"]["methods"][key]) == \
        set(ref["stats"]["methods"][key])


def test_vars_names_match_reference(port_server, ref_server):
    def names(port):
        body = _get(port, "/vars")[2].decode()
        return {ln.split(" : ")[0] for ln in body.splitlines()
                if ln.startswith(VAR_FAMILIES)}
    mine, ref = names(port_server[1]), names(ref_server[1])
    assert mine == (ref - VARS_LEFT_OUT) | VARS_PORT_ONLY
