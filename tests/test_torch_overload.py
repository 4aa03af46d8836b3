"""The port's overload control against brpc_tpu's, on the CPU.

- The concurrency limiters (constant, auto, timeout) reach the same
  limits after the same latency sequence, on an injected clock, and
  parse the same spec vocabulary.
- The retry budget drains, refills and throttles the same way; channel
  groups share one bucket.
- The admission controller reaches the same threshold after the same
  level histogram and overload signals; levels, user slots and request
  costs are equal.
- ``RpcResponseMeta.admission_threshold`` (field 3) encodes byte for
  byte as protobuf does, and decodes protobuf's bytes.
- The sheds end to end, port to port and both ways across the wire:
  the queue-delay gate and the limiter shed ELIMIT before the handler,
  priority admission sheds EPRIORITYSHED and its threshold reaches the
  client, which then sheds doomed sends itself; the level's user slot
  is the auth token's when the request has one, the client address's
  otherwise, on both sides; a ClusterChannel in
  front of a shedding server keeps every call, drains no retry token
  and gives the shedding server no latency penalty.
- ``/backends``, ``/lb_trace`` and the ``/status`` overload pane have
  brpc_tpu's keys.

The cases run inside one collected test (``_run_cases`` of
test_torch_cluster.py), each under a time limit of its own, with its
checks for sockets, naming threads, health checks and PeriodicTasks
left behind.
"""

import http.client
import json
import random
import time

from brpc_tpu.protocol.proto import tpu_rpc_meta_pb2 as pb
from brpc_tpu.rpc import admission as ref_adm
from brpc_tpu.rpc import backend_stats as ref_bs
from brpc_tpu.rpc import concurrency_limiter as ref_cl
from brpc_tpu.rpc import retry_policy as ref_retry
from brpc_tpu.rpc import server_dispatch as ref_sd
from brpc_tpu.rpc.channel import nclient_priority_shed as ref_cps

from brpc_tpu_torch.protocol import tpu_std as port_std
from brpc_tpu_torch.rpc import admission as port_adm
from brpc_tpu_torch.rpc import backend_stats as port_bs
from brpc_tpu_torch.rpc import concurrency_limiter as port_cl
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.rpc import retry_policy as port_retry
from brpc_tpu_torch.rpc import server_dispatch as port_sd
from brpc_tpu_torch.rpc.channel import nclient_priority_shed as port_cps

from test_torch_cluster import _FakeClock, _run_cases, _Side, _wait_for

# the /status entries whose source the port does not have yet (as in
# test_torch_builtin.py)
SATURATION_LEFT_OUT = {
    "dispatch_batch_size_avg_10s", "dispatch_batch_size_peak_10s",
    "socket_write_coalesced_frames"}
# a token whose user slot is the highest, 127 (crc32 & 127)
TOP_SLOT_TOKEN = "tok-3"


def _clocked(mods, fn):
    """Run ``fn(clock)`` with the modules' ``time`` on one fake clock."""
    clock = _FakeClock()
    saved = [m.time for m in mods]
    for m in mods:
        m.time = clock
    try:
        fn(clock)
    finally:
        for m, t in zip(mods, saved):
            m.time = t


# ------------------------------------------------------------- limiters

def _drive_limiter(lim, clock, rng):
    """Admissions, releases and latencies from one seeded sequence; the
    limit and the verdicts after each step."""
    trail = []
    held = 0
    for step in range(400):
        clock.t += rng.random() * 0.02
        if rng.random() < 0.55:
            ok = lim.on_requested()
            held += ok
            trail.append(("req", ok))
        elif held:
            held -= 1
            # latency inflates in the middle third of the run
            base = 800.0 * (4.0 if 130 <= step < 260 else 1.0)
            lim.on_responded(base * (0.8 + 0.4 * rng.random()),
                             rng.random() < 0.05)
        trail.append(lim.max_concurrency)
    return trail


def _limiters(clock):
    for make in (lambda m: m.ConstantLimiter(6),
                 lambda m: m.AutoLimiter(initial=8, min_concurrency=2,
                                         max_concurrency=64),
                 lambda m: m.TimeoutLimiter(20.0)):
        got = {}
        for kind, m in (("port", port_cl), ("ref", ref_cl)):
            clock.t = 1000.0
            got[kind] = _drive_limiter(make(m), clock, random.Random(9))
        assert got["port"] == got["ref"]
        assert len(set(x for x in got["port"] if isinstance(x, int))) > 1 \
            or isinstance(make(port_cl), port_cl.ConstantLimiter)
    specs = [None, 5, "7", "constant:3", "auto", "auto:16", "auto:16:4",
             "auto:16:4:100", "timeout:20"]
    for m in (port_cl, ref_cl):
        for bad in ("bogus", "auto:x", 3.5, "constant:"):
            try:
                m.new_limiter(bad)
            except ValueError:
                continue
            raise AssertionError(f"{m.__name__} took {bad!r}")
    shape = {kind: [(type(lim).__name__, lim.max_concurrency)
                    if lim is not None else None
                    for lim in map(m.new_limiter, specs)]
             for kind, m in (("port", port_cl), ("ref", ref_cl))}
    assert shape["port"] == shape["ref"], shape


# ---------------------------------------------------------- retry budget

def _retry_budget():
    got = {}
    for kind, m in (("port", port_retry), ("ref", ref_retry)):
        rb = m.RetryBudget(max_tokens=4, token_ratio=0.5)
        trail = []
        for op in "ddrdddrrrrdrrrrrr":
            (rb.drain if op == "d" else rb.refill)()
            trail.append((rb.tokens(), rb.throttled(), rb.snapshot()))
        a = m.shared_retry_budget(f"g-{kind}", m.RetryBudget(max_tokens=8))
        b = m.shared_retry_budget(f"g-{kind}", True)
        a.drain()
        trail.append((a is b, b.tokens(), m.RetryBudget.resolve(None),
                      m.RetryBudget.resolve(False),
                      type(m.RetryBudget.resolve(True)).__name__))
        low = m.RetryBudget(max_tokens=10)
        for _ in range(9):
            low.drain()
        trail.append(m.min_retry_tokens() <= 1.0)
        try:
            m.RetryBudget.resolve(7)
        except TypeError:
            trail.append("TypeError")
        got[kind] = trail
    assert got["port"] == got["ref"], got


# ------------------------------------------------------------- admission

class _FakeLR:
    def __init__(self, p50):
        self.p50 = p50

    def latency_percentile(self, q):
        return self.p50


class _FakeServer:
    method_status = {"S.fast": _FakeLR(300.0), "S.mid": _FakeLR(5000.0),
                     "S.slow": _FakeLR(50000.0), "S.huge": _FakeLR(2e6),
                     "S.none": _FakeLR(0.0)}


def _admission(clock):
    got = {}
    for kind, m in (("port", port_adm), ("ref", ref_adm)):
        clock.t = 1000.0
        rng = random.Random(21)
        adm = m.AdmissionController(window_s=0.5)
        trail = [adm.threshold_engaged()]
        for step in range(600):
            clock.t += 0.01
            level = m.compose_level(rng.choice([0, 1, 1, 2, 3]),
                                    m.user_slot(f"10.0.0.{rng.randrange(40)}"
                                                f":{rng.randrange(9)}"))
            overloaded = 150 <= step < 380
            if adm.threshold_engaged():
                admitted = adm.admit_level(level)
                if overloaded and rng.random() < 0.3:
                    adm.signal_overload(level, True)
                trail.append(admitted)
            elif overloaded and rng.random() < 0.3:
                adm.signal_overload(level)
            trail.append((adm.wire_threshold(), adm.threshold_engaged()))
        trail.append(adm.admission_snapshot())
        trail.append([m.user_slot(x) for x in ("", "tok", "10.0.0.1:5")])
        trail.append([m.compose_level(p, s) for p, s in
                      ((-3, 5), (0, 130), (2, 17), (500, 1))])
        cm = m.CostModel(_FakeServer())
        trail.append([cm.request_cost(k, n) for k, n in (
            ("S.fast", 10), ("S.mid", 200000), ("S.slow", 0),
            ("S.huge", 100 << 20), ("S.none", 64 << 10), (None, 1))])
        got[kind] = trail
    assert got["port"] == got["ref"]
    assert max(t[0] for t in got["port"] if isinstance(t, tuple)) > 0, \
        "the threshold never rose"


# ---------------------------------------------------------- the wire

def _field3():
    for thr in (0, 1, 127, 128, 300, 2 ** 31 - 1, -5):
        for code, text in ((0, ""), (berr.EPRIORITYSHED, "shed")):
            m = pb.RpcMeta()
            m.correlation_id = 77
            m.response.error_code = code
            m.response.error_text = text
            m.response.admission_threshold = thr
            want = m.SerializeToString()
            mine = port_std.RpcMeta(
                response=port_std.RpcResponseMeta(code, text, thr),
                correlation_id=77)
            assert mine.encode() == want, (thr, code)
            got = port_std.RpcMeta.decode(want)
            assert got.response == port_std.RpcResponseMeta(code, text,
                                                             thr)


# ------------------------------------------------------- sheds end to end

PAIRS = (("port", "port"), ("port", "ref"), ("ref", "port"))


def _counters(kind):
    sd = port_sd if kind == "port" else ref_sd
    return (sd.nlimit_shed.get_value(), sd.npriority_shed.get_value())


def _shed_server(side, **opts):
    """A server with ``Svc.Who`` under ``opts``."""
    async def Who(cntl, request):
        return b"ok:%d" % cntl.request_priority
    srv = side.rpc.Server(side.rpc.ServerOptions(
        enable_builtin_services=False, **opts))
    svc = side.rpc.Service("Svc")
    svc.register_method("Who", Who)
    srv.add_service(svc)
    ep = srv.start("tcp://127.0.0.1:0")

    class _Srv:
        def close(self):
            srv.stop()
            srv.join(2)
    side.items.append(_Srv())
    return srv, f"tcp://127.0.0.1:{ep.port}"


def _gate_sheds():
    for cli, srv_kind in PAIRS:
        with _Side(cli) as c, _Side(srv_kind) as s:
            # the queue-delay gate at 1 us: every request has waited
            # longer between its cut and its dispatch
            _, addr = _shed_server(s, queue_delay_shed_ms=1e-3)
            before = _counters(srv_kind)
            r = c.channel(addr, max_retry=0).call_sync("Svc", "Who", b"")
            assert r.error_code == berr.ELIMIT, (cli, srv_kind,
                                                 r.error_code)
            assert "queue delay" in r.error_text
            assert _counters(srv_kind)[0] == before[0] + 1
            # the limiter at 0 sheds everything
            _, addr = _shed_server(s, max_concurrency=0)
            before = _counters(srv_kind)
            r = c.channel(addr, max_retry=0).call_sync("Svc", "Who", b"")
            assert r.error_code == berr.ELIMIT, (cli, srv_kind,
                                                 r.error_code)
            assert "max_concurrency" in r.error_text
            assert _counters(srv_kind)[0] == before[0] + 1
            # the method's own limiter
            _, addr = _shed_server(s, method_max_concurrency={
                "Svc.Who": 0})
            r = c.channel(addr, max_retry=0).call_sync("Svc", "Who", b"")
            assert r.error_code == berr.ELIMIT, (cli, srv_kind)
            # a limiter of 4 serves
            _, addr = _shed_server(s, max_concurrency=4)
            r = c.channel(addr, max_retry=0).call_sync("Svc", "Who", b"")
            assert not r.failed() and c.body(r) == b"ok:0"


def _priority_sheds():
    for cli, srv_kind in PAIRS:
        with _Side(cli) as c, _Side(srv_kind) as s:
            srv, addr = _shed_server(s, priority_admission=True)
            adm = srv._admission
            # engaged, threshold at class 1's floor, no window closing
            adm.WINDOW_S = 1e9
            adm._armed, adm._threshold = True, 1 << 7
            ch = c.channel(addr, max_retry=0)
            before = _counters(srv_kind)
            low = c.controller()
            r = ch.call_sync("Svc", "Who", b"", cntl=low)
            assert r.error_code == berr.EPRIORITYSHED, (cli, srv_kind)
            assert _counters(srv_kind)[1] == before[1] + 1
            high = c.controller()
            high.request_priority = 1
            r = ch.call_sync("Svc", "Who", b"", cntl=high)
            assert not r.failed() and c.body(r) == b"ok:1", r.error_text
            # the threshold came back on both answers: a class-0 send is
            # now doomed, and fails here without reaching the server
            cps = port_cps if cli == "port" else ref_cps
            n0 = cps.get_value()
            r = ch.call_sync("Svc", "Who", b"", cntl=c.controller())
            assert r.error_code == berr.EPRIORITYSHED
            assert cps.get_value() == n0 + 1
            assert _counters(srv_kind)[1] == before[1] + 1


class _LevelSpy:
    """Wraps a server module's ``_request_level`` and keeps each call's
    (priority, token, client address, level)."""

    def __init__(self, sd):
        self.sd, self.orig, self.seen = sd, sd._request_level, []

    def __enter__(self):
        def spy(priority, auth_token, socket):
            level = self.orig(priority, auth_token, socket)
            ep = socket.remote_endpoint
            self.seen.append((priority, auth_token,
                              f"tcp://{ep.host}:{ep.port}", level))
            return level
        self.sd._request_level = spy
        return self

    def __exit__(self, *exc):
        self.sd._request_level = self.orig


def _engage(srv, threshold):
    """Admission engaged at ``threshold``, with no window to close."""
    adm = srv._admission
    adm.WINDOW_S = 1e9
    adm._armed, adm._threshold = True, threshold


def _token_levels():
    """With and without an auth token, the level a server computes is
    brpc_tpu.rpc.admission's, both ways across the wire: the token's
    slot when there is one, else the client address's."""
    assert ref_adm.user_slot(TOP_SLOT_TOKEN) == 127
    for cli, srv_kind in PAIRS:
        with _Side(cli) as c, _Side(srv_kind) as s, \
                _LevelSpy(port_sd if srv_kind == "port" else ref_sd) as spy:
            srv, addr = _shed_server(s, priority_admission=True)
            _engage(srv, 0)                 # engaged, sheds nothing
            ch = c.channel(addr, max_retry=0)
            for token in ("", "alice", TOP_SLOT_TOKEN):
                for prio in (0, 2):
                    cntl = c.controller()
                    cntl.request_priority = prio
                    cntl.auth_token = token
                    r = ch.call_sync("Svc", "Who", b"", cntl=cntl)
                    assert not r.failed(), (cli, srv_kind, r.error_text)
            assert len(spy.seen) == 6, spy.seen
            for prio, token, client, level in spy.seen:
                slot = ref_adm.user_slot(token) if token \
                    else ref_adm.user_slot(client)
                assert level == ref_adm.compose_level(prio, slot), \
                    (cli, srv_kind, prio, token, level)
                assert level == port_adm.compose_level(
                    prio, port_adm.user_slot(token or client))


def _token_doomed_send():
    """A client judges a doomed send by the server's level: with the
    threshold at class 0's top slot, a call with a top-slot token still
    goes out after the threshold came back, one without it fails at the
    client (EPRIORITYSHED, client_priority_shed) before the wire."""
    top = ref_adm.compose_level(0, 127)
    for cli, srv_kind in PAIRS:
        with _Side(cli) as c, _Side(srv_kind) as s:
            srv, addr = _shed_server(s, priority_admission=True)
            _engage(srv, top)
            ch = c.channel(addr, max_retry=0)
            cps = port_cps if cli == "port" else ref_cps

            def call(token):
                cntl = c.controller()
                cntl.auth_token = token
                return ch.call_sync("Svc", "Who", b"", cntl=cntl)
            r = call(TOP_SLOT_TOKEN)    # at the threshold: served
            assert not r.failed(), (cli, srv_kind, r.error_text)
            # the connection's own slot is under 127 for this address
            sock_slot = ref_adm.user_slot(
                "tcp://127.0.0.1:%d" % next(iter(
                    srv.connections())).remote_endpoint.port)
            if sock_slot == 127:
                continue                # the address is at the top too
            before, n0 = _counters(srv_kind), cps.get_value()
            r = call("")
            assert r.error_code == berr.EPRIORITYSHED, (cli, srv_kind)
            assert cps.get_value() == n0 + 1, (cli, srv_kind)
            assert _counters(srv_kind) == before    # never reached it
            r = call(TOP_SLOT_TOKEN)    # not doomed: the token's level
            assert not r.failed(), (cli, srv_kind, r.error_text)
            assert cps.get_value() == n0 + 1


def _reject_discipline():
    """la over a server that sheds everything and one that serves: every
    call succeeds, the budget keeps its tokens, the shedding server's
    latency estimate takes no sample and its breaker never trips."""
    got = {}
    for kind in ("port", "ref"):
        with _Side(kind) as side:
            _, shed = _shed_server(side, max_concurrency=0)
            _, ok = _shed_server(side)
            retry = port_retry if kind == "port" else ref_retry
            rb = retry.RetryBudget(max_tokens=10)
            ch = side.cluster(f"list://{shed},{ok}", "la", retry_budget=rb,
                              max_retry=2, name=f"reject-{kind}")
            shed_ep = side.ep(shed)
            ewma0 = ch._lb.decision_info(shed_ep)["lat_ewma_us"]
            retried = 0
            for _ in range(20):
                r = ch.call_sync("Svc", "Who", b"")
                assert not r.failed(), (kind, r.error_code, r.error_text)
                retried += r.current_try
            info = ch._lb.decision_info(shed_ep)
            bs = port_bs if kind == "port" else ref_bs
            row = bs.global_stats().cell(f"reject-{kind}",
                                         bs.ep_key(shed_ep)).get_value()
            state = ch.backend_state(bs.ep_key(shed_ep))
            assert retried > 0 and info["rejects"] == retried
            assert info["lat_ewma_us"] == ewma0, (kind, info, ewma0)
            assert rb.tokens() == 10.0, (kind, rb.tokens())
            assert row["rejects"] == retried and row["latency_avg_us"] == 0
            assert state.get("breaker", {}).get("trips", 0) == 0
            got[kind] = (info["inflight"], row["inflight"],
                         row["errors_ELIMIT"] == retried)
    assert got["port"] == got["ref"] == (0, 0, True), got


# ---------------------------------------------------------------- pages

def _get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        assert r.status == 200, (path, r.status)
        return json.loads(r.read())
    finally:
        conn.close()


def _drain_health(server):
    return 503, "text/plain", b"draining"


def _page_keys():
    pages = {}
    for kind in ("port", "ref"):
        with _Side(kind) as side:
            srv = side.rpc.Server(side.rpc.ServerOptions(
                max_concurrency=8, health_reporter=_drain_health))
            svc = side.rpc.Service("Svc")
            svc.register_method("Who", lambda cntl, req: b"ok")
            srv.add_service(svc)
            port = srv.start("tcp://127.0.0.1:0").port
            name = f"pages-{kind}"
            ch = side.cluster(f"list://tcp://127.0.0.1:{port}", "la",
                              name=name, retry_budget=True)
            for _ in range(3):
                assert not ch.call_sync("Svc", "Who", b"").failed()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("GET", "/health")
            r = conn.getresponse()
            health = (r.status, r.read())
            conn.close()
            status = _get_json(port, "/status")
            backends = _get_json(port, "/backends")
            trace_dir = _get_json(port, "/lb_trace")
            trace = _get_json(port, f"/lb_trace?channel={name}&n=50")
            entry = backends["channels"][name]
            # this server's row: a channel of another case may have
            # used the name, and its rows stay until it is collected
            row = entry["backends"][f"tcp://127.0.0.1:{port}"]
            pages[kind] = {
                "saturation": set(status["saturation"]) - SATURATION_LEFT_OUT,
                "backends": set(backends),
                "totals": set(backends["totals"]),
                "entry": set(entry),
                "naming": set(entry["naming"]),
                "budget": set(entry["retry_budget"]),
                "row": set(row),
                "state": set(row["state"]),
                "trace_dir": set(trace_dir),
                "trace": set(trace),
                "events": {e["kind"]: tuple(sorted(e)) for e in
                           trace["events"]},
                "health": health,
            }
            srv.stop()
            srv.join(2)
    assert pages["port"] == pages["ref"], pages
    assert {"concurrency_limit", "limit_shed", "priority_shed",
            "admission_threshold", "retry_tokens"} <= \
        pages["port"]["saturation"]
    assert pages["port"]["health"] == (503, b"draining")


CASES = [
    ("limiters on an injected clock", _clocked,
     ((port_cl, ref_cl), _limiters)),
    ("retry budget", _retry_budget, ()),
    ("admission on an injected clock", _clocked,
     ((port_adm, ref_adm), _admission)),
    ("RpcResponseMeta field 3", _field3, ()),
    ("queue-delay and limiter sheds", _gate_sheds, ()),
    ("priority sheds and the client's cache", _priority_sheds, ()),
    ("levels with and without a token, both ways", _token_levels, ()),
    ("a token changes a doomed send's slot", _token_doomed_send, ()),
    ("the reject discipline", _reject_discipline, ()),
    ("/backends, /lb_trace and /status keys", _page_keys, ()),
]


def test_overload_control():
    _run_cases(CASES)
