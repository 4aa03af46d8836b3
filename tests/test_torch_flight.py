"""The port's flight recorder, profiler pages, fiber stacks, census and
logging against brpc_tpu's, on the CPU.

- The renders (text, folded, SVG flamegraph, continuous and diff text)
  of brpc_tpu's profiler and the port's are equal on the same counts.
- The scheduler's current-fiber cells: a sampler thread reads the fiber
  a worker steps (``thread_current_fiber``), and a dead thread's cell
  goes on the second missing snapshot, not the first.
- End to end on a port server: the continuous profile labels a busy
  handler's samples with its method; an on-demand profile answers in
  every format while a second at once is refused with 503; a handler
  that holds the event dispatcher is counted once as a stall and
  annotated into its rpcz span; the sampler stops with the last server.
- ``/fibers?stacks=1``, ``/threads``, ``/census`` (brpc_tpu's keys, every
  registered provider), ``/vlog``, and VLOG's verbosity rules equal to
  brpc_tpu's.

The cases run inside one collected test (``_run_cases`` of
test_torch_cluster.py), each under a time limit of its own, with its
checks for sockets and threads left behind; brpc_tpu's state a case
touches is restored.
"""

import http.client
import json
import signal
import threading
import time
from collections import Counter

import numpy as np

import brpc_tpu.fiber.timer  # noqa: F401  (registers its census)
import brpc_tpu.rpc.backend_stats  # noqa: F401
import brpc_tpu.rpc.span  # noqa: F401
import brpc_tpu.serving.serving_stats  # noqa: F401
import brpc_tpu.transport.device_stats  # noqa: F401
import brpc_tpu.transport.socket  # noqa: F401
from brpc_tpu.builtin import flight_recorder as ref_fr
from brpc_tpu.builtin import profiler as ref_prof
from brpc_tpu.builtin import services as ref_services
from brpc_tpu.butil import logging as ref_log

import brpc_tpu_torch.fiber as port_fiber
import brpc_tpu_torch.rpc as port_rpc
import brpc_tpu_torch.serving.serving_stats  # noqa: F401
from brpc_tpu_torch.builtin import flight_recorder as port_fr
from brpc_tpu_torch.builtin import profiler as port_prof
from brpc_tpu_torch.butil import flags as port_flags
from brpc_tpu_torch.butil import logging as port_log
from brpc_tpu_torch.butil import resource_census as port_census
from brpc_tpu_torch.fiber import scheduler as port_sched
from brpc_tpu_torch.fiber import stacks as port_stacks
from brpc_tpu_torch.rpc.span import global_collector
from brpc_tpu_torch.transport import event_dispatcher as port_ed

from test_torch_cluster import _run_cases, _wait_for

# per subsystem, the census keys whose source the port does not have
CENSUS_LEFT_OUT = {"iobuf_pool": {"outstanding"},     # no debug tracking
                   "sockets": {"idle"}}               # no activity stamp


def _get(port, path, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


class _PortFlags:
    def __init__(self, **values):
        self.values, self.old = values, {}

    def __enter__(self):
        for k, v in self.values.items():
            self.old[k] = port_flags.flag(k)
            assert port_flags.set_flag(k, v), (k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            port_flags.set_flag(k, v)


class _Server:
    """A port server with one service of handlers; closed on exit."""

    def __init__(self, handlers, name="Flt"):
        svc = port_rpc.Service(name)
        for mname, fn in handlers.items():
            svc.register_method(mname, fn)
        self.srv = port_rpc.Server()
        self.srv.add_service(svc)
        self.port = self.srv.start("tcp://127.0.0.1:0").port
        self.ch = port_rpc.Channel(f"tcp://127.0.0.1:{self.port}",
                                   port_rpc.ChannelOptions(timeout_ms=20000))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.ch.close()
        self.srv.stop()
        self.srv.join(2)


def _counts(rng, n=40):
    frames = [f"f{i} (m{i % 3}.py:{i})" for i in range(12)]
    folded, leaves = Counter(), Counter()
    for _ in range(n):
        depth = rng.randint(1, 7)
        stack = [frames[rng.randint(0, 12)] for _ in range(depth)]
        w = int(rng.randint(1, 50))
        folded["rpc:S.M;" + ";".join(stack) + ";x<&>\"y"] += w
        leaves[stack[-1]] += w
    return folded, leaves


def _renders_equal():
    rng = np.random.RandomState(5)
    for _ in range(4):
        folded, leaves = _counts(rng)
        n = sum(folded.values()) + 17
        assert port_prof.render_text(leaves, n) == \
            ref_prof.render_text(leaves, n)
        assert port_prof.render_folded(folded) == \
            ref_prof.render_folded(folded)
        svg = port_prof.render_flamegraph_svg(folded)
        assert svg == ref_prof.render_flamegraph_svg(folded)
        assert svg.startswith("<svg") and "&lt;&amp;&gt;" in svg
        m = {"nsamples": n, "nbusy": sum(folded.values()), "windows": 3,
             "span_s": 12.5, "folded": folded, "labels": Counter(
                 {"rpc:S.M": 30, "thread:x": 4}), "stall_ms_max_10s": 1.5}
        assert port_fr.render_continuous_text(m) == \
            ref_fr.render_continuous_text(m)
        delta = {k: v - 3 for k, v in folded.items()}
        for d in ({"ok": True, "cur_samples": 9, "prev_samples": 4,
                   "delta": delta}, {"ok": False, "reason": "why"},
                  {"ok": True, "cur_samples": 0, "prev_samples": 0,
                   "delta": {}}):
            assert port_fr.render_diff_text(d) == ref_fr.render_diff_text(d)
    assert port_prof.render_text(Counter(), 0) == \
        ref_prof.render_text(Counter(), 0)


def _thread_cells():
    """A worker's current fiber read from this thread, and the prune's
    two strikes."""
    stop = threading.Event()
    seen = {}

    def spin():
        seen["fiber"] = port_sched.current_fiber()
        seen["tid"] = threading.get_ident()
        while not stop.is_set():       # holds its worker, never parks
            pass
    f = port_fiber.spawn(spin, name="cell_spin")
    try:
        assert _wait_for(lambda: "tid" in seen)
        assert seen["fiber"] is f
        assert port_sched.thread_current_fiber(seen["tid"]) is f
        assert port_sched.thread_current_fiber(threading.get_ident()) \
            is None
    finally:
        stop.set()
    assert _wait_for(lambda: port_sched.thread_current_fiber(
        seen["tid"]) is not f)
    box = {}

    def touch():
        port_sched.current_fiber()      # registers this thread's cell
        box["tid"] = threading.get_ident()
    t = threading.Thread(target=touch)
    t.start()
    t.join()
    tid = box["tid"]
    assert tid in port_sched._cell_by_thread
    live = set(threading._active)       # the dead thread is not in it
    # (a running sampler prunes too, and would strike in between; and a
    # thread id is reused, so an old snapshot's suspects are cleared)
    quiet = not port_fr.global_recorder().running()
    port_sched._prune_suspects = set()
    port_sched.prune_thread_registry(live)
    assert tid in port_sched._cell_by_thread or not quiet, \
        "pruned on one strike"
    port_sched.prune_thread_registry(live)
    assert tid not in port_sched._cell_by_thread


def _spin(cntl, request):
    t_end = time.monotonic() + float(bytes(request).decode() or "0.4")
    n = 0
    while time.monotonic() < t_end:
        n += 1
    return b"%d" % n


def _attribution():
    """The continuous profile gives a busy handler's samples to its
    method, and the JSON view has brpc_tpu's text view's numbers."""
    with _PortFlags(continuous_profiler_hz=200), \
            _Server({"Spin": _spin}) as s:
        port_fr.global_recorder().clear()
        r = s.ch.call_sync("Flt", "Spin", b"0.5")
        assert not r.failed(), r.error_text
        status, body = _get(s.port, "/hotspots?mode=continuous&format=json")
        assert status == 200
        prof = json.loads(body)
        assert prof["labels"].get("rpc:Flt.Spin", 0) >= 5, prof["labels"]
        assert any(k.startswith("rpc:Flt.Spin;") and "_spin" in k
                   for k in prof["folded"])
        status, text = _get(s.port, "/hotspots?mode=continuous")
        assert status == 200 and b"rpc:Flt.Spin" in text
        status, diff = _get(s.port, "/hotspots?mode=continuous&diff=1")
        assert status == 200 and diff.startswith(b"window diff")
        status, svg = _get(s.port, "/hotspots?mode=continuous&format=svg")
        assert status == 200 and svg.startswith(b"<svg")


def _on_demand():
    """An on-demand profile in every format; a second one at once is
    refused with 503; bad arguments are 400s."""
    with _Server({"Spin": _spin}) as s:
        got = {}

        def long_profile():
            got["r"] = _get(s.port, "/hotspots?seconds=1&interval_ms=2")
        t = threading.Thread(target=long_profile)
        t.start()
        assert _wait_for(port_fr.global_recorder().profiling)
        assert _get(s.port, "/hotspots?seconds=0.2")[0] == 503
        s.ch.call_sync("Flt", "Spin", b"0.3")
        t.join(30)
        status, text = got["r"]
        assert status == 200 and b" samples\n" in text, text[:200]
        status, body = _get(s.port, "/hotspots?seconds=0.3&interval_ms=1"
                                    "&format=json")
        prof = json.loads(body)
        assert status == 200 and prof["nsamples"] > prof["nbusy"] > 0
        assert prof["idle_by_thread"] and set(prof) == {
            "nsamples", "nbusy", "idle_by_thread", "leaves", "folded"}
        status, body = _get(s.port, "/hotspots?seconds=0.2&format=folded")
        assert status == 200 and all(
            line.rpartition(" ")[2].isdigit()
            for line in body.decode().splitlines())
        assert _get(s.port, "/pprof/profile?seconds=0.1&format=svg")[1] \
            .startswith(b"<svg")
        assert _get(s.port, "/hotspots?seconds=x")[0] == 400
        assert _get(s.port, "/hotspots?type=bogus")[0] == 400
        assert _get(s.port, "/hotspots?type=heap&stop=1")[0] == 200


async def _hold_dispatcher(cntl, request):
    # run in place on the dispatcher until the first await: this holds it
    time.sleep(0.25)
    return b"held"


def _stall():
    """A handler that holds the dispatcher: one stall counted (the
    watchdog saw it running, the loop at its end), the gauge over its
    length, and the note in its rpcz span."""
    with _PortFlags(rpcz_enabled=True), \
            _Server({"Hold": _hold_dispatcher}) as s:
        before = port_ed.nstalls.get_value()
        r = s.ch.call_sync("Flt", "Hold", b"")
        assert not r.failed() and r.response == b"held", r.error_text

        def noted():
            return [sp for sp in global_collector.recent(64)
                    if sp.side == "server" and sp.method == "Hold" and any(
                        "dispatcher_stall" in t for _, t in sp.annotations)]
        assert _wait_for(lambda: bool(noted())), "no span annotated"
        time.sleep(0.1)
        assert port_ed.nstalls.get_value() == before + 1
        assert port_ed.stall_ms_max_10s() >= 200


def _lifecycle():
    """The sampler runs while a server does and stops with the last."""
    fr = port_fr.global_recorder()
    with _Server({"Spin": _spin}) as a:
        assert fr.running()
        with _Server({"Spin": _spin}, name="Flt2"):
            assert fr.running()
        assert fr.running(), "stopped with a server still running"
        assert not a.ch.call_sync("Flt", "Spin", b"0").failed()
    assert _wait_for(lambda: not fr.running())


def _stacks_pages():
    ev = port_fiber.FiberEvent()

    async def parked():
        await ev.wait()
    f = port_fiber.spawn(parked, name="parked_for_stacks")
    try:
        with _Server({"Spin": _spin}) as s:
            assert _wait_for(lambda: f.state ==
                             port_sched.FIBER_STATE_SUSPENDED)
            status, text = _get(s.port, "/fibers?stacks=1")
            block = text.decode().split("--- fiber parked_for_stacks")
            assert status == 200 and len(block) == 2, text[:300]
            assert block[1].startswith(" [SUSPENDED]") and \
                "in parked" in block[1]
            status, body = _get(s.port, "/bthreads")
            page = json.loads(body)
            assert set(page) == {"concurrency", "alive_fibers",
                                 "fibers_created", "switches_per_group",
                                 "steals_per_group", "runqueue_depth"}
            status, text = _get(s.port, "/threads")
            assert status == 200 and b"(event_dispatcher)" in text and \
                b"(flight_recorder)" in text
    finally:
        ev.set()
    # off the main thread nothing is installed: it says whether a server
    # of the main thread did, and the disposition stays as it was
    before = signal.getsignal(signal.SIGUSR2)
    assert port_stacks.enable_stack_dump_signal() is \
        port_stacks._installed[0]
    assert signal.getsignal(signal.SIGUSR2) is before


def _census():
    """/census: every registered provider, none failing, brpc_tpu's keys
    (less the ones whose source the port lacks), the builtin twin."""
    with _Server({"Spin": _spin}) as s:
        status, body = _get(s.port, "/census")
        assert status == 200
        mine = json.loads(body)
        ref = ref_services.census_page_payload()
        names = port_census.registered_names()
        assert set(names) == set(mine["subsystems"]) == {
            "fds", "bvar", "fibers", "device_lane", "timers", "iobuf_pool",
            "sockets", "backend_stats", "span_store", "serving_lane"}
        assert set(names) <= set(ref["subsystems"])
        assert set(mine) == set(ref)
        assert set(mine["connections"]) == set(ref["connections"])
        for name in names:
            sub = mine["subsystems"][name]
            assert "error" not in sub, (name, sub)
            want = set(ref["subsystems"][name])
            if name == "fibers":
                # brpc_tpu adds the run-queue depth once it has a control
                want.add("runqueue_depth")
            assert set(sub) == want - CENSUS_LEFT_OUT.get(name, set()), name
        assert mine["subsystems"]["sockets"]["server_count"] >= 1
        assert mine["total_bytes"] == port_census.total_bytes(
            mine["subsystems"])
        r = s.ch.call_sync("builtin", "census", b"")
        assert not r.failed() and set(json.loads(r.response)) == set(ref)


VMODULE_SPECS = ["", "3", "rpc*=2", "rpc*=2,rpc.channel=0,*=1",
                 "serving.engine=4,serv*=1"]


def _logging():
    """VLOG's verbosity rules equal brpc_tpu's; a sink consumes; /vlog
    reads and sets them."""
    saved = (dict(ref_log._vmodule), ref_log._global_v)
    try:
        for spec in VMODULE_SPECS:
            port_log.set_vmodule(spec)
            ref_log.set_vmodule(spec)
            assert port_log.vmodule() == ref_log.vmodule(), spec
            for mod in ("", "rpc", "rpc.channel", "serving.engine",
                        "serving.batcher", "fiber"):
                for v in range(5):
                    assert port_log.vlog_is_on(v, mod) == \
                        ref_log.vlog_is_on(v, mod), (spec, mod, v)
    finally:
        ref_log._vmodule.clear()
        ref_log._vmodule.update(saved[0])
        ref_log._global_v = saved[1]
        port_log.set_vmodule("")

    class Sink(port_log.LogSink):
        def __init__(self):
            self.got = []

        def on_log(self, record):
            self.got.append(record.getMessage())
            return True
    sink = Sink()
    old = port_log.set_log_sink(sink)
    try:
        port_log.log_warning("w %d", 1, module="x")
        port_log.VLOG(1, "quiet")                   # verbosity 0: dropped
        port_log.set_vmodule("x=1")
        port_log.VLOG(1, "loud %s", "v", module="x")
    finally:
        port_log.set_log_sink(old)
        port_log.set_vmodule("")
    assert sink.got == ["w 1", "loud v"]
    with _Server({"Spin": _spin}) as s:
        status, body = _get(s.port, "/vlog?vmodule=rpc*=2")
        assert status == 200
        status, body = _get(s.port, "/vlog")
        page = json.loads(body)
        assert set(page) == {"loggers", "vmodule"} and page["vmodule"] == \
            {"rpc*": 2}
        assert _get(s.port, "/vlog?vmodule=a=b")[0] == 400
        assert _get(s.port, "/vlog?level=NOPE&module=brpc_tpu_torch.x")[0] \
            == 400
        port_log.set_vmodule("")


CASES = [
    ("the renders", _renders_equal, ()),
    ("current-fiber cells and the prune", _thread_cells, ()),
    ("continuous attribution by method", _attribution, ()),
    ("on-demand profiles and the 503", _on_demand, ()),
    ("a dispatcher stall in its span", _stall, ()),
    ("the sampler stops with the last server", _lifecycle, ()),
    ("/fibers, /threads and the signal", _stacks_pages, ()),
    ("/census", _census, ()),
    ("VLOG, the sink and /vlog", _logging, ()),
]


def test_flight_recorder():
    _run_cases(CASES)
