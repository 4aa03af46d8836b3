"""The socket pages and the small ``butil`` modules of the port against
brpc_tpu's, on the CPU.

- ``/sockets``, ``/ids`` and ``/connections`` of a server with a client
  connected: the rows' keys equal brpc_tpu's (``/connections`` has the
  port's ``wqueue_bytes`` and ``read_bytes`` besides), the client
  channels' rows listed apart; ``/census`` counts idle sockets; the
  ``idle_conn_count`` and ``conn_resident_bytes_avg`` bvars exist on both;
  the tabbed index links both new pages.
- The idle class: a connection quiet for ``census_idle_s`` is idle on
  ``/connections``, ``/census`` and ``idle_conn_count``, and a call makes
  it active again.
- ``/status``: the key set of brpc_tpu's, with the input batching
  (``dispatch_batch_size_avg_10s``, ``_peak_10s``) and
  ``socket_write_coalesced_frames`` on the saturation pane, and a
  ``saturation_timeline`` link once an entry's trend ring exists;
  ``/protobufs`` lists every method with ``bytes`` on both sides.
- ``/device``'s probe pane with ``device_probe_path`` set: the keys of
  brpc_tpu's pane over one artifact of ``ipc_probe``, its age, and the
  artifact the probe writes on a machine without a card.
- ``butil/containers.py`` and ``butil/timekeeping.py``: the cases of
  tests/test_butil_ext.py run on the port's and brpc_tpu's classes with
  the same results.

One collected test over the cases (``_run_cases`` of
test_torch_cluster.py).
"""

import http.client
import json
import threading
import time

from brpc_tpu.builtin import tabbed as ref_tabbed
from brpc_tpu.bvar import PassiveStatus as RefPassiveStatus
from brpc_tpu.bvar.variable import describe_exposed as ref_describe_exposed
from brpc_tpu.butil import containers as ref_containers
from brpc_tpu.butil import timekeeping as ref_time
from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import ChannelOptions as RefChannelOptions
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc import Service as RefService
from brpc_tpu.transport import input_messenger as ref_im

from brpc_tpu_torch.builtin import tabbed as port_tabbed
from brpc_tpu_torch.butil import containers as port_containers
from brpc_tpu_torch.butil import timekeeping as port_time
from brpc_tpu_torch.butil.flags import flag, set_flag
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service

from test_torch_cluster import ROOT, _run_cases, _wait_for


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        assert r.status == 200, (path, r.status)
        return r.read()
    finally:
        conn.close()


def _page(port: int, path: str):
    return json.loads(_get(port, path))


def _vars(port: int) -> set:
    return {ln.split(" : ")[0]
            for ln in _get(port, "/vars").decode().splitlines()}


class _Pair:
    """A server of each package with a channel of its own package
    connected and one call answered."""

    def __enter__(self):
        self.port_srv = Server()
        svc = Service("Svc")
        svc.register_method("Echo", lambda cntl, req: bytes(req))
        self.port_srv.add_service(svc)
        self.port = self.port_srv.start("tcp://127.0.0.1:0").port
        self.port_ch = Channel(f"tcp://127.0.0.1:{self.port}",
                               ChannelOptions(timeout_ms=5000,
                                              name="pages-port"))
        assert not self.port_ch.call_sync("Svc", "Echo", b"x").failed()
        self.ref_srv = RefServer(RefServerOptions())
        rsvc = RefService("Svc")

        def Echo(cntl, request):
            return bytes(request)
        rsvc.method()(Echo)
        self.ref_srv.add_service(rsvc)
        self.ref = self.ref_srv.start("tcp://127.0.0.1:0").port
        self.ref_ch = RefChannel(f"tcp://127.0.0.1:{self.ref}",
                                 RefChannelOptions(timeout_ms=5000,
                                                   name="pages-ref"))
        assert not self.ref_ch.call_sync("Svc", "Echo", b"x").failed()
        return self

    def __exit__(self, *exc):
        self.port_ch.close()
        self.ref_ch.close()
        for s in (self.port_srv, self.ref_srv):
            s.stop()
            s.join(5)


def case_page_keys():
    with _Pair() as p:
        # the channel's connection and the page's own
        mine, ref = _page(p.port, "/sockets"), _page(p.ref, "/sockets")
        assert len(mine) == len(ref) == 2, (mine, ref)
        assert {frozenset(r) for r in mine} == {frozenset(r) for r in ref}
        assert all(r["write_queue"] == 0 and not r["failed"] for r in mine)
        mine, ref = _page(p.port, "/ids"), _page(p.ref, "/ids")
        assert set(mine) == set(ref) == {"inflight_client_calls"}
        assert mine["inflight_client_calls"] == 0
        mine = _page(p.port, "/connections")
        ref = _page(p.ref, "/connections")
        assert set(mine) == set(ref)
        row, rrow = mine["connections"][0], ref["connections"][0]
        assert set(row) == set(rrow) | {"wqueue_bytes", "read_bytes",
                                        "protocol"}, (row, rrow)
        assert {r["protocol"] for r in mine["connections"]} == {"tpu_std",
                                                                "http"}
        assert {r["idle_class"] for r in mine["connections"]} == {"active"}
        # the client rows come from the census walk, memoized for 0.2 s
        # (in both packages): a walk made before the channels dialled may
        # still be served
        def client_rows(port, name):
            return [r for r in _page(port, "/connections")
                    ["client_connections"] if r["channel"] == name]
        assert _wait_for(lambda: client_rows(p.port, "pages-port")) and \
            _wait_for(lambda: client_rows(p.ref, "pages-ref"))
        crows = client_rows(p.port, "pages-port")
        rrows = client_rows(p.ref, "pages-ref")
        assert len(crows) == len(rrows) == 1
        assert set(crows[0]) == set(rrows[0]), (crows, rrows)
        mine = _page(p.port, "/census")
        ref = _page(p.ref, "/census")
        assert set(mine["connections"]) == set(ref["connections"])
        assert isinstance(mine["connections"]["idle"], int)
        assert set(mine["subsystems"]["sockets"]) == \
            set(ref["subsystems"]["sockets"])
        want = {"idle_conn_count", "conn_resident_bytes_avg"}
        assert want <= _vars(p.port) and want <= _vars(p.ref)
    tabs = {url for _, url in port_tabbed.TABS}
    assert {"/sockets", "/ids"} <= tabs
    assert {"/sockets", "/ids"} <= {url for _, url in ref_tabbed.TABS}


def case_idle_class():
    was = flag("census_idle_s")
    set_flag("census_idle_s", 0.2)
    try:
        with _Pair() as p:
            mine = f":{p.port_ch._socket.local_endpoint.port}"

            def idle_rows():
                # the channel's connection (the page's own is active)
                rows = _page(p.port, "/connections")["connections"]
                return [r["idle_class"] for r in rows
                        if r["remote"].endswith(mine)]
            assert _wait_for(lambda: idle_rows() == ["idle"], 5.0)
            time.sleep(0.25)            # past the census rows' 0.2 s memo
            # both ends of the channel's connection are this process's
            census = _page(p.port, "/census")
            assert census["subsystems"]["sockets"]["idle"] >= 2, census
            assert census["connections"]["idle"] >= 2
            from brpc_tpu_torch.transport.socket import idle_conn_count
            assert idle_conn_count() >= 2
            assert not p.port_ch.call_sync("Svc", "Echo", b"y").failed()
            assert idle_rows() == ["active"]
    finally:
        set_flag("census_idle_s", was)


def _bounded_queue(mod):
    q = mod.BoundedQueue(3)
    out = [q.empty(), q.full(), [q.push(i) for i in range(3)], q.full(),
           q.push(99), q.top(), q.pop(), q.push(3),
           [q.pop() for _ in range(3)], q.pop()]
    f = mod.BoundedQueue(2)
    out += [f.push_force(1), f.push_force(2), f.push_force(3), f.pop(),
            f.pop()]
    q = mod.BoundedQueue(64)
    got, done = [], threading.Event()

    def producer():
        for i in range(1000):
            while not q.push(i):
                pass
        done.set()

    def consumer():
        while not (done.is_set() and q.empty()):
            v = q.pop()
            if v is not None:
                got.append(v)
    ts = [threading.Thread(target=producer), threading.Thread(
        target=consumer)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    out.append(got == list(range(1000)))
    return out


def _mru_cache(mod):
    evicted = []
    c = mod.MRUCache(3, deleter=lambda k, v: evicted.append(k))
    for k in "abc":
        c.put(k, k.upper())
    out = [c.get("a")]
    c.put("d", "D")
    out += [list(evicted), "b" in c, "a" in c]
    gone = []
    c = mod.MRUCache(4, deleter=lambda k, v: gone.append((k, v)))
    c.put("x", 1)
    c.put("y", 2)
    out += [c.erase("x"), c.erase("x")]
    c.clear()
    out += [gone, len(c)]
    c = mod.MRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    c.peek("a")
    c.put("c", 3)
    out.append("a" in c)
    return out


def _case_ignored(mod):
    d = mod.CaseIgnoredDict({"Content-Type": "text/plain"})
    out = [d["content-type"], d.get("CONTENT-TYPE")]
    d["X-Foo"] = 1
    out += ["x-foo" in d, "X-FOO" in d]
    del d["x-FOO"]
    out.append("x-foo" in d)
    d.update({"Accept": "a"})
    out.append(d.pop("ACCEPT"))
    return out


def case_containers():
    for fn in (_bounded_queue, _mru_cache, _case_ignored):
        assert fn(port_containers) == fn(ref_containers), fn.__name__


def case_timekeeping():
    names = ("cpuwide_time_ns", "monotime_us", "gettimeofday_us")
    for n in names:
        a, b = getattr(port_time, n)(), getattr(ref_time, n)()
        assert isinstance(a, int) and abs(a - b) < 10 ** 9 * (
            1 if n.endswith("ns") else 1e-3 if n.endswith("us") else 1), n
    t0 = port_time.monotime_us()
    time.sleep(0.01)
    assert port_time.monotime_us() - t0 >= 10000


def case_status_saturation_keys():
    """``/status`` has brpc_tpu's keys, the batching and coalescing
    gauges among them, and links a saturation entry to its trend ring
    once the ring exists; ``/protobufs`` lists every method as bytes."""
    with _Pair() as p:
        mine, ref = _page(p.port, "/status"), _page(p.ref, "/status")
        assert set(mine) == set(ref), (set(mine) ^ set(ref))
        new = {"dispatch_batch_size_avg_10s", "dispatch_batch_size_peak_10s",
               "socket_write_coalesced_frames"}
        assert new <= set(mine["saturation"]) and \
            new <= set(ref["saturation"])
        assert isinstance(mine["saturation"]["dispatch_batch_size_peak_10s"],
                          int)
        # the trend rings tick once a second while a server runs
        assert _wait_for(lambda: "socket_wqueue_bytes" in _page(
            p.port, "/status")["saturation_timeline"], 5.0)
        links = _page(p.port, "/status")["saturation_timeline"]
        assert links["socket_wqueue_bytes"] == \
            "/timeline?name=socket_wqueue_bytes"
        assert all(url.startswith("/timeline?name=") for url in
                   links.values())
        want = {"dispatch_batch_size_avg_10s", "dispatch_batch_size_peak_10s"}
        # brpc_tpu's tests/test_bvar.py calls its unexpose_all() around
        # each case, which drops these variables, exposed once at import,
        # from brpc_tpu's registry for the rest of the worker process
        # (ROADMAP section 3): expose them again as its input_messenger
        # does at import
        for name, fn in (("dispatch_batch_size_avg_10s",
                          ref_im.dispatch_batch_avg_10s),
                         ("dispatch_batch_size_peak_10s",
                          ref_im.dispatch_batch_peak_10s)):
            if ref_describe_exposed(name) is None:
                RefPassiveStatus(fn).expose(name)
        assert want <= _vars(p.port) and want <= _vars(p.ref)
        pb = _page(p.port, "/protobufs")
        assert pb["Svc.Echo"] == {"request": "bytes", "response": "bytes"}
        assert set(_page(p.ref, "/protobufs")["Svc.Echo"]) == \
            {"request", "response"}
    assert ("protobufs", "/protobufs") in port_tabbed.TABS


def case_probe_pane():
    """With ``device_probe_path`` set, ``/device`` shows the probe
    artifact's keys and its age as brpc_tpu's does; the port's probe on
    a machine without a card writes an artifact that says so."""
    import os
    import subprocess
    import sys
    import tempfile
    from brpc_tpu.butil import flags as ref_flags
    from brpc_tpu.transport import device_stats as ref_ds
    from brpc_tpu_torch.transport import ipc_probe
    probe = {"card": "x", "share_ms": 1.5, "child_rc": 0,
             "child": {"open_ms": [0.4, 0.5, 0.3], "reopen_ms": [0.1] * 5,
                       "event_open_ms": 0.2, "enqueue_ms": 0.05,
                       "copy_wall_ms": 2.0, "a_ok": True, "b_ok": True,
                       "c_ok": True}}
    # the child runs as a module: by its path, the transport directory
    # would come first on sys.path and its socket.py shadow the stdlib's
    assert ipc_probe.child_command()[1:3] == \
        ["-m", "brpc_tpu_torch.transport.ipc_probe"]
    assert os.path.isdir(os.path.join(ipc_probe._PACKAGE_PARENT,
                                      "brpc_tpu_torch"))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "probe.json")
        ipc_probe.write_artifact(path, ipc_probe.artifact(probe))
        saved = ref_flags.flag("device_probe_path")
        set_flag("device_probe_path", path)
        ref_flags.set_flag("device_probe_path", path)
        try:
            with _Pair() as p:
                pane = _page(p.port, "/device")["probe"]
                want = ref_ds._probe_pane()
                assert set(pane) == set(want), (pane, want)
                assert pane["lane_kind"] == "cuda_ipc" and \
                    pane["p50_us"] == 100.0 and pane["p99_us"] == 500.0 \
                    and pane["age_s"] >= 0
                assert "lane_error" not in pane
                # on this machine the probe has no card: it says so
                env = dict(os.environ)
                env.pop("PYTHONPATH", None)
                proc = subprocess.run(
                    [sys.executable, "-m",
                     "brpc_tpu_torch.transport.ipc_probe", "--out", path],
                    cwd=str(ROOT), env=env, capture_output=True, text=True,
                    timeout=120)
                assert proc.returncode == 1, proc.stderr[-2000:]
                pane = _page(p.port, "/device")["probe"]
                assert pane["error"] == "CUDA is not available"
            set_flag("device_probe_path", "")
            with _Pair() as p:
                assert "probe" not in _page(p.port, "/device")
        finally:
            set_flag("device_probe_path", "")
            ref_flags.set_flag("device_probe_path", saved)


CASES = [
    ("/sockets, /ids, /connections, /census keys", case_page_keys, ()),
    ("/status saturation keys and links, /protobufs",
     case_status_saturation_keys, ()),
    ("the probe pane on /device", case_probe_pane, ()),
    ("the idle class", case_idle_class, ()),
    ("containers", case_containers, ()),
    ("timekeeping", case_timekeeping, ()),
]


def test_pages_and_butil():
    _run_cases(CASES)
