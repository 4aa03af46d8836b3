"""The port's combo channels against brpc_tpu's, on the CPU.

The cases of brpc_tpu's tests/test_cluster.py ``TestParallelChannel`` and
``TestSelectiveChannel`` (fan-out order, ``fail_limit`` ETOOMANYFAILS, a
mapper that skips every sub-call EREQUEST, a partition parser, a retry on
another sub-channel) run three ways, with the same requests made from a
numpy seed: a port ParallelChannel to port servers (mem://), a port
ParallelChannel to brpc_tpu servers (tcp://), and brpc_tpu's to brpc_tpu
servers (mem://); all three must agree. Tensors fan out the same three
ways (mem:// by reference, tcp:// inline). ``attach_collective`` over an
8-shard mesh (the port's on ``["cpu"] * 8`` behind cuda://#device=cpu
sub-channels, brpc_tpu's on its 8 virtual CPU devices behind tpu://
ones): a mapped tensor call lowers, a host call, an unmapped method and a
lowering that fails fan out, and the fused and fallback counts and every
value equal brpc_tpu's. The load balancers: ``rr`` and ``random`` cover
their servers and honour exclusions as brpc_tpu's do; other names raise.

The cases run inside one collected test (``_run_cases``), so every other
test file keeps its place in pytest-xdist's ``--dist loadfile`` queue
(see test_torch_iobuf.py).
"""

import itertools
import time
import traceback

import jax.numpy as jnp
import numpy as np
import torch

import brpc_tpu.rpc as ref_rpc
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu.butil.endpoint import str2endpoint as ref_str2endpoint
from brpc_tpu.parallel import CollectiveChannel as RefCollectiveChannel
from brpc_tpu.parallel import make_rpc_mesh as ref_make_rpc_mesh
from brpc_tpu.rpc import load_balancer as ref_lb
from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.parallel import CollectiveChannel, make_rpc_mesh
from brpc_tpu_torch.rpc import load_balancer as port_lb
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher

# (client package, server package, server scheme)
WIRINGS = {"port->port": (port_rpc, port_rpc, "mem"),
           "port->ref": (port_rpc, ref_rpc, "tcp"),
           "ref->ref": (ref_rpc, ref_rpc, "mem")}
_seq = itertools.count()


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


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


class _Wiring:
    """Servers and channels of one wiring, closed when the case ends."""

    def __init__(self, name):
        self.name = name
        self.cli, self.srv, self.scheme = WIRINGS[name]
        self.items = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for x in reversed(self.items):
            x.close()

    def server(self, tag, extra=None, address=None):
        srv = self.srv.Server(self.srv.ServerOptions(
            enable_builtin_services=False))
        svc = self.srv.Service("EchoService")

        def Echo(cntl, request):
            return tag.encode() + b":" + bytes(request)

        def WhoAmI(cntl, request):
            return tag.encode()

        def Scale(cntl, request):
            k = float(request or b"1")
            cntl.response_device_arrays = [
                a * k for a in cntl.request_device_arrays]
            return tag.encode()
        for name, fn in dict(Echo=Echo, WhoAmI=WhoAmI, Scale=Scale,
                             **(extra or {})).items():
            svc.register_method(name, fn)
        srv.add_service(svc)
        if address is None:
            address = (f"mem://{tag}-{next(_seq)}" if self.scheme == "mem"
                       else "tcp://127.0.0.1:0")
        ep = srv.start(address)

        class _Srv:
            def close(self):
                srv.stop()
                srv.join(2)
        self.items.append(_Srv())
        return str(ep)

    def channel(self, address, timeout_ms=2000):
        if self.cli is port_rpc:
            ch = port_rpc.Channel(address,
                                  port_rpc.ChannelOptions(timeout_ms=timeout_ms))
        else:
            ch = ref_rpc.Channel(address, ref_rpc.ChannelOptions(
                timeout_ms=timeout_ms, max_retry=0))
        self.items.append(ch)
        return ch

    def dead_address(self):
        return ("tcp://127.0.0.1:1" if self.scheme == "tcp"
                else f"mem://nobody-{next(_seq)}")

    def body(self, cntl):
        if cntl.failed():
            return None
        if self.cli is port_rpc:
            return cntl.response
        return cntl.response_payload.to_bytes()

    def tensors(self, arrays):
        if self.cli is port_rpc:
            return [torch.from_numpy(a) for a in arrays]
        return [jnp.asarray(a) for a in arrays]


def _all_wirings(fn, *args):
    got = {}
    for name in WIRINGS:
        with _Wiring(name) as w:
            got[name] = fn(w, *args)
    assert got["port->port"] == got["port->ref"] == got["ref->ref"], got
    return got["port->port"]


# ------------------------------------------------------------------ cases

def _fan_out_order(w):
    pch = w.cli.ParallelChannel()
    for i in range(4):
        pch.add_sub_channel(w.channel(w.server(f"p{i}")))
    cntl = pch.call_sync("EchoService", "WhoAmI", b"")
    assert not cntl.failed(), cntl.error_text
    return cntl.sub_responses


def _fail_limit(w):
    pch = w.cli.ParallelChannel(fail_limit=1)
    pch.add_sub_channel(w.channel(w.server("f0")))
    pch.add_sub_channel(w.channel(w.dead_address(), timeout_ms=300))
    pch.add_sub_channel(w.channel(w.server("f1")))
    cntl = pch.call_sync("EchoService", "WhoAmI", b"")
    return (cntl.error_code, sum(e is not None for e in cntl.sub_errors))


def _mapper_skips_all(w):
    class SkipAll(w.cli.CallMapper):
        def map(self, i, n, service, method, request, cntl):
            return w.cli.SubCall.skipped()
    pch = w.cli.ParallelChannel(call_mapper=SkipAll())
    for i in range(3):
        pch.add_sub_channel(w.channel(w.server(f"s{i}")))
    done = []
    cntl = pch.call("EchoService", "WhoAmI", b"", done=done.append)
    assert cntl.join(1) and done == [cntl]
    return cntl.error_code


def _partition_parser(w, seed):
    request = np.random.RandomState(seed).bytes(12)

    class ShardParser(w.cli.PartitionParser):
        def parse(self, i, n, service, method, request, cntl):
            return w.cli.SubCall(service, "Echo", request[i::n])
    pch = w.cli.PartitionChannel(partition_parser=ShardParser())
    for i in range(3):
        pch.add_partition(w.channel(w.server(f"m{i}")))
    cntl = pch.call_sync("EchoService", "ignored", request)
    assert not cntl.failed(), cntl.error_text
    assert cntl.sub_responses == [f"m{i}:".encode() + request[i::3]
                                  for i in range(3)]
    return (pch.partition_count, len(cntl.sub_responses))


def _selective_retry(w):
    sch = w.cli.SelectiveChannel("rr", max_retry=2)
    sch.add_sub_channel(w.channel(w.dead_address(), timeout_ms=300))
    sch.add_sub_channel(w.channel(w.server("alive")))
    out = []
    for _ in range(6):
        cntl = sch.call_sync("EchoService", "WhoAmI", b"")
        out.append((cntl.error_code, w.body(cntl)))
    assert out == [(0, b"alive")] * 6, out
    # every sub-channel dead: the retries run out
    sch = w.cli.SelectiveChannel("random", max_retry=5)
    for _ in range(2):
        sch.add_sub_channel(w.channel(w.dead_address(), timeout_ms=300))
    cntl = sch.call_sync("EchoService", "WhoAmI", b"")
    return out, cntl.error_code


def _tensor_fan_out(w, seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(3, 4).astype(np.float32),
              rng.randn(5).astype(np.float32)]

    class Scaled(w.cli.CallMapper):
        def map(self, i, n, service, method, request, cntl):
            return w.cli.SubCall(service, method, str(i + 1).encode(),
                                 device_arrays=cntl.request_device_arrays)
    pch = w.cli.ParallelChannel(call_mapper=Scaled())
    for i in range(3):
        pch.add_sub_channel(w.channel(w.server(f"t{i}")))
    cntl = w.cli.Controller()
    cntl.request_device_arrays = w.tensors(arrays)
    pch.call("EchoService", "Scale", b"", cntl=cntl)
    assert cntl.join(10) and not cntl.failed(), cntl.error_text
    for i, sub in enumerate(cntl.sub_device_arrays):
        for got, a in zip(sub, arrays):
            np.testing.assert_array_equal(_as_numpy(got), a * (i + 1))
    return [len(s) for s in cntl.sub_device_arrays]


def _collective(kind, seed):
    """attach_collective on 8 device-lane sub-channels: one server, a
    channel (and connection) a shard."""
    rng = np.random.RandomState(seed)
    x = rng.randn(16).astype(np.float32)
    bad = rng.randn(12).astype(np.float32)     # 12 rows do not split 8 ways
    w = _Wiring("port->port" if kind == "port" else "ref->ref")
    with w:
        if kind == "port":
            addr = w.server("c", address=f"cuda://cc-{next(_seq)}:1"
                                         f"#device=cpu")
            mesh = make_rpc_mesh(1, 8, devices=["cpu"] * 8)
            coll = CollectiveChannel(mesh, merge="concat")
        else:
            addr = w.server("c", address=f"tpu://cc-{next(_seq)}:1"
                                         f"#device=0")
            coll = RefCollectiveChannel(ref_make_rpc_mesh(1, 8),
                                        merge="concat")
        pch = w.cli.ParallelChannel()
        for _ in range(8):
            pch.add_sub_channel(w.channel(addr))
        pch.attach_collective(coll, {("EchoService", "Scale"):
                                     lambda s: s * 3})
        out = []

        def call(method, arrays, request=b""):
            cntl = w.cli.Controller()
            cntl.request_device_arrays = w.tensors(arrays)
            pch.call("EchoService", method, request, cntl=cntl)
            assert cntl.join(10) and not cntl.failed(), cntl.error_text
            lowered = bool(getattr(cntl, "collective_lowered", False))
            out.append((method, lowered, pch.collective_fused,
                        pch.collective_fallbacks))
            return cntl
        c = call("Scale", [x])                  # lowered
        np.testing.assert_allclose(
            _as_numpy(c.response_device_arrays[0]), x * 3, rtol=1e-6)
        c = call("WhoAmI", [], b"host")         # host payload: fan-out
        assert c.sub_responses == [b"c"] * 8
        c = call("Echo", [x], b"")              # unmapped: fan-out
        assert sum(1 for a in c.sub_device_arrays if a) == 0
        c = call("Scale", [bad], b"2")          # lowering fails: fan-out
        for sub in c.sub_device_arrays:
            np.testing.assert_allclose(_as_numpy(sub[0]), bad * 2)
        return out


def _collective_counts(seed):
    got = {kind: _collective(kind, seed) for kind in ("port", "ref")}
    assert got["port"] == got["ref"], got
    assert got["port"][0][1:] == (True, 1, 0)
    assert got["port"][-1][1:] == (False, 1, 1)


def _load_balancers():
    eps = [f"tcp://10.0.0.{i}:80" for i in range(1, 5)]
    for name in ("rr", "random"):
        out = {}
        for kind, lb_mod, parse in (("port", port_lb, str2endpoint),
                                    ("ref", ref_lb, ref_str2endpoint)):
            lb = lb_mod.new_load_balancer(name)
            servers = [parse(e) for e in eps]
            lb.reset_servers(servers)
            picks = {str(lb.select_server()) for _ in range(200)}
            ex = set(servers[:2])
            kept = {str(lb.select_server(ex)) for _ in range(50)}
            lb.reset_servers([])
            out[kind] = (picks, kept, lb.select_server())
        assert out["port"] == out["ref"], out
        assert out["port"][0] == set(eps)
        assert out["port"][1] == set(eps[2:])
    for lb_mod in (port_lb, ref_lb):
        try:
            lb_mod.new_load_balancer("no-such-balancer")
        except ValueError:
            continue
        raise AssertionError("an unknown balancer name must raise")


CASES = [
    ("fan-out order", _all_wirings, (_fan_out_order,)),
    ("fail_limit ETOOMANYFAILS", _all_wirings, (_fail_limit,)),
    ("a mapper that skips everything", _all_wirings, (_mapper_skips_all,)),
    ("partition parser", _all_wirings, (_partition_parser, 201)),
    ("selective retry elsewhere", _all_wirings, (_selective_retry,)),
    ("tensor fan-out", _all_wirings, (_tensor_fan_out, 202)),
    ("attach_collective counts", _collective_counts, (203,)),
    ("load balancers", _load_balancers, ()),
]


def test_combo_channels():
    _run_cases(CASES)
