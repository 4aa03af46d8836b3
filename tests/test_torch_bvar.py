"""The port's bvar against brpc_tpu.bvar, on the CPU.

Each case is one script written against a package's public names; it
runs once through ``brpc_tpu`` and once through ``brpc_tpu_torch``, and
both must give the same result. Windows run on a private Sampler whose
thread never starts: the case drives ``take_sample(now)`` by hand, so no
case depends on timing. Exposed variables take names unique to the case
and the package, and are hidden again at its end.
"""

import importlib
import itertools
import threading
import time
from types import SimpleNamespace

import pytest

PACKAGES = {"reference": "brpc_tpu", "port": "brpc_tpu_torch"}
_names = itertools.count()


def _pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(
        root=root, bvar=mod("bvar"), flags=mod("butil.flags"),
        variable=mod("bvar.variable"), collector=mod("bvar.collector"),
        prometheus=mod("bvar.prometheus"), gflag=mod("bvar.gflag"),
        contention=mod("fiber.contention"), fiber=mod("fiber"))


class _Exposed:
    """Unique names for a case's variables, hidden on exit."""

    def __init__(self, pkg):
        self.prefix = f"tbvar{next(_names)}_"
        self.vars = []

    def __call__(self, name, var):
        self.vars.append(var.expose(self.prefix + name))
        return var

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for v in self.vars:
            v.hide()


def _manual_sampler(pkg):
    """A Sampler whose thread never starts: ``take_sample`` by hand."""
    class Manual(pkg.bvar.Sampler):
        def _ensure_thread(self):
            pass
    return Manual()


# ------------------------------------------------------------- reducers

def reducers(pkg):
    b = pkg.bvar
    a, mx, mn, rec = b.Adder(), b.Maxer(), b.Miner(), b.IntRecorder()
    for v in (3, -7, 12, 5, 0, 9):
        a << v
        mx << v
        mn << v
        rec << v
    rec.record(4, times=3)
    out = {"adder": a.get_value(), "max": mx.get_value(),
           "min": mn.get_value(), "avg": rec.get_value(),
           "sum": rec.sum, "count": rec.count}
    out["adder_reset"] = a.reset()
    a.add(2)
    out["adder_after_reset"] = a.get_value()
    out["max_reset"] = mx.reset()
    out["max_after_reset"] = mx.get_value()
    out["rec_reset"] = rec.reset()
    box = [1]
    ps = b.PassiveStatus(lambda: box[0] * 10)
    box[0] = 4
    st = b.Status("x")
    st.set_value({"k": 1})
    out["passive"] = ps.get_value()
    out["status"] = st.get_value()
    # a dead thread's counts stay in the total
    t = threading.Thread(target=lambda: a.add(100))
    t.start()
    t.join(5)
    out["adder_with_dead_thread"] = a.get_value()
    return out


def percentile_below_capacity(pkg):
    p = pkg.bvar.Percentile()
    values = [(i * 37) % 101 for i in range(500)]     # under the reservoir
    for v in values:
        p << v
    return {"value": p.get_value(),
            "ratios": [p.get_percentile(r) for r in (0.0, 0.25, 0.5, 0.75,
                                                     0.95, 1.0)],
            "n": len(p.merged_samples()), "reset": sorted(p.reset()),
            "after_reset": p.get_value()}


def latency_recorder(pkg):
    sampler = _manual_sampler(pkg)
    lr = pkg.bvar.LatencyRecorder(window_size=5, sampler=sampler)
    sampler.take_sample(100.0)
    for v in (120, 80, 300, 95, 110, 5000):
        lr << v
    lr.record_batch(200.0, 4)
    sampler.take_sample(102.0)
    return {"value": lr.get_value(), "latency": lr.latency(),
            "max": lr.max_latency(), "count": lr.count(), "qps": lr.qps(),
            "p50": lr.latency_percentile(0.5)}


# -------------------------------------------------------------- windows

def windows(pkg):
    b = pkg.bvar
    sampler = _manual_sampler(pkg)
    adder, maxer = b.Adder(), b.Maxer()
    win = b.Window(adder, window_size=3, sampler=sampler)
    ps = b.PerSecond(adder, window_size=3, sampler=sampler)
    mwin = b.Window(maxer, window_size=2, sampler=sampler)
    out = {"cold": (win.get_value(), ps.get_value(), mwin.get_value())}
    now = 1000.0
    steps = []
    for tick, (n, m) in enumerate([(5, 3), (10, 9), (0, 1), (7, 4),
                                   (20, 2), (1, 8)]):
        adder.add(n)
        maxer.update(m)
        now += 1.0 if tick % 2 else 2.0
        sampler.take_sample(now)
        steps.append((win.get_value(), ps.get_value(), mwin.get_value(),
                      win.get_span_seconds()))
    out["steps"] = steps
    return out


# ----------------------------------------------------- labelled family

def multi_dimension(pkg):
    b = pkg.bvar
    md = b.MultiDimension(["method", "status"], b.Adder)
    md.get_stats(("Echo", "ok")).add(3)
    md.get_stats(["Echo", "fail"]).add(1)
    md.get_stats(("Generate", 200)).add(7)
    out = {"count": md.count_stats(), "list": md.list_stats(),
           "has": md.has_stats(("Echo", "ok")),
           "value": sorted(md.get_value().items()),
           "labeled": sorted(md.labeled_items())}
    md.delete_stats(("Echo", "fail"))
    out["after_delete"] = md.list_stats()
    with pytest.raises(ValueError):
        md.get_stats(("only-one",))
    out["describe"] = md.describe()
    return out


# ------------------------------------------------------------- dumps

def dumps(pkg):
    b = pkg.bvar
    sampler = _manual_sampler(pkg)
    with _Exposed(pkg) as expose:
        a = expose("requests", b.Adder())
        a.add(41)
        a << 1
        expose("flag_like", b.Status(True))
        expose("ratio", b.PassiveStatus(lambda: 0.25))
        expose("text", b.Status("not a number"))
        lr = expose("latency", b.LatencyRecorder(sampler=sampler))
        for v in (10, 20, 30):
            lr << v
        md = expose("per_method", b.MultiDimension(["method"], b.Adder))
        md.get_stats(("Echo",)).add(2)
        md.get_stats(('quo"te\\',)).add(5)
        lmd = expose("per_method_latency",
                     b.MultiDimension(["method"],
                                      lambda: b.LatencyRecorder(
                                          sampler=sampler)))
        lmd.get_stats(("Echo",)) << 7
        prefix = expose.prefix
        exposed = b.dump_exposed(prefix)
        # MultiDimension values carry tuple keys: compare them sorted
        exposed = [(n.replace(prefix, ""), sorted(v.items())
                    if isinstance(v, dict) else v) for n, v in exposed]
        text = b.dump_prometheus(prefix).replace(prefix, "")
        described = b.describe_exposed(prefix + "requests")
    return {"exposed": exposed, "prometheus": text, "describe": described,
            "hidden": b.dump_exposed(prefix)}


def flags_as_variables(pkg):
    b, flags = pkg.bvar, pkg.flags
    before = flags.flag("rpcz_max_spans")
    with _Exposed(pkg) as expose:
        fv = b.expose_flag("rpcz_max_spans", expose.prefix + "spans")
        expose.vars.append(fv)
        seen = [fv.get_value()]
        try:
            assert flags.set_flag("rpcz_max_spans", "2048")
            seen.append(b.describe_exposed(expose.prefix + "spans"))
            assert not flags.set_flag("rpcz_max_spans", "8")   # validator
            assert not flags.set_flag("rpcz_max_spans", "many")
            seen.append(fv.get_value())
        finally:
            flags.set_flag("rpcz_max_spans", before)
        seen.append(fv.get_value())
        with pytest.raises(KeyError):
            b.FlagVar("no_such_flag")
        listed = {n for n, *_ in flags.list_flags()}
    return {"seen": seen, "name": fv.flag_name,
            "rpcz_flags": sorted(n for n in listed if n.startswith("rpcz"))}


# ------------------------------------------------------------ contention

def collector_budget(pkg):
    c = pkg.collector.Collector(samples_per_second=3, max_pending=5)
    admitted = [c.submit(i) for i in range(6)]
    snap = c.snapshot()
    c.set_rate(10)
    more = [c.submit(i) for i in range(10, 14)]
    return {"admitted": admitted, "snapshot": snap, "more": more,
            "last2": c.snapshot(2), "drain": c.drain(), "after": c.drain(),
            "counts": (c.nsubmitted.get_value(), c.nsampled.get_value(),
                       c.ndropped.get_value())}


def contention_sampled(pkg):
    """A contended FiberMutex, taken from a plain thread, leaves one
    sample whose site is the caller's frame."""
    m = pkg.fiber.FiberMutex()
    assert m.lock_pthread()

    def contended_caller():
        assert m.lock_pthread(timeout_s=5)
        m.unlock()

    t = threading.Thread(target=contended_caller)
    t.start()
    time.sleep(0.02)
    m.unlock()
    t.join(5)
    assert not t.is_alive()
    site = "contended_caller"
    rows = [r for r in pkg.contention.contention_report(1000)
            if r[0].startswith(site + " ")]
    # an uncontended lock records nothing
    assert m.lock_pthread()
    m.unlock()
    rows2 = [r for r in pkg.contention.contention_report(1000)
             if r[0].startswith(site + " ")]
    return {"rows": [(r[0].split(" (")[1].split(":")[0], r[1], r[2] >= 1e4)
                     for r in rows],
            "unchanged": rows2 == rows}


CASES = [reducers, percentile_below_capacity, latency_recorder, windows,
         multi_dimension, dumps, flags_as_variables, collector_budget,
         contention_sampled]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_port_equals_reference(case):
    got = {name: case(_pkg(root)) for name, root in PACKAGES.items()}
    assert got["port"] == got["reference"]


def test_dump_text_is_not_empty():
    """The byte-for-byte dump case compares real text, not two blanks."""
    out = dumps(_pkg("brpc_tpu_torch"))
    assert "requests 42" in out["prometheus"]
    assert 'per_method{method="quo\\"te\\\\"} 5' in out["prometheus"]
    assert "per_method_latency_count{method=\"Echo\"} 1" in out["prometheus"]
    assert out["hidden"] == []


def test_windows_move():
    """The window case sees values change tick by tick."""
    out = windows(_pkg("brpc_tpu_torch"))
    assert len({s[0] for s in out["steps"]}) > 2
