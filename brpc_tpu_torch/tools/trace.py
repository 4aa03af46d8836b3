"""trace: one trace tree a call from the span stores of many processes
(the port of tools/trace.py).

Each process with ``rpcz_dir`` set writes its finished spans to
``rpcz_dir/rpcz_spans.jsonl`` (``rpc/span.py``). This tool reads those
stores, joins spans into trees by ``trace_id`` and ``parent_span_id``,
computes each trace's critical path and writes Chrome trace-event JSON
(Perfetto), so that a call over several hops shows as one timeline with
each hop's queue, handle and write stages.

Processes are placed on one axis by each span's ``base_real_us``, its
wall-clock anchor (a span's stamps are monotonic in its own process), so
the skew between two processes' clocks shows as it is.

    python3 -m brpc_tpu_torch.tools.trace DIR [DIR ...]   # summaries
    python3 -m brpc_tpu_torch.tools.trace DIR ... --perfetto out.json
    python3 -m brpc_tpu_torch.tools.trace DIR ... --top 10
    python3 -m brpc_tpu_torch.tools.trace --smoke          # self-check

``--smoke``: a loopback client -> Mid.Hop -> Leaf.Echo burst in this
process, assembled and exported; one JSON line, exit 1 on a broken
invariant. The span dicts are the same as brpc_tpu's, so either
package's tool reads the other's stores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

SPAN_FILE = "rpcz_spans.jsonl"


# ------------------------------------------------------------------ load
def load_spans(paths) -> List[dict]:
    """Read span dicts from rpcz_dir directories (current + aged file,
    oldest first) and/or explicit JSONL files. Malformed lines are
    skipped — a store truncated by a crash must not block assembly of
    everything before it."""
    spans: List[dict] = []
    for p in paths:
        if os.path.isdir(p):
            files = [os.path.join(p, SPAN_FILE + ".1"),
                     os.path.join(p, SPAN_FILE)]
        else:
            files = [p]
        for fp in files:
            try:
                fh = open(fp, encoding="utf-8")
            except OSError:
                continue
            with fh:
                for line in fh:
                    try:
                        d = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(d, dict) and "trace_id" in d:
                        spans.append(d)
    return spans


# -------------------------------------------------------------- assembly
class TraceNode:
    __slots__ = ("span", "children")

    def __init__(self, span: dict):
        self.span = span
        self.children: List["TraceNode"] = []

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def assemble(spans) -> Dict[str, List[TraceNode]]:
    """trace_id(hex) -> list of root TraceNodes. A span whose parent is
    absent from the merged set (lost store, sampled-out hop) becomes a
    root — the tree degrades to a forest instead of vanishing."""
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    out: Dict[str, List[TraceNode]] = {}
    for tid, ss in by_trace.items():
        by_id: Dict[str, TraceNode] = {}
        for s in ss:
            # duplicate span ids (a re-read of a rotated store): first wins
            by_id.setdefault(s["span_id"], TraceNode(s))
        roots: List[TraceNode] = []
        for node in by_id.values():
            parent = by_id.get(node.span.get("parent_span_id", ""))
            if parent is not None and parent is not node:
                parent.children.append(node)
            else:
                roots.append(node)
        for node in by_id.values():
            node.children.sort(key=lambda n: n.span.get("base_real_us", 0))
        roots.sort(key=lambda n: n.span.get("base_real_us", 0))
        out[tid] = roots
    return out


def critical_path(roots) -> Tuple[int, List[Tuple[TraceNode, int]]]:
    """(total_us, [(node, self_us), ...]) down the max-latency chain:
    at each hop the child with the largest latency is charged, and the
    hop keeps the remainder as self time — where the trace's wall time
    actually went, hop by hop."""
    if not roots:
        return 0, []
    root = max(roots, key=lambda n: n.span.get("latency_us", 0))
    path: List[Tuple[TraceNode, int]] = []
    node = root
    while True:
        child = max(node.children,
                    key=lambda n: n.span.get("latency_us", 0), default=None)
        child_lat = child.span.get("latency_us", 0) if child else 0
        path.append((node, max(0, node.span.get("latency_us", 0)
                               - child_lat)))
        if child is None:
            break
        node = child
    return root.span.get("latency_us", 0), path


def stage_attribution(path) -> Dict[str, int]:
    """Sum the queue/handle/write stages along a critical path — the
    --top answer to "is the fleet queueing, computing, or flushing"."""
    out = {"queue_us": 0, "handle_us": 0, "write_us": 0}
    for node, _self_us in path:
        for k in out:
            out[k] += int(node.span.get(k, 0) or 0)
    return out


# -------------------------------------------------------------- perfetto
def _stage_bounds(s: dict):
    """[(from_us, to_us, stage_name)] in the span's monotonic clock."""
    start = s.get("start_us", 0)
    if s.get("side") == "server":
        base = s.get("received_us") or start
        m0, m1 = s.get("handler_start_us", 0), s.get("handler_end_us", 0)
        tail = s.get("flushed_us") or s.get("end_us", start)
    else:
        base = start
        m0, m1 = s.get("write_done_us", 0), s.get("first_byte_us", 0)
        tail = s.get("end_us", start)
    if m0 and m1:
        return [(base, m0, "queue"), (m0, m1, "handle"), (m1, tail, "write")]
    return [(base, tail, "queue")]


def to_perfetto(spans) -> dict:
    """Chrome trace-event JSON (loads in Perfetto / chrome://tracing):
    one complete ("X") slice per span, with its queue/handle/write
    stages as nested sub-slices on the same track, grouped by pid.
    Timestamps are wall-anchored microseconds relative to the earliest
    span, so a multi-process trace lines up on one axis."""
    events: List[dict] = []
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(s.get("base_real_us", 0) for s in spans)
    next_tid: Dict[int, int] = {}
    named_pids = set()
    for s in spans:
        pid = int(s.get("pid", 0))
        if pid not in named_pids:
            named_pids.add(pid)
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": f"pid {pid}"}})
        tid = next_tid.get(pid, 0) + 1   # one track per span within a pid
        next_tid[pid] = tid
        base_real = s.get("base_real_us", 0)
        start = s.get("start_us", 0)

        def real(us: int) -> int:
            return base_real + (us - start) - t0

        name = f'{s.get("service", "?")}.{s.get("method", "?")}'
        events.append({
            "ph": "X", "name": f'{name} ({s.get("side", "?")})',
            "cat": s.get("side", "span"),
            "pid": pid, "tid": tid,
            "ts": real(start), "dur": max(0, int(s.get("latency_us", 0))),
            "args": {
                "trace_id": s.get("trace_id"),
                "span_id": s.get("span_id"),
                "parent_span_id": s.get("parent_span_id"),
                "error_code": s.get("error_code", 0),
                "request_size": s.get("request_size", 0),
                "response_size": s.get("response_size", 0),
                "queue_us": s.get("queue_us", 0),
                "handle_us": s.get("handle_us", 0),
                "write_us": s.get("write_us", 0),
            },
        })
        for lo, hi, stage in _stage_bounds(s):
            if hi > lo:
                events.append({
                    "ph": "X", "name": stage, "cat": "stage",
                    "pid": pid, "tid": tid,
                    "ts": real(lo), "dur": hi - lo,
                    "args": {"span_id": s.get("span_id")},
                })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_perfetto(doc) -> int:
    """Raise on any malformed event; returns the slice count (the
    acceptance check: every emitted event is well-formed)."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a trace-event document")
    nslices = 0
    for ev in doc["traceEvents"]:
        if ev.get("ph") not in ("X", "M"):
            raise ValueError(f"bad ph in {ev!r}")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            raise ValueError(f"bad pid/tid in {ev!r}")
        if ev["ph"] == "M":
            continue
        nslices += 1
        if not isinstance(ev.get("ts"), int) or ev["ts"] < 0:
            raise ValueError(f"bad ts in {ev!r}")
        if not isinstance(ev.get("dur"), int) or ev["dur"] < 0:
            raise ValueError(f"bad dur in {ev!r}")
        if not ev.get("name"):
            raise ValueError(f"missing name in {ev!r}")
    return nslices


# ----------------------------------------------------------------- report
def _tree_lines(node: TraceNode, depth: int, out: List[str]) -> None:
    s = node.span
    out.append("  " * depth
               + f'{s.get("side", "?"):6s} {s.get("service")}.'
                 f'{s.get("method")} {s.get("latency_us", 0)}us '
                 f'(q={s.get("queue_us", 0)} h={s.get("handle_us", 0)} '
                 f'w={s.get("write_us", 0)})'
               + (f' ERR={s["error_code"]}' if s.get("error_code") else ""))
    for c in node.children:
        _tree_lines(c, depth + 1, out)


def summarize(forest, top: Optional[int] = None) -> str:
    ranked = []
    for tid, roots in forest.items():
        total, path = critical_path(roots)
        nspans = sum(1 for r in roots for _ in r.walk())
        ranked.append((total, tid, roots, path, nspans))
    ranked.sort(reverse=True, key=lambda r: r[0])
    if top is not None:
        ranked = ranked[:top]
    lines: List[str] = []
    for total, tid, roots, path, nspans in ranked:
        attr = stage_attribution(path)
        lines.append(f"trace {tid}: {nspans} spans, "
                     f"critical_path={total}us "
                     f"(queue={attr['queue_us']}us "
                     f"handle={attr['handle_us']}us "
                     f"write={attr['write_us']}us)")
        for root in roots:
            _tree_lines(root, 1, lines)
    return "\n".join(lines)


# ------------------------------------------------------------------ smoke
def run_smoke() -> dict:
    """A loopback burst with ``rpcz_dir`` set: client -> Mid.Hop ->
    Leaf.Echo; the store assembled, the trees' shape, the critical paths
    and the Perfetto export checked. One process over real sockets: the
    cheapest proof that stamping, persisting, assembling and exporting
    hold together."""
    import tempfile
    import time

    tmp = tempfile.mkdtemp(prefix="rpcz_smoke_")
    from brpc_tpu_torch.butil.flags import set_flag
    set_flag("rpcz_enabled", True)
    set_flag("rpcz_dir", tmp)
    from brpc_tpu_torch.rpc import Channel, Server, ServerOptions, Service
    from brpc_tpu_torch.rpc.span import global_store

    leaf = Server(ServerOptions(enable_builtin_services=False))
    lsvc = Service("Leaf")
    lsvc.register_method("Echo", lambda c, r: b"leaf:" + bytes(r))
    leaf.add_service(lsvc)
    leaf_ep = leaf.start("tcp://127.0.0.1:0")
    leaf_ch = Channel(str(leaf_ep))

    mid = Server(ServerOptions(enable_builtin_services=False))
    msvc = Service("Mid")

    def hop(cntl, request):
        r = leaf_ch.call_sync("Leaf", "Echo", bytes(request))
        if r.failed():
            cntl.set_failed(r.error_code, r.error_text)
            return b""
        return b"mid:" + r.response

    msvc.register_method("Hop", hop)
    mid.add_service(msvc)
    mid_ep = mid.start("tcp://127.0.0.1:0")
    mid_ch = Channel(str(mid_ep))

    report: dict = {"rpcz_dir": tmp}
    try:
        calls = 6
        for i in range(calls):
            cntl = mid_ch.call_sync("Mid", "Hop", b"ping%d" % i)
            if cntl.failed():
                raise AssertionError(f"smoke call failed: {cntl.error_text}")
        time.sleep(0.2)        # let trailing server-side finishes land
        global_store.flush()
        spans = load_spans([tmp])
        forest = assemble(spans)
        # each call yields 4 spans on one trace: client(Mid.Hop) ->
        # server(Mid.Hop) -> client(Leaf.Echo) -> server(Leaf.Echo)
        chains = {tid: roots for tid, roots in forest.items()
                  if sum(1 for r in roots for _ in r.walk()) >= 4}
        if len(chains) < calls:
            raise AssertionError(
                f"expected >= {calls} 4-span traces, got {len(chains)} "
                f"of {len(forest)} traces / {len(spans)} spans")
        depths = []
        for tid, roots in chains.items():
            if len(roots) != 1:
                raise AssertionError(f"trace {tid}: {len(roots)} roots")
            # the chain must be strictly nested: one child per hop
            node, depth = roots[0], 1
            while node.children:
                if len(node.children) != 1:
                    raise AssertionError(f"trace {tid}: branchy chain")
                node = node.children[0]
                depth += 1
            depths.append(depth)
            total, path = critical_path(roots)
            if total <= 0 or len(path) != depth:
                raise AssertionError(f"trace {tid}: bad critical path")
        if max(depths) < 4:
            raise AssertionError(f"chain depth {max(depths)} < 4")
        doc = json.loads(json.dumps(to_perfetto(spans)))
        nslices = validate_perfetto(doc)
        report.update(ok=True, spans=len(spans), traces=len(forest),
                      chains=len(chains), chain_depth=max(depths),
                      perfetto_slices=nslices)
        return report
    finally:
        set_flag("rpcz_dir", "")
        set_flag("rpcz_enabled", False)
        for ch in (mid_ch, leaf_ch):
            try:
                ch.close()
            except Exception:
                pass
        for srv in (mid, leaf):
            try:
                srv.stop()
                srv.join(2)
            except Exception:
                pass


# ------------------------------------------------------------------- main
def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="merge rpcz_dir span stores, assemble trace trees, "
                    "export Perfetto JSON")
    p.add_argument("dirs", nargs="*",
                   help="rpcz_dir directories (or span .jsonl files)")
    p.add_argument("--perfetto", metavar="OUT",
                   help="write Chrome trace-event JSON to OUT ('-' = "
                        "stdout)")
    p.add_argument("--top", type=int, metavar="N",
                   help="print only the N slowest traces by critical-"
                        "path latency, stage-attributed")
    p.add_argument("--smoke", action="store_true",
                   help="self-check: loopback multi-hop burst, assemble, "
                        "validate the export (JSON verdict on stdout)")
    args = p.parse_args(argv)
    if args.smoke:
        try:
            report = run_smoke()
        except AssertionError as e:
            print(json.dumps({"ok": False, "invariant": str(e)}))
            return 1
        print(json.dumps(report))
        return 0
    if not args.dirs:
        p.error("no span stores given (and --smoke not set)")
    spans = load_spans(args.dirs)
    if args.perfetto:
        doc = to_perfetto(spans)
        validate_perfetto(doc)
        out = json.dumps(doc)
        if args.perfetto == "-":
            print(out)
        else:
            with open(args.perfetto, "w", encoding="utf-8") as f:
                f.write(out)
            print(f"wrote {len(doc['traceEvents'])} events "
                  f"({len(spans)} spans) to {args.perfetto}")
        return 0
    forest = assemble(spans)
    print(f"{len(spans)} spans in {len(forest)} traces "
          f"from {len(args.dirs)} store(s)")
    print(summarize(forest, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
