"""rpc_view: corpus inspector (the port of tools/rpc_view.py, grown for
the traffic engine's .brpccap format).

    python3 -m brpc_tpu_torch.tools.rpc_view capture_dir/  # + records
    python3 -m brpc_tpu_torch.tools.rpc_view corpus.brpccap --summary
    python3 -m brpc_tpu_torch.tools.rpc_view dump.jsonl --service Echo \
        --limit 20
    python3 -m brpc_tpu_torch.tools.rpc_view \
        --incident incident-3-11-170.brpcinc

Reads .brpccap corpora (file or capture directory) and legacy rpc_dump
JSONL files. The summary block shows per-method and per-priority
histograms, a payload-size histogram, the interarrival profile, and
status/latency spread — the "what is in this corpus" view an operator
wants before replaying it.

--incident (implied by a ``.brpcinc`` suffix) opens an incident
artifact instead: the incident document (trigger keys, window stamps,
per-class error counts), the snapshot inventory, and the embedded
corpus's summary — the "what broke and what evidence rode along" view
before handing the artifact to ``brpc_tpu_torch.tools.incident_replay``.
The plain
corpus flags (--service/--limit/...) still apply to the embedded
corpus because .brpcinc is a recordio superset of .brpccap.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _preview(payload: bytes, width: int = 60) -> str:
    try:
        text = payload.decode("utf-8")
        if text.isprintable() or all(c.isprintable() or c in "\r\n\t"
                                     for c in text):
            return repr(text[:width])
    except UnicodeDecodeError:
        pass
    return payload[:width // 2].hex() + ("…" if len(payload) > width // 2
                                         else "")


def _load(path: str):
    """Yield CapturedRequest-shaped records from corpus or legacy
    files."""
    from brpc_tpu_torch.traffic.corpus import CapturedRequest, corpus_files
    from brpc_tpu_torch.traffic.corpus import CorpusReader
    paths = corpus_files(path) if os.path.isdir(path) else [path]
    for p in paths:
        with open(p, "rb") as f:
            is_corpus = f.read(4) == b"RIO1"
        if is_corpus:
            yield from CorpusReader(p)
            continue
        from brpc_tpu_torch.rpc.rpc_dump import load_dump
        for i, (service, method, payload, log_id) in enumerate(
                load_dump(p)):
            yield CapturedRequest(
                method_key=f"{service}.{method}", service=service,
                method=method, payload=payload, attachment=b"",
                arrival_mono_ns=0, arrival_wall_ns=0, timeout_ms=0.0,
                priority=0, log_id=log_id, status=0, latency_us=0.0)


def _size_bucket(n: int) -> str:
    if n <= 64:
        return "<=64"
    b = 128
    while b < n:
        b <<= 1
    return f"<={b}"


def _pct(sorted_vals, ratio):
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(ratio * len(sorted_vals)))]


def summarize(records) -> dict:
    methods = {}
    priorities = {}
    sizes = {}
    statuses = {}
    lat = []
    stamps = []
    total_bytes = 0
    n = 0
    for r in records:
        n += 1
        methods[r.method_key] = methods.get(r.method_key, 0) + 1
        pk = str(r.priority)
        priorities[pk] = priorities.get(pk, 0) + 1
        sz = len(r.payload) + len(r.attachment)
        total_bytes += sz
        sk = _size_bucket(sz)
        sizes[sk] = sizes.get(sk, 0) + 1
        ek = str(r.status)
        statuses[ek] = statuses.get(ek, 0) + 1
        if r.latency_us:
            lat.append(r.latency_us)
        if r.arrival_mono_ns:
            stamps.append(r.arrival_mono_ns)
    out = {"records": n, "bytes": total_bytes, "methods": methods,
           "priorities": priorities, "size_hist": sizes,
           "statuses": statuses}
    lat.sort()
    if lat:
        out["latency_us"] = {
            "p50": round(_pct(lat, 0.5), 1),
            "p99": round(_pct(lat, 0.99), 1),
            "max": round(lat[-1], 1)}
    stamps.sort()
    if len(stamps) >= 2:
        gaps = sorted((b - a) / 1e6
                      for a, b in zip(stamps, stamps[1:]))
        span_s = (stamps[-1] - stamps[0]) / 1e9
        out["interarrival"] = {
            "span_s": round(span_s, 3),
            "avg_qps": round((n - 1) / span_s, 1) if span_s else None,
            "gap_ms_p50": round(_pct(gaps, 0.5), 3),
            "gap_ms_p99": round(_pct(gaps, 0.99), 3),
            "gap_ms_max": round(gaps[-1], 3)}
    return out


def incident_view(path: str, args) -> None:
    """The --incident mode: artifact document + snapshot inventory +
    embedded-corpus summary (one JSON doc with --json)."""
    from brpc_tpu_torch.incident.artifact import read_artifact
    art = read_artifact(path)
    meta = art["meta"]
    corpus = [r for r in art["corpus"]
              if (not args.service or r.service == args.service)
              and (not args.method or r.method == args.method)
              and (args.priority is None or r.priority == args.priority)]
    snaps = {name: sorted(doc) if isinstance(doc, dict)
             else f"{len(doc)} rows" if isinstance(doc, list)
             else type(doc).__name__
             for name, doc in art["snapshots"].items()}
    if args.json:
        print(json.dumps({"incident": meta, "snapshots": snaps,
                          "corpus": summarize(corpus),
                          "bad_records": art.get("bad_records", 0)},
                         default=str))
        return
    print(f"# incident #{meta.get('id')}  state={meta.get('state')}  "
          f"pid={meta.get('pid')}")
    print(f"# keys: {json.dumps(meta.get('keys'))}  "
          f"peak={meta.get('peak_key')} z={meta.get('peak_z')} "
          f"value={meta.get('peak_value')} "
          f"baseline={meta.get('baseline')}")
    print(f"# window: opened_t={meta.get('opened_t')} "
          f"closed_t={meta.get('closed_t')} "
          f"window_ticks={meta.get('window_ticks')}")
    print(f"# error_classes: {json.dumps(meta.get('error_classes'))}")
    print(f"# snapshots: {json.dumps(snaps)}")
    if not args.summary:
        for r in corpus[:args.limit or 20]:
            extra = f"  status={r.status}" if r.status else ""
            print(f"  {r.service}.{r.method}  log_id={r.log_id}  "
                  f"{len(r.payload)}B{extra}  {_preview(r.payload)}")
    s = summarize(corpus)
    print(f"# corpus: {s['records']} records, {s['bytes']} bytes")
    print(f"# methods: {json.dumps(s['methods'])}")
    print(f"# statuses: {json.dumps(s['statuses'])}")
    if "latency_us" in s:
        print(f"# latency_us: {json.dumps(s['latency_us'])}")
    print(f"# replay: python3 -m brpc_tpu_torch.tools.incident_replay "
          f"{path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="inspect captured corpora")
    ap.add_argument("path", help="corpus file, capture dir, legacy "
                                 "jsonl dump, or .brpcinc artifact")
    ap.add_argument("--incident", action="store_true",
                    help="treat path as a .brpcinc incident artifact "
                         "(implied by the suffix)")
    ap.add_argument("--service", default=None, help="filter by service")
    ap.add_argument("--method", default=None, help="filter by method")
    ap.add_argument("--priority", type=int, default=None,
                    help="filter by priority tag")
    ap.add_argument("--limit", type=int, default=0, help="0 = all")
    ap.add_argument("--summary", action="store_true",
                    help="histograms/profile only, no per-record lines")
    ap.add_argument("--json", action="store_true",
                    help="summary as one JSON line")
    ap.add_argument("--raw", action="store_true",
                    help="write payload bytes of the first match to stdout")
    args = ap.parse_args(argv)

    if args.incident or args.path.endswith(".brpcinc"):
        incident_view(args.path, args)
        return

    def matches(r) -> bool:
        if args.service and r.service != args.service:
            return False
        if args.method and r.method != args.method:
            return False
        if args.priority is not None and r.priority != args.priority:
            return False
        return True

    shown = 0
    kept = []
    truncated = False
    for r in _load(args.path):
        if not matches(r):
            continue
        if args.raw:
            sys.stdout.buffer.write(r.payload)
            return
        if args.limit and len(kept) >= args.limit:
            # --limit bounds the WORK, not just the printout: a
            # disk-budget-sized capture dir must not be read (and
            # held in memory) end to end for a 5-line peek — the
            # summary then covers the scanned prefix, flagged below
            truncated = True
            break
        kept.append(r)
        if not args.summary and not args.json:
            extra = ""
            if r.priority:
                extra += f"  prio={r.priority}"
            if r.timeout_ms:
                extra += f"  timeout={r.timeout_ms:g}ms"
            if r.status:
                extra += f"  status={r.status}"
            if r.latency_us:
                extra += f"  lat={r.latency_us:.0f}us"
            print(f"{r.service}.{r.method}  log_id={r.log_id}  "
                  f"{len(r.payload)}B{extra}  {_preview(r.payload)}")
            shown += 1
    if not kept:
        print("no samples matched", file=sys.stderr)
        sys.exit(1)
    s = summarize(kept)
    if truncated:
        s["truncated_at"] = args.limit
    if args.json:
        print(json.dumps(s))
        return
    head = (f"first {s['records']} records (--limit)" if truncated
            else f"{s['records']} records")
    print(f"\n# {head}, {s['bytes']} payload+attachment bytes")
    print(f"# methods: {json.dumps(s['methods'])}")
    print(f"# priorities: {json.dumps(s['priorities'])}")
    print(f"# sizes: {json.dumps(s['size_hist'])}")
    print(f"# statuses: {json.dumps(s['statuses'])}")
    if "latency_us" in s:
        print(f"# latency_us: {json.dumps(s['latency_us'])}")
    if "interarrival" in s:
        print(f"# interarrival: {json.dumps(s['interarrival'])}")


if __name__ == "__main__":
    main()
