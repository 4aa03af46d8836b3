"""The .brpccap corpus (the port of brpc_tpu/traffic/corpus.py): captured
RPC requests over recordio, byte for byte the reference's format.

Each record is one captured request:

    meta  = compact JSON {k,s,n,t,w,o,p,l,e,u,ps}
    data  = payload bytes || attachment bytes   (meta["ps"] splits)

      k  method key ("Service.Method")   s/n  service / method name
      t  arrival monotonic ns            w    arrival wall-clock ns
      o  request timeout_ms (0 = none)   p    priority tag (0 = unset)
      l  log_id                          e    completion error code
      u  completion latency us           ps   payload size (split point)

A sidecar ``<corpus>.idx`` (JSON) makes summaries O(1); it is checked
against the corpus's size and rebuilt by a scan when missing, stale or
corrupt. A torn tail loses at most its last record. A writer and a
reader have one owner at a time: the capture writer thread while
recording, a tool otherwise.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, NamedTuple, Optional

from brpc_tpu_torch.butil.recordio import RecordReader, RecordWriter

SUFFIX = ".brpccap"
INDEX_SUFFIX = ".idx"
_INDEX_VERSION = 1


class CapturedRequest(NamedTuple):
    method_key: str
    service: str
    method: str
    payload: bytes
    attachment: bytes
    arrival_mono_ns: int
    arrival_wall_ns: int
    timeout_ms: float          # 0.0 = no deadline recorded
    priority: int              # 0 = unset
    log_id: int
    status: int                # completion error code (0 = OK)
    latency_us: float


def encode_meta(rec: CapturedRequest) -> bytes:
    return json.dumps({
        "k": rec.method_key, "s": rec.service, "n": rec.method,
        "t": rec.arrival_mono_ns, "w": rec.arrival_wall_ns,
        "o": rec.timeout_ms, "p": rec.priority, "l": rec.log_id,
        "e": rec.status, "u": round(rec.latency_us, 1),
        "ps": len(rec.payload),
    }, separators=(",", ":")).encode()


def decode_record(meta: bytes, data: bytes) -> Optional[CapturedRequest]:
    try:
        m = json.loads(meta)
        ps = int(m["ps"])
        return CapturedRequest(
            method_key=m["k"], service=m.get("s", ""),
            method=m.get("n", ""), payload=data[:ps],
            attachment=data[ps:],
            arrival_mono_ns=int(m.get("t", 0)),
            arrival_wall_ns=int(m.get("w", 0)),
            timeout_ms=float(m.get("o", 0) or 0.0),
            priority=int(m.get("p", 0)), log_id=int(m.get("l", 0)),
            status=int(m.get("e", 0)),
            latency_us=float(m.get("u", 0.0)))
    except (ValueError, KeyError, TypeError):
        return None        # foreign/corrupt meta: skip, keep reading


class CorpusWriter:
    """Append captured requests to a .brpccap file, maintaining the
    sidecar index on close(). NOT thread-safe by itself — the capture
    recorder serializes all writes on its one writer thread."""

    # the varying half of the record meta; the (key, service, method)
    # prefix is cached per method — a full json.dumps per record was
    # a measurable slice of the capture writer's GIL share
    _META_TAIL = (b',"t":%d,"w":%d,"o":%.3f,"p":%d,"l":%d,"e":%d,'
                  b'"u":%.1f,"ps":%d}')

    def __init__(self, path: str):
        self.path = path
        # TRUNCATES: one writer owns a corpus file for its whole life
        # (capture names files per pid+seq, merge/save replace).
        # Appending to a pre-existing file would make close() write a
        # sidecar index whose counts cover only this session while its
        # file_size matches — a "valid" index that lies. 1MB buffer:
        # the capture writer appends thousands of small records per
        # second — the default 8KB buffer turned that into a write
        # syscall every ~30 records.
        self._f = open(path, "wb", buffering=1 << 20)
        self._w = RecordWriter(self._f)
        self.records = 0
        self.bytes = 0
        self._methods: Dict[str, int] = {}
        self._priorities: Dict[str, int] = {}
        self._prefixes: Dict[str, bytes] = {}
        self._first_mono = 0
        self._last_mono = 0

    def write(self, rec: CapturedRequest) -> int:
        return self.write_fields(
            rec.method_key, rec.service, rec.method, rec.payload,
            rec.attachment, rec.arrival_mono_ns, rec.arrival_wall_ns,
            rec.timeout_ms, rec.priority, rec.log_id, rec.status,
            rec.latency_us)

    def write_fields(self, method_key: str, service: str, method: str,
                     payload: bytes, attachment: bytes,
                     arrival_mono_ns: int, arrival_wall_ns: int,
                     timeout_ms: float, priority: int, log_id: int,
                     status: int, latency_us: float) -> int:
        """Returns bytes appended. payload/attachment go to disk as
        separate chunks (write_chunks) — no concat copy — and the
        JSON meta assembles from a cached per-method prefix + one
        bytes interpolation (wire-compatible with encode_meta)."""
        pfx = self._prefixes.get(method_key)
        if pfx is None:
            if not service:
                # capture hands "" so the DISPATCH path never pays the
                # two pb string reads per request: the key is always
                # "Service.Method" (service.py full_name), so the
                # split happens here, once per method
                service, _, method = method_key.rpartition(".")
                if not service:
                    service, method = method_key, ""
            pfx = ('{"k":%s,"s":%s,"n":%s' % (
                json.dumps(method_key), json.dumps(service),
                json.dumps(method))).encode()
            if len(self._prefixes) < 4096:
                self._prefixes[method_key] = pfx
        meta = pfx + self._META_TAIL % (
            arrival_mono_ns, arrival_wall_ns, timeout_ms, priority,
            log_id, status, latency_us, len(payload))
        n = self._w.write_chunks((payload, attachment), meta)
        self.records += 1
        self.bytes += n
        self._methods[method_key] = self._methods.get(method_key, 0) + 1
        p = str(priority)
        self._priorities[p] = self._priorities.get(p, 0) + 1
        if not self._first_mono:
            self._first_mono = arrival_mono_ns
        if arrival_mono_ns:
            self._last_mono = max(self._last_mono, arrival_mono_ns)
        return n

    def flush(self) -> None:
        self._w.flush()

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.flush()
        size = self._f.tell()
        self._f.close()
        # the index is advisory: a failure writing it must not lose the
        # corpus (the reader falls back to a scan)
        try:
            tmp = self.path + INDEX_SUFFIX + f".tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({
                    "version": _INDEX_VERSION, "file_size": size,
                    "records": self.records, "methods": self._methods,
                    "priorities": self._priorities,
                    "first_mono_ns": self._first_mono,
                    "last_mono_ns": self._last_mono,
                }, f)
            os.replace(tmp, self.path + INDEX_SUFFIX)
        except OSError:
            pass


class CorpusReader:
    """Iterate a corpus file's valid records; resyncs past torn tails
    and corrupt spans (recordio semantics). ``skipped_bytes`` and
    ``bad_records`` report what degradation cost."""

    def __init__(self, path: str):
        self.path = path
        self.bad_records = 0
        self.skipped_bytes = 0

    def __iter__(self) -> Iterator[CapturedRequest]:
        with open(self.path, "rb") as f:
            rr = RecordReader(f)
            for meta, data in rr:
                rec = decode_record(meta, data)
                if rec is None:
                    self.bad_records += 1
                    continue
                yield rec
            self.skipped_bytes = rr.skipped_bytes

    def records(self) -> List[CapturedRequest]:
        return list(self)

    # ------------------------------------------------------------ index
    def index(self, rebuild: bool = False) -> dict:
        """The summary index: record count, per-method and per-priority
        counts, corpus time span. Served from the sidecar when it
        matches the corpus file byte-for-size; rebuilt by scanning
        otherwise (stale index after a torn tail, missing sidecar,
        corrupt JSON)."""
        try:
            size = os.stat(self.path).st_size
        except OSError:
            size = -1
        if not rebuild:
            try:
                with open(self.path + INDEX_SUFFIX,
                          encoding="utf-8") as f:
                    idx = json.load(f)
                if idx.get("version") == _INDEX_VERSION \
                        and idx.get("file_size") == size:
                    idx["source"] = "sidecar"
                    return idx
            except (OSError, ValueError):
                pass
        methods: Dict[str, int] = {}
        priorities: Dict[str, int] = {}
        n = 0
        first = last = 0
        for rec in self:
            n += 1
            methods[rec.method_key] = methods.get(rec.method_key, 0) + 1
            p = str(rec.priority)
            priorities[p] = priorities.get(p, 0) + 1
            if not first:
                first = rec.arrival_mono_ns
            if rec.arrival_mono_ns:
                last = max(last, rec.arrival_mono_ns)
        return {"version": _INDEX_VERSION, "file_size": size,
                "records": n, "methods": methods,
                "priorities": priorities, "first_mono_ns": first,
                "last_mono_ns": last, "source": "scan",
                "bad_records": self.bad_records,
                "skipped_bytes": self.skipped_bytes}


def corpus_files(path: str) -> List[str]:
    """Resolve a corpus argument: a file, or a directory holding
    .brpccap files (a capture dir; legacy rpc_dump jsonl files are the
    caller's business)."""
    if os.path.isdir(path):
        return sorted(os.path.join(path, n) for n in os.listdir(path)
                      if n.endswith(SUFFIX))
    return [path]


def read_corpus(path: str) -> List[CapturedRequest]:
    """All valid records across a file or capture directory, ordered
    by arrival monotonic time (per-shard files interleave by stamp —
    each shard's clock is the same machine's monotonic clock)."""
    out: List[CapturedRequest] = []
    for f in corpus_files(path):
        out.extend(CorpusReader(f))
    out.sort(key=lambda r: r.arrival_mono_ns)
    return out


def merge_corpora(paths: List[str], out_path: str) -> dict:
    """Merge shard corpus files into one, ordered by arrival stamp —
    the supervisor's /capture download builds the group-wide corpus
    this way. Returns the merged index."""
    recs: List[CapturedRequest] = []
    for p in paths:
        recs.extend(CorpusReader(p))
    recs.sort(key=lambda r: r.arrival_mono_ns)
    w = CorpusWriter(out_path)    # truncates: merge replaces
    try:
        for r in recs:
            w.write(r)
    finally:
        w.close()
    return CorpusReader(out_path).index()
