"""The .brpcinc incident artifact (the port of
brpc_tpu/incident/artifact.py): one incident, one file, byte for byte
the reference's format.

A recordio container (``butil/recordio.py``) of three kinds of record,
told apart by their meta JSON:

    {"inc":"meta","v":1}          data = the incident document (trigger
                                  keys, window stamps, error classes,
                                  corpus accounting)
    {"inc":"snap","name":<name>}  data = a JSON snapshot (status,
                                  timeline slice, hotspots, device,
                                  backends, serving, rpcz spans)
    corpus meta  {k,s,n,...}      data = payload||attachment: the
                                  window's captured requests, encoded
                                  exactly as ``traffic/corpus.py``'s

So ``CorpusReader`` over a .brpcinc file skips the incident records and
yields the captured requests. A sidecar ``<artifact>.idx`` (JSON) is an
O(1) summary, checked against the file's size and rebuilt by a scan when
missing or stale.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from brpc_tpu_torch.butil.recordio import RecordReader, RecordWriter
from brpc_tpu_torch.traffic.corpus import (CapturedRequest, decode_record,
                                     encode_meta)

SUFFIX = ".brpcinc"
INDEX_SUFFIX = ".idx"
_INDEX_VERSION = 1
_ARTIFACT_VERSION = 1


class ArtifactWriter:
    """Append-assemble one incident artifact. Single-owner by protocol
    (the incident bundler thread); tracks bytes written so the bundler
    can stop adding corpus records at the size cap."""

    def __init__(self, path: str):
        self.path = path
        # TRUNCATES: one bundler owns an artifact for its whole life
        self._f = open(path, "wb", buffering=1 << 20)
        self._w = RecordWriter(self._f)
        self.bytes = 0
        self.corpus_records = 0
        self.snapshot_names: List[str] = []
        self._meta_doc: Optional[dict] = None

    def put_incident_meta(self, doc: dict) -> int:
        """The incident document — write it FIRST so a size-capped or
        torn artifact still identifies its incident."""
        self._meta_doc = doc
        meta = json.dumps({"inc": "meta", "v": _ARTIFACT_VERSION},
                          separators=(",", ":")).encode()
        data = json.dumps(doc, sort_keys=True,
                          separators=(",", ":")).encode()
        n = self._w.write_chunks((data,), meta)
        self.bytes += n
        return n

    def put_snapshot(self, name: str, doc) -> int:
        meta = json.dumps({"inc": "snap", "name": name},
                          separators=(",", ":")).encode()
        data = json.dumps(doc, separators=(",", ":"),
                          default=str).encode()
        n = self._w.write_chunks((data,), meta)
        self.bytes += n
        self.snapshot_names.append(name)
        return n

    def put_request(self, rec: CapturedRequest) -> int:
        """One in-window captured request, encoded exactly as a
        .brpccap record (CorpusReader-compatible)."""
        n = self._w.write_chunks((rec.payload, rec.attachment),
                                 encode_meta(rec))
        self.bytes += n
        self.corpus_records += 1
        return n

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.flush()
        size = self._f.tell()
        self._f.close()
        # advisory sidecar: pages/tools summarize without a scan
        md = self._meta_doc or {}
        try:
            tmp = self.path + INDEX_SUFFIX + f".tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({
                    "version": _INDEX_VERSION, "file_size": size,
                    "corpus_records": self.corpus_records,
                    "snapshots": list(self.snapshot_names),
                    "incident_id": md.get("id"),
                    "peak_key": md.get("peak_key"),
                    "keys": md.get("keys"),
                    "opened_t": md.get("opened_t"),
                }, f)
            os.replace(tmp, self.path + INDEX_SUFFIX)
        except OSError:
            pass


def read_artifact(path: str) -> dict:
    """Parse a whole artifact: ``{"meta": incident doc, "snapshots":
    {name: doc}, "corpus": [CapturedRequest], "bad_records": n}``.
    Resyncs past corruption (recordio semantics); a torn tail loses at
    most the final record."""
    meta_doc: Optional[dict] = None
    snapshots: Dict[str, object] = {}
    corpus: List[CapturedRequest] = []
    bad = 0
    with open(path, "rb") as f:
        for meta, data in RecordReader(f):
            kind = None
            try:
                m = json.loads(meta)
                kind = m.get("inc") if isinstance(m, dict) else None
            except ValueError:
                m = None
            if kind == "meta":
                try:
                    meta_doc = json.loads(data)
                except ValueError:
                    bad += 1
            elif kind == "snap":
                try:
                    snapshots[m.get("name") or ""] = json.loads(data)
                except ValueError:
                    bad += 1
            else:
                rec = decode_record(meta, data)
                if rec is None:
                    bad += 1
                else:
                    corpus.append(rec)
    return {"meta": meta_doc or {}, "snapshots": snapshots,
            "corpus": corpus, "bad_records": bad}


def artifact_summary(path: str) -> dict:
    """O(1) summary from the sidecar when it matches the artifact's
    byte size; full scan otherwise."""
    try:
        size = os.stat(path).st_size
    except OSError:
        size = -1
    try:
        with open(path + INDEX_SUFFIX, encoding="utf-8") as f:
            idx = json.load(f)
        if idx.get("version") == _INDEX_VERSION \
                and idx.get("file_size") == size:
            idx["source"] = "sidecar"
            return idx
    except (OSError, ValueError):
        pass
    art = read_artifact(path)
    md = art["meta"]
    return {"version": _INDEX_VERSION, "file_size": size,
            "corpus_records": len(art["corpus"]),
            "snapshots": sorted(art["snapshots"]),
            "incident_id": md.get("id"), "peak_key": md.get("peak_key"),
            "keys": md.get("keys"), "opened_t": md.get("opened_t"),
            "source": "scan", "bad_records": art["bad_records"]}


def artifact_files(dirpath: str) -> List[str]:
    """All artifacts under an incident dir, oldest mtime first (the
    disk-budget eviction order)."""
    try:
        names = [n for n in os.listdir(dirpath) if n.endswith(SUFFIX)]
    except OSError:
        return []
    paths = [os.path.join(dirpath, n) for n in names]

    def _stamp(p: str):
        try:
            return (os.stat(p).st_mtime, p)
        except OSError:
            return (0.0, p)

    paths.sort(key=_stamp)
    return paths
