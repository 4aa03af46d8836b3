"""rpc_dump: the old sampler's surface over the traffic recorder (the port
of brpc_tpu/rpc/rpc_dump.py; bRPC's rpc_dump.h:50-95).

The sampler grew into ``brpc_tpu_torch/traffic/``: a recorder with
per-method sampling, rotation, a disk budget and the indexed ``.brpccap``
corpus. This module keeps the old surface:

- the ``rpc_dump_dir`` and ``rpc_dump_max_requests_per_second`` flags: a
  non-empty ``rpc_dump_dir`` starts the recorder with that budget
  (``traffic/capture.py`` reads them), and clearing it stops it;
- ``global_dumper.maybe_dump(...)`` records through the recorder's gates;
- ``load_dump(path)`` yields ``(service, method, payload, log_id)`` from
  an old JSONL dump or a ``.brpccap`` corpus alike (sniffed by magic).
"""

from __future__ import annotations

import base64
import json

from brpc_tpu_torch.butil.flags import define_flag
from brpc_tpu_torch.butil.recordio import MAGIC as _RIO_MAGIC

define_flag("rpc_dump_dir", "", "LEGACY alias: directory for sampled "
            "request capture (empty = disabled); prefer capture_dir / "
            "the /capture page")
define_flag("rpc_dump_max_requests_per_second", 100,
            "LEGACY alias: sampling budget per second (applies when "
            "capture starts via rpc_dump_dir)", validator=lambda v: v >= 1)


class RpcDumper:
    """The old dumper's API, forwarded to the traffic recorder, which
    owns the files, the queue and the fork hygiene."""

    def maybe_dump(self, service: str, method: str, payload: bytes,
                   log_id: int = 0) -> bool:
        from brpc_tpu_torch.traffic.capture import global_recorder
        rec = global_recorder()
        if not rec.capture_enabled():
            return False
        r = rec.sample_request(f"{service}.{method}", service, method,
                               bytes(payload), None, 0, 0.0, log_id, 0)
        if r is None:
            return False
        rec.record_complete(r, 0, 0.0)
        return True


global_dumper = RpcDumper()


def load_dump(path: str):
    """Yield ``(service, method, payload, log_id)`` from an old JSONL dump
    or a ``.brpccap`` corpus."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == _RIO_MAGIC:
        from brpc_tpu_torch.traffic.corpus import CorpusReader
        for rec in CorpusReader(path):
            yield (rec.service, rec.method, rec.payload, rec.log_id)
        return
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            yield (rec["service"], rec["method"],
                   base64.b64decode(rec["payload"]), rec.get("log_id", 0))
