"""Shard groups: N forked worker processes behind one SO_REUSEPORT port
(the port of brpc_tpu/rpc/shard_group.py).

One CPython process is bound by its interpreter lock to about one core
of framework work. ``Server.start(address, num_shards=N)`` escapes that
as the reference's ``-reuse_port`` does: every worker binds the same
port with ``SO_REUSEPORT`` and the kernel spreads accepted connections
over them.

- The supervisor binds a placeholder reuseport socket, which never
  listens, to hold the port, then forks N shards.
- Each shard crosses the fork through the postfork registry
  (``butil/postfork.py``): a fresh dispatcher, TaskControl, timer,
  bvar sampler, socket pool, and its own serving engine, built by its
  own ``Server.start``. It binds the port with ``reuse_port=1`` and
  serves.
- Each shard writes its counters and latency reservoirs to a JSON dump
  of its own (``write_shard_dump``); the dump's mtime is its heartbeat.
- The supervisor restarts a crashed or hung shard with jittered
  exponential backoff, and serves the merged views (``/status``,
  ``/vars``, the Prometheus dump, ``/serving``, ``/device``,
  ``/timeline``, ``/hotspots``, ``/capture``, ``/incidents``,
  ``/census``, ``/shards``) from an admin server, one shard's behind
  ``?shard=i``.
- ``stop()`` drains: each shard closes its listener, finishes its calls
  in flight, writes a last dump and exits.

CUDA (the port's own rule). CUDA does not survive ``fork()``: a
process that initialised CUDA cannot give a forked child a working
one, and PyTorch marks a child whose parent asked the CUDA runtime for
its device count as unable to initialise CUDA. So the supervisor runs
no CUDA call before it forks. ``start`` refuses a process in which
CUDA is initialised, each shard builds its own engine on the card in
its own ``Server.start`` (its own context), and a shard whose serving
device is the card exits with ``EXIT_CUDA_BAD_FORK`` when its parent
touched CUDA; the monitor then fails the whole group (every shard
stopped, ``/shards`` naming the cause) instead of restarting shards
that can never serve. Nothing falls back to the CPU. Before the first fork the supervisor compiles,
and does not load, the libraries the shards load (the native core and
the serving lane's decode kernel): several shards compiling at once
from an empty ``_build/`` would outlast the hang check.
"""

from __future__ import annotations

import json
import logging
import os
import random
import re
import signal
import socket as pysocket
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint, str2endpoint

log = logging.getLogger("brpc_tpu_torch.rpc")

# a shard's exit code when its parent made a CUDA call before the fork:
# a restart forks from the same parent, so the group fails instead
EXIT_CUDA_BAD_FORK = 86


class CudaBadForkError(RuntimeError):
    """A shard that serves on the card was forked from a process that
    made a CUDA call; it cannot initialise CUDA."""


class ShardGroupOptions:
    """The group's knobs (brpc_tpu/rpc/shard_group.py:56-85).
    ``admin_address``: the supervisor's merged-observability server
    (None: the group's host, a free port; only with ``enable_admin``).
    ``heartbeat_timeout_s``: a shard whose dump has not moved this long
    while its process lives is hung, and is killed and restarted (<= 0:
    no hang check). ``shard_dir``: where the dumps go (None: a private
    temporary directory). ``seed``: the backoff jitter's."""

    def __init__(self,
                 num_shards: int = 2,
                 admin_address: Optional[str] = None,
                 enable_admin: bool = True,
                 dump_interval_s: float = 0.3,
                 heartbeat_timeout_s: float = 10.0,
                 restart_backoff_s: float = 0.25,
                 restart_backoff_max_s: float = 5.0,
                 restart_jitter: float = 0.5,
                 drain_timeout_s: float = 5.0,
                 shard_dir: Optional[str] = None,
                 seed: Optional[int] = None):
        self.num_shards = num_shards
        self.admin_address = admin_address
        self.enable_admin = enable_admin
        self.dump_interval_s = dump_interval_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.restart_jitter = restart_jitter
        self.drain_timeout_s = drain_timeout_s
        self.shard_dir = shard_dir
        self.seed = seed


# ------------------------------------------------------------------ dumps

def write_shard_dump(dirpath: str, index: int, server, seq: int) -> None:
    """One shard's observability snapshot, written whole (a temporary
    file and ``os.replace``), so that the supervisor never reads a torn
    one. It carries ``/vars``, ``/status`` and the raw latency
    reservoirs of each method (percentiles merge from pooled samples,
    never from averaged percentiles), with the keys of brpc_tpu's dumps
    (brpc_tpu/rpc/shard_group.py:90-154): either package's aggregator
    reads the other's."""
    from brpc_tpu_torch.builtin.flight_recorder import global_recorder
    from brpc_tpu_torch.builtin.services import (census_page_payload,
                                                 status_page)
    from brpc_tpu_torch.bvar.variable import dump_exposed
    samples = {}
    for key, lr in list(server.method_status.items()):
        samples[key] = lr._percentile.merged_samples()[:1024]
    doc = {
        "shard": index,
        "pid": os.getpid(),
        "seq": seq,
        "time": time.time(),
        "vars": dict(dump_exposed("")),
        "status": status_page(server),
        "latency_samples": samples,
        "hotspots": global_recorder().dump_state(),
        "census": census_page_payload(server),
    }
    if getattr(server, "_serving", None) is not None:
        from brpc_tpu_torch.serving.service import serving_page_payload
        doc["serving"] = serving_page_payload(server)
    from brpc_tpu_torch.transport.device_stats import (device_page_payload,
                                                       global_device_stats)
    if global_device_stats().rows():
        # only once a shard has moved a device batch
        doc["device"] = device_page_payload(server)
    from brpc_tpu_torch.bvar.series import series_enabled
    if series_enabled():
        from brpc_tpu_torch.builtin.services import timeline_page_payload
        doc["timeline"] = timeline_page_payload(server, max_vars=64)
    from brpc_tpu_torch.traffic.capture import \
        global_recorder as traffic_recorder
    rec = traffic_recorder()
    if rec.capturing() or rec.corpus_paths():
        doc["capture"] = rec.snapshot()
    from brpc_tpu_torch.incident.manager import global_manager
    mgr = global_manager()
    if mgr.window_engaged or mgr.bundled or mgr.artifact_rows():
        from brpc_tpu_torch.builtin.services import incidents_page_payload
        doc["incidents"] = incidents_page_payload(server)
    path = os.path.join(dirpath, f"shard-{index}.json")
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, default=str)
    os.replace(tmp, path)


_PCTL_RE = re.compile(r"(^|_)p\d")      # p50, latency_p99_us, ...


def _merge_stat_dict(dicts: List[dict]) -> dict:
    """Merge stat dicts (``LatencyRecorder.get_value``'s shape): counts
    and qps sum, maxima and peaks take the max, limits and thresholds the
    largest, token gauges the smallest, averages, fractions, ratios and
    percentile fields weigh by count (equally when no count exists).
    Method latencies merge from pooled samples instead
    (``ShardAggregator.merged_method_status``)."""
    out: dict = {}
    total = sum(d.get("count", 0) or 0 for d in dicts)
    for d in dicts:
        for k, v in d.items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                out.setdefault(k, v)
                continue
            if k in ("count", "qps") or k.endswith(("_count", "_qps")):
                out[k] = out.get(k, 0) + v
            elif "max" in k or "peak" in k:
                out[k] = max(out.get(k, v), v)
            elif k.endswith("limit") or k.endswith("threshold"):
                # a group's headroom is its largest shard limit, and the
                # admission threshold its tightest gate
                out[k] = max(out.get(k, v), v)
            elif "retry_tokens" in k:
                # retry budgets drain apart: the most drained one counts
                # (brpc_tpu takes the min of every key holding "tokens",
                # counters of generated tokens too)
                out[k] = min(out.get(k, v), v)
            elif ("avg" in k or "fraction" in k or "ratio" in k
                    or _PCTL_RE.search(k)):
                w = (d.get("count", 0) or 0) / total if total else \
                    1.0 / len(dicts)
                out[k] = out.get(k, 0.0) + v * w
            else:
                out[k] = out.get(k, 0) + v
    return {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in out.items()}


def merge_var_values(values: list, name: str = ""):
    """One exposed variable's values over the shards: numbers sum
    (counters), dicts merge as stat dicts, anything else keeps the first
    shard's. ``name`` applies the gauge rules: limits and thresholds take
    the max, retry-token gauges the min (-1, no budget, counts only when
    no shard has one), ratios, usages, fractions and ``_pct`` the mean,
    peaks and ``_max`` the max; so merged ``/vars`` agrees with merged
    ``/status`` and with ``merge_timeline_states``' gauges. brpc_tpu
    takes the min of every name holding "tokens", so its merged
    ``serving_tokens`` is one shard's count; the port keeps the min for
    ``retry_tokens`` names and sums the rest."""
    nums = [v for v in values
            if isinstance(v, (int, float)) and not isinstance(v, bool)]
    if nums and len(nums) == len(values):
        if name.endswith("limit") or name.endswith("threshold"):
            return max(nums)
        if "retry_tokens" in name:
            real = [v for v in nums if v >= 0]
            return min(real) if real else -1
        if ("ratio" in name or "usage" in name or "fraction" in name
                or name.endswith("_pct")):
            return round(sum(nums) / len(nums), 4)
        if "peak" in name or name.endswith("_max") or "_max_" in name:
            return max(nums)
        s = sum(nums)
        return round(s, 3) if isinstance(s, float) else s
    dicts = [v for v in values if isinstance(v, dict)]
    if dicts and len(dicts) == len(values):
        return _merge_stat_dict(dicts)
    return values[0] if values else None


def _percentile(sorted_samples: List[float], ratio: float) -> float:
    if not sorted_samples:
        return 0.0
    idx = min(len(sorted_samples) - 1, int(ratio * len(sorted_samples)))
    return sorted_samples[idx]


class ShardAggregator:
    """Reads the shards' dumps and serves the merged views. The merged
    numbers cover the shards only: the supervisor serves no traffic, and
    mixing its own counters in would make "merged equals the sum of the
    dumps" false."""

    def __init__(self, dirpath: str, num_shards: int):
        self.dirpath = dirpath
        self.num_shards = num_shards
        self.group = None      # the ShardGroup, in the supervisor

    # ------------------------------------------------------------- reads
    def shard_dump(self, index: int) -> Optional[dict]:
        path = os.path.join(self.dirpath, f"shard-{index}.json")
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def read_dumps(self) -> List[dict]:
        out = []
        for i in range(self.num_shards):
            d = self.shard_dump(i)
            if d is not None:
                out.append(d)
        return out

    def heartbeat_age_s(self, index: int) -> Optional[float]:
        path = os.path.join(self.dirpath, f"shard-{index}.json")
        try:
            return max(0.0, time.time() - os.stat(path).st_mtime)
        except OSError:
            return None

    # ------------------------------------------------------------ merges
    def merged_vars(self, prefix: str = "") -> Dict[str, object]:
        dumps = self.read_dumps()
        names: List[str] = []
        seen = set()
        for d in dumps:
            for n in d.get("vars", {}):
                if n.startswith(prefix) and n not in seen:
                    seen.add(n)
                    names.append(n)
        out = {}
        for n in sorted(names):
            out[n] = merge_var_values(
                [d["vars"][n] for d in dumps if n in d.get("vars", {})],
                name=n)
        return out

    def merged_method_status(self, dumps: Optional[List[dict]] = None):
        """Each method's latency: counts and qps sum, max takes the max,
        avg weighs by count, and the percentiles come from every shard's
        pooled reservoir samples."""
        dumps = self.read_dumps() if dumps is None else dumps
        keys = sorted({k for d in dumps
                       for k in d.get("status", {}).get("method_status", {})})
        merged = {}
        for key in keys:
            stats = [d["status"]["method_status"][key] for d in dumps
                     if key in d.get("status", {}).get("method_status", {})]
            m = _merge_stat_dict(stats)
            pooled: List[float] = []
            for d in dumps:
                pooled.extend(d.get("latency_samples", {}).get(key, ()))
            pooled.sort()
            if pooled:
                m["latency_p50_us"] = round(_percentile(pooled, 0.5), 1)
                m["latency_p90_us"] = round(_percentile(pooled, 0.9), 1)
                m["latency_p99_us"] = round(_percentile(pooled, 0.99), 1)
                m["latency_p999_us"] = round(_percentile(pooled, 0.999), 1)
            merged[key] = m
        return merged

    def merged_status(self) -> dict:
        dumps = self.read_dumps()
        statuses = [d.get("status", {}) for d in dumps]
        services: Dict[str, list] = {}
        for st in statuses:
            services.update(st.get("services", {}))
        saturation = _merge_stat_dict(
            [st.get("saturation", {}) for st in statuses]) \
            if statuses else {}
        out = {
            "mode": "shard_group",
            "running": bool(dumps),
            "shards": self.num_shards,
            "shards_reporting": len(dumps),
            "concurrency": sum(st.get("concurrency", 0) for st in statuses),
            "processed": sum(st.get("processed", 0) for st in statuses),
            "errors": sum(st.get("errors", 0) for st in statuses),
            "services": services,
            "method_status": self.merged_method_status(dumps),
            "saturation": saturation,
            "shard_breakdown": {
                str(d.get("shard")): {
                    "pid": d.get("pid"),
                    "processed": d.get("status", {}).get("processed", 0),
                    "errors": d.get("status", {}).get("errors", 0),
                    "concurrency": d.get("status", {}).get("concurrency", 0),
                    "heartbeat_age_s": self.heartbeat_age_s(
                        d.get("shard", 0)),
                } for d in dumps},
        }
        if self.group is not None:
            out["endpoint"] = str(self.group.endpoint)
            out["supervisor"] = self.group.group_status()
        return out

    def prometheus_text(self) -> str:
        from brpc_tpu_torch.bvar.prometheus import dump_prometheus_items
        return dump_prometheus_items(sorted(self.merged_vars().items()))

    def merged_hotspots(self) -> dict:
        """The group's continuous profile: the shards' recorder states
        with their sample counters summed."""
        from brpc_tpu_torch.builtin.flight_recorder import merge_dump_states
        return merge_dump_states(
            [d["hotspots"] for d in self.read_dumps()
             if d.get("hotspots")])

    def merged_serving(self) -> dict:
        """The group's serving view: counters and queue depths sum, the
        batch-size histogram and the steps by worker group merge by key,
        KV occupancy averages over the reporting shards (each owns an
        equal KV budget), and the flight deck's panes pool their samples
        (``serving_stats.merge_serving_panes``)."""
        dumps = [d["serving"] for d in self.read_dumps()
                 if d.get("serving") and d["serving"].get("enabled")]
        out: dict = {"mode": "shard_group", "shards_reporting": len(dumps),
                     "enabled": bool(dumps)}
        if not dumps:
            return out
        for key in ("waiting", "completed", "evicted", "shed",
                    "canceled", "tokens_out", "decode_steps"):
            out[key] = sum(d.get(key, 0) or 0 for d in dumps)
        out["running"] = sum(len(d.get("running", [])) for d in dumps)
        for key in ("batch_size_hist", "steps_by_worker_group"):
            merged: Dict[str, int] = {}
            for d in dumps:
                for k, v in (d.get(key) or {}).items():
                    merged[str(k)] = merged.get(str(k), 0) + v
            out[key] = dict(sorted(merged.items()))
        occ = [d.get("kv_occupancy") for d in dumps
               if d.get("kv_occupancy") is not None]
        out["kv_occupancy"] = round(sum(occ) / len(occ), 4) if occ else 0.0
        out["waiting_detail"] = [w for d in dumps
                                 for w in (d.get("waiting_detail")
                                           or ())][:32]
        # the serving package is loaded in a supervisor whose shards
        # serve; sys.modules keeps this module from importing the model
        # stack in an echo-only group
        panes = [d["stats"] for d in dumps if d.get("stats")]
        ss = sys.modules.get("brpc_tpu_torch.serving.serving_stats")
        if panes and ss is not None:
            out["stats"] = ss.merge_serving_panes(panes)
        return out

    def merged_device(self) -> dict:
        """The group's ``/device``: counters sum, latency samples pool,
        the conn panes concatenate."""
        from brpc_tpu_torch.transport.device_stats import (
            merge_device_payloads)
        return merge_device_payloads(
            [d["device"] for d in self.read_dumps() if d.get("device")])

    def merged_timeline(self, names=None, prefix: str = "") -> dict:
        """The group's ``/timeline``: the shards' rings merged bucket by
        epoch second, and their incidents tagged with their shard."""
        from brpc_tpu_torch.bvar.series import merge_timeline_states
        return merge_timeline_states(
            [(d.get("shard"), d["timeline"]) for d in self.read_dumps()
             if d.get("timeline")],
            names=names, prefix=prefix)

    def merged_capture(self) -> dict:
        """The group's ``/capture``: the shards' recorder snapshots
        (counters sum, files union) and the control file's last
        command."""
        dumps = self.read_dumps()
        caps = [(d.get("shard"), d["capture"]) for d in dumps
                if d.get("capture")]
        out: dict = {"mode": "shard_group",
                     "shards_reporting": len(caps),
                     "active": any(c.get("active") for _, c in caps)}
        for key in ("sampled", "written", "written_bytes",
                    "dropped_queue", "dropped_budget", "rotations",
                    "deleted_files", "pending"):
            out[key] = sum(c.get(key, 0) or 0 for _, c in caps)
        files = {}
        for _, c in caps:
            for f in c.get("files", ()):
                files[f["path"]] = f
        out["files"] = [files[p] for p in sorted(files)]
        out["shard_breakdown"] = {
            str(i): {"active": c.get("active"),
                     "written": c.get("written"),
                     "pid": c.get("pid")} for i, c in caps}
        ctl = self._read_capture_control()
        if ctl is not None:
            out["control"] = ctl
        return out

    def merged_incidents(self) -> dict:
        """The group's ``/incidents``: the shards' sections concatenated
        (each artifact row tagged with its shard, sorted by open stamp
        then shard), counters and bytes summed, open windows counted."""
        dumps = self.read_dumps()
        secs = [(d.get("shard"), d["incidents"]) for d in dumps
                if d.get("incidents")]
        out: dict = {"mode": "shard_group",
                     "shards_reporting": len(secs),
                     "enabled": any(s.get("enabled") for _, s in secs),
                     "open": sum(int(s.get("open") or 0)
                                 for _, s in secs)}
        for key in ("total", "evicted", "skipped", "artifact_bytes"):
            out[key] = sum(s.get(key, 0) or 0 for _, s in secs)
        rows = []
        for shard, s in secs:
            for row in s.get("artifacts") or ():
                r = dict(row)
                r["shard"] = shard
                rows.append(r)
        rows.sort(key=lambda r: (r.get("opened_t") or 0,
                                 r.get("shard") or 0))
        out["artifacts"] = rows
        out["shard_breakdown"] = {
            str(i): {"open": s.get("open"), "total": s.get("total"),
                     "artifact_bytes": s.get("artifact_bytes"),
                     "last_error": s.get("last_error") or ""}
            for i, s in secs}
        return out

    def capture_paths(self) -> List[str]:
        """Every corpus file the shards named: the merged download's
        set."""
        paths = set()
        for d in self.read_dumps():
            for f in (d.get("capture") or {}).get("files", ()):
                paths.add(f["path"])
        return sorted(p for p in paths if os.path.exists(p))

    def _read_capture_control(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.dirpath, "capture-control.json"),
                      encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def merged_census(self) -> dict:
        """The group's ``/census``: each subsystem's dicts merged by the
        stat rules; totals and the connection roll-up summed."""
        censuses = [d["census"] for d in self.read_dumps()
                    if d.get("census")]
        subs: Dict[str, list] = {}
        for c in censuses:
            for name, d in c.get("subsystems", {}).items():
                subs.setdefault(name, []).append(d)
        return {
            "mode": "shard_group",
            "shards_reporting": len(censuses),
            "subsystems": {n: _merge_stat_dict(ds)
                           for n, ds in sorted(subs.items())},
            "total_bytes": sum(c.get("total_bytes", 0) or 0
                               for c in censuses),
            "connections": _merge_stat_dict(
                [c.get("connections", {}) for c in censuses]),
        }


# ------------------------------------------------------------- the group

def _apply_capture_control(shard_dir: str, seen_seq: int) -> int:
    """A shard's side of the supervisor's ``/capture`` control: apply the
    control file's command once a sequence number. A failure is kept
    here: serving must not die for a capture knob."""
    try:
        with open(os.path.join(shard_dir, "capture-control.json"),
                  encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return seen_seq
    seq = int(doc.get("seq", 0) or 0)
    if seq <= seen_seq:
        return seen_seq
    try:
        from brpc_tpu_torch.traffic.capture import (start_capture,
                                                    stop_capture)
        if doc.get("action") == "start":
            kw = {}
            if doc.get("rate") not in (None, ""):
                kw["default_rate"] = float(doc["rate"])
            if doc.get("max_per_second") not in (None, ""):
                kw["max_per_second"] = int(doc["max_per_second"])
            if doc.get("rotate_mb") not in (None, ""):
                kw["rotate_bytes"] = int(doc["rotate_mb"]) << 20
            if doc.get("disk_budget_mb") not in (None, ""):
                kw["disk_budget_bytes"] = \
                    int(doc["disk_budget_mb"]) << 20
            start_capture(dir=doc.get("dir"), **kw)
        elif doc.get("action") == "stop":
            stop_capture()
    except (ValueError, OSError):
        pass
    return seq


def _refuse_cuda_before_fork() -> None:
    """Raise if this process initialised CUDA: its forked shards could
    not initialise their own. Nothing here makes a CUDA call."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(
            "shard group: CUDA is initialised in this process, and a "
            "forked shard cannot initialise its own; start the group "
            "before any CUDA call (the shards build their engines)")


def _build_before_fork(server) -> None:
    """Compile, without loading anything CUDA, what every shard would
    otherwise compile in its warm-up: the native core (g++; a failed
    build leaves the Python lanes, as in any process) and the serving
    lane's decode kernel (nvcc), at once. A kernel build that fails here
    is left to the shards, which fail on it loudly in their own start.
    The threads end before any fork."""
    from concurrent.futures import ThreadPoolExecutor

    from brpc_tpu_torch import native
    from brpc_tpu_torch.native import fastcore
    serving = getattr(server, "_serving", None)
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(native.lib), pool.submit(fastcore.get)]
        if serving is not None:
            jobs.append(pool.submit(serving.build_kernels))
    try:
        for job in jobs:
            job.result()
    except Exception as e:              # reported by every shard's start
        log.warning("shard group: building before the fork failed (%s); "
                    "each shard builds at its warm-up", e)


class _ShardState:
    __slots__ = ("index", "pid", "state", "restarts", "consecutive",
                 "restart_at", "started_at", "hb_sig", "hb_seen", "ready_s")

    def __init__(self, index: int):
        self.index = index
        self.pid = 0
        self.state = "starting"        # starting|running|restarting
        self.restarts = 0              # over the group's life
        self.consecutive = 0           # crashes since the last healthy run
        self.restart_at = 0.0          # monotonic time of the next fork
        self.started_at = 0.0
        self.hb_sig = None             # the dump's last mtime_ns seen
        self.hb_seen = 0.0             # monotonic time hb_sig last moved
        self.ready_s = None            # fork to first dump, this run

    def to_dict(self) -> dict:
        return {"index": self.index, "pid": self.pid, "state": self.state,
                "restarts": self.restarts, "ready_s": self.ready_s,
                "uptime_s": round(time.monotonic() - self.started_at, 1)
                if self.started_at else 0.0}


class ShardGroup:
    """The supervisor of a reuseport shard group (module note)."""

    # a shard healthy this long resets its crash streak
    _HEALTHY_AFTER_S = 5.0

    def __init__(self, server, address,
                 options: Optional[ShardGroupOptions] = None):
        self.server = server
        self.options = options or ShardGroupOptions()
        ep = address if isinstance(address, EndPoint) \
            else str2endpoint(address)
        if ep.scheme != "tcp":
            raise ValueError(
                f"shard groups need SO_REUSEPORT, a tcp:// kernel "
                f"feature; got {ep.scheme}://")
        if self.options.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self._requested_ep = ep
        self._endpoint: Optional[EndPoint] = None
        self._placeholder: Optional[pysocket.socket] = None
        self._shards: List[_ShardState] = [
            _ShardState(i) for i in range(self.options.num_shards)]
        self._lock = threading.Lock()
        self._stopping = False
        self._stopped = False
        self._monitor: Optional[threading.Thread] = None
        self._admin_server = None
        self._admin_endpoint: Optional[EndPoint] = None
        self._rng = random.Random(self.options.seed)
        self._capture_ctl_seq = 0
        self._failed: Optional[str] = None
        self.shard_dir = self.options.shard_dir
        self.aggregator: Optional[ShardAggregator] = None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> EndPoint:
        """Bind the port, fork the shards, start the monitor and the
        admin server; the data plane's endpoint."""
        _refuse_cuda_before_fork()
        _build_before_fork(self.server)
        ep = self._requested_ep
        # the placeholder holds the port for the group's life and never
        # listens, so the kernel balances over the shards' listeners
        # only; a restarted shard binds the same port through it even
        # when every shard is down
        sock = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_STREAM)
        sock.setsockopt(pysocket.SOL_SOCKET, pysocket.SO_REUSEADDR, 1)
        sock.setsockopt(pysocket.SOL_SOCKET, pysocket.SO_REUSEPORT, 1)
        sock.bind((ep.host or "127.0.0.1", ep.port))
        host, port = sock.getsockname()[:2]
        self._placeholder = sock
        self._endpoint = EndPoint("tcp", host, port, ())
        if self.shard_dir is None:
            self.shard_dir = tempfile.mkdtemp(prefix="brpc-tpu-torch-shards-")
        else:
            os.makedirs(self.shard_dir, exist_ok=True)
        self.aggregator = ShardAggregator(self.shard_dir,
                                          self.options.num_shards)
        self.aggregator.group = self
        try:
            for st in self._shards:
                self._fork_shard(st)
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             name="shard_supervisor",
                                             daemon=True)
            self._monitor.start()
            if self.options.enable_admin:
                self._start_admin()
        except BaseException:
            # no live shard may serve a port whose start failed
            self.stop()
            raise
        return self._endpoint

    def _start_admin(self) -> None:
        from brpc_tpu_torch.rpc.server import Server, ServerOptions
        admin = Server(ServerOptions(enable_builtin_services=True))
        admin.shard_aggregator = self.aggregator
        addr = self.options.admin_address or \
            f"tcp://{self._endpoint.host}:0"
        self._admin_endpoint = admin.start(addr)
        self._admin_server = admin

    @property
    def endpoint(self) -> Optional[EndPoint]:
        return self._endpoint

    @property
    def admin_endpoint(self) -> Optional[EndPoint]:
        return self._admin_endpoint

    def shard_pids(self) -> List[int]:
        with self._lock:
            return [st.pid for st in self._shards if st.state == "running"]

    def write_capture_control(self, action: str, params: dict) -> int:
        """The supervisor's capture control: a sequenced control file in
        the shard directory, which every shard reads at its next dump
        tick. The new sequence number."""
        if action not in ("start", "stop"):
            raise ValueError(f"unknown capture action {action!r}")
        with self._lock:
            self._capture_ctl_seq += 1
            seq = self._capture_ctl_seq
        doc = {"seq": seq, "action": action}
        if action == "start":
            # one directory: the per-pid file names keep shards apart
            doc["dir"] = params.get("dir") or \
                os.path.join(self.shard_dir, "capture")
            for k in ("rate", "max_per_second", "rotate_mb",
                      "disk_budget_mb"):
                if params.get(k) not in (None, ""):
                    doc[k] = params[k]
        path = os.path.join(self.shard_dir, "capture-control.json")
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return seq

    @property
    def failed(self) -> Optional[str]:
        """Why the group stopped serving by itself, or None."""
        with self._lock:
            return self._failed

    def group_status(self) -> dict:
        with self._lock:
            return {"stopping": self._stopping, "failed": self._failed,
                    "admin": str(self._admin_endpoint)
                    if self._admin_endpoint else None,
                    "shard_dir": self.shard_dir,
                    "shards": [st.to_dict() for st in self._shards]}

    def stop(self) -> None:
        """Drain: SIGTERM every shard (each closes its listener, finishes
        its calls, writes a last dump and exits); SIGKILL what is left
        past the drain budget."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = self._stopping = True
            pids = [st.pid for st in self._shards if st.pid > 0]
        self._drain(pids)
        if self._admin_server is not None:
            try:
                self._admin_server.stop()
                self._admin_server.join(1.0)
            except Exception:
                pass
        self._close_placeholder()

    def _drain(self, pids: List[int]) -> None:
        """SIGTERM ``pids``, reap them, SIGKILL what outlives the drain
        budget."""
        for pid in pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + self.options.drain_timeout_s + 2.0
        live = set(pids)
        # parked on an Event, as the monitor's tick is: the flight
        # recorder counts the supervisor as waiting, not busy
        park = threading.Event()
        while live and time.monotonic() < deadline:
            for pid in list(live):
                try:
                    done, _ = os.waitpid(pid, os.WNOHANG)
                    if done:
                        live.discard(pid)
                except OSError:
                    live.discard(pid)
            if live:
                park.wait(0.02)
        for pid in live:
            try:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            except OSError:
                pass

    def _close_placeholder(self) -> None:
        if self._placeholder is not None:
            try:
                self._placeholder.close()
            except OSError:
                pass

    def _fail(self, st: "_ShardState", reason: str) -> None:
        """A shard exit that no restart can mend: stop every shard and
        release the port; the admin pages stay up until ``stop`` and
        ``/shards`` carries ``reason``."""
        log.error("shard group failed: %s", reason)
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            self._failed = reason
            st.state = "failed"
            st.pid = 0
            pids = [s.pid for s in self._shards if s.pid > 0]
        self._drain(pids)
        with self._lock:
            for s in self._shards:
                if s.pid in pids:
                    s.pid = 0
                    s.state = "stopped"
        self._close_placeholder()

    def join(self, timeout_s: float = 10.0) -> None:
        t = self._monitor
        if t is not None:
            t.join(timeout_s)

    # ------------------------------------------------------------ forking
    def _dump_mtime(self, index: int) -> Optional[int]:
        try:
            return os.stat(os.path.join(
                self.shard_dir, f"shard-{index}.json")).st_mtime_ns
        except OSError:
            return None

    def _fork_shard(self, st: _ShardState) -> None:
        # a restarted shard's predecessor left a dump: only a newer one
        # is this shard's heartbeat
        last_dump = self._dump_mtime(st.index)
        # a stop's SIGTERM can reach the child before it installs its
        # drain handler; held blocked across the fork, it waits for the
        # handler instead of running this process's copy in the child
        mask = signal.pthread_sigmask(signal.SIG_BLOCK,
                                      (signal.SIGTERM, signal.SIGINT))
        try:
            pid = os.fork()
        except BaseException:
            signal.pthread_sigmask(signal.SIG_SETMASK, mask)
            raise
        if pid == 0:
            # the child never returns: the postfork registry ran inside
            # fork(), so every singleton rebuilds privately here
            code = 1
            try:
                self._child_main(st.index, mask)
            except BaseException as e:
                if isinstance(e, CudaBadForkError):
                    code = EXIT_CUDA_BAD_FORK
                try:
                    traceback.print_exc(file=sys.stderr)
                    sys.stderr.flush()
                except Exception:
                    pass
            finally:
                os._exit(code)
        signal.pthread_sigmask(signal.SIG_SETMASK, mask)
        with self._lock:
            st.pid = pid
            st.state = "running"
            st.started_at = time.monotonic()
            st.hb_sig = last_dump
            st.hb_seen = st.started_at
            st.ready_s = None
            stopping = self._stopping
        if stopping:
            # a restart raced stop(): its SIGTERM sweep never reached this
            # child and nobody else would reap it (brpc_tpu/rpc/
            # shard_group.py:791-806); it has nothing to drain
            try:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            except OSError:
                pass

    def _backoff_s(self, st: _ShardState) -> float:
        base = min(self.options.restart_backoff_max_s,
                   self.options.restart_backoff_s
                   * (2 ** max(0, st.consecutive - 1)))
        # jitter: shards felled by one cause must not restart in step
        return base * (1.0 + self.options.restart_jitter
                       * self._rng.random())

    # ------------------------------------------------------------ monitor
    def _monitor_loop(self) -> None:
        hb = self.options.heartbeat_timeout_s
        # parked on an Event, so the flight recorder counts it as waiting
        park = threading.Event()
        while True:
            with self._lock:
                if self._stopping:
                    return
                shards = list(self._shards)
            now = time.monotonic()
            for st in shards:
                if st.state == "running":
                    crashed = False
                    code = None
                    try:
                        done, status = os.waitpid(st.pid, os.WNOHANG)
                        crashed = bool(done)
                        if done:
                            code = os.waitstatus_to_exitcode(status)
                    except ChildProcessError:
                        crashed = True
                    except OSError:
                        pass
                    if code == EXIT_CUDA_BAD_FORK:
                        self._fail(st, (
                            f"shard {st.index} (pid {st.pid}) cannot "
                            f"initialise CUDA: this process made a CUDA "
                            f"call before the fork, and a restart would "
                            f"fork from it again"))
                        return
                    if not crashed and hb > 0 and self.aggregator:
                        # on the monitor's monotonic clock: a dump whose
                        # mtime moved is a heartbeat; comparing wall-clock
                        # ages would kill every shard after a clock step
                        sig = self._dump_mtime(st.index)
                        if sig is not None and sig != st.hb_sig:
                            if st.ready_s is None:
                                st.ready_s = round(now - st.started_at, 3)
                            st.hb_sig = sig
                            st.hb_seen = now
                        elif now - st.hb_seen > hb \
                                and now - st.started_at > hb:
                            # alive and not dumping: hung; reaped at the
                            # next tick like a crash
                            try:
                                os.kill(st.pid, signal.SIGKILL)
                            except OSError:
                                pass
                    if crashed:
                        with self._lock:
                            if self._stopping:
                                return
                            if now - st.started_at > self._HEALTHY_AFTER_S:
                                st.consecutive = 0
                            st.consecutive += 1
                            st.restarts += 1
                            st.state = "restarting"
                            # reaped: the pid may be recycled, and stop()
                            # must never signal its new owner
                            st.pid = 0
                            st.restart_at = now + self._backoff_s(st)
                elif st.state == "restarting" and now >= st.restart_at:
                    self._fork_shard(st)
            park.wait(0.05)

    # -------------------------------------------------------------- child
    def _child_main(self, index: int, mask) -> None:
        """A shard's body: its own serving stack, the shared port with
        SO_REUSEPORT, the dump as heartbeat, a drain on SIGTERM.
        ``mask``: the signal mask to restore once the handlers are in."""
        # close this process's copies of the supervisor's listening fds,
        # so that no shard holds the admin port or the placeholder open
        admin = self._admin_server
        admin_sock = getattr(getattr(admin, "_listener", None), "_sock",
                             None) if admin is not None else None
        for obj in (self._placeholder, admin_sock):
            try:
                if obj is not None:
                    obj.close()
            except OSError:
                pass
        stop_ev = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop_ev.set())
        signal.signal(signal.SIGINT, lambda *_: stop_ev.set())
        signal.pthread_sigmask(signal.SIG_SETMASK, mask)

        server = self.server
        serving = getattr(server, "_serving", None)
        device = getattr(serving, "device", None)
        torch = sys.modules.get("torch")
        if device is not None and device.type == "cuda" and torch is not None \
                and torch.cuda._is_in_bad_fork():
            raise CudaBadForkError(
                f"shard {index}: the supervisor made a CUDA call before "
                f"the fork, so this shard cannot initialise CUDA for "
                f"{device}; no CPU fallback")
        server._postfork_child_reset()
        server.shard_index = index
        from brpc_tpu_torch.bvar.reducer import Adder, PassiveStatus
        PassiveStatus(lambda: index).expose("shard_index")
        # what the dump loop costs this shard: the dumps written, and the
        # CPU and wall time they took on its main thread (the dump holds
        # the interpreter lock while it gathers and encodes its state)
        dumps, dump_cpu_us, dump_wall_us = Adder(), Adder(), Adder()
        dumps.expose("shard_dumps")
        dump_cpu_us.expose("shard_dump_cpu_us")
        dump_wall_us.expose("shard_dump_wall_us")
        ep = EndPoint("tcp", self._endpoint.host, self._endpoint.port,
                      (("reuse_port", "1"),))
        server.start(ep)
        # the drain path, not a handler server.start may have set
        signal.signal(signal.SIGTERM, lambda *_: stop_ev.set())

        parent = os.getppid()
        seq = 0
        ctl_seen = 0
        interval = max(0.05, self.options.dump_interval_s)
        while not stop_ev.is_set():
            seq += 1
            cpu0, wall0 = time.thread_time_ns(), time.perf_counter_ns()
            try:
                write_shard_dump(self.shard_dir, index, server, seq)
            except OSError:
                pass   # a disk hiccup: serving must not die for a dump
            ctl_seen = _apply_capture_control(self.shard_dir, ctl_seen)
            dumps << 1
            dump_cpu_us << (time.thread_time_ns() - cpu0) // 1000
            dump_wall_us << (time.perf_counter_ns() - wall0) // 1000
            if os.getppid() != parent:
                break  # the supervisor died without SIGTERM: orphan exit
            stop_ev.wait(interval)

        # close the listener first (the kernel takes this shard out of
        # the group; new connections go to its siblings), then let the
        # calls in flight finish under their deadlines
        server.stop()
        server.join(self.options.drain_timeout_s)
        try:
            write_shard_dump(self.shard_dir, index, server, seq + 1)
        except OSError:
            pass
        from brpc_tpu_torch.rpc.span import global_store
        global_store.flush()
        os._exit(0)
