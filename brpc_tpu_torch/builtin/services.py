"""Builtin observability services (the port of
brpc_tpu/builtin/services.py; brpc/builtin/*, server.cpp:468-540).

One function per page, shared by the ``builtin`` tpu_std service that
``add_builtin_services`` registers and the HTTP pages of
``protocol/http.py``, so the two views cannot diverge.

The port keeps the entries whose source it has: ``/timeline``,
``/census``, ``/capture`` and ``/incidents`` (with their tpu_std twins),
and on ``/status`` the incident line and the IOBuf pool's gauges. Left
out, until their modules are ported (ROADMAP section 1): on ``/status``
the trend-ring links (``saturation_timeline``) and the input-batching
and write-coalescing gauges; on ``/connections`` the client channels'
rows, the chaos counters, and the read-side bytes and idle class of
each row.
"""

from __future__ import annotations

import json

from brpc_tpu_torch.bvar.prometheus import dump_prometheus
from brpc_tpu_torch.bvar.variable import dump_exposed
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.rpc.service import Service


# the overload and retry counters of the robustness pane
ROBUSTNESS_VARS = ("server_deadline_shed", "server_limit_shed",
                   "server_priority_shed", "client_priority_shed",
                   "retry_suppressed_budget", "retry_throttled",
                   "hedge_suppressed_budget", "naming_empty")


def connections_page(server) -> dict:
    """The server's open connections (Sockets): peer, state and the
    bytes queued for the kernel; the circuit breakers of every cluster
    channel of the process, by endpoint; and the robustness pane, the
    shed and retry counters."""
    from brpc_tpu_torch.rpc.circuit_breaker import all_breaker_snapshots
    rows = []
    for c in server.connections():
        ep = c.remote_endpoint
        rows.append({
            "role": "server",
            "remote": f"{ep.host}:{ep.port}",
            "failed": c.failed,
            "wqueue_bytes": c.write_backlog(),
        })
    robustness = {}
    for name in ROBUSTNESS_VARS:
        robustness.update(dump_exposed(name))
    return {"connections": rows, "breakers": all_breaker_snapshots(),
            "robustness": robustness}


def census_page_payload(server=None) -> dict:
    """The /census payload: bytes and objects by subsystem (the
    providers of ``butil/resource_census.py``) and the connections'
    roll-up from the sockets provider's one walk."""
    from brpc_tpu_torch.butil.resource_census import census_page
    out = census_page()
    sub = out["subsystems"].get("sockets", {})
    count = sub.get("count", 0) or 0
    total = sub.get("bytes", 0) or 0
    out["connections"] = {
        "count": count,
        "resident_bytes": total,
        # the port's sockets keep no activity stamp (ROADMAP section 1)
        "idle": sub.get("idle"),
        "avg_bytes": round(total / count, 1) if count else 0.0,
    }
    return out


def capture_page_payload(server=None) -> dict:
    """The /capture payload: the recorder's state, counters, rotation and
    disk-budget effects, and the corpus files ready to download."""
    from brpc_tpu_torch.traffic.capture import global_recorder
    return global_recorder().snapshot()


def capture_control(action: str, params: dict) -> dict:
    """Start or stop the recorder from a page action; ValueError on a bad
    action or no directory (the callers answer 400 or EREQUEST)."""
    from brpc_tpu_torch.traffic.capture import start_capture, stop_capture
    if action == "stop":
        return stop_capture()
    if action != "start":
        raise ValueError(f"unknown capture action {action!r}")
    kw = {}
    if params.get("rate") not in (None, ""):
        kw["default_rate"] = float(params["rate"])
    if params.get("max_per_second") not in (None, ""):
        kw["max_per_second"] = int(params["max_per_second"])
    if params.get("rotate_mb") not in (None, ""):
        kw["rotate_bytes"] = int(params["rotate_mb"]) << 20
    if params.get("disk_budget_mb") not in (None, ""):
        kw["disk_budget_bytes"] = int(params["disk_budget_mb"]) << 20
    return start_capture(dir=params.get("dir") or None, **kw)


def capture_download_bytes(paths=None) -> bytes:
    """Every corpus file of the capture directory merged, in arrival
    order, into one .brpccap byte string."""
    import os
    import tempfile

    from brpc_tpu_torch.traffic.capture import global_recorder
    from brpc_tpu_torch.traffic.corpus import merge_corpora
    if paths is None:
        paths = global_recorder().corpus_paths()
    if not paths:
        return b""
    if len(paths) == 1:
        with open(paths[0], "rb") as f:
            return f.read()
    fd, tmp = tempfile.mkstemp(suffix=".brpccap")
    os.close(fd)
    try:
        merge_corpora(paths, tmp)
        with open(tmp, "rb") as f:
            return f.read()
    finally:
        for p in (tmp, tmp + ".idx"):
            try:
                os.remove(p)
            except OSError:
                pass


def timeline_page_payload(server=None, names=None, prefix: str = "",
                          max_vars=None) -> dict:
    """The /timeline payload: the trend rings of every tracked variable
    (``bvar/series.py``), the watchdog's incidents and its keys."""
    import time

    from brpc_tpu_torch.bvar.anomaly import global_watchdog
    from brpc_tpu_torch.bvar.series import (HOUR_BUCKETS, MIN_BUCKETS,
                                            SEC_BUCKETS, global_series,
                                            series_enabled)
    wd = global_watchdog()
    return {
        "enabled": series_enabled(),
        "now": time.time(),
        "resolution": {"sec": SEC_BUCKETS, "min": MIN_BUCKETS,
                       "hr": HOUR_BUCKETS},
        "series": global_series().dump_series(names=names, prefix=prefix,
                                              max_vars=max_vars),
        "incidents": wd.incident_snapshot(),
        "watch_keys": wd.tracked_keys(),
    }


def incidents_page_payload(server=None) -> dict:
    """The /incidents payload: the capture-on-anomaly state, the artifact
    ledger and the disk budget's accounting."""
    from brpc_tpu_torch.incident.manager import incidents_snapshot_payload
    return incidents_snapshot_payload(server)


def status_page(server) -> dict:
    """The /status payload: server state, per-method latency windows
    (qps and p50/p90/p99/max, "which method is slow" without scraping
    /vars), and the saturation pane naming why it is slow: workers'
    busy share, run-queue depth, bytes queued on the connections and
    calls in flight, and the overload pane: the limiter's limit, the
    shed counters, the admission threshold and the process's most
    drained retry budget (brpc_tpu/builtin/services.py:228)."""
    from brpc_tpu_torch.butil.iobuf import pool as iobuf_pool
    from brpc_tpu_torch.incident.manager import incident_status_line
    from brpc_tpu_torch.rpc.retry_policy import min_retry_tokens
    from brpc_tpu_torch.rpc.server_dispatch import (nlimit_shed,
                                                    npriority_shed, nshed)
    saturation = server.control.saturation_pane()
    saturation["socket_wqueue_bytes"] = sum(
        c.write_backlog() for c in server.connections())
    # are blocks recycling (a hit ratio near 1 once warm)
    saturation["iobuf_pool_hit_ratio"] = round(iobuf_pool.hit_ratio(), 4)
    saturation["iobuf_pool_bytes"] = iobuf_pool.cached_bytes()
    saturation["concurrency_limit"] = server.concurrency_limit()
    saturation["inflight"] = server.concurrency
    saturation["limit_shed"] = nlimit_shed.get_value()
    saturation["deadline_shed"] = nshed.get_value()
    saturation["priority_shed"] = npriority_shed.get_value()
    if server._admission is not None:
        saturation["admission_threshold"] = \
            server._admission.wire_threshold()
    tokens = min_retry_tokens()
    if tokens is not None:
        saturation["retry_tokens"] = tokens
    return {
        "running": server.is_running,
        "endpoint": str(server.endpoint) if server.endpoint else None,
        # capture on anomaly: open window, artifacts, bytes on disk
        "incidents": incident_status_line(),
        "concurrency": server.concurrency,
        "processed": server.nprocessed,
        "errors": server.nerror,
        "services": {n: sorted(s.methods)
                     for n, s in server.services().items()},
        "method_status": {k: lr.get_value()
                          for k, lr in server.method_status.items()},
        "saturation": saturation,
    }


def version_page(server) -> dict:
    """The /version payload: the port's and torch's versions and the
    serving lane's device (the reference reports jax's version)."""
    import torch

    from brpc_tpu_torch import __version__
    out = {"brpc_tpu_torch": __version__, "torch": torch.__version__,
           "cuda": torch.version.cuda, "server": "brpc-tpu"}
    gs = getattr(server, "_serving", None)
    dev = getattr(gs, "device", None)
    if dev is not None:
        out["device"] = str(dev)
        out["device_name"] = (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu")
    return out


def add_builtin_services(server) -> None:
    """Register the ``builtin`` service: the pages over tpu_std."""
    builtin = Service("builtin")

    @builtin.method()
    def health(cntl, request):
        return b"OK"

    @builtin.method()
    def status(cntl, request):
        return json.dumps(status_page(server), default=str).encode()

    @builtin.method()
    def vars(cntl, request):
        prefix = bytes(request).decode() if request else ""
        return json.dumps(dict(dump_exposed(prefix)), default=str).encode()

    @builtin.method()
    def prometheus_metrics(cntl, request):
        return dump_prometheus().encode()

    @builtin.method()
    def connections(cntl, request):
        return json.dumps(connections_page(server), default=str).encode()

    @builtin.method()
    def device(cntl, request):
        # the device lanes' cells, conns, recv pool and leaks: the twin
        # of HTTP /device, from the same function
        from brpc_tpu_torch.transport.device_stats import (
            device_page_payload)
        return json.dumps(device_page_payload(server),
                          default=str).encode()

    @builtin.method()
    def backends(cntl, request):
        # this process's client channels: the twin of HTTP /backends
        from brpc_tpu_torch.rpc.backend_stats import backends_page_payload
        return json.dumps(backends_page_payload(), default=str).encode()

    @builtin.method()
    def lb_trace(cntl, request):
        # the request names the channel (empty: the directory)
        from brpc_tpu_torch.rpc.backend_stats import lb_trace_payload
        name = bytes(request).decode() if request else ""
        payload = lb_trace_payload(name or None)
        if payload is None:
            cntl.set_failed(berr.EREQUEST, f"no such channel {name!r}")
            return b""
        return json.dumps(payload, default=str).encode()

    @builtin.method()
    def census(cntl, request):
        return json.dumps(census_page_payload(server), default=str).encode()

    @builtin.method()
    def timeline(cntl, request):
        # the request names a prefix (empty: every series)
        prefix = bytes(request).decode().strip() if request else ""
        return json.dumps(timeline_page_payload(server, prefix=prefix),
                          default=str).encode()

    @builtin.method()
    def capture(cntl, request):
        # "" for the state, "stop", or "start <dir>" (the dir may be left
        # out when the capture_dir flag is set); downloads stay on HTTP
        arg = bytes(request).decode().strip() if request else ""
        if arg:
            verb, _, dirpart = arg.partition(" ")
            try:
                return json.dumps(
                    capture_control(verb, {"dir": dirpart.strip()}),
                    default=str).encode()
            except (ValueError, OSError) as e:
                cntl.set_failed(berr.EREQUEST, str(e))
                return b""
        return json.dumps(capture_page_payload(server),
                          default=str).encode()

    @builtin.method()
    def incidents(cntl, request):
        return json.dumps(incidents_page_payload(server),
                          default=str).encode()

    @builtin.method()
    def serving(cntl, request):
        # imported here: the serving lane imports torch, the RPC layer not
        from brpc_tpu_torch.serving.service import serving_page_payload
        return json.dumps(serving_page_payload(server),
                          default=str).encode()

    server.add_service(builtin)
