"""Builtin observability services (the port of
brpc_tpu/builtin/services.py; brpc/builtin/*, server.cpp:468-540).

One function per page, shared by the ``builtin`` tpu_std service that
``add_builtin_services`` registers and the HTTP pages of
``protocol/http.py``, so the two views cannot diverge.

The port keeps the entries whose source it has. Left out, until their
modules are ported (ROADMAP section 1): on ``/status`` the incident
line, the trend-ring links (``saturation_timeline``) and, in the
saturation pane, the IOBuf pool, input-batching and write-coalescing
gauges; on ``/connections`` the client channels' rows, the chaos
counters, and the read-side bytes and idle class of each row.
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


def status_page(server) -> dict:
    """The /status payload: server state, per-method latency windows
    (qps and p50/p90/p99/max, "which method is slow" without scraping
    /vars), and the saturation pane naming why it is slow: workers'
    busy share, run-queue depth, bytes queued on the connections and
    calls in flight, and the overload pane: the limiter's limit, the
    shed counters, the admission threshold and the process's most
    drained retry budget (brpc_tpu/builtin/services.py:228)."""
    from brpc_tpu_torch.rpc.retry_policy import min_retry_tokens
    from brpc_tpu_torch.rpc.server_dispatch import (nlimit_shed,
                                                    npriority_shed, nshed)
    saturation = server.control.saturation_pane()
    saturation["socket_wqueue_bytes"] = sum(
        c.write_backlog() for c in server.connections())
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
    def serving(cntl, request):
        # imported here: the serving lane imports torch, the RPC layer not
        from brpc_tpu_torch.serving.service import serving_page_payload
        return json.dumps(serving_page_payload(server),
                          default=str).encode()

    server.add_service(builtin)
