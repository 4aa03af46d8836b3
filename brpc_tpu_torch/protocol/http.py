"""HTTP/1.1 request heads and responses for the server's HTTP path (the
subset of brpc_tpu/protocol/http.py that ``POST /<Service>/<Method>``
and the builtin pages need: a ``Content-Length`` body, a query string,
keep-alive, and plain or chunked responses).

``HttpProtocol`` (brpc_tpu/protocol/http.py:142-209) is this format's
entry in the protocol registry: ``parse`` claims bytes that start a
request line of a known method (``is_request_start``), cuts the head at
the blank line and the body by its ``Content-Length``, and ``parse_head``
reads the head. A head that cannot be read disclaims the bytes, and the
InputMessenger drops the connection. ``process_inline`` queues each
request behind the earlier ones of its connection
(``process_in_parse_order``): HTTP/1.1 answers in request order.

``builtin_page`` answers the builtin pages (brpc_tpu/protocol/http.py:
281-588) before the server dispatches ``/<Service>/<Method>``: ``/``,
``/health``, ``/status``, ``/vars`` (``/vars/<prefix>``, ``?prefix=``),
``/brpc_metrics`` and ``/metrics``, ``/flags`` (``POST
/flags/<name>?setvalue=``), ``/connections``, ``/serving``, ``/rpcz``
(``?trace_id=``, ``?n=``, ``?history=1``), ``/device`` (the device
lanes' cells, conns, recv pool and leaks), ``/backends`` (the client
channels' backend cells), ``/lb_trace`` (``?channel=``, ``?n=``: a
channel's load-balancing decisions), ``/contentions``, ``/version``;
``/vars?series=<name>`` and the sparklines on ``/vars``, ``/timeline``
(``?name=``, ``?prefix=``), ``/hotspots`` and ``/pprof/profile``
(on-demand, ``?mode=continuous``, ``diff=1``, ``?type=heap|growth``),
``/fibers`` and ``/bthreads`` (``?stacks=1``), ``/threads``, ``/census``,
``/capture`` (``?action=start|stop|download``), ``/incidents``
(``?action=download&path=``), ``/vlog``, ``/sockets`` (the server's
sockets in detail) and ``/ids`` (the client calls in flight). ``/health``
asks ``ServerOptions.health_reporter`` when there is one.
``/protobufs`` lists every method's request and response types, which
in the port are ``bytes`` on every side (it has no message classes).

A shard group supervisor's admin server (a Server with a
``shard_aggregator``, ``rpc/shard_group.py``) answers ``/status``,
``/vars``, the Prometheus dump, ``/serving``, ``/device``,
``/timeline``, ``/hotspots?mode=continuous``, ``/capture``,
``/incidents`` and ``/census`` with the shards' merged view, one
shard's with ``?shard=i``, and ``/shards`` with the group's state
(brpc_tpu/protocol/http.py:83-97, :298-360, :423-430).

The native parse (brpc_tpu/protocol/http.py:41-160): with fastcore
loaded, one C pass (``http_parse_request``, httpparse.cc) finds the
head's end, splits the request line and builds the lowercased header
dict; it answers exactly what ``parse_head`` would or defers (-2) to it,
so the two lanes cannot differ. ``nnative_heads`` counts the requests
whose head it read.
"""

from __future__ import annotations

import json
import urllib.parse
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol, register_protocol)

METHODS = (b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ", b"OPTIONS ",
           b"PATCH ")
# the longest method token: a shorter prefix no protocol claims may
# still become a request line
PROBE_BYTES = max(len(m) for m in METHODS)
MAX_HEADER = 64 * 1024
MAX_BODY = 64 << 20

_REASONS = {200: "OK", 400: "Bad Request", 403: "Forbidden",
            404: "Not Found", 405: "Method Not Allowed",
            500: "Internal Server Error"}


class HttpError(ValueError):
    """A request the server cannot read: the connection is dropped."""


@dataclass
class HttpRequest:
    method: str
    path: str
    headers: Dict[str, str] = field(default_factory=dict)
    content_length: int = 0
    keep_alive: bool = True
    body: bytes = b""
    query: Dict[str, str] = field(default_factory=dict)


def is_request_start(head: bytes) -> bool:
    """Whether ``head``, a connection's first bytes, begins (or may yet
    begin) a request line of one of the known methods."""
    return any(m.startswith(head) if len(head) < len(m) else
               head.startswith(m) for m in METHODS)


def parse_head(raw: bytes) -> HttpRequest:
    """The request line and headers, without the blank line after them."""
    lines = raw.split(b"\r\n")
    try:
        method, target, _version = lines[0].decode("latin1").split(" ", 2)
    except ValueError:
        raise HttpError(f"bad request line {lines[0][:80]!r}") from None
    headers = {}
    for line in lines[1:]:
        k, _, v = line.decode("latin1").partition(":")
        headers[k.strip().lower()] = v.strip()
    if "transfer-encoding" in headers:
        raise HttpError("chunked request bodies are not supported")
    try:
        n = int(headers.get("content-length", "0") or "0")
    except ValueError:
        raise HttpError("bad Content-Length") from None
    if n < 0 or n > MAX_BODY:
        raise HttpError(f"Content-Length {n} out of range")
    split = urllib.parse.urlsplit(target)
    return HttpRequest(
        method=method.upper(), path=split.path,
        headers=headers, content_length=n,
        keep_alive=headers.get("connection", "keep-alive").lower()
        != "close",
        query=dict(urllib.parse.parse_qsl(split.query)))


def response(status: int, body: bytes, content_type: str = "text/plain",
             keep_alive: bool = True) -> bytes:
    head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            f"\r\n").encode()
    return head + body


def chunked_head(content_type: str, keep_alive: bool = True) -> bytes:
    """Headers of a 200 whose body follows as chunks."""
    return (f"HTTP/1.1 200 OK\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Transfer-Encoding: chunked\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            f"\r\n").encode()


def chunk(data: bytes) -> bytes:
    return b"%x\r\n%s\r\n" % (len(data), data)


LAST_CHUNK = b"0\r\n\r\n"


_fc = False             # the extension, resolved at the first head


def _fastcore():
    global _fc
    if _fc is False:
        from brpc_tpu_torch.native import fastcore
        _fc = fastcore.get()
    return _fc


# request heads the native parse read
nnative_heads = Adder().expose("http_native_heads")


def native_parse_head(raw: bytes):
    """``(head_len, HttpRequest)`` from fastcore's parse of ``raw`` (the
    portal's first bytes, the body's not yet cut), ``None`` for more
    bytes, ``"defer"`` when only ``parse_head`` can judge them (or no
    extension), or raises HttpError where ``parse_head`` would."""
    fc = _fastcore()
    if fc is None:
        return "defer"
    r = fc.http_parse_request(raw, MAX_HEADER, MAX_BODY)
    if r is None:
        return None
    if r == -2:
        return "defer"
    if not isinstance(r, tuple):
        raise HttpError("unreadable request head")
    head_len, method, target, n, keep_alive, headers = r
    if "transfer-encoding" in headers:
        raise HttpError("chunked request bodies are not supported")
    split = urllib.parse.urlsplit(target)
    return head_len, HttpRequest(
        method=method.upper(), path=split.path, headers=headers,
        content_length=n, keep_alive=bool(keep_alive),
        query=dict(urllib.parse.parse_qsl(split.query)))


class HttpProtocol(Protocol):
    name = "http"
    min_probe_bytes = PROBE_BYTES

    def parse(self, portal, socket):
        if not is_request_start(portal.peek_bytes(PROBE_BYTES)):
            return PARSE_TRY_OTHERS, None
        raw = portal.peek_bytes(MAX_HEADER)
        try:
            got = native_parse_head(raw)
        except HttpError:
            return PARSE_TRY_OTHERS, None       # unreadable: drop
        if got is None:
            return PARSE_NOT_ENOUGH_DATA, None
        native = got != "defer"
        if not native:
            sep = raw.find(b"\r\n\r\n")
            if sep < 0:
                if portal.size >= MAX_HEADER:
                    return PARSE_TRY_OTHERS, None   # header flood: drop
                return PARSE_NOT_ENOUGH_DATA, None
            try:
                got = sep + 4, parse_head(raw[:sep])
            except HttpError:
                return PARSE_TRY_OTHERS, None       # unreadable: drop
        head_len, req = got
        if portal.size < head_len + req.content_length:
            return PARSE_NOT_ENOUGH_DATA, None
        if native:
            nnative_heads.add(1)
        portal.pop_front(head_len)
        req.body = portal.cut(req.content_length).to_bytes()
        return PARSE_OK, req

    def process_inline(self, req: HttpRequest, socket) -> bool:
        """Requests of one connection are served one at a time, in order,
        by one fiber (a chunked response holds it until its end)."""
        from brpc_tpu_torch.transport.input_messenger import (
            process_in_parse_order)
        process_in_parse_order(socket, "http", req, self.process)
        return True

    async def process(self, req: HttpRequest, socket) -> None:
        server = socket.user_data.get("server")
        if server is None:
            socket.set_failed(ConnectionError("no server bound to socket"))
            return
        await server._serve_http(socket, req)


_instance: Optional[HttpProtocol] = None


def ensure_registered() -> HttpProtocol:
    global _instance
    if _instance is None:
        _instance = HttpProtocol()
        register_protocol(_instance)
    return _instance


# ---------------------------------------------------------- builtin pages

Page = Tuple[int, str, bytes]


def _query_flag(req: HttpRequest, name: str) -> bool:
    """A boolean query parameter: ?x=1 / ?x=true are on."""
    v = req.query.get(name)
    return v is not None and v.lower() in ("1", "true", "yes")


def _trace_id_candidates(tid: str) -> set:
    """Both readings of a trace id: spans print ids as 016x hex, and
    logs often carry decimal, so /rpcz matches either reading."""
    out = set()
    try:
        out.add(int(tid, 16))
    except ValueError:
        pass
    if tid.isdigit():
        out.add(int(tid, 10))
    return out


def _json(doc) -> Page:
    return 200, "application/json", json.dumps(doc, default=str).encode()


def _shard_param(agg, req: HttpRequest):
    """``?shard=i`` against the aggregator: (index or None, error page or
    None). No index means the merged view; a malformed or out-of-range
    value is the client's error, never a fallback to the merged view."""
    raw = req.query.get("shard")
    if raw is None:
        return None, None
    try:
        i = int(raw)
    except ValueError:
        return None, (400, "text/plain", f"bad shard {raw!r}".encode())
    if not 0 <= i < agg.num_shards:
        return None, (400, "text/plain",
                      f"shard {i} out of range 0.."
                      f"{agg.num_shards - 1}".encode())
    return i, None


def _shard_page(agg, req: HttpRequest, key: str, merged, what: str):
    """A supervisor's page: one shard's dump section ``key`` with
    ``?shard=i`` (404 while it has none), else ``merged()``."""
    shard, err = _shard_param(agg, req)
    if err is not None:
        return err
    if shard is None:
        return _json(merged())
    dump = agg.shard_dump(shard)
    if dump is None or not dump.get(key):
        return 404, "text/plain", f"no {what} for shard {shard}".encode()
    return _json(dump[key])


def _supervisor_page(agg, req: HttpRequest, path: str):
    """The merged pages of a shard group supervisor, or None for a page
    that is this process's own."""
    if path == "/status":
        shard, err = _shard_param(agg, req)
        if err is not None:
            return err
        if shard is None:
            return _json(agg.merged_status())
        dump = agg.shard_dump(shard)
        if dump is None:
            return 404, "text/plain", f"no dump for shard {shard}".encode()
        view = dict(dump.get("status", {}))
        view.update(shard=dump.get("shard"), pid=dump.get("pid"))
        return _json(view)
    if (path == "/vars" or path.startswith("/vars/")) \
            and req.query.get("series") is None:
        prefix = req.query.get("prefix", path[6:] if len(path) > 6 else "")
        shard, err = _shard_param(agg, req)
        if err is not None:
            return err
        if shard is None:
            items = sorted(agg.merged_vars(prefix).items())
        else:
            dump = agg.shard_dump(shard)
            if dump is None:
                return (404, "text/plain",
                        f"no dump for shard {shard}".encode())
            items = sorted((n, v) for n, v in dump.get("vars", {}).items()
                           if n.startswith(prefix))
        lines = [f"{n} : {v}" for n, v in items]
        return 200, "text/plain", ("\n".join(lines) + "\n").encode()
    if path == "/vars":
        sname = req.query.get("series")
        ser = agg.merged_timeline(names=[sname]).get(
            "series", {}).get(sname)
        if ser is None:
            return 400, "text/plain", f"no series for {sname!r}".encode()
        return _json({sname: ser})
    if path in ("/brpc_metrics", "/metrics"):
        from brpc_tpu_torch.bvar.prometheus import dump_prometheus_items
        shard, err = _shard_param(agg, req)
        if err is not None:
            return err
        if shard is None:
            return 200, "text/plain", agg.prometheus_text().encode()
        dump = agg.shard_dump(shard)
        if dump is None:
            return 404, "text/plain", f"no dump for shard {shard}".encode()
        return 200, "text/plain", dump_prometheus_items(
            sorted(dump.get("vars", {}).items())).encode()
    if path == "/timeline":
        return _supervisor_timeline(agg, req)
    if path == "/shards":
        out = {"shards": agg.num_shards,
               "heartbeat_age_s": {str(i): agg.heartbeat_age_s(i)
                                   for i in range(agg.num_shards)}}
        if agg.group is not None:
            out["group"] = agg.group.group_status()
        return _json(out)
    if path == "/serving":
        return _shard_page(agg, req, "serving", agg.merged_serving,
                           "serving dump")
    if path == "/device":
        return _shard_page(agg, req, "device", agg.merged_device,
                           "device dump")
    if path == "/census":
        return _shard_page(agg, req, "census", agg.merged_census,
                           "census")
    if path == "/incidents" and not req.query.get("action"):
        return _shard_page(agg, req, "incidents", agg.merged_incidents,
                           "incidents")
    if path == "/incidents":
        return _incidents_page(None, req, agg=agg)
    if path == "/capture":
        return _supervisor_capture(agg, req)
    if path in ("/hotspots", "/pprof/profile") \
            and req.query.get("mode") == "continuous":
        return _supervisor_hotspots(agg, req)
    return None


def _supervisor_timeline(agg, req: HttpRequest) -> Page:
    names = req.query.get("name") or req.query.get("names")
    names = [n for n in names.split(",") if n] if names else None
    prefix = req.query.get("prefix", "")
    shard, err = _shard_param(agg, req)
    if err is not None:
        return err
    if shard is None:
        payload = agg.merged_timeline(names=names, prefix=prefix)
    else:
        dump = agg.shard_dump(shard)
        if dump is None or not dump.get("timeline"):
            return (404, "text/plain",
                    f"no timeline for shard {shard}".encode())
        payload = dict(dump["timeline"])
        if names or prefix:
            payload["series"] = {
                k: v for k, v in (payload.get("series") or {}).items()
                if (names is None or k in names) and k.startswith(prefix)}
    if names:
        missing = [n for n in names if n not in payload.get("series", {})]
        if missing:
            return (400, "text/plain",
                    f"no series for {missing[0]!r}".encode())
    return _json(payload)


def _supervisor_capture(agg, req: HttpRequest) -> Page:
    """A supervisor's ``/capture``: start and stop write the control file
    the shards apply at their next dump tick; the download merges every
    shard's corpus files."""
    from brpc_tpu_torch.builtin.services import capture_download_bytes
    action = req.query.get("action", "")
    group = agg.group
    if action in ("start", "stop"):
        if group is None:
            return 404, "text/plain", b"no supervisor for capture control"
        seq = group.write_capture_control(action, dict(req.query))
        return _json({"control": action, "seq": seq,
                      "applied_within_s": group.options.dump_interval_s})
    if action == "download":
        data = capture_download_bytes(agg.capture_paths())
        if not data:
            return 404, "text/plain", b"no captured corpus"
        return 200, "application/octet-stream", data
    if action:
        return (400, "text/plain",
                f"unknown capture action {action!r}".encode())
    return _json(agg.merged_capture())


def _supervisor_hotspots(agg, req: HttpRequest) -> Page:
    """A supervisor's continuous profile: the shards' recorder states,
    counters summed; ``?shard=i`` narrows (a diff is one process's)."""
    from brpc_tpu_torch.builtin import flight_recorder as fr
    from brpc_tpu_torch.builtin.profiler import (render_flamegraph_svg,
                                                 render_folded)
    if _query_flag(req, "diff"):
        return (400, "text/plain",
                b"diff is per-process; use ?shard=i on a worker")
    shard, err = _shard_param(agg, req)
    if err is not None:
        return err
    dumps = [agg.shard_dump(shard)] if shard is not None \
        else agg.read_dumps()
    m = fr.merge_dump_states([d["hotspots"] for d in dumps
                              if d and d.get("hotspots")])
    fmt = req.query.get("format")
    if fmt == "folded":
        return 200, "text/plain", render_folded(m["folded"]).encode()
    if fmt in ("svg", "flamegraph"):
        return (200, "image/svg+xml",
                render_flamegraph_svg(m["folded"]).encode())
    if fmt == "json":
        return _json({"nsamples": m["nsamples"], "nbusy": m["nbusy"],
                      "windows": m.get("windows"), "span_s": m.get("span_s"),
                      "stall_ms_max_10s": m.get("stall_ms_max_10s"),
                      "shards_reporting": m.get("shards_reporting"),
                      "labels": dict(m["labels"]),
                      "folded": dict(m["folded"].most_common(200))})
    return 200, "text/plain", fr.render_continuous_text(m).encode()


def builtin_page(server, req: HttpRequest):
    """(status, content type, body) of a builtin page, or None when
    ``req.path`` names none (the server then dispatches it as a
    method). An on-demand ``/hotspots`` profile returns an awaitable of
    the page instead: its fiber parks for the sample window. The
    modules behind the pages are imported here, when a page is asked
    for."""
    path = req.path.rstrip("/") or "/"
    agg = getattr(server, "shard_aggregator", None)
    if agg is not None:
        page = _supervisor_page(agg, req, path)
        if page is not None:
            return page
    if path == "/shards":
        return 404, "text/plain", b"not a shard-group supervisor"
    if path == "/":
        from brpc_tpu_torch.builtin.tabbed import render_index
        return 200, "text/html", render_index(server)
    if path == "/health":
        return _health_page(server)
    if path == "/status":
        from brpc_tpu_torch.builtin.services import status_page
        return _json(status_page(server))
    if path == "/vars" or path.startswith("/vars/"):
        return _vars_page(req, path)
    if path == "/timeline":
        return _timeline_page(server, req)
    if path in ("/hotspots", "/pprof/profile"):
        return _hotspots_page(req)
    if path in ("/fibers", "/bthreads"):
        if _query_flag(req, "stacks"):
            from brpc_tpu_torch.fiber.stacks import dump_fiber_stacks
            return 200, "text/plain", dump_fiber_stacks().encode()
        return _json(_fibers_payload(server))
    if path == "/threads":
        return 200, "text/plain", _thread_stacks()
    if path == "/census":
        from brpc_tpu_torch.builtin.services import census_page_payload
        return _json(census_page_payload(server))
    if path == "/capture":
        return _capture_page(server, req)
    if path == "/incidents":
        return _incidents_page(server, req)
    if path == "/vlog":
        return _vlog_page(req)
    if path in ("/brpc_metrics", "/metrics"):
        from brpc_tpu_torch.bvar.prometheus import dump_prometheus
        return 200, "text/plain", dump_prometheus().encode()
    if path == "/flags" or path.startswith("/flags/"):
        return _flags_page(req, path)
    if path == "/connections":
        from brpc_tpu_torch.builtin.services import connections_page
        return _json(connections_page(server))
    if path == "/sockets":
        from brpc_tpu_torch.builtin.services import sockets_page
        return _json(sockets_page(server))
    if path == "/ids":
        from brpc_tpu_torch.builtin.services import ids_page
        return _json(ids_page())
    if path == "/protobufs":
        from brpc_tpu_torch.builtin.services import protobufs_page
        return _json(protobufs_page(server))
    if path == "/serving":
        from brpc_tpu_torch.serving.service import serving_page_payload
        return _json(serving_page_payload(server))
    if path == "/rpcz":
        return _rpcz_page(req)
    if path == "/device":
        from brpc_tpu_torch.transport.device_stats import (
            device_page_payload)
        return _json(device_page_payload(server))
    if path == "/backends":
        # this process's client channels, a row a (channel, backend)
        from brpc_tpu_torch.rpc.backend_stats import backends_page_payload
        return _json(backends_page_payload())
    if path == "/lb_trace":
        return _lb_trace_page(req)
    if path == "/contentions":
        from brpc_tpu_torch.fiber.contention import contention_report
        try:
            top = int(req.query.get("n", "30"))
        except ValueError:
            return 400, "text/plain", b"bad n"
        rows = contention_report(top)
        lines = ["count  total_wait_us  site\n"] + [
            f"{c:6d} {w:13.1f}  {site}\n" for site, c, w in rows]
        return 200, "text/plain", "".join(lines).encode()
    if path == "/version":
        from brpc_tpu_torch.builtin.services import version_page
        return _json(version_page(server))
    return None


def _health_page(server) -> Page:
    """``OK``, or what ``ServerOptions.health_reporter`` says
    (health_reporter.h: the application decides what healthy means)."""
    reporter = server.options.health_reporter
    if reporter is None:
        return 200, "text/plain", b"OK"
    try:
        r = reporter(server)
    except Exception as e:
        return 500, "text/plain", f"health reporter: {e}".encode()
    if isinstance(r, tuple):
        status, ctype, body = r
        return status, ctype, (body if isinstance(body, bytes)
                               else str(body).encode())
    return 200, "text/plain", r if isinstance(r, bytes) else str(r).encode()


def _lb_trace_page(req: HttpRequest) -> Page:
    from brpc_tpu_torch.rpc.backend_stats import lb_trace_payload
    try:
        n = max(1, int(req.query.get("n", "100")))
    except ValueError:
        return 400, "text/plain", f"bad n {req.query.get('n')!r}".encode()
    name = req.query.get("channel")
    payload = lb_trace_payload(name, n)
    if payload is None:
        return (404, "text/plain",
                f"no decision ring for channel {name!r}".encode())
    return _json(payload)


def _flags_page(req: HttpRequest, path: str) -> Page:
    from brpc_tpu_torch.butil.flags import list_flags, set_flag
    if path.startswith("/flags/") and ("setvalue" in req.query
                                       or req.method == "POST"):
        name = path[len("/flags/"):]
        value = req.query.get("setvalue", req.body.decode() or "")
        if set_flag(name, value):
            return 200, "text/plain", b"OK"
        return 400, "text/plain", f"cannot set flag {name!r}".encode()
    rows = [f"{n} = {v!r} (default {d!r})  # {h}"
            for n, v, d, h in list_flags()]
    return 200, "text/plain", ("\n".join(rows) + "\n").encode()


def _rpcz_page(req: HttpRequest) -> Page:
    from brpc_tpu_torch.rpc.span import global_collector, global_store
    tid = req.query.get("trace_id")
    ids = None
    if tid:
        ids = _trace_id_candidates(tid)
        if not ids:
            return 400, "text/plain", f"bad trace_id {tid!r}".encode()
    try:
        n = max(1, int(req.query.get("n", "50")))
    except ValueError:
        return 400, "text/plain", f"bad n {req.query.get('n')!r}".encode()
    if _query_flag(req, "history"):
        # spans that aged out of the ring, read back from rpcz_dir
        return _json(global_store.read(n, trace_id=ids))
    spans = (global_collector.find_trace(ids) if ids
             else global_collector.recent(n))
    return _json([s.to_dict() for s in spans])


def _vars_page(req: HttpRequest, path: str) -> Page:
    """``/vars``: every variable, with the last minute's sparkline of
    each one that has a warm trend ring; ``?series=<name>``: that
    variable's rings as JSON (400 for a name without one)."""
    from brpc_tpu_torch.bvar.series import global_series, series_enabled
    from brpc_tpu_torch.bvar.variable import dump_exposed
    sname = req.query.get("series")
    if sname is not None:
        ser = global_series().dump_series(names=[sname]).get(sname)
        if ser is None:
            return 400, "text/plain", f"no series for {sname!r}".encode()
        return _json({sname: ser})
    prefix = req.query.get("prefix", path[6:] if len(path) > 6 else "")
    col = global_series() if series_enabled() else None
    lines = []
    for n, v in dump_exposed(prefix):
        spark = col.spark(n) if col is not None else ""
        lines.append(f"{n} : {v}  {spark}" if spark else f"{n} : {v}")
    return 200, "text/plain", ("\n".join(lines) + "\n").encode()


def _timeline_page(server, req: HttpRequest) -> Page:
    """``/timeline?name=a,b&prefix=p``: the trend rings, the watchdog's
    incidents and its keys; a named series without a ring is a 400."""
    from brpc_tpu_torch.builtin.services import timeline_page_payload
    names = req.query.get("name") or req.query.get("names")
    names = [n for n in names.split(",") if n] if names else None
    payload = timeline_page_payload(server, names=names,
                                    prefix=req.query.get("prefix", ""))
    if names:
        missing = [n for n in names if n not in payload["series"]]
        if missing:
            return (400, "text/plain",
                    f"no series for {missing[0]!r}".encode())
    return _json(payload)


def _thread_stacks() -> bytes:
    """Every thread's Python stack (``/threads``: the workers are the
    threads that run the fibers)."""
    import sys
    import threading
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---\n")
        out.extend(traceback.format_stack(frame))
        out.append("\n")
    return "".join(out).encode()


def _fibers_payload(server) -> dict:
    c = server.control
    return {
        "concurrency": c.concurrency,
        "alive_fibers": c.nfibers.get_value(),
        "fibers_created": c.nfibers_created.get_value(),
        "switches_per_group": {g.index: g.nswitches for g in c.groups},
        "steals_per_group": {g.index: g.nsteals for g in c.groups},
        "runqueue_depth": {g.index: g.depth() for g in c.groups},
    }


def _incidents_page(server, req: HttpRequest, agg=None) -> Page:
    """``/incidents``: the capture-on-anomaly state and the artifact
    ledger; ``?action=download&path=`` serves an artifact, and only one
    the ledger lists (an arbitrary path must not read any file; a
    supervisor's ledger is the shards' merged one)."""
    from brpc_tpu_torch.builtin.services import incidents_page_payload
    from brpc_tpu_torch.incident.artifact import SUFFIX
    action = req.query.get("action", "")
    if action == "download":
        path = req.query.get("path", "")
        rows = (agg.merged_incidents() if agg is not None
                else incidents_page_payload(server)).get("artifacts") or []
        known = {r.get("path") for r in rows}
        if not path or path not in known or not path.endswith(SUFFIX):
            return 404, "text/plain", b"no such incident artifact"
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return 404, "text/plain", b"artifact unreadable"
        return 200, "application/octet-stream", data
    if action:
        return (400, "text/plain",
                f"unknown incidents action {action!r}".encode())
    return _json(incidents_page_payload(server))


def _capture_page(server, req: HttpRequest) -> Page:
    """``/capture``: the recorder's state; ``?action=start&dir=&rate=``
    and ``?action=stop`` control it; ``?action=download`` is the merged
    corpus."""
    from brpc_tpu_torch.builtin.services import (capture_control,
                                                 capture_download_bytes,
                                                 capture_page_payload)
    action = req.query.get("action", "")
    if action in ("start", "stop"):
        try:
            return _json(capture_control(action, dict(req.query)))
        except (ValueError, OSError) as e:
            return 400, "text/plain", str(e).encode()
    if action == "download":
        data = capture_download_bytes()
        if not data:
            return 404, "text/plain", b"no captured corpus"
        return 200, "application/octet-stream", data
    if action:
        return (400, "text/plain",
                f"unknown capture action {action!r}".encode())
    return _json(capture_page_payload(server))


def _hotspots_page(req: HttpRequest):
    """``/hotspots``: ``?type=heap|growth`` (tracemalloc), the continuous
    profile (``?mode=continuous``, ``diff=1``), or an on-demand CPU
    profile of ``seconds`` at ``interval_ms`` (5 by default) sampled by
    the flight recorder's thread, which the caller awaits. Formats: text,
    ``folded``, ``svg`` and ``json`` (on demand with the idle samples by
    thread, the port's addition)."""
    from brpc_tpu_torch.builtin import flight_recorder as fr
    from brpc_tpu_torch.builtin.profiler import (growth_profile,
                                                 heap_profile, heap_stop,
                                                 render_flamegraph_svg,
                                                 render_folded, render_text)
    ptype = req.query.get("type", "cpu")
    if ptype in ("heap", "growth"):
        if _query_flag(req, "stop"):
            return 200, "text/plain", heap_stop().encode()
        try:
            top = min(200, int(req.query.get("top", "40")))
        except ValueError:
            return 400, "text/plain", b"bad top"
        text = heap_profile(top) if ptype == "heap" else growth_profile(top)
        return 200, "text/plain", text.encode()
    if ptype != "cpu":
        return 400, "text/plain", b"type must be cpu|heap|growth"
    fmt = req.query.get("format")
    rec = fr.global_recorder()
    if req.query.get("mode") == "continuous":
        if _query_flag(req, "diff"):
            return (200, "text/plain",
                    fr.render_diff_text(rec.window_diff()).encode())
        from brpc_tpu_torch.transport.event_dispatcher import (
            stall_ms_max_10s)
        m = rec.merged()
        m["stall_ms_max_10s"] = stall_ms_max_10s()
        if fmt == "folded":
            return 200, "text/plain", render_folded(m["folded"]).encode()
        if fmt in ("svg", "flamegraph"):
            return (200, "image/svg+xml",
                    render_flamegraph_svg(m["folded"]).encode())
        if fmt == "json":
            return _json({
                "nsamples": m["nsamples"], "nbusy": m["nbusy"],
                "windows": m.get("windows"), "span_s": m.get("span_s"),
                "stall_ms_max_10s": m.get("stall_ms_max_10s"),
                "labels": dict(m["labels"]),
                "folded": dict(m["folded"].most_common(200))})
        return 200, "text/plain", fr.render_continuous_text(m).encode()
    try:
        seconds = min(30.0, float(req.query.get("seconds", "1")))
        interval_s = max(1.0, float(req.query.get("interval_ms", "5"))) / 1e3
    except ValueError:
        return 400, "text/plain", b"bad seconds or interval_ms"
    from brpc_tpu_torch.fiber.sync import FiberEvent
    done = FiberEvent()
    result: dict = {}

    def on_done(leaves, folded, n, idle):
        result["v"] = (leaves, folded, n, idle)
        done.set()

    # one profile at a time: a second is refused, not queued
    if not rec.request_profile(seconds, interval_s, on_done):
        return 503, "text/plain", b"another profile is already running"

    async def finish() -> Page:
        await done.wait(seconds + 30)
        if "v" not in result:
            return 503, "text/plain", b"profile did not complete"
        leaves, folded, n, idle = result["v"]
        if fmt == "json":
            return _json({"nsamples": n, "nbusy": sum(folded.values()),
                          "idle_by_thread": dict(idle),
                          "leaves": dict(leaves.most_common(200)),
                          "folded": dict(folded.most_common(400))})
        if fmt == "folded":
            return 200, "text/plain", render_folded(folded).encode()
        if fmt in ("svg", "flamegraph"):
            return (200, "image/svg+xml",
                    render_flamegraph_svg(folded).encode())
        return 200, "text/plain", render_text(leaves, n).encode()
    return finish()


def _vlog_page(req: HttpRequest) -> Page:
    """``/vlog``: the loggers' levels and the VLOG verbosity;
    ``?vmodule=pat=N,...`` sets the verbosity, ``?level=&module=`` a
    logger's level."""
    import logging as pylog

    from brpc_tpu_torch.butil.logging import set_vmodule, vmodule
    module = req.query.get("module", "")
    level = req.query.get("level")
    vmod = req.query.get("vmodule")
    if vmod is not None:
        try:
            set_vmodule(vmod)
        except ValueError as e:
            return 400, "text/plain", f"bad vmodule: {e}".encode()
        return 200, "text/plain", b"OK"
    if level is not None:
        try:
            pylog.getLogger(module or None).setLevel(level.upper())
        except ValueError as e:
            return 400, "text/plain", f"bad level: {e}".encode()
        return 200, "text/plain", b"OK"
    loggers = {"root": pylog.getLevelName(pylog.getLogger().level)}
    for name in sorted(pylog.root.manager.loggerDict):
        lg = pylog.root.manager.loggerDict[name]
        if isinstance(lg, pylog.Logger) and lg.level != pylog.NOTSET:
            loggers[name] = pylog.getLevelName(lg.level)
    return _json({"loggers": loggers, "vmodule": vmodule()})
