"""HTTP/1.1 request heads and responses for the server's HTTP path (the
subset of brpc_tpu/protocol/http.py that ``POST /<Service>/<Method>``
and the builtin pages need: a ``Content-Length`` body, a query string,
keep-alive, and plain or chunked responses).

A connection is taken for HTTP when its first bytes start a request
line (``is_request_start``); the transport cuts the head at the blank
line and the body by its length, then ``parse_head`` reads the head.

``builtin_page`` answers the builtin pages (brpc_tpu/protocol/http.py:
281-588) before the server dispatches ``/<Service>/<Method>``: ``/``,
``/health``, ``/status``, ``/vars`` (``/vars/<prefix>``, ``?prefix=``),
``/brpc_metrics`` and ``/metrics``, ``/flags`` (``POST
/flags/<name>?setvalue=``), ``/connections``, ``/serving``, ``/rpcz``
(``?trace_id=``, ``?n=``, ``?history=1``), ``/contentions`` and
``/version``. The reference's other pages wait for their modules
(ROADMAP section 1).
"""

from __future__ import annotations

import json
import urllib.parse
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

METHODS = (b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ", b"OPTIONS ",
           b"PATCH ")
SNIFF_BYTES = 4
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
    """Whether the first ``SNIFF_BYTES`` of a connection begin a request
    line of one of the known methods."""
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


def builtin_page(server, req: HttpRequest) -> Optional[Page]:
    """(status, content type, body) of a builtin page, or None when
    ``req.path`` names none (the server then dispatches it as a
    method). The modules behind the pages are imported here, when a
    page is asked for."""
    path = req.path.rstrip("/") or "/"
    if path == "/":
        from brpc_tpu_torch.builtin.tabbed import render_index
        return 200, "text/html", render_index(server)
    if path == "/health":
        return 200, "text/plain", b"OK"
    if path == "/status":
        from brpc_tpu_torch.builtin.services import status_page
        return _json(status_page(server))
    if path == "/vars" or path.startswith("/vars/"):
        from brpc_tpu_torch.bvar.variable import dump_exposed
        prefix = req.query.get("prefix",
                               path[6:] if len(path) > 6 else "")
        lines = [f"{n} : {v}" for n, v in dump_exposed(prefix)]
        return 200, "text/plain", ("\n".join(lines) + "\n").encode()
    if path in ("/brpc_metrics", "/metrics"):
        from brpc_tpu_torch.bvar.prometheus import dump_prometheus
        return 200, "text/plain", dump_prometheus().encode()
    if path == "/flags" or path.startswith("/flags/"):
        return _flags_page(req, path)
    if path == "/connections":
        from brpc_tpu_torch.builtin.services import connections_page
        return _json(connections_page(server))
    if path == "/serving":
        from brpc_tpu_torch.serving.service import serving_page_payload
        return _json(serving_page_payload(server))
    if path == "/rpcz":
        return _rpcz_page(req)
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
