"""HTTP/1.1 request heads and responses for the server's HTTP path (the
subset of brpc_tpu/protocol/http.py that ``POST /<Service>/<Method>``
needs: a ``Content-Length`` body, keep-alive, and plain or chunked
responses).

A connection is taken for HTTP when its first bytes start a request
line (``is_request_start``); the transport cuts the head at the blank
line and the body by its length, then ``parse_head`` reads the head.
"""

from __future__ import annotations

import urllib.parse
from dataclasses import dataclass, field
from typing import Dict

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
    return HttpRequest(
        method=method.upper(), path=urllib.parse.urlsplit(target).path,
        headers=headers, content_length=n,
        keep_alive=headers.get("connection", "keep-alive").lower()
        != "close")


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
