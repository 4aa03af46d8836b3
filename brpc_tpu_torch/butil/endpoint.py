"""EndPoint: where a peer lives (the port of brpc_tpu/butil/endpoint.py;
bRPC's butil/endpoint.h:87).

A {scheme, host, port, extras} value. The port registers only the
``tcp`` transport, so ``tcp://10.0.0.1:8000`` is the address it serves
and dials; a bare ``host:port`` parses as tcp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class EndPoint:
    scheme: str = "tcp"
    host: str = ""
    port: int = 0
    extras: Tuple[Tuple[str, str], ...] = ()

    def __str__(self) -> str:
        s = f"{self.scheme}://{self.host}"
        if self.port:
            s += f":{self.port}"
        if self.extras:
            s += "#" + "&".join(f"{k}={v}" for k, v in self.extras)
        return s


def str2endpoint(s: str, default_scheme: str = "tcp") -> EndPoint:
    """Parse ``scheme://host:port#k=v&k2=v2``; a bare ``host:port`` or
    ``host`` gets ``default_scheme`` (butil/endpoint.cpp str2endpoint)."""
    extras: Tuple[Tuple[str, str], ...] = ()
    if "#" in s:
        s, frag = s.split("#", 1)
        pairs = []
        for item in frag.split("&"):
            if not item:
                continue
            k, _, v = item.partition("=")
            pairs.append((k, v))
        extras = tuple(sorted(pairs))
    if "://" in s:
        scheme, rest = s.split("://", 1)
    else:
        scheme, rest = default_scheme, s
    host, port = rest, 0
    if rest.startswith("["):            # [v6]:port
        close = rest.index("]")
        host = rest[1:close]
        tail = rest[close + 1:]
        if tail.startswith(":"):
            port = int(tail[1:])
    elif ":" in rest:
        host, p = rest.rsplit(":", 1)
        if p:
            port = int(p)
    return EndPoint(scheme, host, port, extras)
