"""EndPoint: where a peer lives (the port of brpc_tpu/butil/endpoint.py;
bRPC's butil/endpoint.h:87).

A {scheme, host, port, extras} value:

  tcp://10.0.0.1:8000            a socket peer; a bare ``host:port`` too
  mem://server-a                 in-process loopback (the test fabric)
  cuda://name:1#device=0         in-process device lane; tensors land on
                                 ``cuda:0`` (``#device=cpu``: the host)
  cudad://10.0.0.1:8000#device=1 the staged lane between processes

``#device=K`` names the receiver's device, ``cuda:K``; ``#reply_device=K``
names the device a cuda:// client takes its responses on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class EndPoint:
    scheme: str = "tcp"
    host: str = ""
    port: int = 0
    extras: Tuple[Tuple[str, str], ...] = ()

    def extra(self, key: str, default: Optional[str] = None
              ) -> Optional[str]:
        for k, v in self.extras:
            if k == key:
                return v
        return default

    def with_extras(self, **kv) -> "EndPoint":
        """This endpoint with the extras ``kv`` added or replaced."""
        merged = dict(self.extras)
        merged.update({k: str(v) for k, v in kv.items()})
        return EndPoint(self.scheme, self.host, self.port,
                        tuple(sorted(merged.items())))

    @property
    def device(self) -> Optional[str]:
        """The ``#device=`` extra as a torch device string: ``cuda:K`` for
        an ordinal K, ``cpu`` for ``cpu``; None when absent."""
        return device_spec(self.extra("device"))

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


def device_spec(value: Optional[str]) -> Optional[str]:
    """``"K"`` -> ``"cuda:K"``; ``"cpu"`` stays; None stays None. Anything
    else raises ValueError."""
    if value is None or value == "":
        return None
    if value == "cpu":
        return "cpu"
    return f"cuda:{int(value)}"
