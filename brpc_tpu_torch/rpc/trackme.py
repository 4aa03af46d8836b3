"""trackme: the version phone-home (the port of brpc_tpu/rpc/trackme.py;
bRPC's trackme.{h,cpp}). A client pings a trackme server at most once a
``trackme_interval_s``, and the server answers a severity and a message
for a version it knows to be bad.

Off by default: the ``trackme_server`` flag is empty. Point it at a
server with ``trackme_service()`` added (a port or brpc_tpu server: the
wire is the same JSON over tpu_std). ``maybe_ping()`` never disturbs its
caller: a failed ping answers None, as trackme.cpp swallows its errors,
and is tried again after a short backoff (the least of 5 s and the
interval) instead of a whole interval; between pings it answers the last
verdict.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from brpc_tpu_torch.butil.flags import define_flag, flag

define_flag("trackme_server", "", "address of the trackme server "
            "(empty = disabled)")
define_flag("trackme_interval_s", 30.0, "min seconds between pings")

TRACKME_OK = 0
TRACKME_WARNING = 1
TRACKME_FATAL = 2

_lock = threading.Lock()
_last_ping = float("-inf")
_last_result: Optional[dict] = None


def _version() -> str:
    from brpc_tpu_torch import __version__
    return __version__


def trackme_service():
    """The server half: a ``TrackMeService`` whose ``Ping`` answers each
    peer's version with a verdict (``server.add_service(...)``)."""
    from brpc_tpu_torch.rpc.service import Service

    svc = Service("TrackMeService")

    @svc.method()
    def Ping(cntl, request):
        try:
            info = json.loads(bytes(request) or b"{}")
        except ValueError:
            info = {}
        mine = _version()
        severity, message = TRACKME_OK, ""
        if info.get("version", mine) != mine:
            severity = TRACKME_WARNING
            message = (f"peer runs {info.get('version')}, "
                       f"server runs {mine}")
        return json.dumps({"severity": severity, "message": message}).encode()

    return svc


def maybe_ping() -> Optional[dict]:
    """The client half: the server's verdict, or the last one within the
    interval; None when off, before a first answer, or on a failure."""
    global _last_ping, _last_result
    server = flag("trackme_server")
    if not server:
        return None
    now = time.monotonic()
    interval = flag("trackme_interval_s")
    with _lock:
        if now - _last_ping < interval:
            return _last_result
        _last_ping = now
    ok = False
    try:
        from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
        ch = Channel(server, ChannelOptions(timeout_ms=500, max_retry=0,
                                            share_connections=False))
        try:
            cntl = ch.call_sync("TrackMeService", "Ping",
                                json.dumps({"version": _version()}).encode())
        finally:
            ch.close()
        if cntl.failed():
            return None
        result = json.loads(bytes(cntl.response))
        with _lock:
            _last_result = result
        ok = True
        return result
    except Exception:
        return None
    finally:
        if not ok:
            # a failure must neither burn the whole interval nor hammer
            # a dead server: the next ping comes after a short backoff
            retry_after = min(5.0, interval)
            with _lock:
                _last_ping = now - max(0.0, interval - retry_after)

