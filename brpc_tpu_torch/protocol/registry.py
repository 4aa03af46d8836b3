"""The protocol registry: one object per wire format (the port of
brpc_tpu/protocol/registry.py; bRPC's protocol.h:77-166 and the table in
global.cpp:401-581).

A Protocol provides:

  parse(portal, socket) -> (status, msg)
      Cut one whole message off the portal; peek only unless it returns
      PARSE_OK (the InputMessenger tries the others on PARSE_TRY_OTHERS):
        PARSE_OK              the message was cut and is returned
        PARSE_NOT_ENOUGH_DATA the bytes are this protocol's, not all here
        PARSE_TRY_OTHERS      not this protocol's framing
  process(msg, socket)         handle one message; may return an awaitable
  process_inline(msg, socket)  True when the message was handled here, in
                               parse order (stream frames, HTTP's queue)

The port registers all twelve of the reference's protocols, in its order
of preference (brpc_tpu/protocol/registry.py:87-105): ``tpu_std``,
``hulu_pbrpc``, ``sofa_pbrpc``, ``http``, ``h2`` (it claims a connection
by its client preface, which none of the others takes), ``thrift``,
``nshead`` (and the RPC flavours that ride it, as adaptors of
``nshead_service``), ``esp``, ``mongo``, ``rtmp`` (a 0x03 first byte, on
a server with an ``rtmp_service`` only), ``redis`` (its inline commands
only on a connection that already spoke RESP) and ``memcache``
(client-only: it disclaims every server's bytes). The list is fixed
before a connection's first parse: a socket's preferred protocol is an
index into it. ``find_protocol(name)`` looks one up by name. The
modules do no work at import beyond their ``struct.Struct``s, and the
InputMessenger resolves the registry when it is made, never at a
connection's first read.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

PARSE_OK = "ok"
PARSE_NOT_ENOUGH_DATA = "not_enough_data"
PARSE_TRY_OTHERS = "try_others"


class Protocol:
    name: str = "?"

    #: bytes of prefix ``parse`` needs before its PARSE_TRY_OTHERS is
    #: final: on a shorter prefix that no protocol claims, the
    #: InputMessenger waits for more bytes instead of dropping the peer
    min_probe_bytes: int = 0

    def parse(self, portal, socket) -> Tuple[str, object]:
        raise NotImplementedError

    def process(self, msg, socket):
        raise NotImplementedError

    def process_inline(self, msg, socket) -> bool:
        return False


#: the builtins' order of preference, the reference's
BUILTIN_ORDER = ("tpu_std", "hulu_pbrpc", "sofa_pbrpc", "http", "h2",
                 "thrift", "nshead", "esp", "mongo", "rtmp", "redis",
                 "memcache")

_protocols: List[Protocol] = []
_lock = threading.Lock()
_init_lock = threading.Lock()
_builtins_done = False


def register_protocol(p: Protocol) -> None:
    with _lock:
        if any(x.name == p.name for x in _protocols):
            return
        _protocols.append(p)


def get_protocols() -> List[Protocol]:
    global _builtins_done
    if not _builtins_done:
        with _init_lock:
            if not _builtins_done:
                _register_builtins()
                _builtins_done = True
    return list(_protocols)


def find_protocol(name: str) -> Optional[Protocol]:
    for p in get_protocols():
        if p.name == name:
            return p
    return None


def _register_builtins() -> None:
    from brpc_tpu_torch.protocol import (esp, h2, http, memcache, mongo,
                                         nshead, pbrpc_variants, redis,
                                         rtmp, thrift, tpu_std)
    tpu_std.ensure_registered()
    pbrpc_variants.ensure_registered()
    http.ensure_registered()
    h2.ensure_registered()
    thrift.ensure_registered()
    nshead.ensure_registered()
    esp.ensure_registered()
    mongo.ensure_registered()
    rtmp.ensure_registered()        # claims a 0x03 first byte
    redis.ensure_registered()
    memcache.ensure_registered()
    # a client's module (esp, rtmp, ...) registers its protocol when the
    # client is made, which may come before this: the builtins take
    # their order here all the same, anything else goes after them
    order = {name: i for i, name in enumerate(BUILTIN_ORDER)}
    with _lock:
        _protocols.sort(key=lambda p: order.get(p.name, len(order)))
