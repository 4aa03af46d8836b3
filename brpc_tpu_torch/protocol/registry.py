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

The port registers ``tpu_std`` and ``http``, in that order of preference.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

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


def _register_builtins() -> None:
    from brpc_tpu_torch.protocol import http, tpu_std
    tpu_std.ensure_registered()
    http.ensure_registered()
