"""Client-side response processing (the port of
brpc_tpu/rpc/client_dispatch.py; bRPC's ProcessRpcResponse,
policy/baidu_rpc_protocol.cpp).

A call waiting for its response is registered here under its
correlation id, with the socket its request went on. ``process_response``
runs where the InputMessenger processes the response, most often in place
on the dispatcher thread: it takes the call first (exactly one of the
response, the deadline timer, the socket's failure and ``start_cancel``
wins it), fills the controller (``_fill_response``) and completes it
(``Controller._complete``: the joiners wake and ``done`` runs here).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.protocol import tpu_std

from . import errno_codes as berr

_lock = threading.Lock()
_cids = itertools.count(1)
# cid -> (controller, socket)
_calls: Dict[int, Tuple[object, object]] = {}


def register_call(cntl, socket) -> int:
    """Give ``cntl`` a fresh correlation id and register it as waiting on
    ``socket``."""
    with _lock:
        cid = next(_cids)
        cntl.correlation_id = cid
        _calls[cid] = (cntl, socket)
    return cid


def take_call(cid: int):
    """Take the controller of call ``cid``; None when another path took
    it."""
    with _lock:
        call = _calls.pop(cid, None)
    return None if call is None else call[0]


def fail_calls(socket, code: int, text: str) -> None:
    """Fail and complete every call still waiting on ``socket`` (its
    failure)."""
    with _lock:
        dead = [cid for cid, c in _calls.items() if c[1] is socket]
        taken: List = [_calls.pop(cid)[0] for cid in dead]
    for cntl in taken:
        cntl.set_failed(code, text)
        cntl._complete()


def process_response(proto, msg, socket) -> None:
    cntl = take_call(msg.meta.correlation_id)
    if cntl is None:
        return          # timed out, canceled or failed earlier: dropped
    span = cntl._client_span
    if span is not None:
        # the frame's cut time: the closest honest first-byte stamp
        span.first_byte_us = msg.arrival_ns // 1000
    try:
        _fill_response(cntl, msg, socket)
    except Exception as e:      # the call is taken: it must complete here
        cntl.set_failed(berr.ERESPONSE, f"bad response: {e}")
    if span is not None:
        span.parse_done_us = time.monotonic_ns() // 1000
        span.response_size = len(msg.payload)
    cntl._complete()


def _fill_response(cntl, msg, socket) -> None:
    resp = msg.meta.response
    if resp is not None and resp.error_code:
        cntl.set_failed(resp.error_code, resp.error_text)
        return
    cntl.response = msg.payload
    if msg.meta.device_payloads:
        # inline and lane tensors in meta order
        # (brpc_tpu/rpc/client_dispatch.py:251-265)
        cntl.response_device_arrays = tpu_std.merge_device_arrays(msg)
        span = cntl._client_span
        if msg.device_recv is not None and span is not None:
            # the response's receive leg, a child of the client span
            from brpc_tpu_torch.rpc.span import submit_device_recv_span
            submit_device_recv_span(span, msg.device_recv)
    ss: Optional[object] = msg.meta.stream_settings
    stream = cntl.stream
    if stream is not None and ss is not None and ss.stream_id:
        # in parse order: frames cut after the response find it bound
        stream.peer_id = ss.stream_id
        stream._bind(socket)
        stream._on_established()
