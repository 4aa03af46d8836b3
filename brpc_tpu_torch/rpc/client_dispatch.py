"""Client-side response processing (the port of
brpc_tpu/rpc/client_dispatch.py; bRPC's ProcessRpcResponse,
policy/baidu_rpc_protocol.cpp).

Each attempt of a call is registered here under a correlation id of its
own, with the socket its request went on; a call with a backup request
in flight has two. ``take_call`` takes the whole call for the path that
completes it: every attempt's id goes, so a late response finds none
and is dropped. ``drop_attempt`` ends one attempt only, for a failure
that the call survives (a retry, or another attempt still in flight).
The arbitration runs under the controller's ``_arb_lock``, and the
deadline timer takes the call there too, so it never interleaves with
a retry's hand-over from one attempt to the next.

``process_response`` runs where the InputMessenger processes the
response, most often in place on the dispatcher thread. An error the
server answered goes to the owning channel's retry decision; anything
else takes the call, fills the controller (``_fill_response``: a
payload sent compressed is decompressed there) and
completes it (``Controller._complete``: the joiners wake and ``done``
runs here).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.protocol import tpu_std

from . import errno_codes as berr
from .compress import decompress

_lock = threading.Lock()
_cids = itertools.count(1)
# cid -> (controller, socket), one entry an attempt in flight
_calls: Dict[int, Tuple[object, object]] = {}


def register_call(cntl, socket) -> int:
    """Register one attempt of ``cntl`` on ``socket`` under a fresh
    correlation id, which becomes ``cntl.correlation_id``; 0 when the
    call was taken already (the deadline fired, it was canceled)."""
    with cntl._arb_lock:
        if cntl._taken:
            return 0
        with _lock:
            cid = next(_cids)
            _calls[cid] = (cntl, socket)
        cntl._attempt_cids.append(cid)
        cntl.correlation_id = cid
    return cid


def address_call(cid: int):
    """The controller whose attempt ``cid`` is in flight, or None."""
    with _lock:
        call = _calls.get(cid)
    return None if call is None else call[0]


def _take_locked(cntl) -> None:
    cntl._taken = True
    with _lock:
        for c in cntl._attempt_cids:
            _calls.pop(c, None)
    cntl._attempt_cids = []


def take_call(cid: int):
    """Take the call whose attempt ``cid`` is in flight; None when the
    attempt ended or another path took the call."""
    cntl = address_call(cid)
    if cntl is None:
        return None
    with cntl._arb_lock:
        if cntl._taken or cid not in cntl._attempt_cids:
            return None
        _take_locked(cntl)
    return cntl


def take_controller(cntl) -> bool:
    """Take ``cntl``'s call whichever attempt is in flight, none too
    (between a failed attempt and its retry): the deadline timer and
    ``start_cancel``. False when another path took it."""
    with cntl._arb_lock:
        if cntl._taken:
            return False
        _take_locked(cntl)
    return True


def drop_attempt(cntl, cid: int) -> bool:
    """End attempt ``cid`` alone (held under ``cntl._arb_lock``); False
    when it had ended or the call was taken."""
    if cntl._taken or cid not in cntl._attempt_cids:
        return False
    cntl._attempt_cids.remove(cid)
    with _lock:
        _calls.pop(cid, None)
    return True


def fail_calls(socket, code: int, text: str) -> None:
    """The failure of ``socket``: every attempt still waiting on it
    fails, and its call retries elsewhere or completes."""
    with _lock:
        dead = [(cid, c[0]) for cid, c in _calls.items() if c[1] is socket]
    for cid, cntl in dead:
        cntl._owner_channel._on_attempt_verdict(
            cntl, cid, code, text, failed_ep=socket.remote_endpoint)


def process_response(proto, msg, socket) -> None:
    cid = msg.meta.correlation_id
    cntl = address_call(cid)
    if cntl is None:
        return          # timed out, canceled or failed earlier: dropped
    resp = msg.meta.response
    ch = cntl._owner_channel
    if resp is not None and (resp.admission_threshold or ch._adm_cache):
        # an overloaded server stamps its admission threshold on every
        # response; one without it says that server has relaxed
        ch._track_admission_threshold(socket.remote_endpoint,
                                      cntl._service_name,
                                      resp.admission_threshold)
    if resp is not None and resp.error_code:
        ch._on_attempt_verdict(cntl, cid, resp.error_code, resp.error_text,
                               failed_ep=socket.remote_endpoint,
                               responded=True)
        return
    if take_call(cid) is not cntl:
        return          # another path took the call first
    # the backend whose response completes the call: with a backup in
    # flight it is not always the last one picked
    cntl.responded_server = socket.remote_endpoint
    cntl._bs_resp_bytes = len(msg.payload)
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
    cntl.response = msg.payload
    if msg.meta.compress_type:
        # the server answers in the kind it was sent
        cntl.response = decompress(msg.payload, msg.meta.compress_type)
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


def inflight_attempts() -> List[int]:
    """The correlation ids of the attempts in flight."""
    with _lock:
        return list(_calls)
