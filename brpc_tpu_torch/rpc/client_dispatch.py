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
payload sent compressed is decompressed there, and the attachment lands
in ``cntl.response_attachment``, on every lane) and
completes it (``Controller._complete``: the joiners wake and ``done``
runs here).

The native lanes (brpc_tpu/rpc/client_dispatch.py:16-153, the port of
brpc_tpu/rpc/controller.py:27-51's id pool): correlation ids are the
versioned slots of fastcore's ``Pool`` (respool.cc) when the extension
loads, of a ``ResourcePool`` with slot 0 held back otherwise (an id 0
is an absent field on the wire); ``address_call`` reads it without a
lock. ``process_response_fast`` completes a call from a scan record (the
turbo lane, the pluck lane, the chunk drain), and
``make_client_fast_drain`` is the ``mem://`` chunk lane's hook.

Each attempt has one record, its pool entry ``cid -> (controller,
socket)``; the socket keeps the ids of its attempts
(``Socket.client_cids``), which ``fail_calls`` walks and the lazy
plucker's gate counts. A sync joiner that plucks with its deadline
unarmed (``Controller.join``, brpc_tpu/rpc/controller.py:356-400,
:602-650) registers as its socket's ``lazy_plucker``
(``lazy_pluck_begin``) only while its attempt is the socket's one; a
later attempt on that socket arms the plucker's timer, since its
response would run through the plucker's pass, where the plucker's own
deadline cannot preempt.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from brpc_tpu_torch.butil.resource_pool import ResourcePool
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.transport import syscall_stats as _syscall_stats

from . import errno_codes as berr
from .compress import decompress

_lock = threading.Lock()
# cid -> (controller, socket), one entry an attempt in flight
_call_pool = None

# responses completed by process_response_fast, by lane
nfast_responses = Adder().expose("client_fast_responses")
nchunk_drained = Adder().expose("client_chunk_drain_responses")


def _pool():
    p = _call_pool
    return p if p is not None else _make_pool()


def _make_pool():
    # locked: two first calls must agree on one pool, or a call
    # registered in a discarded one would never hear its response. The
    # native core loads (and at its first use builds) before the lock:
    # every call's registration takes it
    global _call_pool
    from brpc_tpu_torch.native import fastcore
    fc = fastcore.get()
    with _lock:
        if _call_pool is None:
            if fc is not None:
                _call_pool = fc.Pool(1 << 17)
            else:
                p = ResourcePool()
                p.insert(None)      # id 0 stays invalid
                _call_pool = p
        return _call_pool


def warm() -> None:
    """Load the id pool (and with it the native core) ahead of the
    first call."""
    _pool()


def _postfork_reset() -> None:
    """A forked child has no call in flight: a fresh pool and lock (the
    reference keeps its pool in ``rpc/controller.py``, brpc_tpu/rpc/
    controller.py:65-77)."""
    global _call_pool, _lock
    _call_pool = None
    _lock = threading.Lock()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("rpc.client_dispatch", _postfork_reset)


def register_call(cntl, socket) -> int:
    """Register one attempt of ``cntl`` on ``socket`` under a fresh
    correlation id, which becomes ``cntl.correlation_id``; 0 when the
    call was taken already (the deadline fired, it was canceled)."""
    pool = _pool()
    lazy = None
    with cntl._arb_lock:
        if cntl._taken:
            return 0
        with _lock:
            cid = pool.insert((cntl, socket))
            socket.client_cids.add(cid)
            if len(socket.client_cids) > 1:
                lazy = socket.lazy_plucker
        cntl._attempt_cids.append(cid)
        cntl.correlation_id = cid
    if lazy is not None:
        # the joiner plucking this socket would process this attempt's
        # response in its own pass: its deadline gets its timer now
        lazy._arm_lazy_deadline()
    return cid


def lazy_pluck_begin(socket, cntl) -> bool:
    """Make ``cntl`` the plucker of ``socket`` whose deadline is unarmed;
    False when another attempt is in flight there (the joiner arms its
    timer instead). Under the lock ``register_call`` counts under, so
    one of the two sides always arms."""
    with _lock:
        if len(socket.client_cids) > 1:
            return False
        socket.lazy_plucker = cntl
        return True


def lazy_pluck_end(socket, cntl) -> None:
    with _lock:
        if socket.lazy_plucker is cntl:
            socket.lazy_plucker = None


def address_call(cid: int):
    """The controller whose attempt ``cid`` is in flight, or None."""
    try:
        call = _pool().address(cid)
    except OverflowError:       # no such id fits a slot
        return None
    return None if call is None else call[0]


def _forget_locked(cid: int) -> None:
    """Drop one attempt's id (under ``_lock``)."""
    call = _pool().remove(cid)
    if call is not None:
        call[1].client_cids.discard(cid)


def _take_locked(cntl) -> None:
    cntl._taken = True
    with _lock:
        for c in cntl._attempt_cids:
            _forget_locked(c)
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
        _forget_locked(cid)
    return True


def fail_calls(socket, code: int, text: str) -> None:
    """The failure of ``socket``: every attempt still waiting on it
    fails, and its call retries elsewhere or completes."""
    with _lock:
        cids = list(socket.client_cids)
    dead = [(cid, address_call(cid)) for cid in cids]
    for cid, cntl in dead:
        if cntl is None:
            continue
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


class PayloadBytes(bytes):
    """bytes with the read surface of a payload (``to_bytes``, ``size``):
    the fast lanes hand payloads over without an IOBuf."""

    __slots__ = ()

    def to_bytes(self) -> bytes:
        return self

    @property
    def size(self) -> int:
        return len(self)


def process_response_fast(cid: int, err_code: int, err_text,
                          payload: bytes, att: bytes, socket) -> None:
    """Complete a call from a scan record's fields: no RpcMeta, no
    portal. The scanner admits no compression, stream settings, device
    payloads or admission threshold, so what ``process_response`` does
    with those cannot apply; an error goes through it, with the same
    retry decision."""
    cntl = address_call(cid)
    if cntl is None:
        return          # timed out, canceled or failed earlier: dropped
    nfast_responses.add(1)
    if err_code:
        meta = tpu_std.RpcMeta(
            response=tpu_std.RpcResponseMeta(err_code, err_text or ""),
            correlation_id=cid)
        process_response(None, tpu_std.RpcMessage(meta, b"", att), socket)
        return
    ch = cntl._owner_channel
    if ch._adm_cache:
        # a response of the fast lane carries no threshold (the scanner
        # defers that field): its server has relaxed
        ch._track_admission_threshold(socket.remote_endpoint,
                                      cntl._service_name, 0)
    if take_call(cid) is not cntl:
        return
    cntl.responded_server = socket.remote_endpoint
    cntl._bs_resp_bytes = len(payload)
    span = cntl._client_span
    if span is not None:
        span.first_byte_us = time.monotonic_ns() // 1000
    cntl.response = PayloadBytes(payload)
    if att:
        cntl.response_attachment.append(att)
    if span is not None:
        span.parse_done_us = time.monotonic_ns() // 1000
        span.response_size = len(payload)
    cntl._complete()


def make_client_fast_drain():
    """The client's chunk lane (``Socket.fast_drain`` on a ``mem://``
    channel): the writer's bytes objects go through one ``scan_frames``
    pass and their responses complete through ``process_response_fast``,
    with no portal in between. What is not a clean run of fast
    responses goes back into the portal for the classic path; on an fd
    conn the hook disables itself. None without the extension."""
    from brpc_tpu_torch.native import fastcore
    fc = fastcore.get()
    scan = getattr(fc, "scan_frames", None) if fc is not None else None
    if scan is None:
        return None
    from brpc_tpu_torch.transport.socket import pull_chunks
    from .stream import process_stream_frame_fast
    magic, max_body = tpu_std.MAGIC, tpu_std.SMALL_FRAME_MAX

    def fast_drain(sock) -> bool:
        if sock.input_portal or sock.input_need:
            return False
        data, handled = pull_chunks(sock)
        if data is None:
            return handled
        consumed, frames = scan(data, magic, max_body, 128,
                                tpu_std.STREAM_SCAN_MAX, 1)
        if any(f[0] == 0 for f in frames):
            # a request on a client socket: the whole run goes to the
            # classic path in parse order (records carry no offsets)
            sock.input_portal.append_user_data(data)
            return False
        if frames:
            _syscall_stats.note_rpc_messages(len(frames))
        for f in frames:
            if f[0] == 2:
                _, sid, seq, credits, sclose, pay, att = f
                process_stream_frame_fast(sid, seq, credits, sclose, pay,
                                          att)
                continue
            _, cid, ec, et, pay, att = f
            nchunk_drained.add(1)
            process_response_fast(cid, ec, et, pay, att, sock)
        if consumed == len(data):
            if frames:
                sock.user_data["_fdrain_defer_streak"] = 0
            return True
        if not frames:
            # a connection whose responses always defer stops paying
            # for the lane
            streak = sock.user_data.get("_fdrain_defer_streak", 0) + 1
            sock.user_data["_fdrain_defer_streak"] = streak
            if streak >= 16:
                sock.fast_drain = None
        sock.input_portal.append_user_data(data[consumed:])
        return False

    return fast_drain


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
    if msg.attachment:
        # what the inline tensors left: the user's attachment
        cntl.response_attachment.append(msg.attachment)
    ss: Optional[object] = msg.meta.stream_settings
    stream = cntl.stream
    if stream is not None and ss is not None and ss.stream_id:
        # in parse order: frames cut after the response find it bound
        stream.peer_id = ss.stream_id
        stream._bind(socket)
        stream._on_established()


def inflight_attempts() -> int:
    """The number of attempts in flight."""
    p = _pool()
    with _lock:
        # the ResourcePool holds slot 0 back with a None
        return len(p) if hasattr(p, "__len__") else p.live() - 1
