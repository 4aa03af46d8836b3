"""Per-call state shared by client and server: the error, the deadline
budget, the response, the call's tensors, the call's stream or
progressive body, its trace, and on the client its retries and backup
request, its credential and its payload's codec (the port of
brpc_tpu/rpc/controller.py).

Client side, a call has one completion point, ``_complete``
(brpc_tpu/rpc/controller.py:428). A call may make several attempts (a
retry, a backup request), each registered under a correlation id of its
own (``client_dispatch``); exactly one of a response, the deadline
timer, the failure of an attempt that may not retry and
``start_cancel`` takes the call and completes it. ``_complete``
unschedules the call's timers, settles its retry budget, runs its
complete hooks, sets the done event under the lock that ``join``
creates it under, then runs the ``done`` callback. Waiters block
(``join``) or park their fiber (``join_async``) on that event, which is
created only when a waiter arrives before completion.

The retry state (brpc_tpu/rpc/controller.py:120-173): ``max_retry`` and
``backup_request_ms`` (None: the channel's option), ``current_try`` (the
retries so far, ``retried_count()``), ``used_backup``,
``tried_servers`` (a cluster channel's picks, in order),
``responded_server`` (whose response completed the call) and
``request_priority`` (the wire's admission class, inherited by nested
calls); a reused controller starts each call with them cleared.

Auth and compression (brpc_tpu/rpc/controller.py:109-111, :148):
``auth_token`` is the credential the request carries (the channel's,
unless set before the call), ``auth_context`` the identity the server
verified for the connection, and ``compress_type`` the payload's codec
(``rpc/compress.py``): set on a client before the call, it compresses
the request, and the server answers in the kind it was sent.
``session_local_data()`` is the object a handler borrowed from
``ServerOptions.session_local_data_factory``.

Server side, ``is_canceled`` and ``notify_on_cancel`` follow the
client's connection (``Socket.on_failed``).

Attachments (brpc_tpu/rpc/controller.py:167-168): ``request_attachment``
and ``response_attachment`` are IOBufs made at their first touch. A
client sets the request's before the call and reads the response's
after it; a handler reads the request's and fills the response's. They
ride the frame behind the payload (``RpcMeta.attachment_size``), over
tpu_std and its variants; a reused controller starts each call with an
empty response attachment.

The sync pluck lane (brpc_tpu/rpc/controller.py:569-619): a joiner on a
thread that is not a fiber worker reads its own response. It takes over
the input of the socket its attempt went on (``_issue_socket``) with
``Socket.pluck_until``, consuming the claim ``call_sync`` took before
the write (``_pluck_preclaimed``), with fastcore's ``pluck_scan`` when
the issue path armed it (``_pluck_fast``), until the call completes or
the join's budget, clamped to the call's deadline, runs out; then it
waits on the done event as before. A claim left on another socket (a
retry moved the call) is released first. ``call_sync`` leaves the
deadline to the plucker (``_pending_deadline``, the lazy deadline of
brpc_tpu/rpc/controller.py:602-684): the joiner registers as the
socket's lazy plucker while its attempt is the socket's one, fires the
timeout itself when the pluck reaches the deadline, and arms the real
timer (``_arm_lazy_deadline``) as soon as the call leaves the pluck
lane, or when another attempt registers on the socket.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.fiber.scheduler import current_group
from brpc_tpu_torch.fiber.sync import FiberEvent
from brpc_tpu_torch.fiber.timer import global_timer

from . import errno_codes as berr
from . import client_dispatch
from .client_dispatch import process_response_fast, take_controller
from .progressive import ProgressiveAttachment

log = logging.getLogger("brpc_tpu_torch.rpc")


# made at their first touch: most calls carry none
_LAZY_ATTACHMENTS = ("request_attachment", "response_attachment")


class Controller:
    def __init__(self, timeout_ms: Optional[float] = None):
        self.error_code: int = berr.OK
        self.error_text: str = ""
        # client side: this call's timeout (None = the channel's option)
        self.timeout_ms: Optional[float] = timeout_ms
        self.correlation_id: int = 0
        # client side: the response payload once the call succeeded
        self.response: Optional[bytes] = None
        # the call's tensors (brpc_tpu/rpc/controller.py:169-170): the
        # client's request tensors reach the handler here, and what the
        # handler sets in response_device_arrays reaches the client's
        # controller, each in order, inline or over the device lane
        self.request_device_arrays: List = []
        self.response_device_arrays: List = []
        # server side: the deadline taken from the request meta's
        # timeout_ms, counted from the frame's arrival
        self._deadline_ns: Optional[int] = None
        # client side: the Stream set up on this call (stream_options)
        self.stream = None
        # server side: the connection a tpu_std call came on; None for a
        # call that came over HTTP (brpc_tpu/serving/service.py:289)
        self._server_socket = None
        # server side: the client's stream id, and the stream accepted
        self._peer_stream_id: int = 0
        self._accepted_stream = None
        # server side (HTTP): the chunked body fed after the handler
        self._progressive = None
        # server side: the call answers in one response (gRPC, plain
        # HTTP over h2): no progressive body, no stream
        self.unary = False
        # rpcz: the trace this call belongs to and its own span id
        # (brpc_tpu/rpc/controller.py:112-113). A server sets them from
        # the request meta and start_server_span; a client call under
        # rpcz writes them into its request meta.
        self.trace_id: int = 0
        self.span_id: int = 0
        self.log_id: int = 0
        # server side: the peer's EndPoint
        self.remote_side = None
        # client side: this call's rpcz span, finished when it ends
        self._client_span = None
        # client side: call start and completion, monotonic microseconds
        self.start_us: int = 0
        self.end_us: int = 0
        # client side: completion (brpc_tpu/rpc/controller.py:155-179).
        # _completed is published first under _arb_lock, _finalized once
        # _complete has run its timers and hooks; joiners gate on it
        self._done_cb: Optional[Callable] = None
        self._completed = False
        self._finalized = False
        self._done_event: Optional[FiberEvent] = None
        self._timer_ids: List[int] = []
        self._complete_hooks: List[Callable] = []
        self._arb_lock = threading.RLock()
        # server side: (socket, callback) of notify_on_cancel
        self._cancel_subs: List = []
        # combo channels (rpc/combo_channels.py): each sub call's
        # response bytes, response tensors and (code, text) of a failure,
        # by sub index; collective_lowered when the call ran as one
        # collective (ParallelChannel.attach_collective)
        self.sub_responses: List = []
        self.sub_device_arrays: List = []
        self.sub_errors: List = []
        self.collective_lowered = False
        # client side: retries and the backup request
        self.max_retry: Optional[int] = None
        self.backup_request_ms: Optional[float] = None
        # the fields the channel filled in: reuse clears those only
        self._filled_by_channel: List[str] = []
        self.current_try = 0
        self.used_backup = False
        self.tried_servers: List = []
        self.responded_server = None
        # both sides: the admission class (RpcRequestMeta.priority; 0 is
        # unset). A client sets it before the call, a handler reads it
        self.request_priority = 0
        # the request's credential, the identity the server verified for
        # its connection, and the payload's codec (0: none)
        self.auth_token = ""
        self.auth_context = None
        self.compress_type = 0
        # server side: the object borrowed from the session-local pool
        self._session_local = None
        # client side, per call: the channel that issued it, what it
        # sends again on a retry, the call's generation (a reused
        # controller's stale timers and retries must not touch the next
        # call), the attempts' correlation ids in flight, and _taken once
        # a path won the call (client_dispatch)
        self._owner_channel = None
        self._service_name = ""
        self._method_name = ""
        self._request_bytes = b""
        self._request_att = b""
        self._call_seq = 0
        self._issue_seq = 0
        # the socket of the attempt in flight (the pluck lane reads it)
        self._issue_socket = None
        self._attempt_cids: List[int] = []
        self._taken = False
        # backend stats (rpc/backend_stats.py), attempt spans, the
        # cluster channel's selection bookkeeping, the backup's evidence
        # and the sends shed on this side against a cached threshold
        self._bs_attempts: List = []
        self._bs_resp_bytes = 0
        self._attempt_spans: List = []
        self._lb_lock = threading.Lock()
        self._lb_swept_n: Optional[int] = None
        self._lb_fed: List = []
        self._hedge_decision = None
        self._adm_local_sheds = 0

    def __getattr__(self, name):
        # only names missing from the instance get here
        if name in _LAZY_ATTACHMENTS:
            return self.__dict__.setdefault(name, IOBuf())
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def create_progressive_attachment(
            self, content_type: str = "application/octet-stream"):
        """An HTTP chunked response body, fed after the handler returns."""
        self._progressive = ProgressiveAttachment(content_type)
        return self._progressive

    def session_local_data(self):
        """The handler's object from ``ServerOptions.
        session_local_data_factory`` (None without one)."""
        return self._session_local

    def failed(self) -> bool:
        return self.error_code != berr.OK

    def set_failed(self, code: int, text: str = "") -> None:
        self.error_code = code
        self.error_text = text or berr.errno_name(code)

    def latency_us(self) -> int:
        return max(0, self.end_us - self.start_us)

    def retried_count(self) -> int:
        """Retries this call made (Controller::retried_count)."""
        return self.current_try


    def set_deadline(self, timeout_ms: Optional[float],
                     start_ns: Optional[int] = None) -> None:
        """Arm (or clear, with None or <= 0) the deadline budget."""
        if not timeout_ms or timeout_ms <= 0:
            self._deadline_ns = None
            return
        start = time.monotonic_ns() if start_ns is None else start_ns
        self._deadline_ns = start + int(timeout_ms * 1e6)

    def remaining_ms(self) -> Optional[float]:
        """Milliseconds left in the deadline budget, clamped at 0.0;
        None when no deadline applies."""
        dl = self._deadline_ns
        if dl is None:
            return None
        return max(0.0, (dl - time.monotonic_ns()) / 1e6)

    def deadline_expired(self) -> bool:
        dl = self._deadline_ns
        return dl is not None and time.monotonic_ns() >= dl

    # ---------------------------------------------------- client completion
    def _reset_for_call(self) -> None:
        """Per-call client state, reset at the top of each call so that a
        controller can be reused (brpc_tpu/rpc/controller.py:287): a
        stale done event would let ``join`` return at once with the last
        call's response, and a stale trace would chain the new call onto
        the last call's tree."""
        self.error_code, self.error_text = berr.OK, ""
        with self._arb_lock:
            self._completed = False
            self._finalized = False
            self._done_event = None
            self._taken = False
            self._attempt_cids = []
        self.end_us = 0
        self._deadline_ns = None
        self._client_span = None
        self.trace_id = self.span_id = 0
        self.response = None
        self.__dict__.pop("response_attachment", None)
        self.response_device_arrays = []
        self.stream = None
        self._complete_hooks.clear()
        self.collective_lowered = False
        for name in self._filled_by_channel:
            setattr(self, name, None)
        self._filled_by_channel = []
        self.current_try = 0
        self.used_backup = False
        self.responded_server = None
        self.request_priority = 0
        self._issue_seq = 0
        self._issue_socket = None
        self.__dict__.pop("_pending_deadline", None)
        self._bs_attempts = []
        self._bs_resp_bytes = 0
        self._attempt_spans = []
        self._hedge_decision = None
        self._adm_local_sheds = 0
        with self._lb_lock:
            self.tried_servers = []
            self._lb_swept_n = None
            self._lb_fed = []

    def _add_complete_hook(self, hook: Callable) -> None:
        """``hook(cntl)`` runs at completion; at once if the call has
        already completed."""
        with self._arb_lock:
            if not self._completed:
                self._complete_hooks.append(hook)
                return
        hook(self)

    def _complete(self) -> None:
        """The one completion point of a client call. Its caller has taken
        the call (``client_dispatch.take_call``) or never registered it."""
        with self._arb_lock:
            self._completed = True
            if not self._taken:
                take_controller(self)   # completed before any attempt
        self.end_us = time.monotonic_ns() // 1000
        ch = self._owner_channel
        rb = ch._retry_budget if ch is not None else None
        if rb is not None:
            # a success re-earns a fraction of a token; a deadline that
            # fired here with no server answering drains one (a stalled
            # cluster whose sockets stay up gives exactly these). Other
            # failures drained where the channel judged them
            if not self.error_code:
                rb.refill()
            elif self.error_code == berr.ERPCTIMEDOUT \
                    and self.responded_server is None:
                rb.drain()
        if self._timer_ids:
            for tid in self._timer_ids:
                global_timer().unschedule(tid)
            self._timer_ids.clear()
        if self.failed() and self.stream is not None:
            # a stream set up on a failed call must not stay registered
            self.stream.close()
        for hook in self._complete_hooks:
            try:
                hook(self)
            except Exception:   # boundary: completion must reach joiners
                pass
        cb = self._done_cb
        # joiners see completion only after end_us, the timers and the
        # hooks; the event is read under the lock join creates it under,
        # so a joiner either sees _finalized or its event is set here
        with self._arb_lock:
            self._finalized = True
            ev = self._done_event
        if ev is not None:
            ev.set()
        if cb is not None:
            cb(self)

    def start_cancel(self) -> None:
        """Cancel an in-flight client call (Controller::StartCancel): it
        completes now with ECANCELED and its late response is dropped. A
        call that has completed, or was never issued, is left as it is.
        The server may still run the handler."""
        if not self.start_us:
            return
        if take_controller(self):
            self.set_failed(berr.ECANCELED, "canceled by caller")
            self._complete()

    def _join_event(self) -> Optional[FiberEvent]:
        """None once the call is finalized; else the done event, created
        under the lock that ``_complete`` reads it under."""
        if self._finalized:
            return None
        with self._arb_lock:
            if self._finalized:
                return None
            if self._done_event is None:
                self._done_event = FiberEvent()
            return self._done_event

    def join(self, timeout_s: Optional[float] = None) -> bool:
        """Block the calling thread until the call has completed; False
        if ``timeout_s`` passed first. A thread that is not a fiber
        worker plucks its response off the socket first."""
        pre = self.__dict__.pop("_pluck_preclaimed", None)
        try:
            sock = self._issue_socket
            if pre is not None and pre is not sock:
                # a retry moved the call: the old claim holds that
                # socket's reads off
                pre.pluck_release()
                pre = None
            if not self._finalized and sock is not None \
                    and not sock.failed and current_group() is None \
                    and not (sock._ring_attached
                             and self.__dict__.get("_event_join")):
                now = time.monotonic()
                end = now + (timeout_s if timeout_s is not None
                             else 86400.0)
                pend = self.__dict__.get("_pending_deadline")
                if pend is not None and \
                        not client_dispatch.lazy_pluck_begin(sock, self):
                    self._arm_lazy_deadline()
                    pend = None
                dl = self._deadline_ns
                # past the deadline the timer (or, lazily, this thread)
                # completes the call
                pluck_end = end if dl is None else min(end, dl / 1e9)
                pf = self.__dict__.get("_pluck_fast")
                fast = None if pf is None else \
                    (pf[0], self.correlation_id, pf[1],
                     process_response_fast)
                claimed = pre is sock
                pre = None
                try:
                    done = sock.pluck_until(lambda: self._finalized,
                                            pluck_end, fast=fast,
                                            preclaimed=claimed)
                except Exception:       # the lane is a way, not a verdict
                    log.exception("pluck lane failed; waiting instead")
                    done = self._finalized
                finally:
                    if pend is not None:
                        client_dispatch.lazy_pluck_end(sock, self)
                if not done and pend is not None and \
                        self.__dict__.get("_pending_deadline") is pend \
                        and time.monotonic() >= pend[2]:
                    # the pluck reached the deadline: the timeout path,
                    # as the timer would take it
                    self.__dict__.pop("_pending_deadline", None)
                    pend[0]._on_timeout(self, pend[1])
                    done = self._finalized
                if done:
                    self.__dict__.pop("_pending_deadline", None)
                    return True
                if timeout_s is not None:
                    timeout_s = max(0.0, end - time.monotonic())
        finally:
            if pre is not None:
                pre.pluck_release()
        # off the pluck lane (a fiber caller, a failed socket, an
        # escalation): the deadline needs its timer
        self._arm_lazy_deadline()
        ev = self._join_event()
        return True if ev is None else ev.wait_pthread(timeout_s)

    def _arm_lazy_deadline(self) -> None:
        """Arm the timer of a deadline left to the plucker; from here on
        the deadline is enforced as an eager one is. Any thread may call
        it: the pending deadline is taken once."""
        pend = self.__dict__.pop("_pending_deadline", None)
        if pend is None or self._finalized:
            return
        ch, seq, dl = pend
        ch._arm(self, max(0.0, dl - time.monotonic()) * 1e3,
                lambda: ch._on_timeout(self, seq))

    async def join_async(self, timeout_s: Optional[float] = None) -> bool:
        """Park the calling fiber until the call has completed; False if
        ``timeout_s`` passed first."""
        self._arm_lazy_deadline()       # a fiber cannot pluck
        ev = self._join_event()
        return True if ev is None else await ev.wait(timeout_s)

    # ------------------------------------------------- server-side cancel
    def is_canceled(self) -> bool:
        """Server side (Controller::IsCanceled): True once the client's
        connection has failed."""
        s = self._server_socket
        return bool(s is not None and s.failed)

    def notify_on_cancel(self, callback: Callable[[], None]) -> None:
        """Server side (Controller::NotifyOnCancel): run ``callback`` when
        the client's connection fails; at once if it has. The subscription
        ends with the request (``_drop_cancel_subs``)."""
        s = self._server_socket
        if s is None:
            return
        wrapped = lambda _sock: callback()   # noqa: E731
        self._cancel_subs.append((s, wrapped))
        s.on_failed(wrapped)

    def _drop_cancel_subs(self) -> None:
        """At the end of a server request: it must not hear of later
        failures of its connection."""
        subs, self._cancel_subs = self._cancel_subs, []
        for s, cb in subs:
            s.off_failed(cb)
