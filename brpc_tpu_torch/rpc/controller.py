"""Per-call state shared by client and server: the error, the deadline
budget, the response, the call's tensors, the call's stream or
progressive body, and its trace (the port of brpc_tpu/rpc/controller.py
without the retry, backup, auth and compression state, and without the
sync pluck lane).

Client side, a call has one completion point, ``_complete``
(brpc_tpu/rpc/controller.py:428): exactly one of the response, the
deadline timer, the socket's failure and ``start_cancel`` takes the call
from the registry and completes it. ``_complete`` unschedules the call's
timers, runs its complete hooks, sets the done event under the lock that
``join`` creates it under, then runs the ``done`` callback. Waiters block
(``join``) or park their fiber (``join_async``) on that event, which is
created only when a waiter arrives before completion.

Server side, ``is_canceled`` and ``notify_on_cancel`` follow the
client's connection (``Socket.on_failed``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from brpc_tpu_torch.fiber.sync import FiberEvent
from brpc_tpu_torch.fiber.timer import global_timer

from . import errno_codes as berr
from .client_dispatch import take_call
from .progressive import ProgressiveAttachment


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

    def create_progressive_attachment(
            self, content_type: str = "application/octet-stream"):
        """An HTTP chunked response body, fed after the handler returns."""
        self._progressive = ProgressiveAttachment(content_type)
        return self._progressive

    def failed(self) -> bool:
        return self.error_code != berr.OK

    def set_failed(self, code: int, text: str = "") -> None:
        self.error_code = code
        self.error_text = text or berr.errno_name(code)

    def latency_us(self) -> int:
        return max(0, self.end_us - self.start_us)

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
        self.end_us = 0
        self._deadline_ns = None
        self._client_span = None
        self.trace_id = self.span_id = 0
        self.response = None
        self.response_device_arrays = []
        self.stream = None
        self._complete_hooks.clear()
        self.collective_lowered = False

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
        self.end_us = time.monotonic_ns() // 1000
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
        if self.correlation_id == 0:
            return
        with self._arb_lock:
            taken = take_call(self.correlation_id) is self
        if taken:
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
        if ``timeout_s`` passed first."""
        ev = self._join_event()
        return True if ev is None else ev.wait_pthread(timeout_s)

    async def join_async(self, timeout_s: Optional[float] = None) -> bool:
        """Park the calling fiber until the call has completed; False if
        ``timeout_s`` passed first."""
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
