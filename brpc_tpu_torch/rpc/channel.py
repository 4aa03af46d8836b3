"""Channel: tpu_std calls over one client Socket, with streams, retries
and backup requests (the port of brpc_tpu/rpc/channel.py).

The channel dials with ``create_client_socket``: the connection is a
consumer of the process's event dispatcher, and its input goes through an
``InputMessenger`` to ``client_dispatch.process_response``, in place on
the dispatcher thread. Calls from many threads share the socket.
``call`` issues the call's first attempt, arms its deadline timer (and
its backup timer) on the fiber timer and returns the controller;
``call_sync`` joins it on the calling thread, ``call_async`` parks the
calling fiber, and ``done`` runs where the call completes. Exactly one
of a response, the deadline timer, the failure of an attempt that may
not retry and ``Controller.start_cancel`` completes a call
(``Controller._complete``); a late response is dropped. The request meta
carries ``timeout_ms`` so the server can shed work the client no longer
waits for; inside a handler that is at most the parent request's
remaining budget (brpc_tpu/rpc/channel.py:411-448).

Attempts (brpc_tpu/rpc/channel.py:599-1311). Each attempt registers
under a correlation id of its own. A failed attempt, a transport failure
(the connect, the write, the socket's end) or an error the server
answered, goes to ``_on_attempt_verdict``: while tries remain
(``max_retry``, 3 by default), the retry policy allows the error (by
default EFAILEDSOCKET, ECLOSE, ELOGOFF, ELIMIT, EOVERCROWDED and
EPRIORITYSHED), the deadline is not spent and the retry budget is not
throttled, the attempt ends and a new one is issued, on a fiber, after
the policy's backoff; else the error completes the call. A verdict for an
attempt that has ended does nothing. The deadline is final: once it
fires, no attempt follows. ``backup_request_ms`` sends a second attempt
when the first has not answered in that time, unless the budget is
throttled or even the fastest backend's recent p50 would not fit in the
remaining deadline; the first response completes the call.

The reject discipline: a shed (ELIMIT, EOVERCROWDED, EPRIORITYSHED, and
a deadline shed a server answered) drains no retry token, and a naming
list that is empty (ENAMINGEMPTY) drains none either
(brpc_tpu/rpc/channel.py:107-112). Servers in overload stamp their
admission threshold on their responses; the channel keeps it by
(backend, service) for ``ADM_THRESHOLD_TTL_S`` and fails a send below it
here, without writing it (``client_priority_shed``), except one send a
backend every ``ADM_PROBE_INTERVAL_S``, which goes through to see the
threshold relax. Every attempt opens a record in its backend's stat
cell (``backend_stats.py``, ``/backends``).

Auth and compression (brpc_tpu/rpc/channel.py:463-481): the credential
of ``ChannelOptions.auth`` (``generate_credential()``) or
``auth_token`` rides every request's meta, so a new connection after a
failover carries it too. A controller's ``compress_type`` compresses
the request once, before the first attempt (``rpc/compress.py``), and
the response comes back decompressed.

``call(..., stream_options=...)`` sets a Stream up on the call
(brpc_tpu/rpc/channel.py:482-485, :811-819): the stream is registered
before the request is written, so its frames are delivered even when
they overtake the response. The response binds the stream to the peer's
id and to the socket, whose failure then closes it; a failed call closes
it.

``call(..., request_device_arrays=[t, ...])`` sends tensors with
the request (brpc_tpu/rpc/channel.py:391-394, :820-850). On a connection
with a device lane (mem, cuda, cudad, ici) they ride the lane, and the
batch and the request frame are written as an adjacent pair under the
socket's ``lane_lock``, since the receiver pairs batches with frames by
order; on tcp they are copied to the host and go inline in the frame.
The response's tensors come back in ``cntl.response_device_arrays``.
``device_lane_kind()`` names the lane of the channel's connection.

Under the ``rpcz_enabled`` flag a call gets a client span
(brpc_tpu/rpc/channel.py:487, :876; client_dispatch.py:137-150): its
trace and span ids ride the request meta (fields 8-9), ``write_done_us``
is stamped when the first write returns, ``first_byte_us`` at the
response's cut and ``parse_done_us`` once it is processed, and the span
is finished when the call ends. Each attempt gets a child span, kept
when the call made more than one.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.butil.flags import flag
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.fiber import global_control
from brpc_tpu_torch.fiber.timer import global_timer
from brpc_tpu_torch.protocol import tpu_std
from brpc_tpu_torch.transport.input_messenger import InputMessenger
from brpc_tpu_torch.transport.socket import Socket, create_client_socket

from . import admission
from . import backend_stats as _bs
from . import client_dispatch
from . import errno_codes as berr
from . import retry_policy as _retry
from .compress import compress
from . import span as _span
from .controller import Controller
from .server_dispatch import current_serving_controller
from .stream import Stream, StreamOptions

_messenger: Optional[InputMessenger] = None
# the longest an ici:// dial waits for the peer's hello
_HELLO_TIMEOUT_S = 10.0

# retries and backups not issued because the call's deadline was spent
nretry_suppressed = Adder()
# retries and backups not issued because the retry budget was throttled
nretry_throttled = Adder()
# backups not armed: the remaining deadline sat under the fastest
# backend's recent p50, so the backup could not win
nhedge_suppressed = Adder()
# sends failed here against a backend's cached admission threshold
nclient_priority_shed = Adder()

# the admission-threshold cache: an entry lives this long, and one send
# below it goes through every probe interval to see it relax
ADM_THRESHOLD_TTL_S = 5.0
ADM_PROBE_INTERVAL_S = 0.25

# failures that drain no retry token: the sheds cost the server
# microseconds at its door, and an empty naming list burns nothing
_NO_DRAIN_CODES = frozenset(_bs.REJECT_CODES) | {berr.ENAMINGEMPTY}

_chan_seq = itertools.count(1)


def expose_channel_vars() -> None:
    """The client counters in /vars (``Server.start``: exposing again
    survives a test's ``unexpose_all``)."""
    nretry_suppressed.expose("retry_suppressed_budget")
    nretry_throttled.expose("retry_throttled")
    nhedge_suppressed.expose("hedge_suppressed_budget")
    nclient_priority_shed.expose("client_priority_shed")


def _join_budget(cntl: Controller) -> Optional[float]:
    """How long a joiner waits: the deadline timer ends the call first,
    so the slack only bounds a joiner whose call nothing completes."""
    return None if not cntl.timeout_ms else cntl.timeout_ms / 1e3 + 5.0


def _client_messenger() -> InputMessenger:
    global _messenger
    if _messenger is None:
        _messenger = InputMessenger()
    return _messenger


@dataclass
class ChannelOptions:
    """The options of brpc_tpu/rpc/channel.py:131-188 that the port has:
    the timeout, the retries (``max_retry``, ``retry_policy``,
    ``retry_budget``, ``budget_group``), ``backup_request_ms``, the
    credential (``auth_token``, or an ``Authenticator`` in ``auth``,
    which wins), the channel's ``name`` on the pages, and a
    ClusterChannel's ``app_health_check`` and ``naming_wait_s``."""
    timeout_ms: Optional[float] = 1000.0
    # retries after the first attempt (Controller.max_retry overrides)
    max_retry: int = 3
    # a second attempt after this many ms without a response (None: off)
    backup_request_ms: Optional[float] = None
    # a RetryPolicy, a callable(Controller) -> bool, or None (default)
    retry_policy: Optional[Any] = None
    # a RetryBudget, True (100 tokens, 0.1 a success) or None (none)
    retry_budget: Optional[Any] = None
    # channels of one group share one RetryBudget, sized by the first
    budget_group: str = ""
    # the credential every request carries; an Authenticator in auth
    # (rpc/auth.py) wins over auth_token
    auth_token: str = ""
    auth: Optional[Any] = None
    # the channel's name on /backends and /lb_trace ("" = "channel-N";
    # a ClusterChannel's is its naming url)
    name: str = ""
    # ClusterChannel only: a callable(EndPoint) -> bool that must pass
    # before a dead server is revived (rpc_health_check), and how long
    # the constructor waits for the first server list
    app_health_check: Optional[Any] = None
    naming_wait_s: float = 5.0


class Channel:
    lb_name = None      # the /backends header; ClusterChannel's is its LB

    def __init__(self, address: Optional[str] = None,
                 options: Optional[ChannelOptions] = None):
        self.address = address
        self.endpoint = str2endpoint(address) if address else None
        self.options = options or ChannelOptions()
        self._stats_name = self.options.name or self._default_stats_name()
        _bs.global_stats().register_channel(self._stats_name, self)
        if self.options.budget_group:
            self._retry_budget = _retry.shared_retry_budget(
                self.options.budget_group, self.options.retry_budget)
        else:
            self._retry_budget = _retry.RetryBudget.resolve(
                self.options.retry_budget)
        self._policy = _retry.resolve(self.options.retry_policy)
        # (backend key, service) -> [threshold, last seen, last probe]:
        # fed by responses, read by the issue path; one truthiness check
        # a call while empty
        self._adm_cache: dict = {}
        self._adm_sweep = 0.0
        self._bs_cells: dict = {}
        self._lock = threading.Lock()
        self._socket: Optional[Socket] = None
        self._closed = False

    def _default_stats_name(self) -> str:
        return f"channel-{next(_chan_seq)}"

    @property
    def stats_name(self) -> str:
        """This channel's row key on /backends and /lb_trace."""
        return self._stats_name

    # ---------------------------------------------------------- connection
    def _dial(self, ep) -> Socket:
        s = create_client_socket(
            ep, on_input=_client_messenger().on_new_messages)
        # an ici:// dial completes with the peer's hello (the QP
        # bring-up): the first batch then goes, and is counted, on the
        # lane it really takes
        wait_hello = getattr(s.conn, "wait_hello", None)
        if wait_hello is not None and not wait_hello(_HELLO_TIMEOUT_S):
            s.set_failed(ConnectionError("no hello from the peer"))
            raise ConnectionError(
                f"no hello from {ep} within {_HELLO_TIMEOUT_S} s")
        return s

    def _get_socket(self) -> Socket:
        with self._lock:
            if self._closed:
                raise ConnectionError("channel closed")
            if self.endpoint is None:
                raise ConnectionError("channel has no address")
            s = self._socket
            if s is None or s.failed:
                s = self._dial(self.endpoint)
                s.on_failed(self._on_socket_failed)
                self._socket = s
            return s

    @staticmethod
    def _on_socket_failed(socket: Socket) -> None:
        """Every attempt still waiting on ``socket`` fails (and may retry
        on a new socket); attempts on a newer socket are not its
        business."""
        client_dispatch.fail_calls(socket, berr.EFAILEDSOCKET,
                                   "connection closed")

    def device_lane_kind(self) -> Optional[str]:
        """The device lane of this channel's connection (``loopback-d2d``,
        ``staged-dcn``; on ici:// ``local-d2d``, ``cuda-ipc`` or
        ``staged``, from the peer's hello), or None without one; dials
        if needed."""
        try:
            conn = self._get_socket().conn
        except OSError:
            return None
        if not conn.supports_device_lane:
            return None
        return conn.lane_kind

    # ---------------------------------------------------------------- call
    def call(self, service: str, method: str, request: bytes = b"",
             cntl: Optional[Controller] = None,
             done: Optional[Callable[[Controller], None]] = None,
             request_device_arrays: Optional[List] = None,
             stream_options: Optional[StreamOptions] = None) -> Controller:
        """Begin one call and return its controller at once
        (brpc_tpu/rpc/channel.py:391). Wait with ``cntl.join()`` on a
        thread or ``await cntl.join_async()`` in a fiber, or pass
        ``done``: ``done(cntl)`` runs where the call completes, most
        often in place on the event dispatcher as the response is
        processed, else on the timer thread, on a fiber that issued a
        retry, on the thread that saw the socket fail, or in this call
        when it completes before returning. ``done`` must not block.

        Inside a handler the call inherits the request being served
        (``current_serving_controller``): its timeout shrinks to the
        parent's remaining budget, it joins the parent's trace and takes
        its priority, and a parent whose budget is spent fails it with
        ERPCTIMEDOUT before any socket work."""
        cntl = cntl or Controller()
        if cntl.start_us:
            cntl._reset_for_call()      # a reused controller
        cntl.start_us = time.monotonic_ns() // 1000
        cntl._call_seq += 1
        cntl._done_cb = done
        if cntl.timeout_ms is None:
            cntl.timeout_ms = self.options.timeout_ms
        parent = current_serving_controller()
        if parent is not None and parent is not cntl:
            if parent.trace_id and not cntl.trace_id:
                cntl.trace_id = parent.trace_id
                cntl.span_id = parent.span_id
            if parent.request_priority and not cntl.request_priority:
                cntl.request_priority = parent.request_priority
            rem = parent.remaining_ms()
            if rem is not None:
                if rem <= 0.0:
                    cntl.set_failed(berr.ERPCTIMEDOUT,
                                    "parent request's deadline budget "
                                    "exhausted before nested call")
                    cntl._complete()
                    return cntl
                if not cntl.timeout_ms or cntl.timeout_ms > rem:
                    cntl.timeout_ms = rem
        if cntl.timeout_ms:
            cntl._deadline_ns = time.monotonic_ns() + int(
                cntl.timeout_ms * 1e6)
        if cntl.max_retry is None:
            cntl.max_retry = self.options.max_retry
            cntl._filled_by_channel.append("max_retry")
        if cntl.backup_request_ms is None and \
                self.options.backup_request_ms is not None:
            cntl.backup_request_ms = self.options.backup_request_ms
            cntl._filled_by_channel.append("backup_request_ms")
        if not cntl.auth_token:
            cntl.auth_token = (self.options.auth.generate_credential()
                               if self.options.auth is not None
                               else self.options.auth_token)
        cntl.request_device_arrays = list(request_device_arrays or ())
        cntl._owner_channel = self
        cntl._service_name = service
        cntl._method_name = method
        cntl._request_bytes = bytes(request)
        if cntl.compress_type:
            # once here, not on every attempt; an unknown codec raises
            cntl._request_bytes = compress(cntl._request_bytes,
                                           cntl.compress_type)
        if stream_options is not None:
            # one stream a call, whichever attempt sets it up
            cntl.stream = Stream(stream_options)
        if flag("rpcz_enabled"):
            span = _span.start_client_span(cntl, service, method)
            span.request_size = len(request)
            cntl._client_span = span
            cntl._add_complete_hook(
                lambda c, s=span: (_span.finish_span(s, c),
                                   _span.settle_attempt_spans(c)))
        self._issue_rpc(cntl)
        # the deadline timer (HandleTimeout, final) and the backup timer.
        # The call may have completed during the issue: arming then would
        # pin the controller in the timer heap, so check before, and
        # after, since a completion on another thread can interleave
        seq = cntl._call_seq
        if cntl.timeout_ms:
            self._arm(cntl, cntl.timeout_ms,
                      lambda: self._on_timeout(cntl, seq))
        if cntl.backup_request_ms and cntl.backup_request_ms > 0:
            self._arm(cntl, cntl.backup_request_ms,
                      lambda: self._on_backup_timer(cntl, seq))
        return cntl

    @staticmethod
    def _arm(cntl: Controller, ms: float, fn) -> None:
        if cntl._completed:
            return
        tid = global_timer().schedule_after(ms / 1e3, fn)
        cntl._timer_ids.append(tid)
        if cntl._completed:
            global_timer().unschedule(tid)

    def call_sync(self, service: str, method: str, request: bytes = b"",
                  cntl: Optional[Controller] = None, **kw) -> Controller:
        """Send one request and wait for its response (``call`` +
        ``join``). Returns the controller: ``failed()`` / ``error_code`` /
        ``response``, the response's tensors in
        ``response_device_arrays``, and ``stream`` when ``stream_options``
        set a stream up."""
        cntl = self.call(service, method, request, cntl=cntl, **kw)
        cntl.join(_join_budget(cntl))
        return cntl

    async def call_async(self, service: str, method: str,
                         request: bytes = b"",
                         cntl: Optional[Controller] = None,
                         **kw) -> Controller:
        """``call`` + ``join_async``, for a fiber (channel.py:568)."""
        cntl = self.call(service, method, request, cntl=cntl, **kw)
        await cntl.join_async(_join_budget(cntl))
        return cntl

    # ------------------------------------------------------------- attempts
    def _pick_socket(self, cntl: Controller) -> Socket:
        """The socket of one attempt; ClusterChannel picks a backend."""
        return self._get_socket()

    def _issue_rpc(self, cntl: Controller) -> None:
        """One attempt (Controller::IssueRPC, controller.cpp:1010): pick a
        socket, register, write. A failure to connect or to write goes
        to the verdict like any other failed attempt."""
        cntl._issue_seq += 1
        try:
            sock = self._pick_socket(cntl)
        except (OSError, ValueError) as e:
            # a selection failure with an errno of its own (an empty
            # naming list) keeps it; a failed connect is EFAILEDSOCKET
            self._on_attempt_verdict(
                cntl, 0, getattr(e, "berrno", berr.EFAILEDSOCKET),
                f"connect failed: {e}")
            return
        if self._adm_cache and self._doomed_by_threshold(cntl, sock):
            # below this backend's threshold: the send is doomed there.
            # Failed here, before the record and the write, and handed to
            # the retries as the server's own shed would be
            nclient_priority_shed.add(1)
            cntl._adm_local_sheds += 1
            self._on_attempt_verdict(
                cntl, 0, berr.EPRIORITYSHED,
                f"below the admission threshold of {sock.remote_endpoint} "
                "(shed client-side)", failed_ep=sock.remote_endpoint)
            return
        cid = client_dispatch.register_call(cntl, sock)
        if not cid:
            return                      # the call was taken meanwhile
        cntl.remote_side = sock.remote_endpoint
        if _bs.enabled():
            self._bs_attempt_begin(cntl, sock)
        if cntl._client_span is not None:
            self._add_attempt_span(cntl, sock)
        meta = tpu_std.RpcMeta(
            request=tpu_std.RpcRequestMeta(
                service_name=cntl._service_name,
                method_name=cntl._method_name,
                timeout_ms=int(cntl.timeout_ms) if cntl.timeout_ms else 0,
                auth_token=cntl.auth_token,
                priority=cntl.request_priority),
            compress_type=cntl.compress_type,
            correlation_id=cid)
        if cntl.trace_id:
            meta.trace_id = cntl.trace_id
            meta.span_id = cntl.span_id
        if cntl.stream is not None:
            meta.stream_settings = tpu_std.StreamSettings(
                stream_id=cntl.stream.id)
        arrays = cntl.request_device_arrays
        try:
            wire, lane = tpu_std.pack_frame(
                meta, cntl._request_bytes, device_arrays=arrays,
                device_lane=bool(arrays) and sock.conn.supports_device_lane)
            if lane is None:
                written = sock.write(wire)
            else:
                # the batch and its frame, adjacent: Socket.write only
                # queues, and the peer learns of the bytes through the
                # dispatcher, so nothing of it runs under the lock
                with sock.lane_lock:
                    # the batch's device span is a child of the call's
                    sock.write_device_payload(lane,
                                              span=cntl._client_span)
                    written = sock.write(wire)
        except OSError as e:
            written = False
            sock.set_failed(e)
        except BaseException:
            # a tensor that cannot be sent (a failed copy, an unknown
            # dtype) fails loudly: no fallback. The call completes first,
            # so its stream and span do not stay behind; on the first
            # attempt the exception, not ``done``, tells the caller
            if client_dispatch.take_call(cid) is cntl:
                first = cntl._issue_seq == 1
                if first:
                    cntl._done_cb = None
                cntl.set_failed(berr.EREQUEST, "request not sent")
                cntl._complete()
                if not first:
                    return
            raise
        if not written or sock.failed:
            # the socket failed before or as the attempt was registered
            self._on_attempt_verdict(
                cntl, cid, berr.EFAILEDSOCKET,
                f"write failed: {sock.fail_reason}",
                failed_ep=sock.remote_endpoint)
            return
        span = cntl._client_span
        if span is not None and not span.write_done_us:
            # the first write queued the whole frame; most often the
            # kernel took it in the write itself
            span.write_done_us = time.monotonic_ns() // 1000

    def _policy_allows(self, cntl: Controller, code: int, text: str) -> bool:
        """The retry policy, shown the attempt's error through a view
        that cannot write the controller (retry_policy.h's DoRetry takes
        a const Controller*)."""
        try:
            return bool(self._policy.do_retry(_PolicyView(cntl, code, text)))
        except Exception:
            return False        # a broken policy must not loop retries

    def _budget_exhausted(self, cntl: Controller) -> bool:
        dl = cntl._deadline_ns
        return dl is not None and time.monotonic_ns() >= dl

    def _on_attempt_verdict(self, cntl: Controller, cid: int, code: int,
                            text: str, failed_ep=None,
                            responded: bool = False) -> None:
        """Attempt ``cid`` failed (0: an attempt that never registered; a
        pick, a connect, a client-side shed): retry, or complete the call
        with the error (OnVersionedRPCReturned's error branch,
        controller.cpp:634; brpc_tpu's ``_maybe_retry`` and, for errors a
        server answered, ``_retry_taken_call``). A verdict for an attempt
        that has ended, or a call that was taken, does nothing."""
        if self._adm_cache and code in (berr.EFAILEDSOCKET, berr.ECLOSE) \
                and failed_ep is not None:
            # the connection died: the threshold it brought describes a
            # process that may be gone, so a restarted backend starts
            # fresh
            epk = _bs.ep_key(failed_ep)
            for key in [k for k in list(self._adm_cache) if k[0] == epk]:
                self._adm_cache.pop(key, None)
        # the policy runs outside the lock: user code must not hold up
        # the timer thread, which takes the call under it
        allow = (cntl.current_try < (cntl.max_retry or 0)
                 and self._policy_allows(cntl, code, text))
        if allow and self._budget_exhausted(cntl):
            allow = False               # the deadline timer has the word
            nretry_suppressed.add(1)
        rb = self._retry_budget
        if allow and rb is not None and rb.throttled():
            allow = False
            nretry_throttled.add(1)
        with cntl._arb_lock:
            if cntl._taken or (cid and cid not in cntl._attempt_cids):
                return                  # ended, or another path won
            if allow:
                if cid:
                    client_dispatch.drop_attempt(cntl, cid)
                cntl.current_try += 1
            else:
                client_dispatch.take_controller(cntl)
        if rb is not None and not (
                _bs.is_reject(code, True) if responded
                else code in _NO_DRAIN_CODES):
            # once a verdict, after the check above: a second report of
            # the same dead socket must not spend a second token. A shed
            # a server answered (a deadline shed too) drains nothing
            rb.drain()
        if allow:
            self._on_attempt_failed(cntl, code, text, failed_ep)
            self._launch_retry(cntl, code, text)
            return
        if responded:
            cntl.responded_server = failed_ep
        cntl.set_failed(code, text)
        cntl._complete()

    def _launch_retry(self, cntl: Controller, code: int, text: str) -> None:
        """Issue the next attempt on a fiber (a connect may block; a
        verdict often runs on the dispatcher), after the policy's
        backoff, clamped to the deadline. A retry that finds the call
        taken, or the controller on a newer call, does nothing."""
        try:
            # current_try counts the new attempt already; the policy
            # wants the 0-based index of the one that failed
            backoff_s = float(self._policy.retry_backoff_s(_PolicyView(
                cntl, code, text, current_try=cntl.current_try - 1)) or 0.0)
        except Exception:
            backoff_s = 0.0             # a broken policy must not block
        dl = cntl._deadline_ns
        if backoff_s > 0.0 and dl is not None:
            backoff_s = min(backoff_s, max(
                0.0, (dl - time.monotonic_ns()) / 1e9 - 1e-3))
        seq = cntl._call_seq

        def reissue():
            if not cntl._taken and cntl._call_seq == seq:
                self._issue_rpc(cntl)

        def spawn():
            global_control().spawn(reissue, name="retry_reissue")

        if backoff_s > 0.0:
            global_timer().schedule_after(backoff_s, spawn)
        else:
            spawn()

    def _on_timeout(self, cntl: Controller, seq: int) -> None:
        """The deadline timer (brpc_tpu/rpc/channel.py:1246): it ends the
        call, whichever attempt is in flight, unless another path took
        it first."""
        with cntl._arb_lock:
            taken = cntl._call_seq == seq and \
                client_dispatch.take_controller(cntl)
        if taken:
            cntl.set_failed(berr.ERPCTIMEDOUT,
                            f"deadline {cntl.timeout_ms}ms exceeded")
            cntl._complete()

    def _hedge_p50_ms(self) -> Optional[float]:
        """The fastest backend's recent p50 (ms) in this channel's cells:
        a backup that cannot finish inside the remaining budget is pure
        load. None before any telemetry."""
        best = None
        for _key, cell in list(self._bs_cells.values()):
            p = cell.recent_p50_us()
            if p > 0.0 and (best is None or p < best):
                best = p
        return None if best is None else best / 1e3

    def _on_backup_timer(self, cntl: Controller, seq: int) -> None:
        """Send a second attempt; the first response wins
        (backup_request_ms, controller.cpp:331). Not armed when the
        deadline is spent, the budget throttled, or the remaining budget
        under the fastest backend's p50; the loser is swept as abandoned
        when the call completes. Issued on a fiber: the timer thread
        fires every call's deadline and must not wait on a connect."""
        if cntl._taken or cntl._call_seq != seq:
            return
        if self._budget_exhausted(cntl):
            nretry_suppressed.add(1)
            return
        rb = self._retry_budget
        if rb is not None and rb.throttled():
            nretry_throttled.add(1)
            return
        dl = cntl._deadline_ns
        remaining_ms = None if dl is None \
            else (dl - time.monotonic_ns()) / 1e6
        p50_ms = self._hedge_p50_ms()
        if remaining_ms is not None and p50_ms is not None \
                and remaining_ms < p50_ms:
            nhedge_suppressed.add(1)
            return
        cntl.used_backup = True
        cntl._hedge_decision = (remaining_ms, p50_ms)

        def issue():
            if not cntl._taken and cntl._call_seq == seq:
                self._issue_rpc(cntl)
        global_control().spawn(issue, name="backup_request")

    # ------------------------------------------- admission-threshold cache
    def _track_admission_threshold(self, ep, service: str,
                                   threshold: int) -> None:
        """A response brought its server's admission threshold (0: none,
        the server is calm): keep it by (backend, service)."""
        key = (_bs.ep_key(ep), service)
        now = time.monotonic()
        if threshold:
            ent = self._adm_cache.get(key)
            if ent is None:
                self._adm_cache[key] = [threshold, now, now]
            else:
                ent[0], ent[1] = threshold, now
        else:
            self._adm_cache.pop(key, None)
        if now - self._adm_sweep > ADM_THRESHOLD_TTL_S:
            # at most once a TTL: an entry nobody calls any more would
            # keep every call of the channel paying for the lookups
            self._adm_sweep = now
            for k in [k for k, e in list(self._adm_cache.items())
                      if now - e[1] > ADM_THRESHOLD_TTL_S]:
                self._adm_cache.pop(k, None)

    def _client_user_slot(self, cntl: Controller, sock) -> int:
        """This call's user slot as the server computes it
        (brpc_tpu/rpc/channel.py:1123-1133): the hash of the auth token
        when the request carries one, else that of the connection's
        client address (this socket's ``local_endpoint`` is the server's
        ``remote_endpoint``)."""
        if cntl.auth_token:
            return admission.user_slot(cntl.auth_token)
        return admission.cached_socket_slot(sock, sock.local_endpoint)

    def _doomed_by_threshold(self, cntl: Controller, sock) -> bool:
        """True: this send's level is below the backend's threshold and
        no probe is due. The level's user slot is the one the server
        computes (``_client_user_slot``)."""
        key = (_bs.ep_key(sock.remote_endpoint), cntl._service_name)
        ent = self._adm_cache.get(key)
        if ent is None:
            return False
        now = time.monotonic()
        if now - ent[1] > ADM_THRESHOLD_TTL_S:
            self._adm_cache.pop(key, None)
            return False
        level = admission.compose_level(cntl.request_priority,
                                        self._client_user_slot(cntl, sock))
        if level >= ent[0]:
            return False
        if now - ent[2] >= ADM_PROBE_INTERVAL_S:
            ent[2] = now                # the probe goes through
            return False
        return True

    # ------------------------------------------------- backend telemetry
    def _bs_cell(self, ep) -> tuple:
        """(backend key, cell) of ``ep``, cached by the channel."""
        entry = self._bs_cells.get(ep)
        if entry is None:
            key = _bs.ep_key(ep)
            entry = (key, _bs.global_stats().cell(self._stats_name, key))
            self._bs_cells[ep] = entry
        return entry

    def _bs_attempt_begin(self, cntl: Controller, sock) -> None:
        key, cell = self._bs_cell(sock.remote_endpoint)
        cell.on_start(len(cntl._request_bytes))
        _bs.attempt_start(cntl, [key, time.monotonic_ns(), cell],
                          _bs.call_complete)

    def _add_attempt_span(self, cntl: Controller, sock) -> None:
        sp = _span.start_attempt_span(
            cntl._client_span, cntl._service_name, cntl._method_name,
            cntl._issue_seq, self._bs_cell(sock.remote_endpoint)[0],
            backup=cntl.used_backup)
        dec = cntl._hedge_decision
        if cntl.used_backup and dec is not None:
            r, p = dec
            sp.annotate("hedge_armed remaining_ms=%s p50_ms=%s" % (
                "inf" if r is None else round(r, 2),
                "na" if p is None else round(p, 2)))
        with cntl._arb_lock:
            cntl._attempt_spans.append(sp)

    def _close_attempt_span(self, cntl: Controller, code: int,
                            key: Optional[str]) -> None:
        """The failed attempt's span takes its error: the open span of
        its backend (with a backup in flight the newest is another's),
        else the newest open one."""
        now = time.monotonic_ns() // 1000
        with cntl._arb_lock:
            victim = None
            for sp in reversed(cntl._attempt_spans):
                if sp.end_us:
                    continue
                if victim is None:
                    victim = sp
                if key is not None and sp.remote_side == key:
                    victim = sp
                    break
            if victim is not None:
                victim.end_us = now
                victim.error_code = code

    def _on_attempt_failed(self, cntl: Controller, code: int, text: str,
                           failed_ep=None) -> None:
        """An attempt failed and the call goes on: its stat-cell record
        and its span settle here (ClusterChannel adds the balancer's and
        the breaker's feedback)."""
        ep = failed_ep or self.endpoint
        if _bs.enabled():
            _bs.attempt_error(self._stats_name, cntl, code, ep)
        self._close_attempt_span(cntl, code,
                                 _bs.ep_key(ep) if ep is not None else None)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            s, self._socket = self._socket, None
        if s is not None:
            s.set_failed(ConnectionError("channel closed"))


class _PolicyView:
    """What a RetryPolicy sees: the attempt's error, every other field
    read through to the controller, no writes (so a policy cannot race
    the completion paths). ``current_try`` may be pinned: the backoff
    runs after the count moved on to the new attempt."""

    __slots__ = ("_cntl", "error_code", "error_text", "current_try")

    def __init__(self, cntl, code: int, text: str,
                 current_try: Optional[int] = None):
        object.__setattr__(self, "_cntl", cntl)
        object.__setattr__(self, "error_code", code)
        object.__setattr__(self, "error_text", text)
        object.__setattr__(self, "current_try",
                           cntl.current_try if current_try is None
                           else current_try)

    def failed(self) -> bool:
        return self.error_code != 0

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_cntl"), name)

    def __setattr__(self, name, value):
        raise AttributeError("retry policies see a read-only controller")
