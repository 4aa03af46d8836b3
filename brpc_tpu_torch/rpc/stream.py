"""Streaming RPC: the port of brpc_tpu/rpc/stream.py (bRPC's stream.h,
SURVEY.md §2.6), without the native scan lane.

A stream is set up on an RPC: the client's request carries its stream
id in ``stream_settings``, the handler accepts (``stream_accept``) and
the response carries the server's id back. After that, bare stream
frames (meta with ``stream_settings`` alone) flow both ways on the same
connection under credit-based flow control:

- each side starts with ``initial_credits`` frames of send budget; a
  DATA frame (``frame_seq`` set) spends one;
- the receiver grants credits back every ``CREDIT_BATCH`` frames it has
  DELIVERED, so a consumer that stops draining stops the sender;
- the credits are a Butex: ``await stream.write(...)``, inside a fiber,
  parks on it until a credit comes (or the stream closes, which adds a
  sentinel of ``1 << 20`` credits so no writer parks again);
  ``write_nowait``, from any thread, fails at once.

Frames are delivered to ``on_received(stream, msg)`` in order by the
stream's own fiber ExecutionQueue, a batch at a time, never on the
dispatcher thread that parsed them; an ``on_received`` that returns an
awaitable is awaited there, so delivery stays serial. Remote closure (a
close frame, or the connection's end) happens exactly once and runs the
``on_close`` callbacks on the same queue, after the frames before it.

A stream writes through its connection's ``Socket.write``, which only
queues (``transport/socket.py``), and watches the socket's end through
``Socket.on_failed``.

A DATA frame may carry tensors (``write(payload, device_arrays=[...])``,
brpc_tpu/rpc/stream.py:126-188): its meta describes them, so it takes
the full-meta path, and they ride the connection's device lane when it
has one, inline otherwise; the receiver finds them, in order, in
``StreamMessage.device_arrays``. The lane batch and its frame are
written under the socket's ``lane_lock``, as a unary call's are: a
unary call on the same connection must not slip between them, or the
receiver pairs its batch with the stream's frame (brpc_tpu writes the
stream's pair without the lock).

Stream ids come from one registry per process, as the reference's
ResourcePool: frames name their stream by id whichever connection they
arrive on. Id 0 is invalid (proto3's default), and ids are not reused.
"""

from __future__ import annotations

import inspect
import itertools
import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch.fiber import (WAIT_TIMEOUT, Butex, ExecutionQueue,
                                  FiberEvent)
from brpc_tpu_torch.protocol import tpu_std

log = logging.getLogger("brpc_tpu_torch.rpc")

DEFAULT_CREDITS = 64
CREDIT_BATCH = 16       # grant credits back every K delivered frames
_CLOSED_CREDITS = 1 << 20   # added on closure: no writer parks again


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._streams: Dict[int, "Stream"] = {}

    def insert(self, stream: "Stream") -> int:
        with self._lock:
            sid = next(self._ids)
            self._streams[sid] = stream
            return sid

    def remove(self, sid: int) -> None:
        with self._lock:
            self._streams.pop(sid, None)

    def address(self, sid: int) -> Optional["Stream"]:
        return self._streams.get(sid)


_registry = _Registry()


@dataclass
class StreamMessage:
    """One delivered DATA frame."""
    payload: bytes
    attachment: bytes = b""
    device_arrays: List = field(default_factory=list)


class StreamOptions:
    def __init__(self, on_received: Optional[Callable] = None,
                 initial_credits: int = DEFAULT_CREDITS):
        self.on_received = on_received
        self.initial_credits = initial_credits


class Stream:
    def __init__(self, options: Optional[StreamOptions] = None):
        self.options = options or StreamOptions()
        self.id: int = _registry.insert(self)
        self.peer_id: int = 0
        self.conn = None                # the Socket frames go out on
        self._subscribed = None         # the Socket whose end we watch
        self.closed = False
        self.remote_closed = False
        self._frame_seq = 0
        self._send_lock = threading.Lock()  # seq order == wire order
        self._credits = Butex(self.options.initial_credits)
        self._grant_lock = threading.Lock()
        self._pending_grants = 0
        self._close_lock = threading.Lock()
        self._close_cbs: List[Callable] = []
        self._established = FiberEvent()
        self._recv_q = ExecutionQueue(self._deliver, name=f"stream-{self.id}")

    def _on_established(self) -> None:
        """The peer id is known (client: the response arrived; server:
        accept). Grants held back while it was unknown go out now."""
        self._established.set()
        with self._grant_lock:
            grant = 0
            if self._pending_grants >= CREDIT_BATCH:
                grant, self._pending_grants = self._pending_grants, 0
        if grant and not self.closed:
            self._send_frame(b"", credits=grant, data=False)

    # --------------------------------------------------------------- write
    def _dead(self) -> bool:
        return self.closed or self.remote_closed

    async def write(self, payload: bytes = b"",
                    timeout_s: Optional[float] = 10.0,
                    device_arrays: Optional[List] = None) -> bool:
        """Send one DATA frame from a fiber, parking first until the
        stream is established, then on the credit butex until a credit
        comes. False when the stream closed or a wait timed out."""
        if self._dead():
            return False
        if self.peer_id == 0:
            # a frame to stream id 0 would be dropped and its credit lost
            if not await self._established.wait(timeout_s) or self._dead():
                return False
        while True:
            # closure adds a credit sentinel; test closed BEFORE spending
            # one, or a dead stream would "send" on sentinel credits
            if self._dead():
                return False
            v = self._credits.value
            if v > 0 and self._credits.compare_exchange(v, v - 1):
                break
            if await self._credits.wait(expected=0, timeout_s=timeout_s) \
                    == WAIT_TIMEOUT:
                return False
        return self._send_frame(payload, device_arrays=device_arrays)

    def write_nowait(self, payload: bytes = b"",
                     device_arrays: Optional[List] = None) -> bool:
        """Send one DATA frame if a credit is at hand; False at once when
        out of credits, not yet established, or closed. Any thread."""
        if self._dead() or self.peer_id == 0:
            return False
        while True:
            v = self._credits.value
            if v <= 0:
                return False
            if self._credits.compare_exchange(v, v - 1):
                break
        return self._send_frame(payload, device_arrays=device_arrays)

    def _send_frame(self, payload: bytes, close: bool = False,
                    credits: int = 0, data: bool = True,
                    device_arrays: Optional[List] = None) -> bool:
        conn = self.conn
        if conn is None:
            return False
        with self._send_lock:
            seq = 0
            if data:
                # frame_seq marks DATA frames (they spend a credit and are
                # delivered even when empty); grants and closes leave it 0
                self._frame_seq += 1
                seq = self._frame_seq
            # Socket.write only queues: it never parks this thread; on a
            # failed socket it is False, and the failure subscription
            # closes the stream
            if not device_arrays:
                return conn.write(tpu_std.pack_stream_frame(
                    self.peer_id, seq, credits, close, bytes(payload)))
            meta = tpu_std.RpcMeta(stream_settings=tpu_std.StreamSettings(
                self.peer_id, False, seq, credits, close))
            wire, lane = tpu_std.pack_frame(
                meta, bytes(payload), device_arrays=device_arrays,
                device_lane=conn.conn.supports_device_lane)
            if lane is None:
                return conn.write(wire)
            with conn.lane_lock:
                try:
                    conn.write_device_payload(lane)
                except OSError:
                    return False    # the connection's end closes us
                return conn.write(wire)

    # ------------------------------------------------------------ receive
    def _on_frame(self, msg: tpu_std.RpcMessage) -> None:
        """Where the frame was cut (most often the dispatcher thread), in
        parse order: cheap."""
        ss = msg.meta.stream_settings
        if ss.credits:
            self._credits.fetch_add(ss.credits)
            self._credits.wake_all()
        if ss.close:
            self._remote_close_once()
            return
        if ss.frame_seq:
            arrays = (tpu_std.merge_device_arrays(msg)
                      if msg.meta.device_payloads else [])
            self._recv_q.execute(StreamMessage(msg.payload, msg.attachment,
                                               arrays))

    async def _deliver(self, batch) -> None:
        """The delivery queue's consumer: frames in order; None is the
        remote closure."""
        for item in batch:
            if item is None:
                for cb in list(self._close_cbs):
                    try:
                        cb(self)
                    except Exception:   # boundary: every callback runs
                        log.exception("stream on_close failed")
                continue
            if self.options.on_received is not None:
                try:
                    r = self.options.on_received(self, item)
                    if inspect.isawaitable(r):
                        await r         # in the drainer: stays serial
                except Exception:       # boundary: keep delivering
                    log.exception("stream on_received failed")
            with self._grant_lock:
                self._pending_grants += 1
                grant = 0
                if self._pending_grants >= CREDIT_BATCH and self.peer_id:
                    grant, self._pending_grants = self._pending_grants, 0
            if grant and not self.closed:
                self._send_frame(b"", credits=grant, data=False)

    # ------------------------------------------------------------ binding
    def _bind(self, conn) -> None:
        """Attach the established stream to the Socket ``conn`` and watch
        its end: a peer dying mid-stream closes the stream. Called once
        the stream is established on ``conn``; a previous subscription is
        dropped."""
        self.conn = conn
        prev, self._subscribed = self._subscribed, conn
        if prev is conn:
            return
        if prev is not None:
            prev.off_failed(self._on_conn_failed)
        conn.on_failed(self._on_conn_failed)

    def _on_conn_failed(self, conn) -> None:
        if conn is self.conn:
            self._remote_close_once()

    def _wake_writers(self) -> None:
        # the sentinel makes every credit park short-circuit (value
        # changed), so a writer racing the closure cannot sleep out its
        # timeout on a dead stream
        self._credits.fetch_add(_CLOSED_CREDITS)
        self._credits.wake_all()

    def _remote_close_once(self) -> None:
        """The one remote-closure path, shared by the peer's close frame
        and the connection's end (they race on a normal hang-up)."""
        with self._close_lock:
            if self.closed or self.remote_closed:
                return
            self.remote_closed = True
        self._wake_writers()
        self._established.set()         # release writers still waiting
        self._recv_q.execute(None)      # on_close, after pending frames

    # -------------------------------------------------------------- close
    def close(self) -> None:
        with self._close_lock:
            if self.closed:
                return
            self.closed = True
        if self.conn is not None and self.peer_id and not self.remote_closed:
            self._send_frame(b"", close=True, data=False)
        sub, self._subscribed = self._subscribed, None
        if sub is not None:
            sub.off_failed(self._on_conn_failed)
        _registry.remove(self.id)
        self._wake_writers()

    def on_close(self, cb: Callable[["Stream"], None]) -> None:
        """``cb(stream)`` when the peer closes or the connection ends."""
        self._close_cbs.append(cb)


def address_stream(stream_id: int) -> Optional[Stream]:
    return _registry.address(stream_id)


def process_stream_frame(msg: tpu_std.RpcMessage) -> None:
    """Dispatch a bare stream frame (where it was cut, in parse order). A
    frame for an unknown or closed stream is dropped, as the reference
    drops it; its lane batch, if any, was taken when it was cut."""
    stream = _registry.address(msg.meta.stream_settings.stream_id)
    if stream is not None:
        stream._on_frame(msg)


def stream_accept(cntl, options: Optional[StreamOptions] = None
                  ) -> Optional[Stream]:
    """Server side, inside the handler: accept the stream the client
    attached to this call; None when it attached none."""
    peer_id = getattr(cntl, "_peer_stream_id", 0)
    if not peer_id or cntl._server_socket is None:
        return None
    s = Stream(options)
    s.peer_id = peer_id
    s._bind(cntl._server_socket)
    s._on_established()
    cntl._accepted_stream = s
    return s
