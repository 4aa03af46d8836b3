"""TCP transport: non-blocking sockets driven by the EventDispatcher (the
port of brpc_tpu/transport/tcp.py, the classic selector lane; bRPC's
socket.cpp and acceptor.cpp).

No thread is started per connection, nor for accepting: a listening
socket is a dispatcher consumer whose read event accepts until EAGAIN
(acceptor.cpp:253), and every accepted or dialled socket is one too
(``TcpConn.start_events``), level-triggered. Out of descriptors
(EMFILE/ENFILE), the listener pauses accepting for
``acceptor_backoff_ms`` instead of spinning the dispatcher.

A listener with the endpoint extra ``reuse_port=1`` sets
``SO_REUSEPORT`` before it binds: the shards of a shard group
(``rpc/shard_group.py``) share one port that way.

fd lifetime: a ``TcpConn`` owns its ``socket.socket``; ``close``
unregisters the fd from the dispatcher first and then closes the socket,
once. Nothing here closes an fd number it does not own.

On the ring lane (``transport/ring_lane.py``, brpc_tpu/transport/
tcp.py:51-60, :169-250) a TcpConn is ring-native: its Socket offers a
sink (``ring_sink``) before ``start_events``, the ring's tick recvs the
fd and hands the bytes to it, and ``ring_attached`` says so. A sync
plucker fences the tick first (``ring_read_barrier``); on the uring
backend a recv in the kernel cannot be fenced, so ``ring_pluck_ok`` is
False there and sync joins take the event path. A listener's accepts
run in the tick too: its fds come made, non-blocking and close-on-exec
(``_on_ring_accept``).
"""

from __future__ import annotations

import errno
import os
import socket as pysocket
from typing import Callable, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.transport.base import Conn, Listener, Transport
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher
from brpc_tpu_torch.transport.syscall_stats import (py_accept as _c_accept,
                                                    py_recv as _c_recv,
                                                    py_writev as _c_writev)

define_flag("acceptor_backoff_ms", 100,
            "pause accepting for this long after accept hits descriptor "
            "exhaustion (EMFILE/ENFILE): a level-triggered listener would "
            "otherwise spin the dispatcher",
            validator=lambda v: v > 0)

naccept_pauses = Adder().expose("acceptor_fd_exhausted_pauses")

_WOULD_BLOCK = (errno.EAGAIN, errno.EWOULDBLOCK)


def _ep(addr) -> EndPoint:
    return EndPoint("tcp", addr[0], addr[1])


class TcpConn(Conn):
    # the first write of a frame runs in the writer's own context (the
    # reference writes once in place before KeepWrite, socket.cpp:1960)
    inline_write_ok = True
    # readiness is level-triggered: a short read means the kernel buffer
    # is (almost surely) empty, and if not, the event fires again
    level_triggered = True
    # the ring lane: the Socket sets ring_sink before start_events, which
    # decides whether the tick owns this fd's recv (ring_attached)
    supports_ring_sink = True
    ring_sink = None
    ring_attached = False
    ring_pluck_ok = True

    def __init__(self, sock: pysocket.socket, local: EndPoint,
                 remote: EndPoint):
        sock.setblocking(False)
        try:
            sock.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._sock = sock
        self._fd = sock.fileno()        # the selector key, while open
        self._local = local
        self._remote = remote
        self._closed = False
        self._on_writable: Optional[Callable[[], None]] = None

    def write(self, mv) -> int:
        _c_writev.add(1)
        try:
            return self._sock.send(mv)
        except OSError as e:
            if e.errno in _WOULD_BLOCK:
                raise BlockingIOError from e
            raise

    def writev(self, views) -> int:
        """One sendmsg for a chain of buffers (iobuf.h:177)."""
        _c_writev.add(1)
        try:
            return self._sock.sendmsg(views)
        except OSError as e:
            if e.errno in _WOULD_BLOCK:
                raise BlockingIOError from e
            raise

    def read_into(self, mv: memoryview) -> int:
        _c_recv.add(1)
        try:
            return self._sock.recv_into(mv)
        except OSError as e:
            if e.errno in _WOULD_BLOCK:
                raise BlockingIOError from e
            raise

    def pluck_fd(self) -> int:
        """The fd for the native fd loops (the sync pluck lane and the
        server's ``serve_drain``): a thread may poll and read this conn
        directly. ``Socket.pin_fd_acquire`` dups it first."""
        if self._closed:
            raise OSError("connection closed")
        return self._fd

    def peek_closed(self) -> bool:
        """True only when the peer's FIN arrived and no data is left to
        read (MSG_PEEK: nothing is consumed)."""
        if self._closed:
            return True
        try:
            return self._sock.recv(1, pysocket.MSG_PEEK) == b""
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            return True

    def close(self) -> None:
        """Unregister, then close the socket; once."""
        if self._closed:
            return
        self._closed = True
        global_dispatcher().remove_consumer(self._fd)
        try:
            self._sock.shutdown(pysocket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def start_events(self, on_readable, on_writable) -> None:
        self._on_writable = on_writable
        d = global_dispatcher()
        sink = self.ring_sink
        if sink is not None and getattr(d, "ring_native", False):
            # the tick recvs this fd in its native pass and hands the
            # bytes to the sink (Socket.ring_input)
            d.add_consumer(self._fd, on_readable, ring_recv=sink)
            self.ring_attached = True
            self.ring_pluck_ok = d.backend == "batch"
            return
        d.add_consumer(self._fd, on_readable)

    def ring_read_barrier(self) -> None:
        """Fence the tick in flight (``Socket.pluck_preclaim``): past the
        return, the native pass can no longer consume this fd."""
        rb = getattr(global_dispatcher(), "read_barrier", None)
        if rb is not None:
            rb()

    def pause_read_events(self) -> None:
        if not self._closed:
            global_dispatcher().pause_read(self._fd)

    def resume_read_events(self) -> None:
        if not self._closed:
            global_dispatcher().resume_read(self._fd)

    def request_writable_event(self) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        global_dispatcher().request_writable(self._fd, self._on_writable)

    @property
    def local_endpoint(self) -> EndPoint:
        return self._local

    @property
    def remote_endpoint(self) -> EndPoint:
        return self._remote


class _TcpListener(Listener):
    def __init__(self, sock: pysocket.socket, ep: EndPoint,
                 on_new_conn: Callable[[Conn], None]):
        self._sock = sock
        self._fd = sock.fileno()
        self._ep = ep
        self._on_new_conn = on_new_conn
        self._stopped = False
        sock.setblocking(False)
        d = global_dispatcher()
        if getattr(d, "ring_native", False):
            # the tick's accept burst runs in its native pass
            d.add_consumer(self._fd, self._on_acceptable,
                           ring_accept=self._on_ring_accept)
        else:
            d.add_consumer(self._fd, self._on_acceptable)

    def _on_ring_accept(self, res: int) -> None:
        """The ring's accept sink: one accepted fd (made non-blocking and
        close-on-exec) or -errno a call."""
        if res < 0:
            if -res in (errno.EMFILE, errno.ENFILE, errno.ENOMEM):
                # the backlog would fire every tick: back off, as the
                # selector's loop does
                self._pause_accept()
            return
        if self._stopped:
            os.close(res)               # a stop raced the tick
            return
        try:
            s = pysocket.socket(fileno=res)
        except OSError:
            os.close(res)
            return
        try:
            addr = s.getpeername()
        except OSError:                 # the peer left (an RST queued)
            s.close()
            return
        self._on_new_conn(TcpConn(s, self._ep, _ep(addr)))

    def _on_acceptable(self) -> None:
        """Accept until EAGAIN (acceptor.cpp:253)."""
        while not self._stopped:
            _c_accept.add(1)
            try:
                s, addr = self._sock.accept()
            except BlockingIOError:
                return
            except OSError as e:
                if e.errno in (errno.EMFILE, errno.ENFILE, errno.ENOMEM):
                    # the connection stays in the backlog, so this
                    # level-triggered fd would fire again at once
                    self._pause_accept()
                return
            self._on_new_conn(TcpConn(s, self._ep, _ep(addr)))

    def _pause_accept(self) -> None:
        naccept_pauses.add(1)
        global_dispatcher().pause_read(self._fd)
        from brpc_tpu_torch.fiber.timer import global_timer
        global_timer().schedule_after(flag("acceptor_backoff_ms") / 1e3,
                                      self._resume_accept)

    def _resume_accept(self) -> None:
        if not self._stopped:   # never re-arm a closed (reusable) fd
            global_dispatcher().resume_read(self._fd)

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        global_dispatcher().remove_consumer(self._fd)
        self._sock.close()

    @property
    def endpoint(self) -> EndPoint:
        return self._ep


class TcpTransport(Transport):
    scheme = "tcp"

    def listen(self, ep: EndPoint, on_new_conn) -> Listener:
        sock = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_STREAM)
        try:
            sock.setsockopt(pysocket.SOL_SOCKET, pysocket.SO_REUSEADDR, 1)
            if ep.extra("reuse_port") in ("1", "true"):
                # a shard group (brpc_tpu/transport/tcp.py:324-330): every
                # shard binds this port and the kernel spreads accepted
                # connections over their listeners; set before bind, by
                # every member of the group
                sock.setsockopt(pysocket.SOL_SOCKET, pysocket.SO_REUSEPORT,
                                1)
            sock.bind((ep.host or "127.0.0.1", ep.port))
            sock.listen(1024)
            host, port = sock.getsockname()[:2]
        except BaseException:
            sock.close()
            raise
        return _TcpListener(sock, EndPoint("tcp", host, port, ep.extras),
                            on_new_conn)

    def connect(self, ep: EndPoint, timeout_s: float = 10.0) -> Conn:
        sock = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_STREAM)
        try:
            # a blocking connect keeps bring-up simple, as the reference's
            sock.settimeout(timeout_s)
            sock.connect((ep.host, ep.port))
            sock.settimeout(None)
            local = _ep(sock.getsockname())
        except BaseException:
            sock.close()
            raise
        return TcpConn(sock, local, ep)
