"""TCP transport: non-blocking sockets driven by the EventDispatcher (the
port of brpc_tpu/transport/tcp.py, the classic selector lane; bRPC's
socket.cpp and acceptor.cpp).

No thread is started per connection, nor for accepting: a listening
socket is a dispatcher consumer whose read event accepts until EAGAIN
(acceptor.cpp:253), and every accepted or dialled socket is one too
(``TcpConn.start_events``), level-triggered. Out of descriptors
(EMFILE/ENFILE), the listener pauses accepting for
``acceptor_backoff_ms`` instead of spinning the dispatcher.

fd lifetime: a ``TcpConn`` owns its ``socket.socket``; ``close``
unregisters the fd from the dispatcher first and then closes the socket,
once. Nothing here closes an fd number it does not own.
"""

from __future__ import annotations

import errno
import socket as pysocket
from typing import Callable, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.transport.base import Conn, Listener, Transport
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher

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
        try:
            return self._sock.send(mv)
        except OSError as e:
            if e.errno in _WOULD_BLOCK:
                raise BlockingIOError from e
            raise

    def writev(self, views) -> int:
        """One sendmsg for a chain of buffers (iobuf.h:177)."""
        try:
            return self._sock.sendmsg(views)
        except OSError as e:
            if e.errno in _WOULD_BLOCK:
                raise BlockingIOError from e
            raise

    def read_into(self, mv: memoryview) -> int:
        try:
            return self._sock.recv_into(mv)
        except OSError as e:
            if e.errno in _WOULD_BLOCK:
                raise BlockingIOError from e
            raise

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
        global_dispatcher().add_consumer(self._fd, on_readable)

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
        global_dispatcher().add_consumer(self._fd, self._on_acceptable)

    def _on_acceptable(self) -> None:
        """Accept until EAGAIN (acceptor.cpp:253)."""
        while not self._stopped:
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
