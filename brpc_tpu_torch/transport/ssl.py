"""ssl://: TLS over the TCP lane (the port of brpc_tpu/transport/ssl.py;
bRPC's details/ssl_helper.cpp and the Socket's SSL state machine).

Python's ``ssl`` module is the engine. ``SSLWantReadError`` and
``SSLWantWriteError`` become BlockingIOError (and a writable-event
request for a write that wants to write), so the Socket, its KeepWrite
hand-off and the dispatcher work as on TCP. The handshake runs lazily on
the non-blocking socket: a read or a write before it is done drives
``do_handshake`` instead. A writer that TLS asks to read first (the
handshake's round trip, or records the SSL object must take in before
it sends, such as a TLS 1.3 key update) parks until the read path has
run once (``_wake_parked_writer``): a writable event fires at once on an
open socket, and the writer would spin on it without bound until a read
pumped the SSL object. Every OpenSSL call runs under one lock a
connection: the reference saw a segfault when a reading fiber and a
writing one met inside the shared SSL state (brpc_tpu/transport/
ssl.py:37-60).

Decrypted bytes can wait above the fd, so an ssl conn never gives its
fd to a native loop (no ``pluck_fd``) and registers poll-only on the
ring lane. A read returns everything the SSL object holds decrypted, so
a short read still means the kernel buffer is what is left, and the
level-triggered events stay right.

Endpoint extras:
  server:  ssl://0.0.0.0:443#cert=/path/cert.pem&key=/path/key.pem
  client:  ssl://host:443            (no verification, the test default,
           as the reference's verify_depth=0)
           ssl://host:443#verify=1&ca=/path/ca.pem&sni=name
"""

from __future__ import annotations

import errno
import socket as pysocket
import ssl as pyssl
import threading
from typing import Callable, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.transport.base import Conn, Listener, Transport
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher
from brpc_tpu_torch.transport.tcp import TcpConn, TcpTransport

_WOULD_BLOCK = (errno.EAGAIN, errno.EWOULDBLOCK)


class SslConn(Conn):
    """A non-blocking TLS connection whose handshake runs lazily (the
    reference's SSL_CONNECTING -> SSL_CONNECTED, socket.h)."""

    level_triggered = True

    def __init__(self, sock: pyssl.SSLSocket, local: EndPoint,
                 remote: EndPoint):
        sock.setblocking(False)
        self._sock = sock
        self._fd = sock.fileno()
        self._local = local
        self._remote = remote
        self._closed = False
        self._handshaken = False
        self._on_writable: Optional[Callable[[], None]] = None
        self._ssl_lock = threading.Lock()
        # a writer that TLS asks to read first parks here: a writable
        # event would fire at once on an open socket and spin until a
        # read pumped the SSL object, so the read path wakes it. What the
        # handshake waits for, and whether the last write wanted a read
        self._hs_want: Optional[str] = None
        self._write_wants_read = False
        self._writer_parked = False

    # ----------------------------------------------------------- handshake
    def _drive_handshake(self) -> None:
        """Advance the handshake (the caller holds ``_ssl_lock``);
        BlockingIOError while it goes on, noting what it waits for."""
        if self._handshaken:
            return
        try:
            self._sock.do_handshake()
        except pyssl.SSLWantReadError:
            self._hs_want = "read"
            raise BlockingIOError("tls handshake wants read") from None
        except pyssl.SSLWantWriteError:
            self._hs_want = "write"
            raise BlockingIOError("tls handshake wants write") from None
        except pyssl.SSLError as e:
            raise ConnectionError(f"tls handshake failed: {e}") from e
        self._handshaken = True
        self._hs_want = None

    def _wants_read(self) -> bool:
        # under _ssl_lock
        return self._write_wants_read if self._handshaken \
            else self._hs_want == "read"

    def _wake_parked_writer(self) -> None:
        """After a read: the SSL object took in what arrived, so a write
        that wanted a read may go on (a handshake still waiting keeps its
        writer parked)."""
        fire = False
        with self._ssl_lock:
            if self._handshaken:
                self._write_wants_read = False
            if self._writer_parked and not self._wants_read():
                self._writer_parked = False
                fire = True
        if fire and self._on_writable is not None:
            self._on_writable()

    # ------------------------------------------------------------------ io
    def write(self, mv) -> int:
        with self._ssl_lock:
            self._drive_handshake()
            try:
                return self._sock.send(mv)
            except pyssl.SSLWantWriteError:
                raise BlockingIOError from None
            except pyssl.SSLWantReadError:
                # records to take in first: the writer parks until a read
                self._write_wants_read = True
                raise BlockingIOError from None
            except pyssl.SSLError as e:
                raise ConnectionError(f"tls write failed: {e}") from e
            except OSError as e:
                if e.errno in _WOULD_BLOCK:
                    raise BlockingIOError from e
                raise

    def read_into(self, mv: memoryview) -> int:
        try:
            return self._read_into_locked(mv)
        finally:
            # a read may have completed the handshake
            self._wake_parked_writer()

    def _read_into_locked(self, mv: memoryview) -> int:
        with self._ssl_lock:
            self._drive_handshake()
            try:
                n = self._sock.recv_into(mv)
                # and what the SSL object holds decrypted: none of it
                # would make the fd readable
                while n and n < len(mv) and self._sock.pending():
                    n += self._sock.recv_into(mv[n:])
                return n
            except pyssl.SSLWantReadError:
                raise BlockingIOError from None
            except pyssl.SSLWantWriteError:
                self._ask_writable()
                raise BlockingIOError from None
            except pyssl.SSLZeroReturnError:
                return 0                # a clean close-notify: the end
            except pyssl.SSLError as e:
                raise ConnectionError(f"tls read failed: {e}") from e
            except OSError as e:
                if e.errno in _WOULD_BLOCK:
                    raise BlockingIOError from e
                raise

    # ------------------------------------------------------------ plumbing
    def close(self) -> None:
        """Unregister, then close; once."""
        if self._closed:
            return
        self._closed = True
        global_dispatcher().remove_consumer(self._fd)
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def closed(self) -> bool:
        return self._closed

    def start_events(self, on_readable, on_writable) -> None:
        self._on_writable = on_writable
        # poll-only on the ring lane: readiness, the bytes read here
        global_dispatcher().add_consumer(self._fd, on_readable)

    def pause_read_events(self) -> None:
        if not self._closed:
            global_dispatcher().pause_read(self._fd)

    def resume_read_events(self) -> None:
        if not self._closed:
            global_dispatcher().resume_read(self._fd)

    def _ask_writable(self) -> None:
        if self._on_writable is not None and not self._closed:
            global_dispatcher().request_writable(self._fd,
                                                 self._on_writable)

    def request_writable_event(self) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        with self._ssl_lock:
            if self._wants_read():
                self._writer_parked = True
                return
        self._ask_writable()

    @property
    def local_endpoint(self) -> EndPoint:
        return self._local

    @property
    def remote_endpoint(self) -> EndPoint:
        return self._remote


class _SslListener(Listener):
    def __init__(self, inner: Listener, ep: EndPoint):
        self._inner = inner
        self._ep = ep

    def stop(self) -> None:
        self._inner.stop()

    @property
    def endpoint(self) -> EndPoint:
        return self._ep


class SslTransport(Transport):
    scheme = "ssl"

    def __init__(self):
        self._tcp = TcpTransport()

    @staticmethod
    def _server_context(ep: EndPoint) -> pyssl.SSLContext:
        cert, key = ep.extra("cert"), ep.extra("key")
        if not cert:
            raise ValueError("an ssl:// listener needs #cert=/path.pem "
                             "(and &key=/path.pem) in its endpoint")
        ctx = pyssl.SSLContext(pyssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key or None)
        return ctx

    @staticmethod
    def _client_context(ep: EndPoint) -> pyssl.SSLContext:
        verify = (ep.extra("verify") or "").lower() in ("1", "true", "yes")
        if verify:
            return pyssl.create_default_context(
                cafile=ep.extra("ca") or None)
        ctx = pyssl.SSLContext(pyssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = pyssl.CERT_NONE
        return ctx

    def listen(self, ep: EndPoint, on_new_conn) -> Listener:
        ctx = self._server_context(ep)
        tcp_ep = EndPoint("tcp", ep.host or "127.0.0.1", ep.port, ep.extras)
        bound = []
        ready = threading.Event()

        def wrap(conn: TcpConn):
            # an accept can come before listen() below has returned
            if not ready.wait(5):
                conn.close()
                raise ConnectionError("ssl listener not bound in 5 s")
            tls = ctx.wrap_socket(conn._sock, server_side=True,
                                  do_handshake_on_connect=False)
            on_new_conn(SslConn(tls, bound[0], conn.remote_endpoint))

        inner = self._tcp.listen(tcp_ep, wrap)
        bound.append(EndPoint("ssl", inner.endpoint.host,
                              inner.endpoint.port, ep.extras))
        ready.set()
        return _SslListener(inner, bound[0])

    def connect(self, ep: EndPoint, timeout_s: float = 10.0) -> Conn:
        ctx = self._client_context(ep)
        sni = ep.extra("sni") or ep.host
        sock = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_STREAM)
        try:
            # a blocking TCP connect, as TcpTransport's: a health probe
            # relies on connect() raising for a peer that is down
            sock.settimeout(timeout_s)
            sock.connect((ep.host, ep.port))
            sock.settimeout(None)
            sock.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
            lh, lp = sock.getsockname()[:2]
            tls = ctx.wrap_socket(
                sock, server_hostname=sni if ctx.check_hostname or sni
                else None, do_handshake_on_connect=False)
        except BaseException:
            sock.close()
            raise
        return SslConn(tls, EndPoint("ssl", lh, lp), ep)
