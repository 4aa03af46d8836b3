"""The global SocketMap: client connections shared across a process (the
port of brpc_tpu/transport/socket_map.py; bRPC's socket_map.h:147).

Channels to one server with ``connection_type="single"`` and
``share_connections`` (both the defaults) multiplex one connection. The
key is (endpoint string, protocol and credential): the ssl flavour lives
in the endpoint's scheme, and channels with different credentials must
not share a connection the server verified for one of them. Entries are
refcounted: each Channel holds one lease, the socket closes when the
last lease is returned, and a failed socket leaves the map
(``evict_failed``, from its failure callback) so that the next
``acquire`` dials anew.

An entry keeps alive the object its key names (``owner``: a channel's
``Authenticator``, keyed on its ``id``), so that no other object can
take that ``id`` while the connection lives. The reference keys on the
``id`` alone (brpc_tpu/rpc/channel.py:316-320): a new credential could
then get a freed one's ``id`` and share the connection the server
verified for the old one.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Optional, Tuple

Key = Tuple[str, str]


class _Entry:
    __slots__ = ("socket", "refs", "owner")

    def __init__(self, socket, owner=None):
        self.socket = socket
        self.refs = 0
        self.owner = owner


class SocketMap:
    def __init__(self):
        self._map: Dict[Key, _Entry] = {}
        self._lock = threading.Lock()
        # leases and sockets of collected channels, given back at the
        # map's next use (a finalizer may run inside this map's lock)
        self._orphans: deque = deque()

    @staticmethod
    def key(ep, protocol: str = "") -> Key:
        return (str(ep), protocol)

    def acquire(self, key: Key, make: Callable[[], object], owner=None):
        """A live socket for ``key``, dialled by ``make`` (outside the
        lock) when there is none or it failed; a new entry holds
        ``owner``. Pair each acquire with one ``release``."""
        if self._orphans:
            self._reap()
        with self._lock:
            e = self._map.get(key)
            if e is not None and not e.socket.failed:
                e.refs += 1
                return e.socket
        new = make()
        with self._lock:
            e = self._map.get(key)
            if e is not None and not e.socket.failed:
                # another dial won the race: keep it, close ours
                e.refs += 1
                winner = e.socket
            else:
                self._map[key] = e = _Entry(new, owner)
                e.refs = 1
                winner = None
        if winner is not None:
            new.set_failed(ConnectionError("duplicate connect discarded"))
            return winner
        return new

    def release(self, key: Key, socket) -> None:
        """Drop one lease; the socket closes with the last one, or at once
        when it is no longer the mapped one (a stale lease)."""
        if self._orphans:
            self._reap()
        self._release(key, socket)

    def _release(self, key: Key, socket) -> None:
        close = False
        with self._lock:
            e = self._map.get(key)
            if e is None or e.socket is not socket:
                close = True
            else:
                e.refs -= 1
                if e.refs <= 0:
                    del self._map[key]
                    close = True
        if close and not socket.failed:
            socket.set_failed(ConnectionError("socket map released"))

    def evict_failed(self, key: Key, socket) -> None:
        """Forget a failed socket so that the next acquire dials; its
        holders keep their leases, whose release then closes nothing."""
        with self._lock:
            e = self._map.get(key)
            if e is not None and e.socket is socket:
                del self._map[key]

    def orphan(self, key: Optional[Key], socket) -> None:
        """A collected channel's lease on ``socket`` (``key`` None: a
        socket of its own, to close), given back at the map's next use.
        Lock-free: a finalizer calls it."""
        self._orphans.append((key, socket))

    def _reap(self) -> None:
        while True:
            try:
                key, socket = self._orphans.popleft()
            except IndexError:
                return
            if key is not None:
                self._release(key, socket)
            elif not socket.failed:
                socket.set_failed(ConnectionError("channel collected"))

    def leases(self) -> int:
        """Leases held across every entry (the tests' leak check)."""
        if self._orphans:
            self._reap()
        with self._lock:
            return sum(e.refs for e in self._map.values())


_global: Optional[SocketMap] = None
_glock = threading.Lock()


def global_socket_map() -> SocketMap:
    global _global
    if _global is None:
        with _glock:
            if _global is None:
                _global = SocketMap()
    return _global


def _postfork_reset() -> None:
    """Fork hygiene: the mapped sockets are the parent's connections (the
    child holds copies of their fds, registered with the parent's
    dispatcher); writing on one would write on a connection the parent
    owns. The child's channels dial their own."""
    global _global, _glock
    _global = None
    _glock = threading.Lock()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("transport.socket_map", _postfork_reset)
