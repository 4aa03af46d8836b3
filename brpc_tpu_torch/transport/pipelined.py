"""The pipelined FIFO client: the connection and the matching of replies
to requests shared by the protocols whose replies carry no correlation
id and come strictly in request order (redis's RESP, memcached's binary
protocol, framed thrift). The port of brpc_tpu/transport/pipelined.py;
bRPC gets this from ``pipelined_count`` on a Socket's write.

Invariants:

- batch order in ``_inflight`` equals write order on the wire: a batch
  is queued and its bytes written under one lock (``Socket.write`` only
  queues and writes what the kernel takes at once);
- a batch belongs to the socket it was written on, and a socket's
  failure fails its own batches only;
- a reply timeout fails the connection: a FIFO stream cannot find its
  place again past a lost reply.

The socket is a port ``Socket`` on the process's dispatcher, read by an
``InputMessenger`` of the client's one protocol. It never sticks
(``Socket.sticky_ok`` stays False): its owner does not probe it before
reuse. ``live_sockets()`` counts the clients' sockets not yet failed
(the tests' leak check); ``close()`` fails the client's.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, List, Optional, Union

from brpc_tpu_torch.butil.endpoint import EndPoint, str2endpoint
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.fiber.sync import FiberEvent
from brpc_tpu_torch.transport.input_messenger import InputMessenger
from brpc_tpu_torch.transport.socket import create_client_socket

_live_lock = threading.Lock()
_live: set = set()


def live_sockets() -> int:
    """Sockets of pipelined clients that have not failed."""
    with _live_lock:
        return sum(1 for s in _live if not s.failed)


class Batch:
    __slots__ = ("n", "results", "event", "error", "socket")

    def __init__(self, n: int, socket=None):
        self.n = n
        self.results: List[Any] = []
        self.event = FiberEvent()
        self.error: Optional[BaseException] = None
        self.socket = socket


class PipelinedClient:
    """A subclass sets ``user_data_key`` (how its protocol's parse and
    process know a client socket) and ``protocol_name`` (its row on
    ``/connections``), and may override ``_hello_commands()``, the wire
    bytes sent first on a fresh connection, one reply each, which
    ``_check_hello_reply`` judges."""

    user_data_key = "pipelined_client"

    def __init__(self, address: Union[str, EndPoint], protocol,
                 timeout_s: float = 5.0,
                 control: Optional[TaskControl] = None):
        self._endpoint = (address if isinstance(address, EndPoint)
                          else str2endpoint(address))
        self._timeout_s = timeout_s
        self._control = control or global_control()
        self._messenger = InputMessenger(protocols=[protocol],
                                         control=self._control)
        self._protocol_name = protocol.name
        # reentrant: a write that fails runs the socket's failure
        # callbacks, this client's among them, in place
        self._lock = threading.RLock()
        self._socket = None
        self._inflight: deque = deque()

    # ---------------------------------------------------------- overrides
    def _hello_commands(self) -> List[bytes]:
        return []

    def _check_hello_reply(self, reply) -> None:
        """Raise to refuse the connection on a hello reply."""

    # ------------------------------------------------------------ plumbing
    def _get_socket(self):
        with self._lock:
            s = self._socket
        if s is not None and not s.failed:
            return s
        new = create_client_socket(
            self._endpoint, on_input=self._messenger.on_new_messages,
            control=self._control)
        new.user_data[self.user_data_key] = self
        new.user_data["protocol"] = self._protocol_name
        with _live_lock:
            _live.add(new)
        new.on_failed(self._on_socket_failed)
        hello = self._hello_commands()
        hello_batch = None
        with self._lock:
            if self._socket is not None and not self._socket.failed:
                loser, new = new, self._socket
            else:
                self._socket, loser = new, None
                if hello:
                    # the first batch on the connection, before any user
                    # command can queue
                    hello_batch = Batch(len(hello), new)
                    self._inflight.append(hello_batch)
                    new.write(b"".join(hello))
        if loser is not None:
            loser.set_failed(ConnectionError("duplicate connect discarded"))
        if hello_batch is not None:
            # an AUTH or SELECT refused shows at the connect, not as every
            # later command failing
            if not hello_batch.event.wait_pthread(self._timeout_s):
                new.set_failed(TimeoutError("connection hello timed out"))
                raise TimeoutError("connection hello timed out")
            if hello_batch.error is not None:
                raise hello_batch.error
            for v in hello_batch.results:
                try:
                    self._check_hello_reply(v)
                except BaseException:
                    new.set_failed(ConnectionError("connection hello failed"))
                    raise
        return new

    def _on_socket_failed(self, socket) -> None:
        """Fail the batches written on this socket only: the loser of a
        dial race dies with none, and failing the winner's would lose its
        place in the FIFO."""
        with _live_lock:
            _live.discard(socket)
        failed = []
        with self._lock:
            kept = deque()
            for batch in self._inflight:
                (failed if batch.socket is socket else kept).append(batch)
            self._inflight = kept
            if self._socket is socket:
                self._socket = None
        err = socket.fail_reason or ConnectionError("connection failed")
        for batch in failed:
            batch.error = err
            batch.event.set()

    def _on_reply(self, socket, value) -> None:
        with self._lock:
            if not self._inflight or self._inflight[0].socket is not socket:
                return      # a stale socket's leftovers
            batch = self._inflight[0]
            batch.results.append(value)
            done = None
            if len(batch.results) >= batch.n:
                self._inflight.popleft()
                done = batch
        if done is not None:
            done.event.set()

    def _start(self, wire: bytes, nreplies: int) -> Batch:
        socket = self._get_socket()
        # queued and written under one lock: batch order must be write
        # order, or the FIFO matching crosses
        with self._lock:
            batch = Batch(nreplies, socket)
            self._inflight.append(batch)
            ok = socket.write(wire)
        if not ok:
            self._on_socket_failed(socket)
        return batch

    def _wait(self, batch: Batch, what: str = "command") -> List[Any]:
        if not batch.event.wait_pthread(self._timeout_s):
            self._fail_timeout(batch, what)
        return self._finish(batch)

    async def _wait_async(self, batch: Batch,
                          what: str = "command") -> List[Any]:
        if not await batch.event.wait(self._timeout_s):
            self._fail_timeout(batch, what)
        return self._finish(batch)

    @staticmethod
    def _fail_timeout(batch: Batch, what: str):
        if batch.socket is not None:
            batch.socket.set_failed(TimeoutError(f"{what} timed out"))
        raise TimeoutError(f"{what} timed out")

    @staticmethod
    def _finish(batch: Batch) -> List[Any]:
        if batch.error is not None:
            raise batch.error
        return batch.results

    def close(self) -> None:
        with self._lock:
            s, self._socket = self._socket, None
        if s is not None and not s.failed:
            s.set_failed(ConnectionError("client closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
