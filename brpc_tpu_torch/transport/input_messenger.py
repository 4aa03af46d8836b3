"""InputMessenger: cuts whole messages off a socket's input by trying the
registered protocols' ``parse`` (the port of
brpc_tpu/transport/input_messenger.py, its classic loop; bRPC's
input_messenger.cpp).

It keeps the reference's two tricks: the socket remembers the protocol
that parsed its last message and tries it first (``preferred_protocol``,
input_messenger.cpp:219), and the LAST message of a read is processed in
place while the earlier ones get fibers of their own (:183), so a
pipelined burst runs in parallel and the common single message pays no
handoff. Of a burst's earlier messages, responses (no user handler, only
completion work) run in place in parse order, up to
``dispatch_inline_budget``; requests and the rest spawn as fibers with
one wake for the batch (``spawn_many``; the reference counts them on the
socket for its cut-through lane, which the port does not have).
``on_new_messages``
returns the last message's processing when it is a coroutine, and the
Socket steps it in place (``TaskControl.run_inline``) until it first
suspends.

A prefix that every protocol disclaims drops the connection, unless it
is shorter than some protocol's ``min_probe_bytes``: then it waits for
more bytes.

The turbo lane (brpc_tpu/transport/input_messenger.py:172-260): a
protocol with ``turbo_scan`` (tpu_std, on fastcore) first serves what its
``native_serve`` can in C, then cuts and meta-decodes every complete
small frame of the whole portal, scan after scan, before it dispatches
any (``turbo_dispatch``); the classic loop takes what the scans left. The
lane is tried on a connection's first bytes too, where no protocol has
claimed the connection yet (the reference waits for one classic parse):
the scan disclaims bytes that are not its protocol's by returning
nothing.
"""

from __future__ import annotations

import inspect
import threading
from collections import deque
from typing import Callable, List, Optional

from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.reducer import Adder, Maxer, PassiveStatus
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, get_protocols)
from brpc_tpu_torch.transport import syscall_stats as _syscall_stats

define_flag("dispatch_inline_budget", 16,
            "responses of one input burst processed in place before the "
            "rest of the burst spawns as fibers",
            validator=lambda v: v >= 0)

# messages dispatched, and dispatch cycles: their ratio is the batch size
_batch_msgs = Adder().expose("dispatch_batch_msgs")
_batch_cycles = Adder().expose("dispatch_batches")
_batch_peak = Maxer()
_batch_windows = None


def _batch_window_views():
    """(messages a second, cycles a second, the peak's window) over 10 s,
    made at the first read: a Window registers with the sampler thread
    (brpc_tpu/transport/input_messenger.py:47-70)."""
    global _batch_windows
    if _batch_windows is None:
        from brpc_tpu_torch.bvar.window import PerSecond, Window
        _batch_windows = (PerSecond(_batch_msgs, 10),
                          PerSecond(_batch_cycles, 10),
                          Window(_batch_peak, 10))
    return _batch_windows


def dispatch_batch_avg_10s() -> float:
    """Messages a dispatch cycle over the last 10 s (1.0: no batching)."""
    msgs, cycles, _ = _batch_window_views()
    c = cycles.get_value() or 0
    if not c:
        return 0.0
    return round((msgs.get_value() or 0) / c, 2)


def dispatch_batch_peak_10s() -> int:
    return _batch_window_views()[2].get_value() or 0


def _postfork_reset() -> None:
    """Fork hygiene: the batch counters count this process's dispatch
    cycles only (a shard's merged ``/vars`` is the sum of the shards',
    and a restarted shard must not carry its supervisor's cycles), and
    the windows are made again against the child's sampler
    (brpc_tpu/transport/input_messenger.py:73-83)."""
    global _batch_windows
    _batch_msgs.postfork_clear()
    _batch_cycles.postfork_clear()
    _batch_peak.postfork_clear()
    _batch_windows = None


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("transport.input_messenger", _postfork_reset)

PassiveStatus(dispatch_batch_avg_10s).expose("dispatch_batch_size_avg_10s")
PassiveStatus(dispatch_batch_peak_10s).expose("dispatch_batch_size_peak_10s")


def record_dispatch_batch(n: int) -> None:
    _batch_msgs.add(n)
    _batch_cycles.add(1)
    _batch_peak.update(n)
    _syscall_stats.note_rpc_messages(n)


async def _drive(work) -> None:
    r = work()
    if inspect.isawaitable(r):
        await r


class InputMessenger:
    def __init__(self, protocols: Optional[List] = None,
                 control: Optional[TaskControl] = None):
        self._protocols = protocols     # None: the global registry
        self._control = control or global_control()
        if protocols is None:
            # the registry's first use imports its protocol modules (h2
            # and HPACK take 10-20 ms to compile): here, on the thread
            # that makes the messenger, not on the dispatcher at a
            # connection's first read, where it held back the reads of a
            # whole burst's sockets
            get_protocols()

    def protocols(self) -> List:
        return self._protocols if self._protocols is not None \
            else get_protocols()

    def on_new_messages(self, socket):
        """The socket's input callback: parse the portal, dispatch every
        whole message, and return the last one's pending processing (an
        awaitable) or None."""
        portal = socket.input_portal
        need = socket.input_need
        if need:
            # the last parse said how many bytes its frame needs
            if portal.size < need:
                return None
            socket.input_need = 0
        protocols = self.protocols()
        tail = self._turbo(socket, protocols)
        if tail is not None or not portal:
            return tail
        msgs = []
        while portal:
            idx = socket.preferred_protocol
            order = range(len(protocols)) if idx < 0 else (
                [idx] + [i for i in range(len(protocols)) if i != idx])
            claimed = None
            waiting = False
            ambiguous = False
            for i in order:
                proto = protocols[i]
                # parse contract: peek only unless it returns PARSE_OK
                status, msg = proto.parse(portal, socket)
                if status == PARSE_OK:
                    socket.preferred_protocol = i
                    claimed = (proto, msg)
                    break
                if status == PARSE_NOT_ENOUGH_DATA:
                    waiting = True      # this protocol's bytes, not all here
                    break
                if portal.size < proto.min_probe_bytes:
                    ambiguous = True    # a tentative disclaim
            if claimed is not None:
                proto, msg = claimed
                if not proto.process_inline(msg, socket):
                    msgs.append(claimed)
                continue
            if not waiting and not ambiguous and portal:
                socket.set_failed(ValueError("unparsable input"))
            break
        if not msgs:
            return None
        record_dispatch_batch(len(msgs))
        if len(msgs) > 1:
            budget = flag("dispatch_inline_budget")
            inline_run, spill = [], []
            for proto, msg in msgs[:-1]:
                if len(inline_run) < budget and \
                        getattr(msg, "is_response", False):
                    inline_run.append((proto, msg))
                else:
                    spill.append((proto, msg))
            if spill:
                self._control.spawn_many(
                    [_drive(lambda p=p, m=m: p.process(m, socket))
                     for p, m in spill], name="process_burst")
            for proto, msg in inline_run:
                self._control.run_inline(
                    _drive(lambda p=proto, m=msg: p.process(m, socket)),
                    name=f"process_{proto.name}")
        proto, msg = msgs[-1]
        r = proto.process(msg, socket)
        return r if inspect.isawaitable(r) else None


    def _turbo(self, socket, protocols):
        """The turbo lane over the whole portal; the last fallback's
        pending processing when the lane took every byte (None
        otherwise: the classic loop goes on)."""
        idx = socket.preferred_protocol
        if idx < 0:
            idx = next((i for i, p in enumerate(protocols)
                        if getattr(p, "turbo_scan", None) is not None), -1)
        if idx < 0:
            return None
        proto = protocols[idx]
        ts = getattr(proto, "turbo_scan", None)
        if ts is None:
            return None
        portal = socket.input_portal
        nserve = getattr(proto, "native_serve", None)
        all_recs = None
        served = False
        while portal:
            if nserve is not None and nserve(portal, socket):
                served = True
                continue
            recs = ts(portal, socket)
            if not recs:
                break
            if all_recs is None:
                all_recs = recs
            else:
                all_recs.extend(recs)
        if served or all_recs:
            socket.preferred_protocol = idx
        if not all_recs:
            return None
        record_dispatch_batch(len(all_recs))
        tail = proto.turbo_dispatch(all_recs, socket)
        if not portal:
            return tail
        if tail is not None:
            # bytes the scans left go through the classic loop; this
            # fallback gets a fiber of its own
            self._control.spawn(tail, name="process_tpu_std")
        return None


def process_in_parse_order(socket, key: str, item,
                           handler: Callable) -> None:
    """Serialize order-critical handling per connection: queue ``item``
    and let one drain fiber at a time run ``await handler(item, socket)``
    for each item in parse order (HTTP/1.1's responses in request
    order)."""
    ud = socket.user_data
    lock = ud.setdefault(key + "_lock", threading.Lock())
    with lock:
        pending = ud.setdefault(key + "_pending", deque())
        pending.append(item)
        if ud.get(key + "_draining"):
            return
        ud[key + "_draining"] = True

    async def _drain():
        while True:
            with lock:
                if not pending:
                    ud[key + "_draining"] = False
                    return
                it = pending.popleft()
            try:
                await handler(it, socket)
            except BaseException as e:
                # a dead drain with _draining still set would wedge the
                # connection: fail it, so the peer sees a close
                with lock:
                    ud[key + "_draining"] = False
                socket.set_failed(e if isinstance(e, Exception)
                                  else ConnectionError(f"drain died: {e!r}"))
                raise

    socket._control.spawn(_drain, name=key + "_serial")
