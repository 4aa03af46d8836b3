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
"""

from __future__ import annotations

import inspect
import threading
from collections import deque
from typing import Callable, List, Optional

from brpc_tpu_torch.butil.flags import define_flag, flag
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, get_protocols)

define_flag("dispatch_inline_budget", 16,
            "responses of one input burst processed in place before the "
            "rest of the burst spawns as fibers",
            validator=lambda v: v >= 0)

# messages dispatched, and dispatch cycles: their ratio is the batch size
_batch_msgs = Adder().expose("dispatch_batch_msgs")
_batch_cycles = Adder().expose("dispatch_batches")


def record_dispatch_batch(n: int) -> None:
    _batch_msgs.add(n)
    _batch_cycles.add(1)


async def _drive(work) -> None:
    r = work()
    if inspect.isawaitable(r):
        await r


class InputMessenger:
    def __init__(self, protocols: Optional[List] = None,
                 control: Optional[TaskControl] = None):
        self._protocols = protocols     # None: the global registry
        self._control = control or global_control()

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
