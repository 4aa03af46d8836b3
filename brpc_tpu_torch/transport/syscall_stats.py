"""The syscalls an RPC costs (the port of
brpc_tpu/transport/syscall_stats.py): recv, send and accept counted at
the native boundary and at the Python conns', merged into the
``syscalls_per_rpc`` key of /vars.

- The native loops (the ring lane's ticks, ``transport/ring_lane.py``,
  and fastcore's ``pluck_scan`` and ``serve_drain`` fd loops) bump
  process-wide C atomics at their recv/send/accept/poll call sites;
  ``_brpc_fastcore.syscall_counts()`` reads them (``ring.cc`` defines
  them). The ring's own counters (``ring_ticks``, ``ring_completions``,
  ``ring_flush_batches``, ``ring_flushed_frames`` and the pluck fence's
  ``ring_read_barriers``, ``ring_barrier_waits``,
  ``ring_barrier_wait_us``) are ring_lane's bvars.
- The Python conns (``transport/tcp.py``) bump the Adders below, one a
  conn method call.

The denominator (``rpc_msgs``) is stamped where messages are dispatched:
``input_messenger.record_dispatch_batch`` (the classic and turbo lanes,
requests and responses alike), the pluck lane's native completions, and
``Server.account_native_batch`` (frames the C echo loops served).
"""

from __future__ import annotations

from brpc_tpu_torch.bvar.reducer import Adder, PassiveStatus

py_recv = Adder()
py_writev = Adder()
py_accept = Adder()

# messages dispatched or served natively: syscalls_per_rpc's denominator
rpc_msgs = Adder()


def note_rpc_messages(n: int) -> None:
    rpc_msgs.add(n)


_native_fn = False      # unresolved; None: the extension is absent


def _native_counts():
    """(recv, send, accept, poll) at the native boundary; zeros without
    the extension. Resolved once, and only from a process whose lanes
    already loaded it: a /vars read never starts a build."""
    global _native_fn
    fn = _native_fn
    if fn is False:
        from brpc_tpu_torch.native import fastcore
        if not fastcore._tried:
            return (0, 0, 0, 0)
        fc = fastcore.get()
        fn = _native_fn = (getattr(fc, "syscall_counts", None)
                           if fc is not None else None)
    if fn is None:
        return (0, 0, 0, 0)
    return fn()


def snapshot() -> dict:
    """Totals since the process started; callers take deltas."""
    nrecv, nsend, naccept, npoll = _native_counts()
    return {"recv": nrecv + (py_recv.get_value() or 0),
            "writev": nsend + (py_writev.get_value() or 0),
            "accept": naccept + (py_accept.get_value() or 0),
            "poll": npoll,
            "rpc_msgs": rpc_msgs.get_value() or 0}


def per_rpc(before: dict, after: dict) -> float:
    """(recv + writev + accept) a dispatched message between two
    snapshots; poll wake-ups are left out (they cover whole ticks)."""
    n = after["rpc_msgs"] - before["rpc_msgs"]
    if n <= 0:
        return 0.0
    return sum(after[k] - before[k] for k in ("recv", "writev", "accept")
               ) / n


def syscalls_per_rpc() -> float:
    """Cumulative (recv + writev + accept) a dispatched message."""
    return round(per_rpc({"recv": 0, "writev": 0, "accept": 0,
                          "rpc_msgs": 0}, snapshot()), 3)


_recv_var = PassiveStatus(lambda: snapshot()["recv"])
_writev_var = PassiveStatus(lambda: snapshot()["writev"])
_accept_var = PassiveStatus(lambda: snapshot()["accept"])
_ratio_var = PassiveStatus(syscalls_per_rpc)


def expose_syscall_vars() -> None:
    """(Re-)expose the bvars; ``Server.start`` calls it, so a restart
    after a test's ``unexpose_all`` keeps them."""
    _recv_var.expose("syscalls_recv")
    _writev_var.expose("syscalls_writev")
    _accept_var.expose("syscalls_accept")
    _ratio_var.expose("syscalls_per_rpc")


def _postfork_reset() -> None:
    """A forked child re-resolves the native counters."""
    global _native_fn
    _native_fn = False


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("transport.syscall_stats", _postfork_reset)
