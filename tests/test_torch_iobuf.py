"""The port's IOBuf against brpc_tpu.butil.iobuf, on the CPU.

Each case drives the same operations, drawn from a numpy seed, through
both packages' IOBuf (append of bytes and bytearrays, append of another
IOBuf, cut, pop_front, peek, cut_into_writer with short writes,
cut_into_gather_writer) and wants equal bytes and an equal ``size`` after
every step. A hypothesis walk does the same from a fixed seed. The
IOPortal reads the same socket bytes as the reference's, and the block
pool recycles a buffer once no view reaches it.

The cases run inside one collected test (``_run_cases`` reports every
failing case, with its traceback, and checks that none leaves a socket
registered with the port's dispatcher). One item per file keeps the
place of every other file in pytest-xdist's ``--dist loadfile`` queue,
which orders files by their number of items: moving brpc_tpu's
``test_backend_stats.py`` onto the worker that ran ``test_http.py``
(which leaves brpc_tpu's ``rpcz_enabled`` on) breaks it.
"""

import gc
import socket
import time
import traceback

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from brpc_tpu.butil import iobuf as ref
from brpc_tpu_torch.butil import iobuf as port
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher

def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    return cond()


def _run_cases(cases):
    """Run every (name, fn, args) case in order; none may leave a socket
    registered with the port's dispatcher. Every failure is reported,
    each with its traceback."""
    d = global_dispatcher()
    failed = []
    for name, fn, args in cases:
        before = set(d._handlers)
        try:
            fn(*args)
            assert _wait_for(lambda: set(d._handlers) <= before), \
                f"fds left registered: {set(d._handlers) - before}"
        except Exception:
            failed.append(f"--- {name}\n{traceback.format_exc()}")
    assert not failed, "\n".join(failed)


OPS = ("append", "append_big", "append_bytearray", "append_buf", "cut",
       "pop_front", "peek", "writer", "gather_writer")


class _Pair:
    """One IOBuf of each package, driven in step."""

    def __init__(self):
        self.ref, self.port = ref.IOBuf(), port.IOBuf()
        self.out_ref, self.out_port = bytearray(), bytearray()

    def check(self):
        assert self.ref.size == self.port.size
        assert self.ref.to_bytes() == self.port.to_bytes()
        assert bytes(self.out_ref) == bytes(self.out_port)

    def step(self, op: str, n: int, data: bytes) -> None:
        if op == "append":
            self.ref.append(data)
            self.port.append(data)
        elif op == "append_big":
            # past the wrap threshold: wrapped, not copied
            big = data * (20000 // max(1, len(data)) + 1)
            self.ref.append(big)
            self.port.append(big)
        elif op == "append_bytearray":
            self.ref.append(bytearray(data))
            self.port.append(bytearray(data))
        elif op == "append_buf":
            r, p = ref.IOBuf(), port.IOBuf()
            r.append(data)
            p.append(data)
            self.ref.append_buf(r)
            self.port.append_buf(p)
        elif op == "cut":
            a, b = self.ref.cut(n), self.port.cut(n)
            assert a.size == b.size and a.to_bytes() == b.to_bytes()
        elif op == "pop_front":
            assert self.ref.pop_front(n) == self.port.pop_front(n)
        elif op == "peek":
            assert self.ref.peek_bytes(n) == self.port.peek_bytes(n)
        elif op == "writer":
            # a writer that takes at most n bytes a call, then blocks
            for buf, out in ((self.ref, self.out_ref),
                             (self.port, self.out_port)):
                budget = [max(1, n)]

                def write(mv, out=out, budget=budget):
                    if budget[0] <= 0:
                        raise BlockingIOError
                    k = min(len(mv), budget[0], 97)
                    out += bytes(mv[:k])
                    budget[0] -= k
                    return k
                buf.cut_into_writer(write)
        elif op == "gather_writer":
            for buf, out in ((self.ref, self.out_ref),
                             (self.port, self.out_port)):
                def writev(views, out=out, cap=max(1, n)):
                    data = b"".join(bytes(v) for v in views)[:cap]
                    out += data
                    return len(data)
                buf.cut_into_gather_writer(writev, max_iov=3)
        self.check()


def _walk(seed: int, steps: int):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        op = OPS[int(rng.integers(len(OPS)))]
        n = int(rng.integers(0, 12000))
        size = int(rng.integers(0, 10000))
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        yield op, n, data


def case_sequences(seed):
    p = _Pair()
    for op, n, data in _walk(seed, 60):
        p.step(op, n, data)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(st.sampled_from(OPS),
                          st.integers(0, 20000),
                          st.binary(max_size=9000)),
                max_size=40))
def case_random_walk(ops):
    p = _Pair()
    for op, n, data in ops:
        p.step(op, n, data)


def case_portal(chunks):
    rng = np.random.default_rng(len(chunks))
    payload = rng.integers(0, 256, sum(chunks), dtype=np.uint8).tobytes()
    got = {}
    for name, mod in (("ref", ref), ("port", port)):
        a, b = socket.socketpair()
        try:
            b.setblocking(False)
            a.sendall(payload)
            a.shutdown(socket.SHUT_WR)
            portal = mod.IOPortal()
            reads = []
            while True:
                try:
                    n = portal.append_from_reader(b.recv_into, hint=8192)
                except BlockingIOError:
                    continue
                reads.append(n)
                if n == 0:
                    break
            got[name] = (portal.size, portal.to_bytes(), sum(reads))
        finally:
            a.close()
            b.close()
    assert got["ref"] == got["port"]
    assert got["port"][1] == payload


def case_block_pool():
    # a pool of the case's own: other threads of the process recycle too
    saved, port.pool = port.pool, port.BlockPool()
    try:
        _block_pool_recycles(port.pool)
    finally:
        port.pool = saved


def _block_pool_recycles(pool):
    free = pool.classes[port.DEFAULT_BLOCK_SIZE]
    buf = port.IOBuf()
    buf.append(b"x" * 100)
    view = buf.cut(10)                  # a second ref to the same block
    data = view.refs()[0].block.data
    del buf
    gc.collect()
    assert not any(b is data for b, _ in free)  # ``view`` reaches it
    assert view.to_bytes() == b"x" * 10
    del view
    gc.collect()
    assert any(b is data for b, _ in free) and pool.recycled >= 1
    again = port.IOBuf()
    again.append(b"y")
    assert again.refs()[0].block.data is data and pool.hits >= 1
    assert again.to_bytes() == b"y"


CASES = ([(f"sequences[{s}]", case_sequences, (s,)) for s in range(8)]
         + [("random_walk", case_random_walk, ())]
         + [(f"portal[{i}]", case_portal, (c,)) for i, c in enumerate(
             [[1] * 40, [7, 4096, 3, 9000, 1], [65536, 65536], [0]])]
         + [("block_pool", case_block_pool, ())])


def test_iobuf_against_reference():
    _run_cases(CASES)
