"""IOBuf: a chained buffer of refcounted host blocks (the port of
brpc_tpu/butil/iobuf.py, host blocks only; bRPC's butil/iobuf.h:64).

Appending and cutting move (offset, length) views of shared blocks and
never copy payload bytes; a block's buffer returns to the process-wide
``BlockPool`` when no view can reach it any more (a ``weakref.finalize``
on the Block, so no manual refcount can race). ``IOPortal`` reads from a
non-blocking reader into spare block space (``append_from_reader``),
and ``cut_into_writer`` / ``cut_into_gather_writer`` feed a socket's
``send`` / ``sendmsg`` and consume what it took.

Device blocks (``DeviceBlock``, ``append_device_array``) hold a 1-D
``torch.uint8`` tensor, on the card or the host; a ref into one is
``is_device`` and slices the tensor without a copy (``device_array``).
Its bytes come only from ``to_bytes``, an explicit ``.cpu()`` copy: a
device ref has no memoryview, so no writer sends it by accident.

``PinnedStaging`` / ``pinned_staging_block`` (brpc_tpu/butil/iobuf.py:
241-275) are the host staging memory of H2D copies, used by the pinned
stager of ``ici://``'s staged lane (``butil/device_pool.py``). The
reference's mlock'd native arena becomes a freelist of page-locked
torch blocks (``pin_memory=True``) by size class: pinning costs tens of
microseconds to milliseconds a block, so a block is reused, never
allocated a batch. Without a card the blocks are plain host memory,
pooled the same way (``pinned`` False).
"""

from __future__ import annotations

import weakref
from typing import Callable, List, Optional, Tuple

DEFAULT_BLOCK_SIZE = 8192      # the reference's payload-block size
BIG_BLOCK_SIZE = 262144        # read blocks of bulk transfers
_MAX_CACHED_BLOCKS = 64
_MAX_CACHED_BIG_BLOCKS = max(1, (16 << 20) // BIG_BLOCK_SIZE)
# bytes payloads of at least this size are wrapped, not copied, by append
_APPEND_ZEROCOPY_MIN = 16384


class BlockPool:
    """Process-wide size-classed freelists of block buffers, one global
    pool rather than the reference's per-thread caches: a block read on
    the dispatcher is freed on a fiber worker. Each entry is one (buffer,
    generation) tuple, so a pop and an append are each one list
    operation, atomic under the interpreter lock. A recycle bumps the
    generation; a Block records the one it was born under. The counters
    are statistics, approximate under races."""

    __slots__ = ("classes", "caps", "hits", "misses", "recycled",
                 "dropped", "generation")

    def __init__(self):
        self.classes = {DEFAULT_BLOCK_SIZE: [], BIG_BLOCK_SIZE: []}
        self.caps = {DEFAULT_BLOCK_SIZE: _MAX_CACHED_BLOCKS,
                     BIG_BLOCK_SIZE: _MAX_CACHED_BIG_BLOCKS}
        self.hits = 0
        self.misses = 0
        self.recycled = 0
        self.dropped = 0
        self.generation = 0

    def acquire(self, capacity: int):
        """(buffer, generation) of a pooled size class, reused when one
        is cached; None for a size the pool does not keep."""
        lst = self.classes.get(capacity)
        if lst is None:
            return None
        try:                            # the check and the pop in one op
            buf, gen = lst.pop()
            self.hits += 1
            return buf, gen
        except IndexError:
            self.misses += 1
            return bytearray(capacity), self.generation

    def recycle(self, buf: bytearray) -> None:
        """Take a buffer back (the Block's finalizer: no view can reach
        it any more)."""
        lst = self.classes.get(len(buf))
        if lst is None:
            return
        if len(lst) >= self.caps[len(buf)]:
            self.dropped += 1
            return
        self.generation += 1
        lst.append((buf, self.generation))
        self.recycled += 1

    def hit_ratio(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def cached_bytes(self) -> int:
        return sum(cap * len(lst) for cap, lst in self.classes.items())


pool = BlockPool()

from brpc_tpu_torch.butil import resource_census as _census  # noqa: E402
#   (the census registration ships with the pool it measures)

_census.register("iobuf_pool", lambda: {
    "bytes": pool.cached_bytes(),
    "count": sum(len(lst) for lst in pool.classes.values()),
    "hit_ratio": round(pool.hit_ratio(), 4)})


def _recycle_buffer(buf: bytearray) -> None:
    pool.recycle(buf)


# ------------------------------------------------------ pinned staging

_PINNED_MIN_CLASS = 64 << 10
_PINNED_MAX_CLASS = 64 << 20
_PINNED_CACHED_PER_CLASS = 8


def _pinned_class(nbytes: int) -> int:
    """The power-of-two size class of an ``nbytes`` block; 0 for a size
    past the largest class (allocated for the request, not pooled)."""
    c = _PINNED_MIN_CLASS
    while c < nbytes:
        c <<= 1
    return c if c <= _PINNED_MAX_CLASS else 0


class PinnedBlockPool:
    """Size-classed freelists of 1-D ``torch.uint8`` host blocks,
    page-locked when a card is there. ``acquire`` pops a cached block
    or makes one; ``recycle`` keeps at most ``_PINNED_CACHED_PER_CLASS``
    a class. The interpreter lock makes each list operation atomic."""

    __slots__ = ("classes", "hits", "misses", "pin")

    def __init__(self):
        self.classes: dict = {}
        self.hits = 0
        self.misses = 0
        self.pin: Optional[bool] = None     # decided at first use

    def _pinnable(self) -> bool:
        if self.pin is None:
            import torch
            self.pin = torch.cuda.is_available()
        return self.pin

    def acquire(self, nbytes: int):
        import torch
        cls = _pinned_class(nbytes)
        lst = self.classes.get(cls) if cls else None
        if lst:
            try:
                blk = lst.pop()
                self.hits += 1
                return blk
            except IndexError:          # a racing pop took the last one
                pass
        self.misses += 1
        return torch.empty(cls or nbytes, dtype=torch.uint8,
                           pin_memory=self._pinnable())

    def recycle(self, blk) -> None:
        cls = blk.numel()
        if _pinned_class(cls) != cls:
            return                      # an unpooled size: dropped
        lst = self.classes.setdefault(cls, [])
        if len(lst) < _PINNED_CACHED_PER_CLASS:
            lst.append(blk)

    def cached_bytes(self) -> int:
        return sum(c * len(lst) for c, lst in self.classes.items())


pinned_pool = PinnedBlockPool()


class PinnedStaging:
    """Host staging memory for one H2D copy: ``tensor`` is a 1-D
    ``torch.uint8`` block of at least ``nbytes`` (page-locked when
    ``pinned``), ``view`` its first ``nbytes`` as a writable
    memoryview. ``release()`` returns the block to its freelist, once;
    call it after the device copy that reads the block has completed."""

    __slots__ = ("tensor", "view", "pinned", "_pool", "__weakref__")

    def __init__(self, block, nbytes: int, pool: PinnedBlockPool,
                 pinned: bool):
        self.tensor = block[:nbytes]
        self.view = memoryview(block.numpy())[:nbytes]
        self.pinned = pinned
        self._pool = pool

    def release(self) -> None:
        p, self._pool = self._pool, None
        if p is not None:
            self.view.release()
            p.recycle(self.tensor._base if self.tensor._base is not None
                      else self.tensor)
            self.tensor = None


def pinned_staging_block(nbytes: int,
                         pool: Optional[PinnedBlockPool] = None
                         ) -> PinnedStaging:
    """Staging memory for an H2D copy of ``nbytes``: a page-locked block
    from the freelist when a card is there (the DMA engine reads locked
    pages directly), plain host memory otherwise: one interface, so
    callers never branch on which."""
    pool = pool or pinned_pool
    blk = pool.acquire(max(1, nbytes))
    return PinnedStaging(blk, nbytes, pool, bool(blk.is_pinned()))


class Block:
    """A contiguous host buffer whose first ``size`` bytes are valid; an
    IOBuf holding the ref that ends at ``size`` may append into the rest."""

    __slots__ = ("data", "size", "capacity", "gen", "__weakref__")

    def __init__(self, capacity: int = DEFAULT_BLOCK_SIZE):
        got = pool.acquire(capacity)
        if got is not None:
            self.data, self.gen = got
            weakref.finalize(self, _recycle_buffer, self.data)
        else:
            self.data = bytearray(capacity)
            self.gen = 0
        self.size = 0
        self.capacity = len(self.data)

    def left_space(self) -> int:
        return self.capacity - self.size

    @classmethod
    def from_user_data(cls, data, deleter: Optional[Callable] = None
                       ) -> "Block":
        """Wrap external bytes-like data without a copy
        (iobuf.h:263 append_user_data)."""
        blk = cls.__new__(cls)
        mv = memoryview(data)
        blk.data = mv
        blk.size = len(mv)
        blk.capacity = len(mv)
        blk.gen = 0
        if deleter is not None:
            weakref.finalize(blk, deleter, data)
        return blk


class DeviceBlock:
    """A payload segment held as a 1-D ``torch.uint8`` tensor (brpc_tpu's
    DeviceBlock over a uint8 jax.Array). Refs slice it without a copy."""

    __slots__ = ("array", "size", "__weakref__")

    def __init__(self, array):
        import torch
        if not isinstance(array, torch.Tensor) or array.dtype != torch.uint8 \
                or array.dim() != 1:
            raise TypeError("a device block is a 1-D torch.uint8 tensor")
        self.array = array
        self.size = int(array.shape[0])

    @property
    def capacity(self) -> int:
        return self.size

    def left_space(self) -> int:
        return 0


class BlockRef:
    """A view (offset, length) into a Block or a DeviceBlock."""

    __slots__ = ("block", "offset", "length")

    def __init__(self, block, offset: int, length: int):
        self.block = block
        self.offset = offset
        self.length = length

    @property
    def is_device(self) -> bool:
        return isinstance(self.block, DeviceBlock)

    def memoryview(self) -> memoryview:
        if self.is_device:
            raise TypeError("a device ref has no host memoryview: "
                            "to_bytes() copies it to the host")
        return memoryview(self.block.data)[self.offset:
                                           self.offset + self.length]

    def device_array(self):
        """The tensor slice this ref covers (no copy)."""
        arr = self.block.array
        if self.offset == 0 and self.length == self.block.size:
            return arr
        return arr[self.offset:self.offset + self.length]

    def to_bytes(self) -> bytes:
        if self.is_device:
            # the one way out of a device block: an explicit host copy
            return self.device_array().cpu().numpy().tobytes()
        blk = self.block
        d = blk.data
        if self.offset == 0 and self.length == blk.size \
                and type(d) is memoryview and type(d.obj) is bytes \
                and d.nbytes == len(d.obj) and d.contiguous:
            # the ref covers a whole wrapped immutable payload: hand the
            # original bytes back instead of copying them
            return d.obj
        return bytes(self.memoryview())


class IOBuf:
    """A chain of BlockRefs; append and cut never copy payload bytes."""

    __slots__ = ("_refs",)

    def __init__(self):
        self._refs: List[BlockRef] = []

    # ------------------------------------------------------------ inspect
    @property
    def size(self) -> int:
        return sum(r.length for r in self._refs)

    def __bool__(self) -> bool:
        return bool(self._refs)

    @property
    def backing_block_count(self) -> int:
        return len(self._refs)

    def refs(self) -> Tuple[BlockRef, ...]:
        return tuple(self._refs)

    # ------------------------------------------------------------- append
    def append(self, data) -> None:
        """Append host bytes: small ones are copied into pooled blocks,
        large immutable ``bytes`` are wrapped (append_user_data)."""
        if isinstance(data, IOBuf):
            self.append_buf(data)
            return
        if isinstance(data, bytes) and len(data) >= _APPEND_ZEROCOPY_MIN:
            self._refs.append(
                BlockRef(Block.from_user_data(data), 0, len(data)))
            return
        mv = memoryview(data).cast("B")
        n = mv.nbytes
        pos = 0
        while pos < n:
            tail = self._writable_tail()
            if tail is None:
                blk = Block(DEFAULT_BLOCK_SIZE)
                take = min(n - pos, blk.left_space())
                blk.data[0:take] = mv[pos:pos + take]
                blk.size = take
                self._refs.append(BlockRef(blk, 0, take))
            else:
                ref, blk = tail
                take = min(n - pos, blk.left_space())
                blk.data[blk.size:blk.size + take] = mv[pos:pos + take]
                blk.size += take
                ref.length += take
            pos += take

    def _writable_tail(self) -> Optional[Tuple[BlockRef, Block]]:
        """The last ref and its block when this IOBuf may extend into the
        block's spare space: it owns the block's high-water mark."""
        if not self._refs:
            return None
        ref = self._refs[-1]
        blk = ref.block
        if not isinstance(getattr(blk, "data", None), bytearray):
            return None
        if ref.offset + ref.length != blk.size or blk.left_space() == 0:
            return None
        return ref, blk

    def append_buf(self, other: "IOBuf") -> None:
        """Append another IOBuf's refs (no byte copy)."""
        for r in other._refs:
            self._refs.append(BlockRef(r.block, r.offset, r.length))

    def append_user_data(self, data,
                         deleter: Optional[Callable] = None) -> None:
        blk = Block.from_user_data(data, deleter)
        if blk.size:
            self._refs.append(BlockRef(blk, 0, blk.size))

    def append_device_array(self, array) -> None:
        """Append a 1-D uint8 tensor as a device block, without a copy."""
        blk = DeviceBlock(array)
        if blk.size:
            self._refs.append(BlockRef(blk, 0, blk.size))

    def has_device_blocks(self) -> bool:
        return any(r.is_device for r in self._refs)

    def device_arrays(self) -> List:
        """The tensor slices of the device refs, in order."""
        return [r.device_array() for r in self._refs if r.is_device]

    # ---------------------------------------------------------------- cut
    def cut(self, n: int) -> "IOBuf":
        """Move the first n bytes into a new IOBuf; at most one ref is
        split (iobuf.h cutn)."""
        out = IOBuf()
        self.cut_into(out, n)
        return out

    def cut_into(self, out: "IOBuf", n: int) -> int:
        """Move up to n bytes into ``out``; the bytes moved."""
        moved = 0
        while n > 0 and self._refs:
            r = self._refs[0]
            if r.length <= n:
                out._refs.append(r)
                self._refs.pop(0)
                n -= r.length
                moved += r.length
            else:
                out._refs.append(BlockRef(r.block, r.offset, n))
                r.offset += n
                r.length -= n
                moved += n
                n = 0
        return moved

    def pop_front(self, n: int) -> int:
        """Drop the first n bytes; the bytes dropped."""
        dropped = 0
        while n > 0 and self._refs:
            r = self._refs[0]
            if r.length <= n:
                self._refs.pop(0)
                n -= r.length
                dropped += r.length
            else:
                r.offset += n
                r.length -= n
                dropped += n
                n = 0
        return dropped

    # ------------------------------------------------------------ consume
    def to_bytes(self) -> bytes:
        if len(self._refs) == 1:
            return self._refs[0].to_bytes()
        return b"".join(r.to_bytes() for r in self._refs)

    def peek_bytes(self, n: int) -> bytes:
        """The first n bytes (or fewer, if fewer are held), not consumed."""
        refs = self._refs
        if refs and refs[0].length >= n:
            r = refs[0]
            if r.length == n:
                return r.to_bytes()
            return _head(r, n)
        chunks = []
        need = n
        for r in refs:
            if need <= 0:
                break
            take = min(need, r.length)
            chunks.append(_head(r, take))
            need -= take
        return b"".join(chunks)

    # ----------------------------------------------------------------- io
    def cut_into_gather_writer(self, writev: Callable,
                               max_iov: int = 32) -> int:
        """Feed the chain to a gather-write callable (sendmsg), one call
        per batch of up to ``max_iov`` refs; consume what it took and
        return the total. BlockingIOError stops with the rest intact."""
        total = 0
        while self._refs:
            views = [r.memoryview() for r in self._refs[:max_iov]]
            offered = sum(len(v) for v in views)
            try:
                nw = writev(views)
            except BlockingIOError:
                break
            if nw is None or nw <= 0:
                break
            self.pop_front(nw)
            total += nw
            if nw < offered:
                break
        return total

    def cut_into_writer(self, write: Callable[[memoryview], int],
                        max_bytes: Optional[int] = None) -> int:
        """Feed refs to a write callable (socket.send-like, may write
        short); consume what it took and return the total
        (iobuf.h:163 cut_into_file_descriptor)."""
        total = 0
        budget = max_bytes if max_bytes is not None else float("inf")
        while self._refs and budget > 0:
            mv = self._refs[0].memoryview()
            if budget < len(mv):
                mv = mv[:int(budget)]
            try:
                nw = write(mv)
            except BlockingIOError:
                break
            if nw is None or nw <= 0:
                break
            self.pop_front(nw)
            total += nw
            budget -= nw
            if nw < len(mv):
                break
        return total


def _head(r: BlockRef, n: int) -> bytes:
    """The first n bytes of a ref (a device ref's by a host copy)."""
    if r.is_device:
        return r.device_array()[:n].cpu().numpy().tobytes()
    return bytes(r.memoryview()[:n])


class IOPortal(IOBuf):
    """An IOBuf that reads from a non-blocking reader (iobuf.h:457)."""

    def append_from_reader(self, recv_into: Callable[[memoryview], int],
                           hint: int = 65536) -> int:
        """Read once into the tail block's spare space, or into a fresh
        block of at least ``hint`` bytes. The bytes read; 0 at EOF;
        BlockingIOError when the reader would block."""
        tail = self._writable_tail()
        if tail is not None:
            ref, blk = tail
            # a nearly full tail would cap the read at a few bytes
            if blk.left_space() >= 4096:
                mv = memoryview(blk.data)[blk.size:blk.capacity]
                nr = recv_into(mv)
                if nr and nr > 0:
                    blk.size += nr
                    ref.length += nr
                    return nr
                return 0
        blk = Block(max(hint, DEFAULT_BLOCK_SIZE))
        nr = recv_into(memoryview(blk.data)[0:blk.capacity])
        if nr and nr > 0:
            blk.size = nr
            self._refs.append(BlockRef(blk, 0, nr))
            return nr
        return 0
