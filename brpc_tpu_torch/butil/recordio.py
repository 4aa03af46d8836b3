"""recordio (the port of brpc_tpu/butil/recordio.py; butil/recordio.h):
a length-prefixed, checksummed record stream that resyncs past
corruption. Byte for byte the reference's format:

    "RIO1" | meta_size:u32be | data_size:u32be | crc32:u32be | meta | data

The crc (zlib's crc32, IEEE) covers meta and data. A reader that meets a
bad crc or garbage scans on to the next magic: one torn write loses one
record, not the file."""
from __future__ import annotations

import struct
from typing import Iterator, NamedTuple, Optional
from zlib import crc32 as _crc32

MAGIC = b"RIO1"
_HDR = struct.Struct(">4sIII")
HEADER_SIZE = 16
_MAX_RECORD = 256 << 20


class Record(NamedTuple):
    meta: bytes
    data: bytes


class RecordWriter:
    def __init__(self, fobj):
        self._f = fobj

    def write(self, data: bytes, meta: bytes = b"") -> None:
        data = bytes(data)
        meta = bytes(meta)
        crc = _crc32(meta + data)
        self._f.write(_HDR.pack(MAGIC, len(meta), len(data), crc))
        self._f.write(meta)
        self._f.write(data)

    # records under this size take the single-join single-crc path:
    # one crc + one write over a joined buffer beats chaining three
    # calls for the small-record common case (measured on the capture
    # writer, whose GIL share is exactly this loop). Big records stay
    # chunk-chained: no multi-KB copies.
    _JOIN_MAX = 65536

    def write_chunks(self, chunks, meta: bytes = b"") -> int:
        """One record whose data is the concatenation of ``chunks``,
        never joining large buffers: big chunks go to the file as they
        are, the crc chained (crc32(a+b) == crc32(b, crc32(a))). Returns
        the record's size on disk."""
        meta = bytes(meta)
        total = 0
        for c in chunks:
            total += len(c)
        if len(meta) + total <= self._JOIN_MAX:
            blob = meta + b"".join(chunks)
            self._f.write(_HDR.pack(MAGIC, len(meta), total,
                                    _crc32(blob)))
            self._f.write(blob)
            return HEADER_SIZE + len(blob)
        crc = _crc32(meta)
        for c in chunks:
            crc = _crc32(c, crc)
        self._f.write(_HDR.pack(MAGIC, len(meta), total, crc))
        self._f.write(meta)
        for c in chunks:
            self._f.write(c)
        return HEADER_SIZE + len(meta) + total

    def flush(self) -> None:
        self._f.flush()


class RecordReader:
    """Iterates valid records; silently resyncs past corruption (the
    reference's Reader returns false for the bad record and continues).
    ``self.skipped_bytes`` counts what resync threw away.

    Streams from the file object — memory stays bounded by the largest
    record, not the file size (dump files reach hundreds of MB)."""

    _CHUNK = 256 << 10

    def __init__(self, fobj):
        self._f = fobj
        self._buf = bytearray()
        self._pos = 0
        self._eof = False
        self.skipped_bytes = 0

    def __iter__(self) -> Iterator[Record]:
        return self

    def __next__(self) -> Record:
        r = self.read()
        if r is None:
            raise StopIteration
        return r

    def _compact(self) -> None:
        if self._pos > self._CHUNK:
            del self._buf[:self._pos]
            self._pos = 0

    def _fill(self, need: int) -> bool:
        """Ensure ``need`` bytes are available from _pos; False at EOF."""
        while len(self._buf) - self._pos < need and not self._eof:
            chunk = self._f.read(self._CHUNK)
            if not chunk:
                self._eof = True
                break
            self._buf += chunk
        return len(self._buf) - self._pos >= need

    def read(self) -> Optional[Record]:
        while True:
            self._compact()
            if not self._fill(len(MAGIC)):
                self.skipped_bytes += len(self._buf) - self._pos
                self._pos = len(self._buf)
                return None
            idx = self._buf.find(MAGIC, self._pos)
            while idx < 0:
                # keep a magic-sized tail: the magic may straddle reads
                keep = len(self._buf) - (len(MAGIC) - 1)
                if keep > self._pos:
                    self.skipped_bytes += keep - self._pos
                    self._pos = keep
                self._compact()
                if self._eof:
                    self.skipped_bytes += len(self._buf) - self._pos
                    self._pos = len(self._buf)
                    return None
                self._fill(len(self._buf) - self._pos + 1)
                idx = self._buf.find(MAGIC, self._pos)
            self.skipped_bytes += idx - self._pos
            self._pos = idx
            if not self._fill(HEADER_SIZE):
                return None         # truncated tail (torn final write)
            magic, meta_size, data_size, crc = _HDR.unpack_from(
                self._buf, self._pos)
            total = meta_size + data_size
            if total > _MAX_RECORD:
                self._pos += 1      # false magic / corrupt header: resync
                continue
            if not self._fill(HEADER_SIZE + total):
                # can't satisfy the declared size: either a torn final
                # write (real truncated tail) or a FALSE magic whose bogus
                # header claims more than the file holds. If another magic
                # is visible past this one, it's the latter — resync so the
                # valid records after it aren't silently discarded.
                if self._buf.find(MAGIC, self._pos + 1) >= 0:
                    self._pos += 1
                    continue
                return None         # truncated tail
            start = self._pos + HEADER_SIZE
            meta = bytes(self._buf[start:start + meta_size])
            data = bytes(self._buf[start + meta_size:start + total])
            if _crc32(meta + data) != crc:
                self._pos += 1      # corrupt: scan to next magic
                continue
            self._pos += HEADER_SIZE + total
            return Record(meta, data)
