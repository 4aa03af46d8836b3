"""HPACK (RFC 7541): the header compression of HTTP/2 (the port of
brpc_tpu/protocol/hpack.py; bRPC's details/hpack.{h,cpp} and
hpack-static-table.h).

The static table (Appendix A) and the Huffman code (Appendix B) are the
RFC's data, as every conforming coder has them. Around them: the integer
and string primitives (section 5), Huffman coding both ways, a dynamic
table with the RFC's size accounting (section 4), and the coder pair.
``HpackEncoder`` indexes every header it sends but the ``sensitive``
ones (never-indexed literals, section 6.2.3); ``HpackDecoder`` refuses
a table size update above the SETTINGS cap, so a peer cannot make it
hold more than the connection agreed. Each side of a connection keeps
its own pair, and the two evict in the same order because both run the
same ``_DynamicTable``.

Every malformed block raises ``HpackError`` and nothing else: a header
block is what any peer may send.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

Header = Tuple[str, str]

# (code, bit length) of symbols 0..255 and EOS (256): RFC 7541 Appendix B
HUFFMAN_TABLE: List[Tuple[int, int]] = [
    (0x1ff8,13),(0x7fffd8,23),(0xfffffe2,28),(0xfffffe3,28),(0xfffffe4,28),
    (0xfffffe5,28),(0xfffffe6,28),(0xfffffe7,28),(0xfffffe8,28),(0xffffea,24),
    (0x3ffffffc,30),(0xfffffe9,28),(0xfffffea,28),(0x3ffffffd,30),
    (0xfffffeb,28),(0xfffffec,28),(0xfffffed,28),(0xfffffee,28),(0xfffffef,28),
    (0xffffff0,28),(0xffffff1,28),(0xffffff2,28),(0x3ffffffe,30),(0xffffff3,28),
    (0xffffff4,28),(0xffffff5,28),(0xffffff6,28),(0xffffff7,28),(0xffffff8,28),
    (0xffffff9,28),(0xffffffa,28),(0xffffffb,28),(0x14,6),(0x3f8,10),(0x3f9,10),
    (0xffa,12),(0x1ff9,13),(0x15,6),(0xf8,8),(0x7fa,11),(0x3fa,10),(0x3fb,10),
    (0xf9,8),(0x7fb,11),(0xfa,8),(0x16,6),(0x17,6),(0x18,6),(0x0,5),(0x1,5),
    (0x2,5),(0x19,6),(0x1a,6),(0x1b,6),(0x1c,6),(0x1d,6),(0x1e,6),(0x1f,6),
    (0x5c,7),(0xfb,8),(0x7ffc,15),(0x20,6),(0xffb,12),(0x3fc,10),(0x1ffa,13),
    (0x21,6),(0x5d,7),(0x5e,7),(0x5f,7),(0x60,7),(0x61,7),(0x62,7),(0x63,7),
    (0x64,7),(0x65,7),(0x66,7),(0x67,7),(0x68,7),(0x69,7),(0x6a,7),(0x6b,7),
    (0x6c,7),(0x6d,7),(0x6e,7),(0x6f,7),(0x70,7),(0x71,7),(0x72,7),(0xfc,8),
    (0x73,7),(0xfd,8),(0x1ffb,13),(0x7fff0,19),(0x1ffc,13),(0x3ffc,14),(0x22,6),
    (0x7ffd,15),(0x3,5),(0x23,6),(0x4,5),(0x24,6),(0x5,5),(0x25,6),(0x26,6),
    (0x27,6),(0x6,5),(0x74,7),(0x75,7),(0x28,6),(0x29,6),(0x2a,6),(0x7,5),
    (0x2b,6),(0x76,7),(0x2c,6),(0x8,5),(0x9,5),(0x2d,6),(0x77,7),(0x78,7),
    (0x79,7),(0x7a,7),(0x7b,7),(0x7ffe,15),(0x7fc,11),(0x3ffd,14),(0x1ffd,13),
    (0xffffffc,28),(0xfffe6,20),(0x3fffd2,22),(0xfffe7,20),(0xfffe8,20),
    (0x3fffd3,22),(0x3fffd4,22),(0x3fffd5,22),(0x7fffd9,23),(0x3fffd6,22),
    (0x7fffda,23),(0x7fffdb,23),(0x7fffdc,23),(0x7fffdd,23),(0x7fffde,23),
    (0xffffeb,24),(0x7fffdf,23),(0xffffec,24),(0xffffed,24),(0x3fffd7,22),
    (0x7fffe0,23),(0xffffee,24),(0x7fffe1,23),(0x7fffe2,23),(0x7fffe3,23),
    (0x7fffe4,23),(0x1fffdc,21),(0x3fffd8,22),(0x7fffe5,23),(0x3fffd9,22),
    (0x7fffe6,23),(0x7fffe7,23),(0xffffef,24),(0x3fffda,22),(0x1fffdd,21),
    (0xfffe9,20),(0x3fffdb,22),(0x3fffdc,22),(0x7fffe8,23),(0x7fffe9,23),
    (0x1fffde,21),(0x7fffea,23),(0x3fffdd,22),(0x3fffde,22),(0xfffff0,24),
    (0x1fffdf,21),(0x3fffdf,22),(0x7fffeb,23),(0x7fffec,23),(0x1fffe0,21),
    (0x1fffe1,21),(0x3fffe0,22),(0x1fffe2,21),(0x7fffed,23),(0x3fffe1,22),
    (0x7fffee,23),(0x7fffef,23),(0xfffea,20),(0x3fffe2,22),(0x3fffe3,22),
    (0x3fffe4,22),(0x7ffff0,23),(0x3fffe5,22),(0x3fffe6,22),(0x7ffff1,23),
    (0x3ffffe0,26),(0x3ffffe1,26),(0xfffeb,20),(0x7fff1,19),(0x3fffe7,22),
    (0x7ffff2,23),(0x3fffe8,22),(0x1ffffec,25),(0x3ffffe2,26),(0x3ffffe3,26),
    (0x3ffffe4,26),(0x7ffffde,27),(0x7ffffdf,27),(0x3ffffe5,26),(0xfffff1,24),
    (0x1ffffed,25),(0x7fff2,19),(0x1fffe3,21),(0x3ffffe6,26),(0x7ffffe0,27),
    (0x7ffffe1,27),(0x3ffffe7,26),(0x7ffffe2,27),(0xfffff2,24),(0x1fffe4,21),
    (0x1fffe5,21),(0x3ffffe8,26),(0x3ffffe9,26),(0xffffffd,28),(0x7ffffe3,27),
    (0x7ffffe4,27),(0x7ffffe5,27),(0xfffec,20),(0xfffff3,24),(0xfffed,20),
    (0x1fffe6,21),(0x3fffe9,22),(0x1fffe7,21),(0x1fffe8,21),(0x7ffff3,23),
    (0x3fffea,22),(0x3fffeb,22),(0x1ffffee,25),(0x1ffffef,25),(0xfffff4,24),
    (0xfffff5,24),(0x3ffffea,26),(0x7ffff4,23),(0x3ffffeb,26),(0x7ffffe6,27),
    (0x3ffffec,26),(0x3ffffed,26),(0x7ffffe7,27),(0x7ffffe8,27),(0x7ffffe9,27),
    (0x7ffffea,27),(0x7ffffeb,27),(0xffffffe,28),(0x7ffffec,27),(0x7ffffed,27),
    (0x7ffffee,27),(0x7ffffef,27),(0x7fffff0,27),(0x3ffffee,26),(0x3fffffff,30),
]

# RFC 7541 Appendix A: the 61 entries of the static table
STATIC_TABLE: List[Header] = [
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""),
]
NSTATIC = len(STATIC_TABLE)


def _static_indexes() -> Tuple[Dict[Header, int], Dict[str, int]]:
    """The first index of each (name, value) and of each name."""
    full: Dict[Header, int] = {}
    names: Dict[str, int] = {}
    for i, (name, value) in enumerate(STATIC_TABLE, 1):
        full.setdefault((name, value), i)
        names.setdefault(name, i)
    return full, names


_STATIC_FULL, _STATIC_NAME = _static_indexes()

EOS = 256
ENTRY_OVERHEAD = 32             # section 4.1: an entry's size beyond its bytes
MAX_INT_SHIFT = 62              # an integer longer than this is refused


class HpackError(Exception):
    """A header block that cannot be decoded (a COMPRESSION_ERROR)."""


# ------------------------------------------------------------- primitives

def encode_integer(value: int, prefix_bits: int, flags: int = 0) -> bytearray:
    """Section 5.1: ``value`` on an N-bit prefix; ``flags`` are the first
    octet's bits above the prefix."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytearray((flags | value,))
    out = bytearray((flags | limit,))
    value -= limit
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return out


def decode_integer(data, pos: int, prefix_bits: int) -> Tuple[int, int]:
    """(value, position after it) of the integer at ``pos``."""
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if shift > MAX_INT_SHIFT:
            raise HpackError("integer overflow")
        if not b & 0x80:
            return value, pos


def huffman_encode(data: bytes) -> bytes:
    """Section 5.2: the codes of ``data``'s bytes, padded with the most
    significant bits of EOS (all ones)."""
    acc = nbits = 0
    out = bytearray()
    table = HUFFMAN_TABLE
    for byte in data:
        code, length = table[byte]
        acc = (acc << length) | code
        nbits += length
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:
        pad = 8 - nbits
        out.append(((acc << pad) | ((1 << pad) - 1)) & 0xFF)
    return bytes(out)


def _decode_trie() -> Tuple[List[int], List[int], List[int]]:
    """The code as a binary trie in three flat lists: the child on a 0
    bit, on a 1 bit (-1: none), and the symbol a node ends (-1: none)."""
    zero, one, sym = [-1], [-1], [-1]
    for s, (code, length) in enumerate(HUFFMAN_TABLE):
        node = 0
        for i in range(length - 1, -1, -1):
            child = one if (code >> i) & 1 else zero
            nxt = child[node]
            if nxt < 0:
                nxt = len(sym)
                zero.append(-1)
                one.append(-1)
                sym.append(-1)
                child[node] = nxt
            node = nxt
        sym[node] = s
    return zero, one, sym


_ZERO, _ONE, _SYM = _decode_trie()


def huffman_decode(data: bytes) -> bytes:
    """The bytes a Huffman string codes; the padding must be shorter
    than 8 bits and all ones (section 5.2), and EOS must not appear."""
    zero, one, sym = _ZERO, _ONE, _SYM
    out = bytearray()
    node = 0
    depth = 0                   # bits since the last symbol
    pad = 0                     # and their values
    for byte in data:
        for i in range(7, -1, -1):
            bit = (byte >> i) & 1
            node = one[node] if bit else zero[node]
            if node < 0:
                raise HpackError("invalid huffman code")
            depth += 1
            pad = (pad << 1) | bit
            s = sym[node]
            if s >= 0:
                if s == EOS:
                    raise HpackError("EOS in huffman string")
                out.append(s)
                node = depth = pad = 0
    if depth > 7:
        raise HpackError("huffman padding too long")
    if pad != (1 << depth) - 1:
        raise HpackError("huffman padding is not an EOS prefix")
    return bytes(out)


def encode_string(s: bytes, huffman: bool = True) -> bytearray:
    """Section 5.2: the shorter of the Huffman and the raw form."""
    if huffman:
        enc = huffman_encode(s)
        if len(enc) < len(s):
            out = encode_integer(len(enc), 7, 0x80)
            out += enc
            return out
    out = encode_integer(len(s), 7, 0x00)
    out += s
    return out


def decode_string(data, pos: int) -> Tuple[bytes, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huff = data[pos] & 0x80
    length, pos = decode_integer(data, pos, 7)
    end = pos + length
    if end > len(data):
        raise HpackError("truncated string literal")
    raw = bytes(data[pos:end])
    return (huffman_decode(raw) if huff else raw), end


# ----------------------------------------------------------- dynamic table

class _DynamicTable:
    """Section 4: a FIFO of entries, the newest at index 1 (61 static
    slots before it at the call sites), evicting the oldest while the
    sizes pass ``max_size``."""

    __slots__ = ("entries", "size", "max_size")

    def __init__(self, max_size: int = 4096):
        self.entries: deque = deque()
        self.size = 0
        self.max_size = max_size

    @staticmethod
    def entry_size(name: str, value: str) -> int:
        return len(name.encode()) + len(value.encode()) + ENTRY_OVERHEAD

    def add(self, name: str, value: str) -> None:
        need = self.entry_size(name, value)
        # an entry bigger than the table empties it and is not added
        self._evict(self.max_size - need)
        if need <= self.max_size:
            self.entries.appendleft((name, value))
            self.size += need

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        self._evict(max_size)

    def _evict(self, budget: int) -> None:
        while self.entries and self.size > budget:
            name, value = self.entries.pop()
            self.size -= self.entry_size(name, value)

    def get(self, index: int) -> Header:
        if 1 <= index <= len(self.entries):
            return self.entries[index - 1]
        raise HpackError(f"dynamic table index {index} out of range")


# ------------------------------------------------------------------ coders

class HpackDecoder:
    def __init__(self, max_table_size: int = 4096):
        self._table = _DynamicTable(max_table_size)
        self._settings_max = max_table_size

    def set_max_table_size(self, n: int) -> None:
        """Our SETTINGS_HEADER_TABLE_SIZE: the peer's encoder must keep
        under it, and the table shrinks to it at once."""
        self._settings_max = n
        if self._table.max_size > n:
            self._table.resize(n)

    def _lookup(self, index: int) -> Header:
        if index == 0:
            raise HpackError("index 0")
        if index <= NSTATIC:
            return STATIC_TABLE[index - 1]
        return self._table.get(index - NSTATIC)

    def _literal(self, data, pos: int, prefix_bits: int
                 ) -> Tuple[Header, int]:
        index, pos = decode_integer(data, pos, prefix_bits)
        if index:
            name = self._lookup(index)[0]
        else:
            raw, pos = decode_string(data, pos)
            name = raw.decode("latin1")
        raw, pos = decode_string(data, pos)
        return (name, raw.decode("latin1")), pos

    def decode(self, data: bytes) -> List[Header]:
        headers: List[Header] = []
        pos = 0
        n = len(data)
        while pos < n:
            b = data[pos]
            if b & 0x80:                        # indexed (6.1)
                index, pos = decode_integer(data, pos, 7)
                headers.append(self._lookup(index))
            elif b & 0x40:                      # incremental indexing (6.2.1)
                hv, pos = self._literal(data, pos, 6)
                self._table.add(*hv)
                headers.append(hv)
            elif b & 0x20:                      # table size update (6.3)
                size, pos = decode_integer(data, pos, 5)
                if size > self._settings_max:
                    raise HpackError("table size update above SETTINGS cap")
                self._table.resize(size)
            else:                               # without / never indexing
                hv, pos = self._literal(data, pos, 4)
                headers.append(hv)
        return headers


class HpackEncoder:
    def __init__(self, max_table_size: int = 4096, huffman: bool = True):
        self._table = _DynamicTable(max_table_size)
        self._huffman = huffman
        self._pending_resize: Optional[int] = None

    def set_max_table_size(self, n: int) -> None:
        """The peer's SETTINGS_HEADER_TABLE_SIZE: the next block starts
        with the size update."""
        self._pending_resize = n

    def _find(self, name: str, value: str) -> Tuple[int, int]:
        """(index of the whole header, index of its name); 0: none."""
        full = _STATIC_FULL.get((name, value), 0)
        name_idx = _STATIC_NAME.get(name, 0)
        for i, (n, v) in enumerate(self._table.entries, NSTATIC + 1):
            if n == name:
                if v == value and not full:
                    full = i
                    break
                if not name_idx:
                    name_idx = i
        return full, name_idx

    def _literal(self, out: bytearray, name_idx: int, name: str,
                 value: str, prefix_bits: int, flags: int) -> None:
        out += encode_integer(name_idx, prefix_bits, flags)
        if not name_idx:
            out += encode_string(name.encode(), self._huffman)
        out += encode_string(value.encode("latin1"), self._huffman)

    def encode(self, headers: Iterable[Header],
               sensitive: Iterable[str] = ()) -> bytes:
        out = bytearray()
        if self._pending_resize is not None:
            self._table.resize(self._pending_resize)
            out += encode_integer(self._pending_resize, 5, 0x20)
            self._pending_resize = None
        for name, value in headers:
            name = name.lower()
            if name in sensitive:
                self._literal(out, _STATIC_NAME.get(name, 0), name, value,
                              4, 0x10)
                continue
            full, name_idx = self._find(name, value)
            if full:
                out += encode_integer(full, 7, 0x80)
                continue
            self._literal(out, name_idx, name, value, 6, 0x40)
            self._table.add(name, value)
        return bytes(out)
