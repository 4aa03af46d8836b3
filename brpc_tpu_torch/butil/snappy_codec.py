"""Snappy block format, pure Python (the port of
brpc_tpu/butil/snappy_codec.py without its native path; the reference's
policy/snappy_compress.cpp registers snappy as a wire compressor).

A greedy hash-table matcher emits literal and copy elements over
independent 64 KB fragments, with the same matcher and the same emission
rules as brpc_tpu's native and pure codecs, so all three give the same
compressed bytes for the same input.

Format:
  preamble  uncompressed length, LE base-128 varint
  elements  tag byte, low 2 bits select the kind:
    00 literal   len-1 in tag>>2 if <60, else 60..63 = 1..4 LE length bytes
    01 copy1     len 4..11 = 4+((tag>>2)&7); offset 11 bits: (tag>>5)<<8|byte
    10 copy2     len 1..64 = (tag>>2)+1; offset = 2 LE bytes
    11 copy4     len 1..64 = (tag>>2)+1; offset = 4 LE bytes
  copies may overlap themselves (offset < length repeats a pattern).
"""

from __future__ import annotations

_HASH_BITS = 14
_HASH_MUL = 0x1E35A7BD
_MIN_MATCH = 4


class SnappyError(ValueError):
    pass


def _emit_varint(out: bytearray, n: int) -> None:
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _emit_literal(out: bytearray, data, start: int, end: int) -> None:
    n = end - start
    if n <= 0:
        return
    rem = n - 1
    if rem < 60:
        out.append(rem << 2)
    elif rem < (1 << 8):
        out.append(60 << 2)
        out.append(rem)
    elif rem < (1 << 16):
        out.append(61 << 2)
        out += rem.to_bytes(2, "little")
    elif rem < (1 << 24):
        out.append(62 << 2)
        out += rem.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += rem.to_bytes(4, "little")
    out += data[start:end]


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    # chunk long matches into <=64-byte copies, keeping every chunk and
    # the remainder >= MIN_MATCH
    while length >= 68:
        _emit_copy_chunk(out, offset, 64)
        length -= 64
    if length > 64:                       # 65..67: leave a >=5 tail
        _emit_copy_chunk(out, offset, 60)
        length -= 60
    _emit_copy_chunk(out, offset, length)


def _emit_copy_chunk(out: bytearray, offset: int, length: int) -> None:
    if 4 <= length <= 11 and offset < 2048:
        out.append(0x01 | ((length - 4) << 2) | ((offset >> 8) << 5))
        out.append(offset & 0xFF)
    elif offset < (1 << 16):
        out.append(0x02 | ((length - 1) << 2))
        out += offset.to_bytes(2, "little")
    else:
        out.append(0x03 | ((length - 1) << 2))
        out += offset.to_bytes(4, "little")


_FRAGMENT = 1 << 16


def compress(data) -> bytes:
    """Compress in independent 64 KB fragments (no match crosses a
    fragment boundary), as snappy does: offsets stay under 65536 and
    copy4 is never emitted, so adversarial input grows by at most
    32 + n/6 bytes."""
    data = bytes(data)
    n = len(data)
    out = bytearray()
    _emit_varint(out, n)
    if n == 0:
        return bytes(out)
    if n < _MIN_MATCH + 1:
        _emit_literal(out, data, 0, n)
        return bytes(out)

    shift = 32 - _HASH_BITS
    mask = 0xFFFFFFFF
    base = 0
    while base < n:
        frag_end = min(base + _FRAGMENT, n)
        table = [0] * (1 << _HASH_BITS)   # position+1 (absolute); 0 = empty
        lit_start = base
        pos = base
        limit = frag_end - _MIN_MATCH
        while pos <= limit:
            cur = int.from_bytes(data[pos:pos + 4], "little")
            h = ((cur * _HASH_MUL) & mask) >> shift
            cand = table[h] - 1
            table[h] = pos + 1
            if cand >= 0 and \
                    data[cand:cand + 4] == data[pos:pos + 4]:
                # extend the match (within the fragment only)
                m = pos + 4
                c = cand + 4
                while m < frag_end and data[m] == data[c]:
                    m += 1
                    c += 1
                _emit_literal(out, data, lit_start, pos)
                _emit_copy(out, pos - cand, m - pos)
                pos = m
                lit_start = m
            else:
                pos += 1
        _emit_literal(out, data, lit_start, frag_end)
        base = frag_end
    return bytes(out)


def decompress(data) -> bytes:
    data = bytes(data)
    i = 0
    n = 0
    shift = 0
    ln = len(data)
    while True:
        if i >= ln:
            raise SnappyError("truncated preamble")
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
        if shift > 32:
            raise SnappyError("preamble varint too long")
    # the preamble comes from the peer: refuse a length past the format's
    # largest expansion (under 22x the input) before decoding anything
    if n > 32 + 22 * ln:
        raise SnappyError("preamble exceeds maximum possible expansion")
    out = bytearray()
    while i < ln:
        tag = data[i]
        i += 1
        kind = tag & 3
        if kind == 0:                       # literal
            rem = tag >> 2
            if rem >= 60:
                extra = rem - 59
                if i + extra > ln:
                    raise SnappyError("truncated literal length")
                rem = int.from_bytes(data[i:i + extra], "little")
                i += extra
            length = rem + 1
            if i + length > ln:
                raise SnappyError("truncated literal")
            out += data[i:i + length]
            i += length
            continue
        if kind == 1:                       # copy, 1-byte offset
            length = 4 + ((tag >> 2) & 0x7)
            if i >= ln:
                raise SnappyError("truncated copy1")
            offset = ((tag >> 5) << 8) | data[i]
            i += 1
        elif kind == 2:                     # copy, 2-byte offset
            length = (tag >> 2) + 1
            if i + 2 > ln:
                raise SnappyError("truncated copy2")
            offset = int.from_bytes(data[i:i + 2], "little")
            i += 2
        else:                               # copy, 4-byte offset
            length = (tag >> 2) + 1
            if i + 4 > ln:
                raise SnappyError("truncated copy4")
            offset = int.from_bytes(data[i:i + 4], "little")
            i += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("copy offset out of range")
        if offset >= length:
            start = len(out) - offset
            out += out[start:start + length]
        else:
            # overlapping copy: repeats the last `offset` bytes
            start = len(out) - offset
            for k in range(length):
                out.append(out[start + k])
    if len(out) != n:
        raise SnappyError(f"length mismatch: preamble {n}, got {len(out)}")
    return bytes(out)
