"""Hashes of the RPC layer (the port of brpc_tpu/butil/hash.py): crc32c
(butil/crc32c.cc) and murmur3 x64-128 (butil/third_party/murmurhash3,
policy/hasher.cpp), which keys the ``c_murmurhash`` balancer's ring.

Both go through the port's native library (``brpc_tpu_torch.native``,
hash.cc) when it loads; ``crc32c_py`` and ``murmur3_x64_128_py`` are the
same arithmetic in Python, bit for bit, for a process without it.
"""

from __future__ import annotations

from typing import List

from brpc_tpu_torch import native

_CRC_POLY = 0x82F63B78
_M64 = 0xFFFFFFFFFFFFFFFF


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes, init: int = 0) -> int:
    v = native.crc32c(data, init)
    return crc32c_py(data, init) if v is None else v


def crc32c_py(data: bytes, init: int = 0) -> int:
    crc = init ^ 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _M64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _M64
    k ^= k >> 33
    return k


def murmur3_x64_128(data: bytes, seed: int = 0) -> int:
    """The 128-bit hash as an int: ``(h2 << 64) | h1``."""
    v = native.murmur3_x64_128(data, seed)
    return murmur3_x64_128_py(data, seed) if v is None else v


def murmur3_x64_128_py(data: bytes, seed: int = 0) -> int:
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    h1 = h2 = seed
    length = len(data)
    nblocks = length // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16:i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8:i * 16 + 16], "little")
        k1 = _rotl64((k1 * c1) & _M64, 31)
        h1 ^= (k1 * c2) & _M64
        h1 = (_rotl64(h1, 27) + h2) & _M64
        h1 = (h1 * 5 + 0x52DCE729) & _M64
        k2 = _rotl64((k2 * c2) & _M64, 33)
        h2 ^= (k2 * c1) & _M64
        h2 = (_rotl64(h2, 31) + h1) & _M64
        h2 = (h2 * 5 + 0x38495AB5) & _M64
    tail = data[nblocks * 16:]
    if len(tail) > 8:
        k2 = _rotl64((int.from_bytes(tail[8:], "little") * c2) & _M64, 33)
        h2 ^= (k2 * c1) & _M64
    if tail:
        k1 = _rotl64((int.from_bytes(tail[:8], "little") * c1) & _M64, 31)
        h1 ^= (k1 * c2) & _M64
    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    h1, h2 = _fmix64(h1), _fmix64(h2)
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    return (h2 << 64) | h1


def murmur3_32of128(data: bytes, seed: int = 0) -> int:
    """The low 32 bits: what the consistent-hash ring keys on."""
    return murmur3_x64_128(data, seed) & 0xFFFFFFFF
