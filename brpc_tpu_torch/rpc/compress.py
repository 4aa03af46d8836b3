"""Payload compression by the numeric type in ``RpcMeta.compress_type``
(the port of brpc_tpu/rpc/compress.py; brpc/compress.{h,cpp} with
policy/gzip_compress.cpp and snappy_compress.cpp).

0 is none, 1 gzip (level 6), 2 zlib and 3 snappy (``butil/
snappy_codec.py``: native when the port's library loads, else pure
Python). A client compresses its request once, before the first
attempt; the server decompresses it and answers in the same kind. An unknown type is an error, never passed through.
"""

from __future__ import annotations

import gzip
import zlib
from typing import Callable, Dict, Tuple

from brpc_tpu_torch.butil import snappy_codec

COMPRESS_NONE = 0
COMPRESS_GZIP = 1
COMPRESS_ZLIB = 2
COMPRESS_SNAPPY = 3

_codecs: Dict[int, Tuple[Callable[[bytes], bytes],
                         Callable[[bytes], bytes]]] = {
    COMPRESS_GZIP: (lambda b: gzip.compress(b, 6), gzip.decompress),
    COMPRESS_ZLIB: (zlib.compress, zlib.decompress),
    COMPRESS_SNAPPY: (snappy_codec.compress_auto,
                      snappy_codec.decompress_auto),
}


def _codec(ctype: int):
    codec = _codecs.get(ctype)
    if codec is None:
        raise ValueError(f"unknown compress_type {ctype}")
    return codec


def compress(data: bytes, ctype: int) -> bytes:
    if ctype == COMPRESS_NONE or not data:
        return data
    return _codec(ctype)[0](data)


def decompress(data: bytes, ctype: int) -> bytes:
    if ctype == COMPRESS_NONE or not data:
        return data
    return _codec(ctype)[1](data)
