"""The FLV container, written and read (the port of
brpc_tpu/protocol/flv.py; the FLV half of bRPC's rtmp.cpp FlvWriter).

A tag's type ids are RTMP's message types (8 audio, 9 video, 18 script
data), so an RTMP media message drops straight into a tag:
``pack_tag(FlvTag(msg.msg_type, msg.timestamp, msg.payload))``.
``file_header`` is the 9-byte header and PreviousTagSize0;
``parse_header`` checks it and returns the first tag's offset;
``iter_tags`` reads tags to the end, and raises ``FlvError`` on a cut
tag or a wrong PreviousTagSize.
"""

from __future__ import annotations

import struct
from typing import Iterator, NamedTuple, Optional

FLV_HEADER_AUDIO = 0x04
FLV_HEADER_VIDEO = 0x01

TAG_AUDIO = 8
TAG_VIDEO = 9
TAG_SCRIPT = 18

_U32 = struct.Struct(">I")


class FlvTag(NamedTuple):
    tag_type: int
    timestamp: int
    payload: bytes


class FlvError(Exception):
    pass


def file_header(has_audio: bool = True, has_video: bool = True) -> bytes:
    flags = (FLV_HEADER_AUDIO if has_audio else 0) | \
        (FLV_HEADER_VIDEO if has_video else 0)
    return b"FLV\x01" + bytes([flags]) + _U32.pack(9) + _U32.pack(0)


def pack_tag(tag: FlvTag) -> bytes:
    ts = tag.timestamp & 0xFFFFFFFF
    n = len(tag.payload)
    # type, 24-bit size, 24-bit timestamp and its high byte, stream id 0
    head = bytes([tag.tag_type]) + _U32.pack(n)[1:] + \
        _U32.pack(ts & 0xFFFFFF)[1:] + bytes([(ts >> 24) & 0xFF]) + \
        b"\x00\x00\x00"
    return head + tag.payload + _U32.pack(11 + n)


def parse_header(data: bytes) -> int:
    """Checks the 9-byte header and PreviousTagSize0; the offset of the
    first tag."""
    if len(data) < 13:
        raise FlvError("short flv header")
    if data[:4] != b"FLV\x01":
        raise FlvError("bad flv signature")
    offset = _U32.unpack(data[5:9])[0]
    if offset < 9:
        raise FlvError("bad flv data offset")
    return offset + 4


def iter_tags(data: bytes, pos: Optional[int] = None) -> Iterator[FlvTag]:
    if pos is None:
        pos = parse_header(data)
    while pos + 11 <= len(data):
        tag_type = data[pos]
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        ts = int.from_bytes(data[pos + 4:pos + 7], "big") | \
            (data[pos + 7] << 24)
        if pos + 11 + size + 4 > len(data):
            raise FlvError("truncated flv tag")
        payload = data[pos + 11:pos + 11 + size]
        if _U32.unpack(data[pos + 11 + size:pos + 15 + size])[0] != 11 + size:
            raise FlvError("bad PreviousTagSize")
        yield FlvTag(tag_type, ts, payload)
        pos += 11 + size + 4
