"""The MPEG-TS muxer, HLS's leg of the media stack: RTMP and FLV media
remuxed into transport-stream segments (the port of
brpc_tpu/protocol/ts.py; bRPC's ts.{h,cpp}).

It writes 188-byte packets, stuffing the adaptation field where a
payload falls short; PAT and PMT sections with the MPEG-2 CRC32; PES
packets with a PTS (90 kHz), and a six-byte PCR on the video PID's
first packet of each frame; a continuity counter per PID. Stream types:
H.264 video (0x1B) and AAC audio (0x0F). ``iter_packets`` and
``extract_pes`` read a segment back.

``mpeg_crc32`` is the reference's bit loop (poly 0x04C11DB7, MSB first,
init 0xFFFFFFFF, no final xor, no reflection) unrolled into a 256-entry
table, which gives the same values a byte at a time.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, NamedTuple, Optional

TS_PACKET_SIZE = 188
PAT_PID = 0x0000
PMT_PID = 0x1000
VIDEO_PID = 0x0100
AUDIO_PID = 0x0101
PROGRAM = 1
STREAM_TYPE_H264 = 0x1B
STREAM_TYPE_AAC = 0x0F
_SYNC = 0x47


def _crc_table() -> List[int]:
    table = []
    for byte in range(256):
        crc = byte << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) & 0xFFFFFFFF \
                if crc & 0x80000000 else (crc << 1) & 0xFFFFFFFF
        table.append(crc)
    return table


_CRC_TABLE = _crc_table()


def mpeg_crc32(data: bytes) -> int:
    """MPEG-2 CRC32 (not crc32c): see the module's doc."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ table[(crc >> 24) ^ byte]
    return crc


class TsError(Exception):
    pass


def _packet(pid: int, payload, counter: int, start: bool,
            adaptation: bytes = b"", pcr: Optional[int] = None):
    """One 188-byte packet of ``payload``'s head, the adaptation field
    stuffed as needed: (packet bytes, payload bytes it took)."""
    if pcr is not None:
        base, ext = divmod(pcr, 300)
        # 48 bits: 33-bit base, 6 reserved ones, 9-bit extension: bytes
        # 2..7 of the 8-byte pack, which keeps the base's top byte past
        # about six minutes of clock
        pcr_bytes = struct.pack(">Q", (base << 15) | (0x3F << 9) | ext)[2:]
        adaptation = bytes([0x10]) + pcr_bytes + adaptation   # PCR flag
    space = TS_PACKET_SIZE - 4
    has_af = len(adaptation) > 0
    body_space = space - (1 + len(adaptation) if has_af else 0)
    if len(payload) < body_space:
        pad = body_space - len(payload)
        if not has_af:
            # a one-byte field is its length byte alone (0)
            adaptation = b"" if pad == 1 else \
                bytes([0x00]) + b"\xff" * (pad - 2)
            has_af = True
        else:
            adaptation = adaptation + b"\xff" * pad
        body_space = space - 1 - len(adaptation)
    take = bytes(payload[:body_space])
    header = bytes([
        _SYNC,
        (0x40 if start else 0) | (pid >> 8) & 0x1F,
        pid & 0xFF,
        (0x30 if has_af else 0x10) | (counter & 0x0F),
    ])
    out = header + (bytes([len(adaptation)]) + adaptation if has_af
                    else b"") + take
    if len(out) != TS_PACKET_SIZE:
        raise TsError(f"internal: packet size {len(out)}")
    return out, len(take)


def _psi_section(table_id: int, body: bytes) -> bytes:
    # section_length covers the body and the CRC
    sec = bytes([table_id]) + \
        struct.pack(">H", 0xB000 | (len(body) + 4 + 5)) + \
        struct.pack(">H", PROGRAM) + bytes([0xC1, 0x00, 0x00]) + body
    return sec + struct.pack(">I", mpeg_crc32(sec))


def pat_section() -> bytes:
    return _psi_section(0x00, struct.pack(">HH", PROGRAM,
                                          0xE000 | PMT_PID))


def pmt_section(has_video: bool = True, has_audio: bool = True) -> bytes:
    streams = b""
    if has_video:
        streams += bytes([STREAM_TYPE_H264]) + \
            struct.pack(">HH", 0xE000 | VIDEO_PID, 0xF000)
    if has_audio:
        streams += bytes([STREAM_TYPE_AAC]) + \
            struct.pack(">HH", 0xE000 | AUDIO_PID, 0xF000)
    # the PCR lives on a PID that carries packets: audio alone clocks
    # off the audio PID
    pcr_pid = VIDEO_PID if has_video else AUDIO_PID
    body = struct.pack(">HH", 0xE000 | pcr_pid, 0xF000) + streams
    return _psi_section(0x02, body)


def pes_packet(stream_id: int, payload: bytes,
               pts_90k: Optional[int]) -> bytes:
    """A PES packet, with a PTS (90 kHz units) unless ``pts_90k`` is
    None."""
    if pts_90k is None:
        header_data = b""
        flags = 0x00
    else:
        p = pts_90k & ((1 << 33) - 1)
        header_data = bytes([
            0x21 | ((p >> 29) & 0x0E),
            (p >> 22) & 0xFF,
            0x01 | ((p >> 14) & 0xFE),
            (p >> 7) & 0xFF,
            0x01 | ((p << 1) & 0xFE),
        ])
        flags = 0x80
    length = 3 + len(header_data) + len(payload)
    if length > 0xFFFF:
        length = 0      # unbounded, as video PES commonly is
    return (b"\x00\x00\x01" + bytes([stream_id]) +
            struct.pack(">H", length) + bytes([0x80, flags,
                                               len(header_data)]) +
            header_data + payload)


class TsMuxer:
    """Feed elementary-stream frames, collect 188-byte packets;
    ``write_tables()`` first (and at each segment's start for HLS)."""

    def __init__(self, has_video: bool = True, has_audio: bool = True):
        self._has_video = has_video
        self._has_audio = has_audio
        self._counters = {PAT_PID: 0, PMT_PID: 0, VIDEO_PID: 0,
                          AUDIO_PID: 0}
        self.packets: List[bytes] = []

    def _emit(self, pid: int, payload: bytes, pcr: Optional[int] = None):
        view = memoryview(payload)
        start = True
        while len(view) or start:
            pkt, consumed = _packet(pid, view, self._counters[pid],
                                    start, pcr=pcr)
            self.packets.append(pkt)
            view = view[consumed:]
            self._counters[pid] = (self._counters[pid] + 1) & 0x0F
            start = False
            pcr = None

    def write_tables(self) -> None:
        # PSI sections go behind a pointer_field
        self._emit(PAT_PID, b"\x00" + pat_section())
        self._emit(PMT_PID, b"\x00" + pmt_section(self._has_video,
                                                  self._has_audio))

    def write_video(self, es: bytes, pts_90k: int) -> None:
        self._emit(VIDEO_PID, pes_packet(0xE0, es, pts_90k),
                   pcr=pts_90k * 300)

    def write_audio(self, es: bytes, pts_90k: int) -> None:
        self._emit(AUDIO_PID, pes_packet(0xC0, es, pts_90k))

    def flush(self) -> bytes:
        out, self.packets = b"".join(self.packets), []
        return out


class TsPacket(NamedTuple):
    pid: int
    start: bool
    counter: int
    payload: bytes


def iter_packets(data: bytes) -> Iterator[TsPacket]:
    if len(data) % TS_PACKET_SIZE:
        raise TsError("stream not packet-aligned")
    for off in range(0, len(data), TS_PACKET_SIZE):
        pkt = data[off:off + TS_PACKET_SIZE]
        if pkt[0] != _SYNC:
            raise TsError(f"lost sync at {off}")
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        start = bool(pkt[1] & 0x40)
        counter = pkt[3] & 0x0F
        pos = 4
        if pkt[3] & 0x20:           # an adaptation field
            pos += 1 + pkt[4]
        yield TsPacket(pid, start, counter, pkt[pos:])


def extract_pes(data: bytes, pid: int) -> List[bytes]:
    """The elementary-stream bytes (after each PES header) of ``pid``'s
    packets, reassembled."""
    out: List[bytes] = []
    cur: Optional[bytearray] = None
    for pkt in iter_packets(data):
        if pkt.pid != pid:
            continue
        if pkt.start:
            if cur is not None:
                out.append(bytes(cur))
            cur = bytearray(pkt.payload)
        elif cur is not None:
            cur += pkt.payload
    if cur is not None:
        out.append(bytes(cur))
    es_out = []
    for pes in out:
        if pes[:3] != b"\x00\x00\x01":
            raise TsError("bad PES start code")
        header_len = pes[8]
        es_out.append(bytes(pes[9 + header_len:]))
    return es_out
