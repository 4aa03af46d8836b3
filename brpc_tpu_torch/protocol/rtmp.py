"""RTMP: the handshake, the chunk stream, the NetConnection and NetStream
commands, and a live publish/play relay served beside the server's other
protocols (the port of brpc_tpu/protocol/rtmp.py; bRPC's rtmp.{h,cpp}
and policy/rtmp_protocol.cpp).

- **Handshake**, both kinds: the plain echo (C2 echoes S1, S2 echoes
  C1) and the digest handshake stock encoders send, schemes 0 and 1,
  with keyed C2/S2 acks. A C1 whose digest does not check gets the plain
  echo, and a client whose S1 carries no server digest echoes S1: each
  side degrades to the other's handshake.
- **Chunk stream**: basic headers of 1-3 bytes, message headers of
  formats 0-3, extended timestamps, ``SET_CHUNK_SIZE`` both ways
  (``pack_chunks`` writes format 0 then format 3 continuations), abort.
- **Commands**: AMF0 (connect, createStream, publish, play,
  deleteStream, onStatus, ``_result``) and the AMF3 command envelope
  (type 17: a format byte, then AMF0 values that may switch to AMF3).
  An aggregate message (type 22) is split into its sub-messages, their
  timestamps rebased onto the aggregate's.
- **Relay** (``RtmpService``, ``ServerOptions.rtmp_service``): one
  publisher a stream name, gated by ``on_publish(name, socket)``, and
  any number of players, gated by ``on_play(name, socket)``; the
  publisher's metadata and AVC/AAC sequence headers are cached for
  players that join late. A write to a player's socket goes through
  ``Socket.write`` under the socket's ``lane_lock``, one whole message
  (all its chunks) a write, so no two messages interleave inside a
  chunk. A socket's failure, and ``Server.stop``, drop its entries
  (``drop_socket``). RTMP carries no credential of the server's: its
  service's hooks gate it, and ``ServerOptions.auth`` does not.
- **Claiming**: ``RtmpProtocol.parse`` claims a connection by its first
  byte, 0x03, and only on a server with an ``rtmp_service``; it claims
  at C0C1, so the random bytes after it are never offered to another
  protocol. A connection's messages are handled in parse order.
- **Client** (``RtmpClient``): one socket, the handshake's gate before
  any command (``FiberEvent.wait_pthread``, so a plain thread may call
  it), a fresh connection and handshake after a failure.
  ``handshake="plain"`` sends a zero-version C1; ``object_encoding=3``
  sends commands in the AMF3 envelope. ``live_sockets()`` counts the
  clients' sockets not yet failed, and ``stale_entries()`` the relay
  entries whose socket failed (the tests' leak check).

Out of scope, as in the reference: HLS over HTTP (``flv.py`` and
``ts.py`` remux the media), RTMPE and RTMPS.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
import threading
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch.butil.endpoint import EndPoint, str2endpoint
from brpc_tpu_torch.fiber import TaskControl, global_control
from brpc_tpu_torch.fiber.sync import FiberEvent
from brpc_tpu_torch.protocol import amf
from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              Protocol, register_protocol)
from brpc_tpu_torch.transport.input_messenger import (InputMessenger,
                                                      process_in_parse_order)
from brpc_tpu_torch.transport.socket import create_client_socket

RTMP_VERSION = 3
HANDSHAKE_SIZE = 1536
DEFAULT_IN_CHUNK = 128
OUT_CHUNK_SIZE = 4096
_MAX_MSG = 32 << 20

# message type ids
MSG_SET_CHUNK_SIZE = 1
MSG_ABORT = 2
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK_SIZE = 5
MSG_SET_PEER_BW = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF3 = 15
MSG_COMMAND_AMF3 = 17
MSG_DATA_AMF0 = 18
MSG_COMMAND_AMF0 = 20
MSG_AGGREGATE = 22

_CONTROL_CSID = 2
_COMMAND_CSID = 3
_MEDIA_CSID = 6




# ------------------------------------------------------ digest handshake
# The digest ("complex") handshake of stock encoders: C1 and S1 carry an
# HMAC-SHA256 digest at an offset that four offset bytes give, in one of
# two schemes (the offset block right after the version word, or after
# a 764-byte key block); C2 and S2 are random blocks whose last 32 bytes
# are keyed on the peer's digest. The keys are the public constants of
# the Flash ecosystem (nginx-rtmp, librtmp and ffmpeg use the same). A
# C1 with a zero version word asks for the plain echo handshake.
_FP_KEY = b"Genuine Adobe Flash Player 001"          # client partial (30)
_FMS_KEY = b"Genuine Adobe Flash Media Server 001"   # server partial (36)
_KEY_TAIL = bytes((0xF0, 0xEE, 0xC2, 0x4A, 0x80, 0x68, 0xBE, 0xE8,
                   0x2E, 0x00, 0xD0, 0xD1, 0x02, 0x9E, 0x7E, 0x57,
                   0x6E, 0xEC, 0x5D, 0x2D, 0x29, 0x80, 0x6F, 0xAB,
                   0x93, 0xB8, 0xE6, 0x36, 0xCF, 0xEB, 0x31, 0xAE))
_CLIENT_VERSION = bytes((127, 101, 0, 1))
_SERVER_VERSION = bytes((3, 5, 1, 1))


def _hs_digest_pos(buf: bytes, scheme: int) -> int:
    base = 8 if scheme == 0 else 772
    return base + 4 + sum(buf[base:base + 4]) % 728


def _hs_make_digest(buf: bytes, pos: int, key: bytes) -> bytes:
    return hmac.new(key, buf[:pos] + buf[pos + 32:], hashlib.sha256).digest()


def _hs_find_digest(block: bytes, key: bytes):
    """(scheme, digest) when the 1536-byte block carries a valid digest
    under ``key``; None for the plain handshake."""
    for scheme in (0, 1):
        pos = _hs_digest_pos(block, scheme)
        if pos + 32 <= len(block) and \
                block[pos:pos + 32] == _hs_make_digest(block, pos, key):
            return scheme, block[pos:pos + 32]
    return None


def _hs_build_block(key: bytes, scheme: int,
                    version: bytes) -> Tuple[bytes, bytes]:
    """A 1536-byte C1 or S1 with its digest in place: (block, digest)."""
    buf = bytearray(os.urandom(HANDSHAKE_SIZE))
    buf[0:4] = b"\x00\x00\x00\x00"
    buf[4:8] = version
    pos = _hs_digest_pos(buf, scheme)
    dig = _hs_make_digest(bytes(buf), pos, key)
    buf[pos:pos + 32] = dig
    return bytes(buf), dig


def _hs_plain_block() -> bytes:
    """A C1 or S1 of the plain handshake: time and version words 0."""
    return struct.pack(">II", 0, 0) + os.urandom(HANDSHAKE_SIZE - 8)


def _hs_ack_block(peer_digest: bytes, full_key: bytes) -> bytes:
    """A C2 or S2 of the digest handshake: random bytes and their HMAC
    under a key that is the HMAC of the peer's digest under the full
    (partial and tail) key."""
    rand = os.urandom(HANDSHAKE_SIZE - 32)
    tmp = hmac.new(full_key, peer_digest, hashlib.sha256).digest()
    return rand + hmac.new(tmp, rand, hashlib.sha256).digest()


class RtmpMessage:
    __slots__ = ("msg_type", "timestamp", "stream_id", "payload")

    def __init__(self, msg_type: int, timestamp: int, stream_id: int,
                 payload: bytes):
        self.msg_type = msg_type
        self.timestamp = timestamp
        self.stream_id = stream_id
        self.payload = payload

    def __repr__(self):
        return (f"RtmpMessage(type={self.msg_type}, ts={self.timestamp}, "
                f"sid={self.stream_id}, {len(self.payload)}B)")


class RtmpError(Exception):
    pass


# ------------------------------------------------------------ chunk writer

def pack_chunks(msg: RtmpMessage, csid: int,
                chunk_size: int = OUT_CHUNK_SIZE) -> bytes:
    """A format-0 first chunk and format-3 continuations (absolute
    headers: simple and within the spec, a little longer than delta
    headers); an extended timestamp repeats on every chunk."""
    ts = msg.timestamp & 0xFFFFFFFF
    ext = ts >= 0xFFFFFF
    hdr_ts = 0xFFFFFF if ext else ts
    payload = msg.payload
    out = [bytes([csid]) + struct.pack(">I", hdr_ts)[1:] +
           struct.pack(">I", len(payload))[1:] + bytes([msg.msg_type]) +
           struct.pack("<I", msg.stream_id) +
           (struct.pack(">I", ts) if ext else b""),
           payload[:chunk_size]]
    cont = bytes([(3 << 6) | csid]) + (struct.pack(">I", ts) if ext
                                       else b"")
    for pos in range(chunk_size, len(payload), chunk_size):
        out.append(cont)
        out.append(payload[pos:pos + chunk_size])
    return b"".join(out)


# ------------------------------------------------------------ chunk reader

class _CsidState:
    __slots__ = ("msg_len", "msg_type", "stream_id", "timestamp", "ts_delta",
                 "buf", "has_ext")

    def __init__(self):
        self.msg_len = 0
        self.msg_type = 0
        self.stream_id = 0
        self.timestamp = 0
        self.ts_delta = 0
        self.buf = b""
        self.has_ext = False


class _ConnState:
    """A connection's RTMP state, in ``socket.user_data``."""

    PHASE_UNINIT = 0         # server: waits for C0C1; client: for S0S1S2
    PHASE_ACK = 1            # server: waits for C2
    PHASE_READY = 2

    def __init__(self, is_client: bool):
        self.is_client = is_client
        self.phase = self.PHASE_UNINIT
        self.in_chunk_size = DEFAULT_IN_CHUNK
        self.csids: Dict[int, _CsidState] = {}
        self.next_stream_id = 1
        self.app = ""


def _parse_one_chunk(state: _ConnState, data: bytes, pos: int
                     ) -> Optional[Tuple[Optional[RtmpMessage], int]]:
    """One chunk at ``pos``: (the message it completed or None, the next
    position), or None when more bytes are needed. Raises RtmpError on
    corruption."""
    if pos >= len(data):
        return None
    b0 = data[pos]
    fmt = b0 >> 6
    csid = b0 & 0x3F
    pos += 1
    if csid == 0:
        if pos >= len(data):
            return None
        csid = 64 + data[pos]
        pos += 1
    elif csid == 1:
        if pos + 2 > len(data):
            return None
        csid = 64 + data[pos] + data[pos + 1] * 256
        pos += 2
    st = state.csids.get(csid)
    if st is None:
        if fmt != 0:
            raise RtmpError(f"first chunk on csid {csid} must be fmt0")
        st = state.csids[csid] = _CsidState()
    hdr_len = (11, 7, 3, 0)[fmt]
    if pos + hdr_len > len(data):
        return None
    # computed in locals and committed to ``st`` only once the whole
    # chunk is here: a chunk cut across reads is parsed again from its
    # header, and a delta applied twice would move the timestamp
    msg_len, msg_type, stream_id = st.msg_len, st.msg_type, st.stream_id
    timestamp, ts_delta, has_ext = st.timestamp, st.ts_delta, st.has_ext
    if fmt == 0:
        ts = int.from_bytes(data[pos:pos + 3], "big")
        msg_len = int.from_bytes(data[pos + 3:pos + 6], "big")
        msg_type = data[pos + 6]
        stream_id = struct.unpack_from("<I", data, pos + 7)[0]
        has_ext = ts == 0xFFFFFF
        pos += 11
        if has_ext:
            if pos + 4 > len(data):
                return None
            ts = struct.unpack_from(">I", data, pos)[0]
            pos += 4
        timestamp = ts
        ts_delta = 0
    elif fmt in (1, 2):
        delta = int.from_bytes(data[pos:pos + 3], "big")
        if fmt == 1:
            msg_len = int.from_bytes(data[pos + 3:pos + 6], "big")
            msg_type = data[pos + 6]
        pos += hdr_len
        has_ext = delta == 0xFFFFFF
        if has_ext:
            if pos + 4 > len(data):
                return None
            delta = struct.unpack_from(">I", data, pos)[0]
            pos += 4
        ts_delta = delta
        if not st.buf:      # a delta applies at a message's start only
            timestamp = (timestamp + delta) & 0xFFFFFFFF
    else:  # fmt 3: a continuation, or the last header again
        if has_ext:
            if pos + 4 > len(data):
                return None
            pos += 4        # the repeated extended timestamp
        if not st.buf and msg_len == 0:
            raise RtmpError(f"fmt3 chunk with no prior header on csid {csid}")
        if not st.buf:
            timestamp = (timestamp + ts_delta) & 0xFFFFFFFF
    if msg_len > _MAX_MSG:
        raise RtmpError(f"rtmp message of {msg_len} bytes exceeds max")
    take = min(state.in_chunk_size, msg_len - len(st.buf))
    if take < 0:
        raise RtmpError("chunk overrun")
    if pos + take > len(data):
        return None
    st.msg_len, st.msg_type, st.stream_id = msg_len, msg_type, stream_id
    st.timestamp, st.ts_delta, st.has_ext = timestamp, ts_delta, has_ext
    st.buf += data[pos:pos + take]
    pos += take
    if len(st.buf) < st.msg_len:
        return None, pos
    payload, st.buf = st.buf, b""
    return RtmpMessage(st.msg_type, st.timestamp, st.stream_id, payload), pos


# ---------------------------------------------------------------- commands

def _split_aggregate(msg: RtmpMessage) -> List[RtmpMessage]:
    """The sub-messages of a type-22 aggregate: each an FLV-shaped tag
    (11-byte header, body, 4-byte back pointer); their timestamps keep
    their deltas from the first and are rebased onto the aggregate's."""
    out: List[RtmpMessage] = []
    data = msg.payload
    pos = 0
    base_ts: Optional[int] = None
    while pos + 11 <= len(data):
        sub_type = data[pos]
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        ts = int.from_bytes(data[pos + 4:pos + 7], "big") | \
            (data[pos + 7] << 24)
        body_start = pos + 11
        body_end = body_start + size
        if body_end > len(data):
            raise RtmpError("aggregate sub-message overruns payload")
        if base_ts is None:
            base_ts = ts
        # a sub-tag older than the first would rebase below 0 and wrap
        # to a far-future timestamp in the chunk writer: clamp it
        out.append(RtmpMessage(sub_type,
                               max(0, msg.timestamp + (ts - base_ts)),
                               msg.stream_id, data[body_start:body_end]))
        pos = body_end + 4
    return out


def command_message(name: str, transaction_id: float, *vals,
                    stream_id: int = 0) -> RtmpMessage:
    return RtmpMessage(MSG_COMMAND_AMF0, 0, stream_id,
                       amf.encode_values(name, float(transaction_id), *vals))


def _control(msg_type: int, payload: bytes) -> RtmpMessage:
    return RtmpMessage(msg_type, 0, 0, payload)


def _write_msg(socket, msg: RtmpMessage, csid: int = _COMMAND_CSID) -> bool:
    """One message, all its chunks in one write, through the socket's
    write path under its ``lane_lock``."""
    data = pack_chunks(msg, csid)
    with socket.lane_lock:
        return socket.write(data)


def on_status(stream_id: int, level: str, code: str, desc: str) -> RtmpMessage:
    return command_message(
        "onStatus", 0, None,
        {"level": level, "code": code, "description": desc},
        stream_id=stream_id)


# ------------------------------------------------------------- live streams

class _LiveStream:
    def __init__(self, name: str):
        self.name = name
        self.publisher = None              # (socket, msg_stream_id)
        self.subscribers: List[Tuple[Any, int]] = []  # (socket, stream_id)
        self.metadata: Optional[Tuple[int, bytes]] = None
        self.avc_seq: Optional[RtmpMessage] = None
        self.aac_seq: Optional[RtmpMessage] = None


_services: "weakref.WeakSet[RtmpService]" = weakref.WeakSet()


def stale_entries() -> int:
    """Publishers and players, across live ``RtmpService``s, whose socket
    has failed."""
    n = 0
    for svc in list(_services):
        with svc._lock:
            for s in svc._streams.values():
                n += s.publisher is not None and s.publisher[0].failed
                n += sum(1 for sk, _ in s.subscribers if sk.failed)
    return n


class RtmpService:
    """The relay: a server's stream registry and its hooks (the
    RtmpService and RtmpServerStream of bRPC's rtmp.h, as callbacks).

    ``on_publish(name, socket) -> bool`` and ``on_play(name, socket) ->
    bool`` may refuse; media goes from the publisher to the players,
    with the sequence headers and metadata cached for late players."""

    def __init__(self, on_publish: Optional[Callable] = None,
                 on_play: Optional[Callable] = None):
        self.on_publish = on_publish
        self.on_play = on_play
        # reentrant: a write under it may fail its socket, whose
        # on_failed callback (drop_socket) takes it again
        self._lock = threading.RLock()
        self._streams: Dict[str, _LiveStream] = {}
        _services.add(self)

    def _stream(self, name: str) -> _LiveStream:
        with self._lock:
            s = self._streams.get(name)
            if s is None:
                s = self._streams[name] = _LiveStream(name)
            return s

    def stream_names(self) -> List[str]:
        with self._lock:
            return sorted(self._streams)

    def publishers(self) -> int:
        with self._lock:
            return sum(1 for s in self._streams.values()
                       if s.publisher is not None)

    def players(self) -> int:
        with self._lock:
            return sum(len(s.subscribers) for s in self._streams.values())

    # ------------------------------------------------------------- publish
    def start_publish(self, name: str, socket, stream_id: int) -> bool:
        if self.on_publish is not None and not self.on_publish(name, socket):
            return False
        s = self._stream(name)
        with self._lock:
            if s.publisher is not None and not s.publisher[0].failed:
                return False       # the name is taken
            s.publisher = (socket, stream_id)
        return True

    def stop_publish(self, name: str, socket) -> None:
        with self._lock:
            s = self._streams.get(name)
            if s is not None and s.publisher is not None and \
                    s.publisher[0] is socket:
                s.publisher = None
                s.metadata = s.avc_seq = s.aac_seq = None

    # ---------------------------------------------------------------- play
    def start_play(self, name: str, socket, stream_id: int) -> bool:
        if self.on_play is not None and not self.on_play(name, socket):
            return False
        s = self._stream(name)
        # the catch-up and the registration under one hold: written
        # outside it, relay() could put a live frame before the cached
        # codec configuration (writes only queue, so the hold is short)
        with self._lock:
            if s.metadata is not None:
                meta_type, meta_payload = s.metadata
                _write_msg(socket, RtmpMessage(meta_type, 0, stream_id,
                                               meta_payload), _MEDIA_CSID)
            for seq in (s.avc_seq, s.aac_seq):
                if seq is not None:
                    _write_msg(socket, RtmpMessage(seq.msg_type, 0,
                                                   stream_id, seq.payload),
                               _MEDIA_CSID)
            s.subscribers.append((socket, stream_id))
        return True

    def stop_play(self, name: str, socket) -> None:
        with self._lock:
            s = self._streams.get(name)
            if s is not None:
                s.subscribers = [(sk, sid) for sk, sid in s.subscribers
                                 if sk is not socket]

    def drop_socket(self, socket) -> None:
        with self._lock:
            for s in self._streams.values():
                if s.publisher is not None and s.publisher[0] is socket:
                    s.publisher = None
                    s.metadata = s.avc_seq = s.aac_seq = None
                s.subscribers = [(sk, sid) for sk, sid in s.subscribers
                                 if sk is not socket]

    # --------------------------------------------------------------- media
    def relay(self, name: str, msg: RtmpMessage, from_socket) -> None:
        s = self._stream(name)
        with self._lock:
            if s.publisher is None or s.publisher[0] is not from_socket:
                return
            if msg.msg_type in (MSG_DATA_AMF0, MSG_DATA_AMF3):
                # either encoding's onMetaData, with its type, so the
                # replay keeps the envelope the payload was encoded for
                s.metadata = (msg.msg_type, msg.payload)
            elif msg.msg_type == MSG_VIDEO and len(msg.payload) >= 2 and \
                    (msg.payload[0] & 0x0F) == 7 and msg.payload[1] == 0:
                s.avc_seq = msg           # AVC sequence header
            elif msg.msg_type == MSG_AUDIO and len(msg.payload) >= 2 and \
                    (msg.payload[0] >> 4) == 10 and msg.payload[1] == 0:
                s.aac_seq = msg           # AAC sequence header
            targets = list(s.subscribers)
        for sock, sid in targets:
            if sock.failed:
                self.stop_play(name, sock)
                continue
            _write_msg(sock, RtmpMessage(msg.msg_type, msg.timestamp, sid,
                                         msg.payload), _MEDIA_CSID)


# ---------------------------------------------------------------- protocol

class RtmpProtocol(Protocol):
    name = "rtmp"

    def parse(self, portal, socket) -> Tuple[str, object]:
        state: Optional[_ConnState] = socket.user_data.get("rtmp_state")
        client = socket.user_data.get("rtmp_client")
        if state is None:
            if client is None:
                if portal.peek_bytes(1) != bytes([RTMP_VERSION]):
                    return PARSE_TRY_OTHERS, None
                server = socket.user_data.get("server")
                if server is None or \
                        getattr(server.options, "rtmp_service", None) is None:
                    # a stray 0x03 at a server without the relay starts
                    # no handshake and holds no state
                    return PARSE_TRY_OTHERS, None
            state = _ConnState(is_client=client is not None)
            socket.user_data["rtmp_state"] = state
        try:
            return self._parse_with_state(portal, socket, state)
        except (RtmpError, amf.AmfError, struct.error) as e:
            socket.set_failed(ConnectionError(f"rtmp: {e}"))
            return PARSE_NOT_ENOUGH_DATA, None

    def _parse_with_state(self, portal, socket, state: _ConnState):
        if state.phase == _ConnState.PHASE_UNINIT:
            if state.is_client:
                need = 1 + 2 * HANDSHAKE_SIZE          # S0 S1 S2
                if portal.size < need:
                    return PARSE_NOT_ENOUGH_DATA, None
                data = portal.peek_bytes(need)
                if data[0] != RTMP_VERSION:
                    raise RtmpError(f"bad server version {data[0]}")
                portal.pop_front(need)
                s1 = data[1:1 + HANDSHAKE_SIZE]
                c2 = s1                 # the plain handshake echoes S1
                if socket.user_data.get("rtmp_c1_digest") is not None:
                    server = _hs_find_digest(s1, _FMS_KEY)
                    if server is not None:
                        # a digest server gets a keyed C2; a plain one,
                        # which echoed our C1, the echo
                        c2 = _hs_ack_block(server[1], _FP_KEY + _KEY_TAIL)
                # the client writes OUT_CHUNK_SIZE chunks, and says so
                # before its first command: the peer reads 128 until told
                # (brpc_tpu's client never says so, and a server reads
                # its messages over 128 bytes wrong; ROADMAP section 3)
                socket.write(c2 + pack_chunks(_control(
                    MSG_SET_CHUNK_SIZE, struct.pack(">I", OUT_CHUNK_SIZE)),
                    _CONTROL_CSID))
                state.phase = _ConnState.PHASE_READY
                return PARSE_OK, ("rtmp_handshake_done",)
            need = 1 + HANDSHAKE_SIZE                  # C0 C1
            if portal.size < need:
                return PARSE_NOT_ENOUGH_DATA, None
            data = portal.peek_bytes(need)
            if data[0] != RTMP_VERSION:
                raise RtmpError(f"bad client version {data[0]}")
            portal.pop_front(need)
            c1 = data[1:]
            found = None
            if c1[4:8] != b"\x00\x00\x00\x00":
                # a version word offers the digest handshake; a digest
                # that does not check falls back to the plain echo
                found = _hs_find_digest(c1, _FP_KEY)
            if found is not None:
                scheme, client_digest = found
                s1, _ = _hs_build_block(_FMS_KEY, scheme, _SERVER_VERSION)
                s2 = _hs_ack_block(client_digest, _FMS_KEY + _KEY_TAIL)
            else:
                s1, s2 = _hs_plain_block(), c1
            socket.write(bytes([RTMP_VERSION]) + s1 + s2)
            state.phase = _ConnState.PHASE_ACK
            # PARSE_OK, so that the messenger makes rtmp this socket's
            # protocol now: the handshake's and chunks' random-looking
            # bytes are never offered to another parser first
            return PARSE_OK, ("rtmp_handshake_progress",)
        if state.phase == _ConnState.PHASE_ACK:
            if portal.size < HANDSHAKE_SIZE:
                return PARSE_NOT_ENOUGH_DATA, None
            portal.pop_front(HANDSHAKE_SIZE)   # C2: not checked
            state.phase = _ConnState.PHASE_READY
            return PARSE_OK, ("rtmp_handshake_progress",)

        data = portal.peek_bytes(portal.size)
        msgs: List[RtmpMessage] = []
        pos = 0
        while pos < len(data):
            got = _parse_one_chunk(state, data, pos)
            if got is None:
                break
            msg, pos = got
            if msg is None:
                continue
            # the connection's control messages change the parse's
            # state in order
            if msg.msg_type == MSG_SET_CHUNK_SIZE and len(msg.payload) >= 4:
                size = struct.unpack(">I", msg.payload[:4])[0] & 0x7FFFFFFF
                if not 1 <= size <= 0xFFFFFF:
                    raise RtmpError(f"bad chunk size {size}")
                state.in_chunk_size = size
                continue
            if msg.msg_type == MSG_ABORT and len(msg.payload) >= 4:
                aborted = struct.unpack(">I", msg.payload[:4])[0]
                st = state.csids.get(aborted)
                if st is not None:
                    st.buf = b""
                continue
            if msg.msg_type in (MSG_ACK, MSG_WINDOW_ACK_SIZE,
                                MSG_SET_PEER_BW, MSG_USER_CONTROL):
                continue
            if msg.msg_type == MSG_AGGREGATE:
                msgs.extend(_split_aggregate(msg))
                continue
            msgs.append(msg)
        if pos:
            portal.pop_front(pos)
        if not msgs:
            return PARSE_NOT_ENOUGH_DATA, None
        return PARSE_OK, msgs

    def process_inline(self, msgs, socket) -> bool:
        client = socket.user_data.get("rtmp_client")
        if isinstance(msgs, tuple):
            if msgs and msgs[0] == "rtmp_handshake_done" and \
                    client is not None:
                client._on_handshake_done(socket)
            return True         # handshake progress needs no dispatch
        if client is not None:
            for m in msgs:
                client._on_message(m)
            return True
        for m in msgs:
            process_in_parse_order(socket, "rtmp", m, self._serve)
        return True

    async def _serve(self, msg: RtmpMessage, socket):
        server = socket.user_data.get("server")
        service: Optional[RtmpService] = (
            getattr(server.options, "rtmp_service", None)
            if server is not None else None)
        if service is None:
            socket.set_failed(ConnectionError("no rtmp_service installed"))
            return
        state: _ConnState = socket.user_data["rtmp_state"]
        if socket.user_data.get("rtmp_cleanup") is None:
            socket.user_data["rtmp_cleanup"] = True
            socket.on_failed(service.drop_socket)
        if msg.msg_type == MSG_COMMAND_AMF0:
            self._serve_command(msg, socket, service, state)
        elif msg.msg_type == MSG_COMMAND_AMF3:
            # the AMF3 envelope: a format byte (0), then AMF0 values that
            # may switch to AMF3 (0x11), which amf.decode_value reads
            body = msg.payload[1:] if msg.payload[:1] == b"\x00" \
                else msg.payload
            self._serve_command(RtmpMessage(MSG_COMMAND_AMF0, msg.timestamp,
                                            msg.stream_id, body),
                                socket, service, state)
        elif msg.msg_type in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0,
                              MSG_DATA_AMF3):
            name = socket.user_data.get("rtmp_pub_name")
            if name:
                service.relay(name, msg, socket)

    def _serve_command(self, msg, socket, service, state) -> None:
        vals = amf.decode_all(msg.payload)
        if not vals or not isinstance(vals[0], str):
            raise RtmpError("malformed command")
        name = vals[0]
        tid = vals[1] if len(vals) > 1 else 0
        if name == "connect":
            obj = vals[2] if len(vals) > 2 and isinstance(vals[2], dict) else {}
            state.app = str(obj.get("app", ""))
            _write_msg(socket, _control(MSG_WINDOW_ACK_SIZE,
                                        struct.pack(">I", 2500000)),
                       _CONTROL_CSID)
            _write_msg(socket, _control(MSG_SET_PEER_BW,
                                        struct.pack(">IB", 2500000, 2)),
                       _CONTROL_CSID)
            _write_msg(socket, _control(MSG_SET_CHUNK_SIZE,
                                        struct.pack(">I", OUT_CHUNK_SIZE)),
                       _CONTROL_CSID)
            _write_msg(socket, command_message(
                "_result", tid,
                {"fmsVer": "BRPC-TPU/1,0", "capabilities": 31.0},
                {"level": "status", "code": "NetConnection.Connect.Success",
                 "description": "Connection succeeded.",
                 "objectEncoding": 0.0}))
        elif name == "createStream":
            sid = state.next_stream_id
            state.next_stream_id += 1
            _write_msg(socket, command_message("_result", tid, None,
                                               float(sid)))
        elif name == "publish":
            stream_name = vals[3] if len(vals) > 3 else ""
            if not isinstance(stream_name, str) or not stream_name:
                raise RtmpError("publish without stream name")
            if service.start_publish(stream_name, socket, msg.stream_id):
                socket.user_data["rtmp_pub_name"] = stream_name
                _write_msg(socket, on_status(
                    msg.stream_id, "status", "NetStream.Publish.Start",
                    f"Publishing {stream_name}."))
            else:
                _write_msg(socket, on_status(
                    msg.stream_id, "error", "NetStream.Publish.BadName",
                    f"Stream {stream_name} is busy or rejected."))
        elif name == "play":
            stream_name = vals[3] if len(vals) > 3 else ""
            if not isinstance(stream_name, str) or not stream_name:
                raise RtmpError("play without stream name")
            if service.start_play(stream_name, socket, msg.stream_id):
                socket.user_data.setdefault("rtmp_play_names", set()).add(
                    stream_name)
                _write_msg(socket, on_status(
                    msg.stream_id, "status", "NetStream.Play.Start",
                    f"Playing {stream_name}."))
            else:
                _write_msg(socket, on_status(
                    msg.stream_id, "error", "NetStream.Play.StreamNotFound",
                    f"Play {stream_name} rejected."))
        elif name in ("deleteStream", "closeStream", "FCUnpublish"):
            pub = socket.user_data.pop("rtmp_pub_name", None)
            if pub:
                service.stop_publish(pub, socket)
            for pname in socket.user_data.pop("rtmp_play_names", set()):
                service.stop_play(pname, socket)
        elif name in ("releaseStream", "FCPublish", "getStreamLength"):
            _write_msg(socket, command_message("_result", tid, None, None))
        # other commands are ignored, as bRPC logs them and goes on

    def process(self, msg, socket):
        raise AssertionError("rtmp messages are processed inline")


# ------------------------------------------------------------------ client

_live_lock = threading.Lock()
_live: set = set()


def live_sockets() -> int:
    """Sockets of RtmpClients that have not failed."""
    with _live_lock:
        return sum(1 for s in _live if not s.failed)


class _Slot:
    __slots__ = ("event", "result", "socket")

    def __init__(self, socket):
        self.event = FiberEvent()
        self.result = None              # the answer, or the failure
        self.socket = socket


class RtmpClient:
    """A publish and play client (RtmpClient and RtmpClientStream of
    bRPC's rtmp.h).

    ``client = RtmpClient(ep, app="live"); client.connect()``, then
    ``sid = client.create_stream(); client.publish(sid, "room")`` and
    ``client.send_video(sid, ts, payload)``, or ``client.play(sid,
    "room", on_media=cb)`` to receive the relay. ``handshake``:
    ``"digest"`` (stock encoders' C1) or ``"plain"`` (a zero-version
    C1, the echo handshake); ``object_encoding``: 0, or 3 to send
    commands in the AMF3 envelope (type 17)."""

    def __init__(self, address, app: str = "live",
                 timeout_s: float = 5.0,
                 control: Optional[TaskControl] = None,
                 handshake: str = "digest", object_encoding: int = 0):
        if handshake not in ("digest", "plain"):
            raise ValueError(f"unknown rtmp handshake {handshake!r}")
        if object_encoding not in (0, 3):
            raise ValueError(f"objectEncoding {object_encoding}: 0 or 3")
        self._endpoint = (address if isinstance(address, EndPoint)
                          else str2endpoint(str(address)))
        self.app = app
        self.handshake = handshake
        self.object_encoding = object_encoding
        self._timeout_s = timeout_s
        self._control = control or global_control()
        self._messenger = InputMessenger(protocols=[ensure_registered()],
                                         control=self._control)
        self._lock = threading.Lock()
        self._socket = None
        self._handshake_done = FiberEvent()
        self._handshake_socket = None    # the socket the gate guards
        self._next_tid = 1
        self._pending: Dict[float, _Slot] = {}
        self._status_waiters: deque = deque()
        self.on_media: Optional[Callable[[RtmpMessage], None]] = None

    # ------------------------------------------------------------ plumbing
    def _c0c1(self, sock) -> bytes:
        if self.handshake == "plain":
            return bytes([RTMP_VERSION]) + _hs_plain_block()
        c1, digest = _hs_build_block(_FP_KEY, 0, _CLIENT_VERSION)
        sock.user_data["rtmp_c1_digest"] = digest
        return bytes([RTMP_VERSION]) + c1

    def _get_socket(self):
        with self._lock:
            existing = self._socket
            gate = self._handshake_done
        if existing is not None and not existing.failed:
            # the socket may still be in its handshake (another caller
            # opened it): every path waits at the gate before it writes
            if not gate.wait_pthread(self._timeout_s):
                raise TimeoutError("rtmp handshake timed out")
            if not existing.failed:
                return existing
        sock = create_client_socket(
            self._endpoint, on_input=self._messenger.on_new_messages,
            control=self._control)
        sock.user_data["rtmp_client"] = self
        sock.user_data["protocol"] = "rtmp"
        with _live_lock:
            _live.add(sock)
        sock.on_failed(self._on_failed)
        with self._lock:
            if self._socket is not None and not self._socket.failed:
                loser, sock = sock, self._socket
            else:
                self._socket, loser = sock, None
                # a fresh gate: the old one is set, and a command written
                # during the new handshake would be read as C2 bytes
                self._handshake_done = FiberEvent()
                self._handshake_socket = sock
                sock.write(self._c0c1(sock))
        if loser is not None:
            loser.set_failed(ConnectionError("duplicate connect discarded"))
        with self._lock:
            gate = self._handshake_done
        if not gate.wait_pthread(self._timeout_s):
            sock.set_failed(TimeoutError("rtmp handshake timed out"))
            raise TimeoutError("rtmp handshake timed out")
        if sock.failed:
            raise ConnectionError("rtmp connection failed during handshake")
        return sock

    def _on_failed(self, socket):
        # only the calls written to this socket fail: a dial race's
        # loser must not fail the winner's calls, nor open the winner's
        # gate before its handshake ends
        with _live_lock:
            _live.discard(socket)
        err = socket.fail_reason or ConnectionError("rtmp connection failed")
        with self._lock:
            if self._socket is socket:
                self._socket = None
            pending = [t for t, s in self._pending.items()
                       if s.socket is socket]
            slots = [self._pending.pop(t) for t in pending]
            waiters = [s for s in self._status_waiters if s.socket is socket]
            for s in waiters:
                self._status_waiters.remove(s)
            handshake = (self._handshake_done
                         if self._handshake_socket is socket else None)
        if handshake is not None:
            handshake.set()   # the waiters see the socket failed
        for slot in slots + waiters:
            slot.result = err
            slot.event.set()

    def _on_handshake_done(self, socket):
        with self._lock:
            gate = self._handshake_done \
                if self._handshake_socket is socket else None
        if gate is not None:
            gate.set()

    def _on_message(self, msg: RtmpMessage):
        if msg.msg_type == MSG_COMMAND_AMF3:
            msg = RtmpMessage(MSG_COMMAND_AMF0, msg.timestamp, msg.stream_id,
                              msg.payload[1:] if msg.payload[:1] == b"\x00"
                              else msg.payload)
        if msg.msg_type == MSG_COMMAND_AMF0:
            vals = amf.decode_all(msg.payload)
            if not vals:
                return
            if vals[0] in ("_result", "_error"):
                tid = float(vals[1]) if len(vals) > 1 else 0.0
                with self._lock:
                    slot = self._pending.pop(tid, None)
                if slot is not None:
                    slot.result = (vals[0], vals[2:])
                    slot.event.set()
            elif vals[0] == "onStatus":
                info = next((v for v in vals[2:] if isinstance(v, dict)), {})
                with self._lock:
                    slot = self._status_waiters.popleft() \
                        if self._status_waiters else None
                if slot is not None:
                    slot.result = info
                    slot.event.set()
        elif msg.msg_type in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0):
            cb = self.on_media
            if cb is not None:
                cb(msg)

    def _command(self, name: str, tid: float, *vals,
                 stream_id: int = 0) -> RtmpMessage:
        msg = command_message(name, tid, *vals, stream_id=stream_id)
        if self.object_encoding == 3:
            msg = RtmpMessage(MSG_COMMAND_AMF3, 0, stream_id,
                              b"\x00" + msg.payload)
        return msg

    def _call(self, name: str, *vals, stream_id: int = 0):
        sock = self._get_socket()
        with self._lock:
            tid = float(self._next_tid)
            self._next_tid += 1
            slot = _Slot(sock)
            self._pending[tid] = slot
        _write_msg(sock, self._command(name, tid, *vals,
                                       stream_id=stream_id))
        if not slot.event.wait_pthread(self._timeout_s):
            with self._lock:
                self._pending.pop(tid, None)
            raise TimeoutError(f"rtmp {name} timed out")
        if isinstance(slot.result, BaseException):
            raise slot.result
        kind, rest = slot.result
        if kind == "_error":
            raise RtmpError(f"{name} failed: {rest}")
        return rest

    def _wait_status(self, sock, msg: RtmpMessage, what: str) -> dict:
        slot = _Slot(sock)
        with self._lock:
            self._status_waiters.append(slot)
        _write_msg(sock, msg)
        if not slot.event.wait_pthread(self._timeout_s):
            with self._lock:
                try:
                    self._status_waiters.remove(slot)
                except ValueError:
                    pass
            raise TimeoutError(f"rtmp {what} timed out")
        if isinstance(slot.result, BaseException):
            raise slot.result
        info = slot.result or {}
        if info.get("level") == "error":
            raise RtmpError(f"{what} rejected: {info.get('code')}")
        return info

    # ----------------------------------------------------------------- api
    def connect(self) -> dict:
        self._get_socket()   # connects and waits out the handshake
        rest = self._call("connect", {
            "app": self.app, "flashVer": "BRPC-TPU",
            "tcUrl": f"rtmp://{self._endpoint}/{self.app}",
            "objectEncoding": float(self.object_encoding)})
        info = next((v for v in rest if isinstance(v, dict)
                     and "code" in v), {})
        if info.get("code") != "NetConnection.Connect.Success":
            raise RtmpError(f"connect rejected: {info}")
        return info

    def create_stream(self) -> int:
        rest = self._call("createStream", None)
        for v in rest:
            if isinstance(v, float):
                return int(v)
        raise RtmpError("createStream returned no stream id")

    def publish(self, stream_id: int, name: str) -> dict:
        sock = self._get_socket()
        return self._wait_status(
            sock, self._command("publish", 0, None, name, "live",
                                stream_id=stream_id),
            f"publish {name!r}")

    def play(self, stream_id: int, name: str,
             on_media: Optional[Callable] = None) -> dict:
        if on_media is not None:
            self.on_media = on_media
        sock = self._get_socket()
        return self._wait_status(
            sock, self._command("play", 0, None, name, -2000.0,
                                stream_id=stream_id),
            f"play {name!r}")

    def _send_media(self, msg_type: int, stream_id: int, timestamp: int,
                    payload: bytes):
        sock = self._get_socket()
        _write_msg(sock, RtmpMessage(msg_type, timestamp, stream_id,
                                     payload), _MEDIA_CSID)

    def send_video(self, stream_id: int, timestamp: int, payload: bytes):
        self._send_media(MSG_VIDEO, stream_id, timestamp, payload)

    def send_audio(self, stream_id: int, timestamp: int, payload: bytes):
        self._send_media(MSG_AUDIO, stream_id, timestamp, payload)

    def send_metadata(self, stream_id: int, metadata: dict):
        self._send_media(MSG_DATA_AMF0, stream_id, 0,
                         amf.encode_values("onMetaData",
                                           amf.AmfEcmaArray(metadata)))

    def close(self):
        with self._lock:
            s, self._socket = self._socket, None
        if s is not None and not s.failed:
            s.set_failed(ConnectionError("rtmp client closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_instance: Optional[RtmpProtocol] = None


def ensure_registered() -> RtmpProtocol:
    global _instance
    if _instance is None:
        _instance = RtmpProtocol()
        register_protocol(_instance)
    return _instance
