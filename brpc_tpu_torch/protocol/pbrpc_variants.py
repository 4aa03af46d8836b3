"""hulu_pbrpc and sofa_pbrpc: tpu_std's meta, payload and attachment
behind two other wire headers (the port of
brpc_tpu/protocol/pbrpc_variants.py; bRPC's policy/hulu_pbrpc_protocol.cpp
and policy/sofa_pbrpc_protocol.cpp).

    hulu: "HULU" | body_size:u32be | meta_size:u32be | meta | payload
          (tpu_std's 12-byte header with hulu's magic)
    sofa: "SOFA" | meta_size:u32be | body_size:u32be | reserved:u32be |
          meta | payload                       (a 16-byte header)

The meta is tpu_std's ``RpcMeta``, encoded by the port's hand-written
codec, so both variants go to the same server and client dispatch as
tpu_std: a request is answered in the protocol that parsed it
(``frame``), and a Channel speaks one with ``ChannelOptions.protocol``.
Bare stream frames stay tpu_std frames on either connection, as in the
reference. The native lanes know only ``TRPC``: a variant's frames take
the classic path (``TpuStdProtocol.turbo_scan`` and ``native_serve``
stand down for a subclass).

A sofa frame whose meta claims more attachment than its body holds fails
the connection (the next frame's bytes would be eaten).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from brpc_tpu_torch.protocol.registry import (PARSE_NOT_ENOUGH_DATA,
                                              PARSE_OK, PARSE_TRY_OTHERS,
                                              register_protocol)
from brpc_tpu_torch.protocol.tpu_std import (HEADER_SIZE, MAX_BODY_SIZE,
                                             DecodeError, RpcMessage, RpcMeta,
                                             TpuStdProtocol, pack_frame)

SOFA_HEADER_SIZE = 16
_SOFA_HDR = struct.Struct(">4sIII")
_TPU_HDR = struct.Struct(">4sII")


class HuluPbrpcProtocol(TpuStdProtocol):
    """tpu_std's 12-byte header with hulu's magic; parse, dispatch and
    the responses are tpu_std's."""

    name = "hulu_pbrpc"
    MAGIC = b"HULU"


class SofaPbrpcProtocol(TpuStdProtocol):
    name = "sofa_pbrpc"
    MAGIC = b"SOFA"

    def frame(self, meta: RpcMeta, payload: bytes = b"",
              attachment: bytes = b"", device_arrays=None,
              device_lane: bool = False):
        """tpu_std's body (inline tensors included) behind sofa's 16-byte
        header."""
        wire, lane = pack_frame(meta, payload, attachment, device_arrays,
                                device_lane)
        _magic, body_size, meta_size = _TPU_HDR.unpack_from(wire)
        return (_SOFA_HDR.pack(self.MAGIC, meta_size, body_size - meta_size,
                               0) + wire[HEADER_SIZE:]), lane

    def parse(self, portal, socket) -> Tuple[str, object]:
        if portal.size < SOFA_HEADER_SIZE:
            head = portal.peek_bytes(min(4, portal.size))
            if not self.MAGIC.startswith(head):
                return PARSE_TRY_OTHERS, None
            return PARSE_NOT_ENOUGH_DATA, None
        magic, meta_size, data_size, _reserved = _SOFA_HDR.unpack(
            portal.peek_bytes(SOFA_HEADER_SIZE))
        if magic != self.MAGIC:
            return PARSE_TRY_OTHERS, None
        total = meta_size + data_size
        if total > MAX_BODY_SIZE:
            return PARSE_TRY_OTHERS, None
        if portal.size < SOFA_HEADER_SIZE + total:
            socket.input_need = SOFA_HEADER_SIZE + total
            return PARSE_NOT_ENOUGH_DATA, None
        portal.pop_front(SOFA_HEADER_SIZE)
        meta_bytes = portal.cut(meta_size).to_bytes()
        body = portal.cut(data_size).to_bytes()
        try:
            meta = RpcMeta.decode(meta_bytes)
        except DecodeError as e:
            socket.set_failed(ConnectionError(f"bad sofa frame: {e}"))
            return PARSE_NOT_ENOUGH_DATA, None
        att = meta.attachment_size
        if att < 0 or att > data_size:
            # a lying attachment_size would eat the next frame's bytes
            socket.set_failed(ConnectionError(
                f"sofa frame attachment_size {att} > data {data_size}"))
            return PARSE_NOT_ENOUGH_DATA, None
        payload = body[:data_size - att]
        attachment = body[data_size - att:] if att else b""
        lane = recv = None
        if any(not dp.inline_bytes for dp in meta.device_payloads):
            lane, recv = socket.take_device_payload_with_recv()
        return PARSE_OK, RpcMessage(meta, payload, attachment, lane, recv)


_hulu: Optional[HuluPbrpcProtocol] = None
_sofa: Optional[SofaPbrpcProtocol] = None


def ensure_registered() -> Tuple[HuluPbrpcProtocol, SofaPbrpcProtocol]:
    global _hulu, _sofa
    if _hulu is None:
        _hulu = HuluPbrpcProtocol()
        register_protocol(_hulu)
    if _sofa is None:
        _sofa = SofaPbrpcProtocol()
        register_protocol(_sofa)
    return _hulu, _sofa
