"""nova_pbrpc, public_pbrpc and ubrpc: the nshead family's RPC flavours
(the port of brpc_tpu/protocol/nshead_pbrpc.py; bRPC's
policy/nova_pbrpc_protocol.cpp, public_pbrpc_protocol.cpp and
ubrpc2pb_protocol.cpp).

All three ride nshead's framing (``protocol/nshead.py``) and install as
``ServerOptions(nshead_service=<adaptor>(service))``; a server has one.

- **nova_pbrpc**: no meta. ``head.reserved`` indexes the service's
  methods in registration order, the body is the request, and
  ``version & 0x1`` flags a snappy body. nova has no error channel and no
  correlation id: a bad index, a corrupt snappy body or a failed call
  drops the connection, since an unanswered request would hand the next
  reply to its caller.
- **public_pbrpc**: the body is a ``PublicPbrpcRequest`` envelope
  (``protocol/public_pbrpc_meta.py``) whose ``requestBody`` entries carry
  ``method_id``, ``id`` and the request. Each is answered in its own
  ``ResponseBody`` (``error`` 1002 for no such method, else the
  Controller's code or 2001); an envelope that does not parse, or lacks
  a required field, drops the connection.
- **ubrpc** (the compack-object flavour): the body is the mcpack map
  ``{content: [{service_name, method, id, params}]}`` and the answer
  ``{content: [{id, result}]}`` or ``{content: [{id, error: {code,
  message}}]}`` (1002: no such method, 2001: a bad body or handler
  error). ``params`` must be a map, which reaches the method as a dict:
  a method that takes bytes (Generate) cannot be served over ubrpc.

The port's methods take and return bytes: there is no protobuf bridge
(ROADMAP section 1). Every handler gets a Controller marked ``unary``
(``nshead.adaptor_controller``), so Generate answers its tokens;
brpc_tpu sends it down the HTTP path and answers an empty body (ROADMAP
section 3).
"""

from __future__ import annotations

import inspect
import itertools
from typing import Any, Dict, Optional, Tuple

from brpc_tpu_torch.protocol import public_pbrpc_meta as ppb
from brpc_tpu_torch.protocol.mcpack import McpackError, decode, encode
from brpc_tpu_torch.protocol.nshead import (NsheadClient, NsheadMessage,
                                            adaptor_controller)

NOVA_SNAPPY_COMPRESS_FLAG = 0x1
UBRPC_NSHEAD_VERSION = 1000


def _as_bytes(r) -> bytes:
    return b"" if r is None else bytes(r)


async def _invoke(service, method, request, socket
                  ) -> Tuple[Any, Any, Optional[str]]:
    """Run one method; never let an exception reach the framing (an
    unanswered request desyncs every later reply on the connection).
    (reply, cntl, error text or None)."""
    cntl = adaptor_controller(socket, service, method)
    try:
        r = method.handler(cntl, request)
        if inspect.isawaitable(r):
            r = await r
    except Exception as e:              # boundary: reported on the wire
        return None, cntl, f"handler error: {e}"
    if cntl.failed():
        return None, cntl, cntl.error_text
    return r, cntl, None


# ------------------------------------------------------------------ nova

def nova_adaptor(service):
    """Serve ``service`` over nova_pbrpc: ``head.reserved`` indexes its
    methods in registration order."""
    methods = list(service.methods.values())

    async def handler(socket, msg: NsheadMessage):
        if not 0 <= msg.reserved < len(methods):
            socket.set_failed(ConnectionError(
                f"nova: no method at index {msg.reserved}"))
            return None
        body = msg.body
        if msg.version & NOVA_SNAPPY_COMPRESS_FLAG:
            from brpc_tpu_torch.butil import snappy_codec
            try:
                body = snappy_codec.decompress_auto(body)
            except Exception as e:      # any corruption drops the peer
                socket.set_failed(ConnectionError(
                    f"nova: corrupt snappy body: {e}"))
                return None
        r, _cntl, err = await _invoke(service, methods[msg.reserved], body,
                                      socket)
        if err is not None:
            socket.set_failed(ConnectionError(f"nova: {err}"))
            return None
        return NsheadMessage(_as_bytes(r), id=msg.id, log_id=msg.log_id)

    return handler


class NovaClient(NsheadClient):
    """Calls a nova_pbrpc server: a method by index, a bytes request; one
    connection, replies in order."""

    def call_method(self, method_index: int, request: bytes,
                    log_id: int = 0, snappy: bool = False) -> bytes:
        body = bytes(request)
        version = 0
        if snappy:
            from brpc_tpu_torch.butil import snappy_codec
            body = snappy_codec.compress_auto(body)
            version = NOVA_SNAPPY_COMPRESS_FLAG
        reply = self.call(NsheadMessage(body, version=version, log_id=log_id,
                                        reserved=method_index))
        if reply.version & NOVA_SNAPPY_COMPRESS_FLAG:
            from brpc_tpu_torch.butil import snappy_codec
            return snappy_codec.decompress_auto(reply.body)
        return reply.body


# ---------------------------------------------------------- public_pbrpc

def public_pbrpc_adaptor(service):
    """Serve ``service`` over public_pbrpc: ``requestBody.method_id``
    indexes its methods in registration order, each body's ``id`` comes
    back in its answer."""
    methods = list(service.methods.values())

    async def handler(socket, msg: NsheadMessage):
        try:
            req = ppb.PublicPbrpcRequest.decode(msg.body)
        except ValueError as e:
            socket.set_failed(ConnectionError(
                f"public_pbrpc: bad envelope: {e}"))
            return None
        res = ppb.PublicPbrpcResponse(
            responseHead=ppb.ResponseHead(code=0, from_host="brpc-tpu"))
        for body in req.requestBody:
            rb = ppb.ResponseBody(id=body.id)
            res.responseBody.append(rb)
            if not 0 <= body.method_id < len(methods):
                rb.error = 1002
                continue
            r, cntl, err = await _invoke(
                service, methods[body.method_id],
                _as_bytes(body.serialized_request), socket)
            if err is not None:
                rb.error = cntl.error_code or 2001
            else:
                rb.serialized_response = _as_bytes(r)
        return NsheadMessage(res.encode(), id=msg.id, log_id=msg.log_id)

    return handler


class PublicPbrpcClient(NsheadClient):
    _ids = itertools.count(1)

    def call_method(self, service: str, method_id: int, request: bytes,
                    log_id: int = 0) -> bytes:
        """The response bytes; raises ConnectionError on an error answer
        or an envelope that is not this call's."""
        body = ppb.RequestBody(service=service, method_id=method_id,
                               id=next(self._ids),
                               serialized_request=bytes(request))
        env = ppb.PublicPbrpcRequest(
            requestHead=ppb.RequestHead(log_id=log_id), requestBody=[body])
        reply = self.call(NsheadMessage(env.encode(), log_id=log_id))
        try:
            res = ppb.PublicPbrpcResponse.decode(reply.body)
        except ValueError as e:
            raise ConnectionError(f"public_pbrpc: bad response: {e}")
        if not res.responseBody:
            raise ConnectionError("public_pbrpc: empty response envelope")
        rb = res.responseBody[0]
        if rb.id != body.id:
            raise ConnectionError(
                f"public_pbrpc: response id {rb.id} != request id {body.id}")
        if rb.error:
            raise ConnectionError(f"public_pbrpc: remote error {rb.error}")
        return _as_bytes(rb.serialized_response)


# ------------------------------------------------------------------ ubrpc

def ubrpc_adaptor(service):
    """Serve ``service`` over ubrpc's compack-object shape: the method by
    name, ``params`` (a map) as the request."""

    async def handler(socket, msg: NsheadMessage):

        def answer(item: Dict[str, Any]) -> NsheadMessage:
            return NsheadMessage(encode({"content": [item]}), id=msg.id,
                                 version=UBRPC_NSHEAD_VERSION,
                                 log_id=msg.log_id)

        def error_reply(corr_id, code, text):
            return answer({"id": corr_id,
                           "error": {"code": code, "message": text}})

        try:
            doc = decode(msg.body)
        except McpackError as e:
            return error_reply(0, 2001, f"bad compack body: {e}")
        content = doc.get("content")
        if not isinstance(content, list) or not content:
            return error_reply(0, 2001, "missing request.content")
        item = content[0]
        if not isinstance(item, dict):
            return error_reply(0, 2001, "request.content[0] is no object")
        try:
            corr_id = int(item.get("id", 0))
        except (TypeError, ValueError):
            return error_reply(0, 2001, "bad request id")
        method_name = str(item.get("method", ""))
        if not method_name:
            return error_reply(corr_id, 1002, "missing method")
        method = service.methods.get(method_name)
        if method is None:
            return error_reply(corr_id, 1002,
                               f"unknown method {method_name!r}")
        params = item.get("params")
        if not isinstance(params, dict):
            return error_reply(corr_id, 2001, "missing params object")
        r, cntl, err = await _invoke(service, method, params, socket)
        if err is not None:
            return error_reply(corr_id, cntl.error_code or 2001, err)
        if isinstance(r, (bytes, bytearray, memoryview)):
            r = bytes(r)
        elif r is None:
            r = {}
        return answer({"id": corr_id, "result": r})

    return handler


class UbrpcClient(NsheadClient):
    _ids = itertools.count(1)

    def call_method(self, service_name: str, method: str,
                    params: Dict[str, Any], log_id: int = 0):
        """The answer's ``result``; raises ConnectionError on an error
        answer (its code and message) or another call's id."""
        corr_id = next(self._ids)
        body = encode({"content": [{
            "service_name": service_name, "method": method,
            "id": corr_id, "params": params}]})
        reply = self.call(NsheadMessage(body, version=UBRPC_NSHEAD_VERSION,
                                        log_id=log_id))
        doc = decode(reply.body)
        item = (doc.get("content") or [{}])[0]
        # the error first: an answer before dispatch carries id 0
        err = item.get("error")
        if err:
            raise ConnectionError(f"ubrpc: remote error {err.get('code')}: "
                                  f"{err.get('message')}")
        got_id = int(item.get("id", -1))
        if got_id != corr_id:
            raise ConnectionError(
                f"ubrpc: response id {got_id} != request id {corr_id}")
        return item.get("result")
