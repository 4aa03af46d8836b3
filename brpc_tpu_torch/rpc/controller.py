"""Per-call state shared by client and server: the error, the deadline
budget, the response, the call's tensors, the call's stream or
progressive body, and its trace (the subset of brpc_tpu/rpc/controller.py
that the serving lane and the device lanes use)."""

from __future__ import annotations

import time
from typing import List, Optional

from . import errno_codes as berr
from .progressive import ProgressiveAttachment


class Controller:
    def __init__(self, timeout_ms: Optional[float] = None):
        self.error_code: int = berr.OK
        self.error_text: str = ""
        # client side: this call's timeout (None = the channel's option)
        self.timeout_ms: Optional[float] = timeout_ms
        self.correlation_id: int = 0
        # client side: the response payload once the call succeeded
        self.response: Optional[bytes] = None
        # the call's tensors (brpc_tpu/rpc/controller.py:169-170): the
        # client's request tensors reach the handler here, and what the
        # handler sets in response_device_arrays reaches the client's
        # controller, each in order, inline or over the device lane
        self.request_device_arrays: List = []
        self.response_device_arrays: List = []
        # server side: the deadline taken from the request meta's
        # timeout_ms, counted from the frame's arrival
        self._deadline_ns: Optional[int] = None
        # client side: the Stream set up on this call (stream_options)
        self.stream = None
        # server side: the connection a tpu_std call came on; None for a
        # call that came over HTTP (brpc_tpu/serving/service.py:289)
        self._server_socket = None
        # server side: the client's stream id, and the stream accepted
        self._peer_stream_id: int = 0
        self._accepted_stream = None
        # server side (HTTP): the chunked body fed after the handler
        self._progressive = None
        # rpcz: the trace this call belongs to and its own span id
        # (brpc_tpu/rpc/controller.py:112-113). A server sets them from
        # the request meta and start_server_span; a client call under
        # rpcz writes them into its request meta.
        self.trace_id: int = 0
        self.span_id: int = 0
        self.log_id: int = 0
        # server side: the peer's EndPoint
        self.remote_side = None
        # client side: this call's rpcz span, finished when it ends
        self._client_span = None

    def create_progressive_attachment(
            self, content_type: str = "application/octet-stream"):
        """An HTTP chunked response body, fed after the handler returns."""
        self._progressive = ProgressiveAttachment(content_type)
        return self._progressive

    def failed(self) -> bool:
        return self.error_code != berr.OK

    def set_failed(self, code: int, text: str = "") -> None:
        self.error_code = code
        self.error_text = text or berr.errno_name(code)

    def set_deadline(self, timeout_ms: Optional[float],
                     start_ns: Optional[int] = None) -> None:
        """Arm (or clear, with None or <= 0) the deadline budget."""
        if not timeout_ms or timeout_ms <= 0:
            self._deadline_ns = None
            return
        start = time.monotonic_ns() if start_ns is None else start_ns
        self._deadline_ns = start + int(timeout_ms * 1e6)

    def remaining_ms(self) -> Optional[float]:
        """Milliseconds left in the deadline budget, clamped at 0.0;
        None when no deadline applies."""
        dl = self._deadline_ns
        if dl is None:
            return None
        return max(0.0, (dl - time.monotonic_ns()) / 1e6)

    def deadline_expired(self) -> bool:
        dl = self._deadline_ns
        return dl is not None and time.monotonic_ns() >= dl
