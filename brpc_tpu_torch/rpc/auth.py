"""Authenticator and Interceptor (the port of brpc_tpu/rpc/auth.py;
brpc/authenticator.h, brpc/interceptor.h:26-37).

Client: ``ChannelOptions.auth`` (its ``generate_credential()``) or
``ChannelOptions.auth_token`` gives the credential, which rides every
request's meta (``RpcRequestMeta.auth_token``), so a channel that
reconnects sends it again on the new connection.

Server: ``ServerOptions.auth`` (or ``auth_token``, sugar for a
``TokenAuthenticator``) verifies the credential of a connection's first
request, before the method lookup, and caches the ``AuthContext`` on the
connection (``cntl.auth_context``); a rejected credential answers
ERPCAUTH. The Interceptor runs after auth and the request's decoding on
every request and may reject it with ``(error_code, reason)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple


class AuthError(Exception):
    """A rejected credential; the text goes back to the caller."""


@dataclass
class AuthContext:
    """The verified identity of a peer (brpc/authenticator.h)."""
    user: str = ""
    group: str = ""
    roles: str = ""
    starter: str = ""
    is_service: bool = False
    extra: dict = field(default_factory=dict)


class Authenticator:
    def generate_credential(self) -> str:
        """Client: the credential to send."""
        raise NotImplementedError

    def verify_credential(self, credential: str, remote_side) -> AuthContext:
        """Server: the peer's AuthContext, or raise AuthError. Called on a
        connection's first request; the result is cached on it."""
        raise NotImplementedError


class TokenAuthenticator(Authenticator):
    """A shared-secret bearer token."""

    def __init__(self, token: str, user: str = "token-peer"):
        self._token = token
        self._user = user

    def generate_credential(self) -> str:
        return self._token

    def verify_credential(self, credential: str, remote_side) -> AuthContext:
        if credential != self._token:
            raise AuthError("authentication failed")
        return AuthContext(user=self._user)


# callable(cntl) -> None to accept, or (error_code, reason) to reject; it
# may also raise InterceptorError
Interceptor = Callable[[object], Optional[Tuple[int, str]]]


class InterceptorError(Exception):
    def __init__(self, error_code: int, reason: str):
        super().__init__(reason)
        self.error_code = error_code
        self.reason = reason


def resolve_server_auth(options) -> Optional[Authenticator]:
    """``ServerOptions.auth``, else a TokenAuthenticator of
    ``auth_token``, else None."""
    if options.auth is not None:
        return options.auth
    if options.auth_token is not None:
        return TokenAuthenticator(options.auth_token)
    return None
