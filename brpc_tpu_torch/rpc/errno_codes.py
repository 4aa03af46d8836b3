"""RPC error codes (brpc/errno.proto equivalents)."""

OK = 0
ENOSERVICE = 1001       # service not found
ENOMETHOD = 1002        # method not found
EREQUEST = 1003         # bad request
ERPCAUTH = 1004         # auth failed
ETOOMANYFAILS = 1005    # too many sub-channel failures (combo channels)
EBACKUPREQUEST = 1007   # backup request fired (internal)
ERPCTIMEDOUT = 1008     # RPC deadline exceeded
EFAILEDSOCKET = 1009    # connection broken during call
EHTTP = 1010            # HTTP-level error
EOVERCROWDED = 1011     # too many buffered writes / server concurrency full
EPERM = 1012            # rejected by server interceptor / permission
EINTERNAL = 2001        # server-side handler exception
ERESPONSE = 2002        # bad response
ELOGOFF = 2003          # server is stopping
ELIMIT = 2004           # concurrency limiter rejected
ECLOSE = 2005           # connection closed by peer
ECANCELED = 2006        # call canceled
ENAMINGEMPTY = 2007     # naming service resolved no servers (cluster
#                         channel fails fast instead of a generic pick
#                         failure — see /vars naming_empty)
EPRIORITYSHED = 2008    # DAGOR priority admission shed: the request's
#                         (business, user) level sat below the server's
#                         current admission threshold — a µs-cheap
#                         reject distinct from ELIMIT so operators see
#                         WHICH overload organ fired (rpc/admission.py)

_NAMES = {v: k for k, v in list(globals().items()) if isinstance(v, int)}


def errno_name(code: int) -> str:
    return _NAMES.get(code, f"E{code}")
