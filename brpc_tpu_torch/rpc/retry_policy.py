"""Retry decisions and the retry budget (the port of
brpc_tpu/rpc/retry_policy.py; brpc/retry_policy.h).

A channel consults its RetryPolicy for every failed attempt, a
transport failure or an error the server returned, while tries remain.
The default (``RpcRetryPolicy``, retry_policy.cpp:25) retries the errors
after which another server, or another moment, may succeed, never the
caller's own (a bad request, a deadline). ``RetryBackoffPolicy`` waits
between attempts, exponentially and with jitter.

``RetryBudget`` is a channel's token bucket (gRPC's retryThrottling):
a failed attempt drains a token, a success refills a tenth of one, and
while the bucket sits at half its size or below the channel issues no
retry and no backup request (``retry_throttled``). A shed (ELIMIT,
EOVERCROWDED, EPRIORITYSHED) and a naming list that is empty drain
nothing. ``shared_retry_budget`` gives every channel of one
``budget_group`` the same bucket; ``retry_tokens_min`` is the lowest
bucket of the process.

``_postfork_reset`` is registered with the postfork registry.
"""

from __future__ import annotations

import random
import threading
import weakref
from typing import Optional

from brpc_tpu_torch.bvar.reducer import PassiveStatus

from . import errno_codes as berr


class RetryPolicy:
    """Override ``do_retry``: True retries the attempt (the controller
    shows the attempt's error_code and error_text)."""

    def do_retry(self, cntl) -> bool:
        raise NotImplementedError

    def retry_backoff_s(self, cntl) -> float:
        """Seconds to wait before the next attempt (0: at once, the
        default). ``cntl.current_try`` is the 0-based index of the
        attempt that failed; the channel clamps the wait to the call's
        remaining budget."""
        return 0.0


class RpcRetryPolicy(RetryPolicy):
    """Transport and availability errors retry; semantic ones do not."""

    RETRYABLE = frozenset({
        berr.EFAILEDSOCKET,   # the connection broke mid-call
        berr.ECLOSE,          # the peer closed
        berr.ELOGOFF,         # the server is stopping: another may serve
        berr.ELIMIT,          # the concurrency limiter or a queue shed
        berr.EOVERCROWDED,    # write buffers full
        berr.EPRIORITYSHED,   # below one node's admission threshold;
        #                       thresholds are per node
    })

    def do_retry(self, cntl) -> bool:
        return cntl.error_code in self.RETRYABLE


class RetryBackoffPolicy(RpcRetryPolicy):
    """Attempt N waits ``base_ms * 2**N``, at most ``max_ms``, spread by
    ``jitter`` (a fraction either way), so that failures that come
    together do not retry together. ``rng`` makes tests repeatable;
    ``retryable`` replaces the decision (``cntl -> bool``)."""

    def __init__(self, base_ms: float = 20.0, max_ms: float = 1000.0,
                 jitter: float = 0.5, rng: Optional[random.Random] = None,
                 retryable=None):
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be within [0, 1]")
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)
        self.jitter = float(jitter)
        self._rng = rng or random.Random()
        self._retryable = retryable

    def do_retry(self, cntl) -> bool:
        if self._retryable is not None:
            return bool(self._retryable(cntl))
        return super().do_retry(cntl)

    def retry_backoff_s(self, cntl) -> float:
        b = min(self.base_ms * (2.0 ** cntl.current_try), self.max_ms)
        if self.jitter:
            b *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return b / 1e3


class RetryBudget:
    """A channel's retry token bucket: ``max_tokens`` tokens, refilled by
    ``token_ratio`` a success, throttled at half."""

    def __init__(self, max_tokens: float = 100.0,
                 token_ratio: float = 0.1):
        if max_tokens <= 0:
            raise ValueError("max_tokens must be > 0")
        self._max = float(max_tokens)
        self._tokens = self._max
        self._ratio = float(token_ratio)
        self._threshold = self._max / 2.0
        self._lock = threading.Lock()
        _budgets.add(self)
        _ensure_tokens_var()

    def drain(self) -> None:
        with self._lock:
            self._tokens = max(0.0, self._tokens - 1.0)

    def refill(self) -> None:
        with self._lock:
            if self._tokens < self._max:
                self._tokens = min(self._max, self._tokens + self._ratio)

    def throttled(self) -> bool:
        """True at half the bucket or below: no retry, no backup."""
        with self._lock:
            return self._tokens <= self._threshold

    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def snapshot(self) -> dict:
        with self._lock:
            return {"tokens": round(self._tokens, 2),
                    "max_tokens": self._max,
                    "token_ratio": self._ratio,
                    "throttled": self._tokens <= self._threshold}

    @staticmethod
    def resolve(spec) -> Optional["RetryBudget"]:
        """``ChannelOptions.retry_budget``: None or False is none, True
        the defaults, an instance itself."""
        if spec is None or spec is False:
            return None
        if spec is True:
            return RetryBudget()
        if isinstance(spec, RetryBudget):
            return spec
        raise TypeError(f"not a retry budget: {spec!r}")


# the live buckets, weakly held: /status and retry_tokens_min report the
# most drained one
_budgets: "weakref.WeakSet[RetryBudget]" = weakref.WeakSet()
_tokens_var_exposed = False
# the buckets of channel groups (ChannelOptions.budget_group), held for
# the process's life: the group is an identity, like the bvar it feeds
_group_budgets: dict = {}
_group_lock = threading.Lock()


def shared_retry_budget(group: str, spec=True) -> RetryBudget:
    """The group's bucket, made from ``spec`` at its first use; later
    members join it whatever their spec (one cluster, one idea of how
    many retries it can take). Made outside the lock: its constructor
    exposes a bvar."""
    cur = _group_budgets.get(group)
    if cur is not None:
        return cur
    made = RetryBudget.resolve(True if spec is None else spec)
    with _group_lock:
        cur = _group_budgets.get(group)
        if cur is None:
            cur = _group_budgets[group] = made
    return cur


def budget_group_snapshot() -> dict:
    """Group -> its bucket's snapshot (on /backends)."""
    with _group_lock:
        groups = dict(_group_budgets)
    return {g: b.snapshot() for g, b in groups.items()}


def min_retry_tokens() -> Optional[float]:
    """The lowest token count of the live buckets; None when no channel
    has one."""
    vals = [b.tokens() for b in list(_budgets)]
    return round(min(vals), 2) if vals else None


def _ensure_tokens_var() -> None:
    """``retry_tokens_min`` exists once the first bucket does."""
    global _tokens_var_exposed
    if _tokens_var_exposed:
        return
    _tokens_var_exposed = True
    PassiveStatus(lambda: (lambda v: -1.0 if v is None else v)(
        min_retry_tokens())).expose("retry_tokens_min")


_default: Optional[RetryPolicy] = None


def default_retry_policy() -> RetryPolicy:
    global _default
    if _default is None:
        _default = RpcRetryPolicy()
    return _default


def resolve(policy) -> RetryPolicy:
    """A RetryPolicy, a bare callable or None (the default)."""
    if policy is None:
        return default_retry_policy()
    if isinstance(policy, RetryPolicy):
        return policy
    if callable(policy):
        wrapped = RetryPolicy()
        wrapped.do_retry = lambda cntl: bool(policy(cntl))  # type: ignore
        return wrapped
    raise TypeError(f"not a retry policy: {policy!r}")


def _postfork_reset() -> None:
    """A forked child re-seeds its jitter (a seeded policy would jitter
    alike in every child) and forgets the parent's buckets, which
    describe sockets it does not own."""
    global _default, _budgets, _tokens_var_exposed
    global _group_budgets, _group_lock
    _default = None
    _budgets = weakref.WeakSet()
    _tokens_var_exposed = False
    _group_budgets = {}
    _group_lock = threading.Lock()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("rpc.retry_policy", _postfork_reset)
