"""FaultPlan: the deterministic script of what breaks, where, and when
(the port of brpc_tpu/chaos/plan.py: ``to_json`` writes the same bytes
for the same script, and ``random(seed)`` draws the same storm).

A plan addresses faults by **endpoint key + per-endpoint connection
index** (the Nth connect() to that endpoint) and **byte offsets** within
the connection's outbound stream — never wall-clock time — so replaying
the same call sequence against the same plan injects the same faults.

Primitives:

  ``delay``          outbound bytes at offset >= ``at_byte`` are held for
                     ``delay_ms`` (the writer parks exactly like a full
                     kernel buffer: BlockingIOError + writable event
                     when the delay elapses)
  ``drop``           the connection dies once ``at_byte`` outbound bytes
                     have left (peer sees EOF mid-stream)
  ``corrupt``        one byte at absolute outbound offset ``at_byte`` is
                     XORed with ``xor_mask``
  ``partial_stall``  writes accept bytes up to ``at_byte``, then stall
                     forever (never writable again) — the half-written
                     frame scenario; the caller's deadline is the verdict
  ``refuse``         the Nth connect() to the endpoint is refused
  ``flap``           link-flap: at connect index ``at_conn`` every live
                     connection to the endpoint is dropped and the next
                     ``refuse_next`` connect attempts are refused (health
                     probes included), after which the link is back.  On
                     ``ici://`` endpoints the blackout covers the
                     descriptor/ACK stream, so senders park on the pull
                     window — the device-lane flavor of the same fault.

``side`` selects which half of the duplex pair a byte-stream fault
wraps: ``"connect"`` (the dialing side's writes — requests) or
``"accept"`` (the accepting side's writes — responses).
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence, Tuple

from brpc_tpu_torch.butil.endpoint import EndPoint, str2endpoint

BYTE_FAULTS = ("delay", "drop", "corrupt", "partial_stall")
CONN_FAULTS = ("refuse", "flap")
KINDS = BYTE_FAULTS + CONN_FAULTS


class Fault:
    """One scripted fault. Byte-stream kinds trigger at ``at_byte`` of
    the wrapped side's outbound stream; connection kinds trigger at a
    connect index (held plan-side, not here)."""

    __slots__ = ("kind", "at_byte", "delay_ms", "xor_mask", "side",
                 "_armed_ns", "_done")

    def __init__(self, kind: str, at_byte: int = 0, delay_ms: float = 0.0,
                 xor_mask: int = 0x01, side: str = "connect"):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        if side not in ("connect", "accept"):
            raise ValueError(f"side must be connect|accept, got {side!r}")
        self.kind = kind
        self.at_byte = int(at_byte)
        self.delay_ms = float(delay_ms)
        self.xor_mask = int(xor_mask) & 0xFF
        self.side = side
        self._armed_ns: Optional[int] = None   # delay: when it started
        self._done = False

    def clone(self) -> "Fault":
        return Fault(self.kind, self.at_byte, self.delay_ms,
                     self.xor_mask, self.side)

    def __repr__(self) -> str:
        return (f"Fault({self.kind!r}, at_byte={self.at_byte}, "
                f"delay_ms={self.delay_ms}, side={self.side!r})")


def endpoint_key(ep) -> str:
    """Canonical plan key for an endpoint (string or EndPoint)."""
    if not isinstance(ep, EndPoint):
        ep = str2endpoint(str(ep))
    return str(ep)


class FaultPlan:
    """The deterministic fault schedule for one chaos run.

    Scripting is chainable::

        plan = (FaultPlan(seed=7)
                .at("mem://a", 1, Fault("corrupt", at_byte=5))
                .refuse("mem://a", 2)
                .flap("mem://b", at_conn=3, refuse_next=4))

    A plan instance carries per-run state (connection counters, consumed
    faults); build a fresh plan (or ``clone()``) per run.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        # key -> conn_index -> [Fault, ...] (byte-stream faults)
        self._scripts: Dict[str, Dict[int, List[Fault]]] = {}
        self._refuse: Dict[str, set] = {}          # key -> {conn_index}
        # key -> {at_conn: refuse_next}
        self._flaps: Dict[str, Dict[int, int]] = {}
        self._conn_counts: Dict[str, int] = {}     # per-run state
        self._flap_until: Dict[str, int] = {}      # key -> refuse < index
        self._fired: List[Tuple[str, str, int]] = []   # (kind, key, idx)

    # ------------------------------------------------------------ scripting
    def at(self, ep, conn_index: int, *faults: Fault) -> "FaultPlan":
        key = endpoint_key(ep)
        bucket = self._scripts.setdefault(key, {}).setdefault(
            int(conn_index), [])
        for f in faults:
            if f.kind not in BYTE_FAULTS:
                raise ValueError(
                    f"{f.kind!r} is scheduled with refuse()/flap(), "
                    "not at()")
            bucket.append(f)
        bucket.sort(key=lambda f: f.at_byte)
        return self

    def refuse(self, ep, *conn_indices: int) -> "FaultPlan":
        self._refuse.setdefault(endpoint_key(ep), set()).update(
            int(i) for i in conn_indices)
        return self

    def flap(self, ep, at_conn: int, refuse_next: int = 3) -> "FaultPlan":
        self._flaps.setdefault(endpoint_key(ep), {})[int(at_conn)] = \
            int(refuse_next)
        return self

    @classmethod
    def random(cls, seed: int, endpoints: Sequence, conns: int = 16,
               fault_rate: float = 0.35,
               kinds: Sequence[str] = BYTE_FAULTS) -> "FaultPlan":
        """Expand a seed into a concrete storm script: for each endpoint
        and each of the first ``conns`` connections, roll (seeded)
        whether and which fault to inject and at which offset. Pure
        function of (seed, endpoints, conns, fault_rate, kinds)."""
        rng = random.Random(seed)
        plan = cls(seed=seed)
        for ep in endpoints:
            for idx in range(conns):
                if rng.random() >= fault_rate:
                    continue
                kind = kinds[rng.randrange(len(kinds))]
                at_byte = rng.randrange(1, 256)
                if kind == "delay":
                    plan.at(ep, idx, Fault("delay", at_byte=at_byte,
                                           delay_ms=rng.randrange(5, 40)))
                elif kind == "corrupt":
                    plan.at(ep, idx, Fault("corrupt", at_byte=at_byte,
                                           xor_mask=rng.randrange(1, 256)))
                else:
                    plan.at(ep, idx, Fault(kind, at_byte=at_byte))
        return plan

    def clone(self) -> "FaultPlan":
        """A fresh, unfired copy of the same script (per-run state
        reset) — the repeat-run determinism primitive."""
        p = FaultPlan(seed=self.seed)
        for key, by_idx in self._scripts.items():
            for idx, faults in by_idx.items():
                p._scripts.setdefault(key, {})[idx] = \
                    [f.clone() for f in faults]
        p._refuse = {k: set(v) for k, v in self._refuse.items()}
        p._flaps = {k: dict(v) for k, v in self._flaps.items()}
        return p

    # -------------------------------------------------- serialization
    def to_json(self) -> str:
        """The plan's full script (seed + every fault with its
        endpoint/conn-index/byte-offset address) as one deterministic
        JSON document — sorted keys, compact separators, so two plans
        with the same script serialize byte-identically. Per-run state
        (connection counters, fired log) is deliberately NOT part of
        the document: a deserialized plan is always fresh."""
        scripts = {
            key: {str(idx): [{"kind": f.kind, "at_byte": f.at_byte,
                              "delay_ms": f.delay_ms,
                              "xor_mask": f.xor_mask, "side": f.side}
                             for f in faults]
                  for idx, faults in by_idx.items()}
            for key, by_idx in self._scripts.items()}
        doc = {"v": 1, "seed": self.seed, "scripts": scripts,
               "refuse": {k: sorted(v) for k, v in self._refuse.items()},
               "flaps": {k: {str(at): n for at, n in v.items()}
                         for k, v in self._flaps.items()}}
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        """Rebuild a fresh (unfired) plan from ``to_json()`` output.
        Rebuilds through the scripting API so the same invariants hold
        (kind validation, at_byte ordering, endpoint-key
        canonicalization)."""
        doc = json.loads(text)
        v = doc.get("v")
        if v != 1:
            raise ValueError(f"unsupported FaultPlan document v={v!r}")
        plan = cls(seed=int(doc.get("seed", 0)))
        for key, by_idx in (doc.get("scripts") or {}).items():
            for idx, faults in by_idx.items():
                plan.at(key, int(idx), *(
                    Fault(f["kind"], at_byte=int(f.get("at_byte", 0)),
                          delay_ms=float(f.get("delay_ms", 0.0)),
                          xor_mask=int(f.get("xor_mask", 0x01)),
                          side=f.get("side", "connect"))
                    for f in faults))
        for key, idxs in (doc.get("refuse") or {}).items():
            plan.refuse(key, *idxs)
        for key, flaps in (doc.get("flaps") or {}).items():
            for at, n in flaps.items():
                plan.flap(key, int(at), refuse_next=int(n))
        return plan

    def schemes(self) -> set:
        """Transport schemes this plan touches (what install() wraps)."""
        out = set()
        for key in (set(self._scripts) | set(self._refuse)
                    | set(self._flaps)):
            out.add(str2endpoint(key).scheme)
        return out

    # ------------------------------------------------------ runtime queries
    # (called by the inject layer; all deterministic given call order)
    def next_conn_index(self, key: str) -> int:
        idx = self._conn_counts.get(key, 0)
        self._conn_counts[key] = idx + 1
        return idx

    def connect_verdict(self, key: str, idx: int) -> Optional[str]:
        """None = proceed; "refuse" = refuse this connect; "flap" = this
        connect TRIGGERS a flap (drop live conns, then refuse it)."""
        refuse_next = self._flaps.get(key, {}).get(idx)
        if refuse_next is not None:
            self._flap_until[key] = idx + refuse_next
            return "flap"
        if idx < self._flap_until.get(key, 0):
            return "refuse"
        if idx in self._refuse.get(key, ()):
            return "refuse"
        return None

    def script_for(self, key: str, idx: int,
                   side: str) -> Optional[List[Fault]]:
        faults = self._scripts.get(key, {}).get(idx)
        if not faults:
            return None
        picked = [f for f in faults if f.side == side]
        return picked or None

    def record(self, kind: str, key: str, idx: int) -> None:
        self._fired.append((kind, key, idx))

    def fired(self) -> List[Tuple[str, str, int]]:
        """Chronological (kind, endpoint_key, conn_index) injection log —
        the determinism witness two identical runs are compared on."""
        return list(self._fired)
