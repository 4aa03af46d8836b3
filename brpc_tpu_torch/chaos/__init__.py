"""Deterministic fault injection at the transport seam, the "chaos lane"
(the port of brpc_tpu/chaos/, with its names and counters).

Basiri et al., *Chaos Engineering* (IEEE Software 2016): failure-handling
machinery (retry, backup request, failover, circuit breaker, health
check) only counts once it survives injected faults on the REAL
transport — hand-rolled stubs exercise the handler, not the stack. The
chaos lane installs a seeded, scripted :class:`FaultPlan` around the
registered transports (``mem://``, ``tcp://``, ``ici://``, ...), so every
layer above the ``Conn`` byte-stream contract — Socket write
arbitration, the input messenger, dispatch, retries, breakers, health
checks — experiences the fault exactly as production would.

Determinism contract: a plan is addressed by (endpoint, connection
index) and byte offsets, never by wall-clock; the same plan against the
same call sequence injects the same faults. ``FaultPlan.random(seed)``
expands to a concrete script via ``random.Random(seed)`` so a storm is
reproducible from its seed alone.

Injection counters (exposed bvars, one per primitive)::

    chaos_injected_delay / drop / corrupt / partial / refuse / flap

They also stand on ``/connections``' robustness pane. The standing
invariants a chaos run must uphold:

  1. every call reaches a verdict — no hangs (completion, error, or the
     caller's own deadline);
  2. a flapping peer is isolated (breaker/health) and revived by the
     health check once the flap ends;
  3. no socket/fiber/stream leaks after the storm settles.

The port's native lanes reach the fd directly (the pluck and turbo
lanes' ``pluck_fd``, ``fast_drain`` and ``serve_drain``, the ring lane's
recv and gather write). Those that only read stay as they are: faults
act on the write side, and every byte they write goes out through
``Socket.write`` and so through the wrapped conn. A wrapped conn hides
``writev`` and is never ring-native, so neither the gather writer nor
the ring's flush can pass the script by.
"""

from brpc_tpu_torch.chaos.plan import Fault, FaultPlan
from brpc_tpu_torch.chaos.inject import (chaos_counters, install,
                                         installed_plan, uninstall)

__all__ = ["Fault", "FaultPlan", "install", "uninstall", "installed_plan",
           "chaos_counters"]
