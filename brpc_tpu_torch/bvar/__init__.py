"""Metrics (the port of brpc_tpu/bvar, bRPC's ``src/bvar``): counters
whose writes touch only a per-thread agent, windows over them, reservoir
percentiles, latency recorders, labelled families and the Prometheus
dump. Pure Python: nothing here imports torch.

The reference's trend rings (``series.py``) and anomaly watchdog
(``anomaly.py``) are not ported yet (ROADMAP section 1)."""

from brpc_tpu_torch.bvar.variable import (Variable, describe_exposed,
                                          dump_exposed, expose,
                                          unexpose_all)
from brpc_tpu_torch.bvar.reducer import (Adder, IntRecorder, Maxer, Miner,
                                         PassiveStatus, Status)
from brpc_tpu_torch.bvar.percentile import Percentile
from brpc_tpu_torch.bvar.window import (PerSecond, Sampler, Window,
                                        global_sampler)
from brpc_tpu_torch.bvar.latency_recorder import LatencyRecorder
from brpc_tpu_torch.bvar.prometheus import dump_prometheus
from brpc_tpu_torch.bvar.multi_dimension import MultiDimension
from brpc_tpu_torch.bvar.default_variables import expose_default_variables
from brpc_tpu_torch.bvar.gflag import FlagVar, expose_all_flags, expose_flag

__all__ = [
    "Variable", "expose", "dump_exposed", "describe_exposed", "unexpose_all",
    "Adder", "Maxer", "Miner", "IntRecorder", "PassiveStatus", "Status",
    "Percentile", "Window", "PerSecond", "Sampler", "global_sampler",
    "LatencyRecorder", "dump_prometheus", "MultiDimension",
    "expose_default_variables", "FlagVar", "expose_flag", "expose_all_flags",
]
