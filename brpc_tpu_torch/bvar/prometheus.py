"""Prometheus text-format dump of exposed variables
(the port of brpc_tpu/bvar/prometheus.py;
builtin/prometheus_metrics_service.cpp)."""

from __future__ import annotations

from typing import List

from brpc_tpu_torch.bvar.variable import dump_exposed_variables


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def dump_prometheus_items(items) -> str:
    """Prometheus text from (name, value) pairs instead of live
    Variables — the shard supervisor's merged dump renders through
    this (its numbers come from the per-shard JSON stores, not from
    this process's registry). Same scalar/composite rules as
    dump_prometheus; non-numeric values are skipped."""
    lines: List[str] = []
    for name, value in items:
        mname = _sanitize(name)
        if isinstance(value, dict):
            for k, v in value.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    lines.append(f"{mname}_{_sanitize(str(k))} {v}")
        elif isinstance(value, bool):
            lines.append(f"{mname} {int(value)}")
        elif isinstance(value, (int, float)):
            lines.append(f"{mname} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


def dump_prometheus(prefix: str = "") -> str:
    from brpc_tpu_torch.bvar.multi_dimension import MultiDimension
    lines: List[str] = []
    for name, var in dump_exposed_variables(prefix):
        mname = _sanitize(name)
        if isinstance(var, MultiDimension):
            # labeled series: name{k="v",...} value — labels come from
            # labeled_items(), NOT get_value() (a subclass may flatten
            # get_value keys for JSON consumers)
            label_names = [_sanitize(ln) for ln in var.label_names]
            for key, v in sorted(var.labeled_items()):
                if isinstance(v, dict):
                    # composite stat (e.g. LatencyRecorder): one line per
                    # numeric component
                    for ck, cv in v.items():
                        if isinstance(cv, (int, float)):
                            labels = ",".join(
                                f'{ln}="{_escape_label(str(kv))}"'
                                for ln, kv in zip(label_names, key))
                            lines.append(
                                f"{mname}_{_sanitize(str(ck))}{{{labels}}} {cv}")
                elif isinstance(v, (int, float)):
                    labels = ",".join(f'{ln}="{_escape_label(str(kv))}"'
                                      for ln, kv in zip(label_names, key))
                    lines.append(f"{mname}{{{labels}}} {v}")
            continue
        value = var.get_value()
        if isinstance(value, dict):
            for k, v in value.items():
                if isinstance(v, (int, float)):
                    lines.append(f"{mname}_{_sanitize(str(k))} {v}")
        elif isinstance(value, bool):
            lines.append(f"{mname} {int(value)}")
        elif isinstance(value, (int, float)):
            lines.append(f"{mname} {value}")
        # non-numeric vars are skipped, like the reference's dumper
    return "\n".join(lines) + ("\n" if lines else "")
