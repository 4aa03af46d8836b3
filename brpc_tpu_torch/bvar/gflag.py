"""Flag <-> bvar bridge (the port of brpc_tpu/bvar/gflag.py;
bvar/gflag.{h,cpp}): expose a runtime flag's
current value as a Variable so it shows up in /vars and windowed dumps,
staying live as /flags mutates it."""

from __future__ import annotations

from typing import Optional

from brpc_tpu_torch.butil.flags import flag, list_flags
from brpc_tpu_torch.bvar.variable import Variable


class FlagVar(Variable):
    def __init__(self, flag_name: str):
        super().__init__()
        self._flag_name = flag_name
        flag(flag_name)  # raises now if undefined, not at dump time

    @property
    def flag_name(self) -> str:
        return self._flag_name

    def get_value(self):
        return flag(self._flag_name)


def expose_flag(flag_name: str, bvar_name: Optional[str] = None) -> FlagVar:
    return FlagVar(flag_name).expose(bvar_name or f"flag_{flag_name}")


def expose_all_flags(prefix: str = "flag_") -> int:
    """Expose every defined flag as ``<prefix><name>``; returns count."""
    n = 0
    for name, _v, _d, _h in list_flags():
        expose_flag(name, prefix + name)
        n += 1
    return n
