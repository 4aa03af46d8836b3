"""Device selection for the port.

Entry points run on ``cuda:0`` unless the caller asks for the CPU
explicitly (the tests do). A missing card raises: there is no silent
fallback, so a number measured here always names the device it ran on.

TF32 is switched off once, here, for the whole port: TinyDecoder is
fp32 and its greedy tokens must equal the reference's, and TF32 keeps
only about three decimal digits of a matmul's operands.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda:0``. ``"cpu"`` is honoured; any CUDA device
    requires a card and raises ``RuntimeError`` without one."""
    if device is None:
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}: use cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run the plain path on the host")
    return torch.device("cuda", 0 if dev.index is None else dev.index)
