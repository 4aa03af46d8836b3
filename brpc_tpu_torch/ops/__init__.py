"""Device ops of the port: flash attention (CUDA kernels + plain twin),
and ring and Ulysses attention over a mesh's shard ring."""

from .flash_attention import (NEG_INF, attention_reference, decode_attention,
                              flash_attention, kernel_launches,
                              reset_launches)
from .ring_attention import ring_attention, ulysses_attention

__all__ = ["NEG_INF", "attention_reference", "decode_attention",
           "flash_attention", "kernel_launches", "reset_launches",
           "ring_attention", "ulysses_attention"]
