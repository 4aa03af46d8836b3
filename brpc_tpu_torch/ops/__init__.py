"""Device ops of the port: flash attention (CUDA kernel + plain twin)."""

from .flash_attention import (NEG_INF, attention_reference, decode_attention,
                              flash_attention, kernel_launches,
                              reset_launches)

__all__ = ["NEG_INF", "attention_reference", "decode_attention",
           "flash_attention", "kernel_launches", "reset_launches"]
