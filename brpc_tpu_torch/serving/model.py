"""TinyDecoder: the seed-derived toy model behind the serving lane, as an
``nn.Module`` (the port of brpc_tpu/serving/model.py).

The weights are drawn with ``numpy.random.RandomState(seed)`` in the
reference's order, so they are bit-identical to brpc_tpu's, and live as
buffers on the model's device. ``prefill`` builds a prompt's KV rows on
that device; ``decode_step`` runs one greedy step for a fixed-shape slot
batch through ``ops.flash_attention.decode_attention`` (the CUDA kernel
on a card, the plain version on the CPU). The projections and logits are
plain ``torch.matmul``, as the reference left them to XLA.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from brpc_tpu_torch.butil.device import DeviceLike, resolve_device
from brpc_tpu_torch.ops.flash_attention import decode_attention

DEFAULT_SEED = 20260803
PARAM_NAMES = ("emb", "wq", "wk", "wv", "wo", "pos")


class TinyDecoderConfig:
    def __init__(self, vocab: int = 256, dim: int = 32,
                 cache_len: int = 160, seed: int = DEFAULT_SEED,
                 block_k: int = 64):
        self.vocab = vocab
        self.dim = dim
        self.cache_len = cache_len    # KV slot capacity (prompt + gen)
        self.seed = seed
        self.block_k = block_k


def _sinusoid(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    pe = np.zeros((n, d), np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: (d + 1) // 2][: pe[:, 1::2].shape[1]])
    return pe.astype(np.float32)


def init_params(cfg: TinyDecoderConfig) -> Dict[str, np.ndarray]:
    """The reference's weights: the same RandomState draws in the same
    order (emb, wq, wk, wv, wo), then the sinusoid positions."""
    rng = np.random.RandomState(cfg.seed)
    s = cfg.dim ** -0.5
    out = {"emb": rng.randn(cfg.vocab, cfg.dim).astype(np.float32)}
    for name in ("wq", "wk", "wv", "wo"):
        out[name] = (rng.randn(cfg.dim, cfg.dim) * s).astype(np.float32)
    out["pos"] = _sinusoid(cfg.cache_len, cfg.dim)
    return out


class TinyDecoder(nn.Module):
    def __init__(self, config: Optional[TinyDecoderConfig] = None, *,
                 device: DeviceLike = None,
                 params: Optional[Dict[str, np.ndarray]] = None):
        super().__init__()
        self.config = cfg = copy.copy(config) if config else \
            TinyDecoderConfig()
        self.device = resolve_device(device)
        params = init_params(cfg) if params is None else params
        for name in PARAM_NAMES:
            self.register_buffer(
                name, torch.from_numpy(np.array(params[name], np.float32,
                                                copy=True)).to(self.device))

    # ------------------------------------------------------------ prefill
    @torch.no_grad()
    def prefill(self, tokens: Sequence[int]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """KV rows for a prompt, position-wise, on the model's device.
        Returns (k [n, d], v [n, d], h_last [d])."""
        toks = torch.as_tensor(list(tokens), dtype=torch.long,
                               device=self.device)
        h = self.emb[toks] + self.pos[: len(toks)]
        return h @ self.wk, h @ self.wv, h[-1]

    # -------------------------------------------------------- decode step
    @torch.no_grad()
    def decode_step(self, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    h_last: torch.Tensor, lengths: torch.Tensor):
        """One greedy step for a [B, L, d] slot batch on the model's
        device. ``lengths`` [B] counts each slot's valid rows. Returns
        (next_tokens [B], k_new [B, d], v_new [B, d], h_new [B, d]), all on
        the device; rows of idle slots are garbage the caller ignores."""
        q = h_last @ self.wq
        o = decode_attention(q, k_cache, v_cache, lengths,
                             block_k=self.config.block_k)
        # logits from the attention output plus a strong position term
        # (see the reference: no embedding residual, so sequences do not
        # collapse to a one-token fixed point)
        cur_pos = self.pos[lengths.long().clamp(0, self.pos.shape[0] - 1)]
        logits = (o @ self.wo + 3.0 * cur_pos) @ self.emb.T
        nxt = torch.argmax(logits, dim=-1)
        h_new = self.emb[nxt] + cur_pos
        return nxt, h_new @ self.wk, h_new @ self.wv, h_new

    # ---------------------------------------------------------- reference
    def generate(self, prompt_tokens: Sequence[int],
                 max_new_tokens: int) -> List[int]:
        """Single-sequence oracle: the token stream the batched engine
        must reproduce whatever shares the batch."""
        cfg, dev = self.config, self.device
        k = torch.zeros((1, cfg.cache_len, cfg.dim), device=dev)
        v = torch.zeros_like(k)
        h = torch.zeros((1, cfg.dim), device=dev)
        kp, vp, hl = self.prefill(prompt_tokens)
        n = len(prompt_tokens)
        k[0, :n], v[0, :n], h[0] = kp, vp, hl
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        out: List[int] = []
        for _ in range(max_new_tokens):
            if n >= cfg.cache_len:
                break
            nxt, kn, vn, hn = self.decode_step(k, v, h, lens)
            out.append(int(nxt[0]))
            k[0, n], v[0, n], h[0] = kn[0], vn[0], hn[0]
            n += 1
            lens += 1
        return out
