"""Carry TinyDecoder weights between brpc_tpu and the port.

The reference keeps its weights as numpy arrays on the model object
(``emb``, ``wq``, ``wk``, ``wv``, ``wo``, ``pos``). ``from_jax_decoder``
reads those attributes off such an object, duck-typed, without importing
brpc_tpu; ``same_weights`` checks bit for bit that a port model holds
given numpy weights (as one built from the same seed must).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from brpc_tpu_torch.butil.device import DeviceLike

from .model import PARAM_NAMES, TinyDecoder, TinyDecoderConfig


def params_from_numpy(arrays: Mapping[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """Validate and copy the six weight arrays as float32 numpy."""
    missing = [n for n in PARAM_NAMES if n not in arrays]
    if missing:
        raise KeyError(f"missing weights: {missing}")
    out = {n: np.array(arrays[n], dtype=np.float32, copy=True)
           for n in PARAM_NAMES}
    vocab, dim = out["emb"].shape
    for n in ("wq", "wk", "wv", "wo"):
        if out[n].shape != (dim, dim):
            raise ValueError(f"{n} is {out[n].shape}, expected {(dim, dim)}")
    if out["pos"].ndim != 2 or out["pos"].shape[1] != dim:
        raise ValueError(f"pos is {out['pos'].shape}, expected [L, {dim}]")
    return out


def from_jax_decoder(obj, device: DeviceLike = None) -> TinyDecoder:
    """A port TinyDecoder holding the weights of a brpc_tpu TinyDecoder."""
    params = params_from_numpy({n: np.asarray(getattr(obj, n))
                                for n in PARAM_NAMES})
    src = obj.config
    cfg = TinyDecoderConfig(vocab=src.vocab, dim=src.dim,
                            cache_len=src.cache_len, seed=src.seed,
                            block_k=src.block_k)
    return TinyDecoder(cfg, device=device, params=params)


def same_weights(model: TinyDecoder,
                 arrays: Mapping[str, np.ndarray]) -> bool:
    """True when every buffer of ``model`` equals ``arrays`` bit for bit."""
    for n in PARAM_NAMES:
        mine = getattr(model, n).detach().cpu()
        theirs = torch.from_numpy(np.ascontiguousarray(arrays[n]))
        if mine.shape != theirs.shape or mine.dtype != theirs.dtype:
            return False
        if not torch.equal(mine.view(torch.int32), theirs.view(torch.int32)):
            return False
    return True
