"""``flash_attn_fwd``'s launch geometry and its per-head ``q_offset``, on
the CPU.

The kernel runs only on a card (``chip_smoke.py`` holds it against
``_flash_plain`` there). What the CPU can hold: the block rows the
launcher sizes its grid with equal the kernel sources' constants, and the
plain version's per-head tensor ``q_offset`` (the form the kernel takes)
agrees with brpc_tpu's ``_flash_lax`` run head by head with that head's
int offset.
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ref = importlib.import_module("brpc_tpu.ops.flash_attention")
port = importlib.import_module("brpc_tpu_torch.ops.flash_attention")
build = importlib.import_module("brpc_tpu_torch.ops._build")

TOL = dict(atol=2e-5, rtol=2e-5)


def _source_block_q(source: str, **defines) -> int:
    """``constexpr int kBQ = <expr>;`` of a kernel source, evaluated with
    ``defines`` for the names the expression uses."""
    text = (build.CSRC / source).read_text()
    m = re.search(r"constexpr\s+int\s+kBQ\s*=\s*([^;]+);", text)
    assert m, f"{source} lost its kBQ constant"
    return eval(m.group(1), {}, defines)


@pytest.mark.parametrize("kernel,source,defines", [
    ("flash_attn_fwd", "flash_attention.cu", {}),
    ("flash_attn_fwd_tc", "flash_attention_tc.cu", {}),
])
def test_launcher_block_rows_mirror_the_kernel(kernel, source, defines):
    assert port.TILE_BLOCK_Q[kernel] == _source_block_q(source, **defines)


@pytest.mark.parametrize("kernel,dtype,d", [
    ("flash_attn_fwd", torch.float32, 16),
    ("flash_attn_fwd_tc", torch.bfloat16, 64),
])
def test_launcher_refuses_more_q_tiles_than_grid_y_holds(kernel, dtype, d):
    """One q tile more than gridDim.y holds is refused before anything is
    built or allocated (a stride-0 view stands in for the rows)."""
    sq = port.TILE_BLOCK_Q[kernel] * port.GRID_Y_MAX + 1
    q = torch.zeros((1, 1, d), dtype=dtype).expand(1, sq, d)
    k = torch.zeros((1, 8, d), dtype=dtype)
    with pytest.raises(ValueError, match="q tiles"):
        port._launch_tile(kernel, q, k, k, 1.0, False)


def _heads(seed, bh, sq, sk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, sq, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32))


# lengths per head: 0 (offset -1, nothing to attend to at row 0), 1, the
# whole cache, and between
OFFSET_CASES = [
    # (d, sq, sk, lengths)
    (16, 1, 40, [0, 1, 40, 17]),
    (16, 7, 40, [0, 1, 40, 17]),
    (128, 1, 70, [0, 1, 70, 33, 64]),
    (128, 7, 70, [0, 1, 70, 33, 64]),
]


@pytest.mark.parametrize("block_k", [16, 64])
@pytest.mark.parametrize("d,sq,sk,lengths", OFFSET_CASES)
def test_plain_per_head_q_offset_matches_flash_lax(d, sq, sk, lengths,
                                                   block_k):
    """``_flash_plain`` with an int32 [bh] ``q_offset`` (lengths - 1, as
    ``_launch_tile`` passes ``q_offset=lengths, q_offset_add=-1``) equals
    ``_flash_lax`` run on each head with that head's int offset."""
    q, k, v = _heads(21 + d + sq, len(lengths), sq, sk, d)
    scale = d ** -0.5
    offsets = torch.tensor(lengths, dtype=torch.int32) - 1
    got = port._flash_plain(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), scale, True, block_k,
                            q_offset=offsets).numpy()
    for b, off in enumerate(offsets.tolist()):
        want = np.asarray(ref._flash_lax(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]), scale,
            True, block_k, q_offset=off))
        np.testing.assert_allclose(got[b], want, **TOL)
    # a length-0 head sees no key at row 0: zeros, as the reference's
    # l == 0 rows; its row 1 sees key 0 alone, so it is v[0]
    assert not got[0, 0].any()
    if sq > 1:
        np.testing.assert_allclose(got[0, 1], v[0, 0], **TOL)
