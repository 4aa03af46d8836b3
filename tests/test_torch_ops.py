"""The port's attention ops against brpc_tpu's, on the CPU.

The same numpy inputs (from seeds) go through brpc_tpu's JAX functions
and through brpc_tpu_torch's plain PyTorch versions, which is the path a
CPU tensor takes. The CUDA kernel itself runs only on a card; chip_smoke.py
holds it against the plain version there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu_torch.butil.device import resolve_device

ref = importlib.import_module("brpc_tpu.ops.flash_attention")
port = importlib.import_module("brpc_tpu_torch.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, shape, sk=None):
    rng = np.random.RandomState(seed)
    kshape = shape if sk is None else shape[:-2] + (sk, shape[-1])
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*kshape).astype(np.float32),
            rng.randn(*kshape).astype(np.float32))


def _port(fn, *arrays, **kw):
    return fn(*[torch.from_numpy(a) for a in arrays], **kw).numpy()


def _ref(fn, *arrays, **kw):
    return np.asarray(fn(*[jnp.asarray(a) for a in arrays], **kw))


# the cases of tests/test_ops.py:24-65, each held against the reference's
# lax backend and its Pallas kernel in interpret mode
CASES = [
    # (seed, shape, causal, block_q, block_k)
    (0, (64, 16), False, 128, 16),
    (0, (64, 16), True, 128, 16),
    (1, (32, 8), False, 16, 16),
    (1, (32, 8), True, 16, 16),
    (2, (2, 4, 32, 8), False, 128, 8),
    (3, (24, 8), False, 128, 7),
    (9, (50, 8), False, 16, 16),
    (9, (50, 8), True, 16, 16),
]


@pytest.mark.parametrize("backend", ["lax", "pallas_interpret"])
@pytest.mark.parametrize("seed,shape,causal,block_q,block_k", CASES)
def test_flash_attention_matches_reference(seed, shape, causal, block_q,
                                           block_k, backend):
    q, k, v = _qkv(seed, shape)
    want = _ref(ref.flash_attention, q, k, v, causal=causal,
                block_q=block_q, block_k=block_k, backend=backend)
    got = _port(port.flash_attention, q, k, v, causal=causal,
                block_q=block_q, block_k=block_k)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("block_k", [8, 16, 64])
def test_causal_sq_ne_sk_matches_flash_lax(block_k):
    """Causal with sq != sk is held against ``_flash_lax``, not against
    ``attention_reference``: the oracle masks with tril(k = sk - sq),
    aligned bottom-right, while the flash recurrence (lax, Pallas and the
    port's kernel alike) aligns top-left, and the two differ by O(1)."""
    q, k, v = _qkv(5, (16, 8), sk=40)
    want = np.asarray(ref._flash_lax(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), 8 ** -0.5, True,
                                     block_k))
    got = _port(port.flash_attention, q, k, v, causal=True, block_k=block_k)
    np.testing.assert_allclose(got, want, **TOL)
    oracle = _port(port.attention_reference, q, k, v, causal=True)
    assert np.abs(oracle - got).max() > 0.1   # the conventions do differ


@pytest.mark.parametrize("q_offset,k_offset", [(0, 0), (24, 0), (8, 16),
                                               (-3, 0)])
def test_plain_offsets_match_flash_lax(q_offset, k_offset):
    """The plain version keeps _flash_lax's q_offset/k_offset (ring
    attention's shard offsets; decode's lengths - 1)."""
    q, k, v = _qkv(6, (12, 16), sk=20)
    want = np.asarray(ref._flash_lax(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, True, 8,
        q_offset=q_offset, k_offset=k_offset))
    got = port._flash_plain(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), 0.3, True, 8,
                            q_offset=q_offset, k_offset=k_offset).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,sk", [((32, 8), None), ((2, 3, 16, 8), None),
                                      ((16, 8), 40), ((40, 8), 16)])
def test_attention_reference_matches(shape, sk, causal):
    q, k, v = _qkv(7, shape, sk=sk)
    want = _ref(ref.attention_reference, q, k, v, causal=causal)
    got = _port(port.attention_reference, q, k, v, causal=causal)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("block_k", [16, 64, 128])
def test_decode_attention_matches_reference(block_k):
    rng = np.random.RandomState(11)
    B, L, d = 4, 40, 16
    k = rng.randn(B, L, d).astype(np.float32)
    v = rng.randn(B, L, d).astype(np.float32)
    q = rng.randn(B, d).astype(np.float32)
    lens = np.array([0, 5, 40, 17])
    want = _ref(ref.decode_attention, q, k, v, lens, block_k=block_k)
    got = port.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(lens),
                                block_k=block_k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert not got[0].any()              # a length-0 slot gives zeros
    # and equals full attention over exactly the valid rows
    for i in (1, 2, 3):
        n = lens[i]
        exact = _port(port.attention_reference, q[i][None], k[i, :n],
                      v[i, :n])
        np.testing.assert_allclose(got[i], exact[0], rtol=1e-4, atol=1e-4)


def test_plain_path_launches_no_kernel():
    q, k, v = _qkv(3, (2, 16, 16))
    port.reset_launches()
    _port(port.flash_attention, q, k, v, causal=True)
    port.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                          torch.from_numpy(v), torch.tensor([3, 16]))
    assert port.kernel_launches() == 0


def test_non_cpu_non_cuda_tensor_raises():
    """A tensor off the CPU never takes the plain version: a device the
    kernel does not serve raises instead of falling back."""
    q = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="no attention path"):
        port.flash_attention(q, q, q)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
