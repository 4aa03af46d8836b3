"""The port's decode split, its dispatch and its tile order, on the CPU.

``flash_decode`` (csrc/flash_decode.cu) splits a long KV cache over several
blocks per sequence and merges their (m, l, o) in a second launch. The
kernel runs only on a card; its arithmetic is repeated step for step by
``_decode_split_plain``, which is held here against brpc_tpu's
``decode_attention`` (JAX on the CPU). ``_plan`` (which kernel a call
launches) and ``_causal_tile_order`` (the order the tile kernels launch
their q tiles) are pure Python and checked directly, the latter also
against the device function it mirrors.
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

NEG_INF = port.NEG_INF
CUDA = torch.device("cuda", 0)


def _cache(seed, b, L, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, d).astype(np.float32),
            rng.randn(b, L, d).astype(np.float32),
            rng.randn(b, L, d).astype(np.float32))


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("seed,b,L,d,lengths", [
    (11, 4, 40, 16, [0, 1, 40, 17]),
    (12, 3, 97, 32, [97, 0, 1]),
])
def test_split_decode_matches_reference(seed, b, L, d, lengths, splits):
    q, k, v = _cache(seed, b, L, d)
    lens = np.array(lengths, dtype=np.int32)
    want = np.asarray(ref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    got = port._decode_split_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(lens), splits).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.isfinite(got).all()
    assert not got[lengths.index(0)].any()     # a length-0 slot gives zeros


@pytest.mark.parametrize("splits", [2, 3, 5, 8])
def test_split_partials_have_empty_chunks(splits):
    """With lengths 0 and 1 every split past the first sees no rows: it
    holds m = NEG_INF, l = 0, o = 0, and the combine gives it weight 0."""
    q, k, v = _cache(13, 3, 40, 16)
    lens = torch.tensor([0, 1, 40], dtype=torch.int32)
    chunk = -(-40 // splits)
    m, l, o = port._decode_partials_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), lens,
        16 ** -0.5, splits, chunk)
    assert (l[:2, 1:] == 0).all() and (m[:2, 1:] == NEG_INF).all()
    assert not o[:2, 1:].any()
    assert (l[2] > 0).all()                    # every chunk of the full row
    out = port._decode_combine_plain(m, l, o, torch.float32)
    assert not out[0].any()
    single = port._decode_split_plain(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), lens, 1)
    np.testing.assert_allclose(out.numpy(), single.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_combine_guards_all_empty_partials():
    """All splits empty: exp(NEG_INF - NEG_INF) = 1 must not reach l."""
    m = torch.full((2, 4), NEG_INF)
    l = torch.zeros((2, 4))
    o = torch.zeros((2, 4, 8))
    out = port._decode_combine_plain(m, l, o, torch.float32)
    assert torch.equal(out, torch.zeros((2, 8)))


@pytest.mark.parametrize("op,dtype,d,sq,want", [
    ("decode", torch.float32, 32, 1, "flash_decode"),
    ("decode", torch.bfloat16, 128, 1, "flash_decode"),
    ("decode", torch.float16, 16, 1, "flash_decode"),
    ("attention", torch.bfloat16, 64, 2048, "flash_attn_fwd_tc"),
    ("attention", torch.float16, 128, 300, "flash_attn_fwd_tc"),
    ("attention", torch.bfloat16, 64, 1, "flash_attn_fwd_tc"),
    ("attention", torch.float32, 64, 2048, "flash_attn_fwd"),
    ("attention", torch.float32, 128, 16, "flash_attn_fwd"),
    ("attention", torch.bfloat16, 32, 16, "flash_attn_fwd"),
    ("attention", torch.float16, 16, 300, "flash_attn_fwd"),
])
def test_plan_routes_cuda_by_dtype_and_head_dim(op, dtype, d, sq, want):
    plan = port._plan(op, CUDA, dtype, d, bh=8, sk=max(sq, 160))
    assert plan.kernel == want


@pytest.mark.parametrize("op", ["decode", "attention"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_routes_cpu_to_plain(op, dtype):
    assert port._plan(op, "cpu", dtype, 64, bh=8, sk=160).kernel == "plain"


def test_plan_refuses_other_devices():
    with pytest.raises(ValueError, match="no attention path"):
        port._plan("decode", "meta", torch.float32, 32)
    with pytest.raises(ValueError, match="unknown op"):
        port._plan("prefill", CUDA, torch.float32, 32)


@pytest.mark.parametrize("bh,L,d,want_splits", [
    (8, 160, 32, 1),          # the serving shape: one launch, no combine
    (4, 4096, 128, None),     # a long cache and few sequences: split
    (1, 127, 64, 1),          # too short to split
    (132, 4096, 64, 1),       # the grid already covers the SMs
    (1, 1 << 20, 64, port.DECODE_MAX_SPLITS),
])
def test_plan_decode_splits(bh, L, d, want_splits):
    plan = port._plan("decode", CUDA, torch.bfloat16, d, bh=bh, sk=L)
    if want_splits is None:
        assert plan.splits > 1
        assert bh * plan.splits >= port.SM_COUNT // 2
    else:
        assert plan.splits == want_splits
    assert plan.chunk * plan.splits >= L
    assert plan.chunk * (plan.splits - 1) < L      # no split starts past L


def _device_tile_order(causal: bool, n: int):
    """The q-tile order of ``causal_tile`` in csrc/tile_order.cuh, from its
    source: its one ``return c ? a : b;`` evaluated for each launch index."""
    text = (build.CSRC / "tile_order.cuh").read_text()
    m = re.search(r"return\s+causal\s*\?\s*([^:;]+):\s*([^;]+);", text)
    assert m, "causal_tile's return expression changed its form"
    expr = m.group(1) if causal else m.group(2)
    return [eval(expr, {}, {"launch_index": i, "n_tiles": n})
            for i in range(n)]


@pytest.mark.parametrize("causal,order", [(False, "forward"),
                                          (True, "heaviest_first")])
def test_plan_tile_order(causal, order):
    """The tile kernels' order is the device function's, from the causal
    flag: the identity without a mask, ``_causal_tile_order`` with one."""
    for n in (1, 2, 7, 16):
        want = (port._causal_tile_order(n) if order == "heaviest_first"
                else list(range(n)))
        assert _device_tile_order(causal, n) == want


@pytest.mark.parametrize("n", [1, 2, 7, 16, 128])
def test_causal_tile_order_heaviest_first(n):
    order = port._causal_tile_order(n)
    assert sorted(order) == list(range(n))
    # k tiles q tile t sees under a top-left causal mask (flash_attn_fwd_tc's
    # 64 x 64 tiles, sq = sk): the count must not grow along the order
    block_q, block_k, sq = 64, 64, 64 * n
    n_k = -(-sq // block_k)
    visible = [min(((t + 1) * block_q + block_k - 1) // block_k, n_k)
               for t in order]
    assert all(a >= b for a, b in zip(visible, visible[1:]))
    assert visible[0] == n_k


def test_every_counted_kernel_has_a_bound_c_entry():
    """The launch counters, the ctypes bindings and the C entry points
    name the same kernels, and each library's source is in the tree."""
    assert set(port.launches) == set(build.LIBRARY_OF)
    for lib, (source, fns) in build.LIBRARIES.items():
        text = (build.CSRC / source).read_text()
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
            assert m, (lib, fn)
            assert len(m.group(1).split(",")) == len(argtypes), fn
    for header in build.HEADERS:
        assert header.exists()


def test_decode_on_cpu_launches_nothing_and_matches_plain_split():
    q, k, v = _cache(14, 4, 40, 16)
    lens = torch.tensor([0, 5, 40, 17])
    port.reset_launches()
    got = port.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), lens)
    assert port.kernel_launches() == 0
    split = port._decode_split_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), lens, 3)
    np.testing.assert_allclose(got.numpy(), split.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_tc_launcher_refuses_what_it_does_not_take():
    """flash_attn_fwd_tc takes fp16/bf16 at head dim 64/128; anything else
    is refused before a launch (``_plan`` never sends it there)."""
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 32)):
        x = torch.zeros((2, 16, d), dtype=dtype)
        with pytest.raises(ValueError, match="flash_attn_fwd_tc takes"):
            port._launch_tile("flash_attn_fwd_tc", x, x, x, 1.0, False)


def test_kernel_inputs_must_be_16_byte_aligned():
    """The kernels read rows with 16-byte loads (flash_decode) or TMA
    (flash_attn_fwd_tc): a view that starts off a 16-byte boundary is
    refused, not read misaligned."""
    base = torch.zeros(2 * 16 + 1)
    q = base[1:].view(2, 16)
    assert q.is_contiguous() and q.data_ptr() % 16
    ok = torch.zeros((2, 16))
    with pytest.raises(ValueError, match="16-byte aligned"):
        port._check_kernel_inputs(q, ok, ok, None)


def _tc_numerics(q, k, v, causal, dtype):
    """flash_attn_fwd_tc's roundings on the CPU, at full-matrix size: fp32
    scores and l, P rounded to ``dtype`` before P V, o rounded to
    ``dtype``."""
    sq, sk = q.shape[-2], k.shape[-2]
    s = torch.einsum("...qd,...kd->...qk", q, k) * q.shape[-1] ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(sq, sk, dtype=torch.bool).tril(), NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    num = torch.einsum("...qk,...kd->...qd", p.to(dtype).float(), v)
    return (num / p.sum(dim=-1, keepdim=True)).to(dtype).float()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rounding_bound_holds_for_tc_numerics_and_rejects_a_dropped_tile(
        dtype, causal):
    """chip_smoke.py's check of the 16-bit kernels: the tc kernel's own
    roundings stay inside ``_rounding_bound``, and dropping the last 64
    keys (one K tile) does not."""
    rng = np.random.RandomState(15)
    q, k, v = (torch.from_numpy(rng.randn(2, n, 64).astype(np.float32))
               .to(dtype).float() for n in (256, 256, 256))
    want = port._flash_plain(q, k, v, 64 ** -0.5, causal, 64)
    bound = port._rounding_bound(
        want, dtype, port._flash_plain(q, k, v.abs(), 64 ** -0.5, causal, 64))
    got = _tc_numerics(q, k, v, causal, dtype)
    assert ((got - want).abs() <= bound).all()
    dropped = port._flash_plain(q, k[:, :-64], v[:, :-64], 64 ** -0.5,
                                causal, 64)
    assert ((dropped - want).abs() > bound).any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rounding_bound_rejects_a_dropped_split(dtype):
    """flash_decode rounds only its output: the plain split decode rounded
    to ``dtype`` passes, the same with one split's partial dropped fails."""
    q, k, v = (torch.from_numpy(x).to(dtype).float()
               for x in _cache(16, 4, 512, 64))
    lens = torch.tensor([0, 1, 512, 300], dtype=torch.int32)
    m, l, o = port._decode_partials_plain(q, k, v, lens, 64 ** -0.5, 4, 128)
    want = port._decode_combine_plain(m, l, o, torch.float32)
    bound = port._rounding_bound(want, dtype)
    assert ((want.to(dtype).float() - want).abs() <= bound).all()
    l[:, 1] = 0.0
    dropped = port._decode_combine_plain(m, l, o, torch.float32)
    assert ((dropped - want).abs() > bound).any()
