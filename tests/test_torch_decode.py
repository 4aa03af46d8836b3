"""The port's decode split, its dispatch and its tile order, on the CPU.

``flash_decode`` (csrc/flash_decode.cu) gives each sequence ``splits``
blocks, of which it uses as many as the valid rows need (the cut of
``decode_rows`` in csrc/decode_rows.cuh), and the last of a sequence's
blocks to finish merges their (m, l, o) inside the same launch. The kernel
runs only on a card; its arithmetic is repeated step for step by
``_decode_split_plain``, which is held here against brpc_tpu's
``decode_attention`` (JAX on the CPU), and ``_decode_rows`` is held to the
header's text. ``_plan`` (which kernel a call launches, and how many blocks
a sequence gets), the decode workspace and ``_causal_tile_order`` (the
order the tile kernels launch their q tiles) are pure Python and checked
directly, the latter also against the device function it mirrors.
"""

import functools
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


@functools.lru_cache(maxsize=None)
def _reference_decode(seed, b, L, d, lengths):
    """brpc_tpu's decode_attention on ``_cache(seed, ...)``, once a case:
    it does not depend on the port's split."""
    q, k, v = _cache(seed, b, L, d)
    return np.asarray(ref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(np.array(lengths, dtype=np.int32))))


@pytest.mark.parametrize("min_rows", [1, 4, port.DECODE_MIN_ROWS])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 64])
@pytest.mark.parametrize("seed,b,L,d,lengths", [
    (11, 4, 40, 16, [0, 1, 40, 17]),
    (12, 3, 97, 32, [97, 0, 1]),
    # every length below splits * min_rows at the larger splits: a
    # sequence uses fewer blocks than the grid gives it
    (13, 4, 256, 16, [5, 33, 0, 200]),
    # every length at the cache's capacity
    (14, 3, 160, 32, [160, 160, 160]),
])
def test_split_decode_matches_reference(seed, b, L, d, lengths, splits,
                                        min_rows):
    q, k, v = _cache(seed, b, L, d)
    lens = np.array(lengths, dtype=np.int32)
    want = _reference_decode(seed, b, L, d, tuple(lengths))
    got = port._decode_split_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(lens), splits,
                                   min_rows=min_rows).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.isfinite(got).all()
    if 0 in lengths:
        assert not got[lengths.index(0)].any()  # a length-0 slot: zeros


@pytest.mark.parametrize("splits", [2, 3, 5, 8])
def test_split_partials_have_empty_chunks(splits):
    """With lengths 0 and 1 every block past the first sees no rows: it
    holds m = NEG_INF, l = 0, o = 0, and the merge gives it weight 0. The
    full row uses every block."""
    q, k, v = _cache(13, 3, 40, 16)
    lens = torch.tensor([0, 1, 40], dtype=torch.int32)
    m, l, o = port._decode_partials_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), lens,
        16 ** -0.5, splits, min_rows=4)
    assert (l[:2, 1:] == 0).all() and (m[:2, 1:] == NEG_INF).all()
    assert not o[:2, 1:].any()
    assert (l[2] > 0).all()                    # every block of the full row
    out = port._decode_combine_plain(m, l, o, torch.float32)
    assert not out[0].any()
    single = port._decode_split_plain(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), lens, 1)
    np.testing.assert_allclose(out.numpy(), single.numpy(), rtol=1e-5,
                               atol=1e-5)


@functools.lru_cache(maxsize=None)
def _decode_rows_steps():
    """The ``const int NAME = EXPR;`` statements of ``decode_rows`` in
    csrc/decode_rows.cuh, in order, compiled as Python (every operand is a
    non-negative int, so C's ``/`` is Python's ``//``)."""
    text = (build.CSRC / "decode_rows.cuh").read_text()
    body = re.search(r"decode_rows\(int len, int splits,\s*int min_rows, "
                     r"int split\) \{(.*?)\n\}", text, re.S)
    assert body, "decode_rows changed its signature"
    steps = re.findall(r"const int (\w+) = ([^;]+);", body.group(1))
    assert [n for n, _ in steps] == ["live", "base", "extra", "first",
                                     "rows"], steps
    assert re.search(r"return \{live, first, rows\};", body.group(1))
    return [(name, compile(expr.replace("/", "//"), name, "eval"))
            for name, expr in steps]


def _device_decode_rows(length, splits, min_rows, split):
    """``decode_rows`` of the header, run from its source."""
    env = {"len": length, "splits": splits, "min_rows": min_rows,
           "split": split}
    for name, code in _decode_rows_steps():
        env[name] = eval(code, {"min": min, "max": max}, env)
    return env["live"], env["first"], env["rows"]


@pytest.mark.parametrize("splits,min_rows", [(1, 32), (2, 32), (66, 32),
                                             (128, 32), (8, 1), (5, 7)])
def test_decode_rows_matches_the_header(splits, min_rows):
    """The Python mirror is the device function, at lengths 0, 1, around
    the multiples of min_rows and up to past splits * min_rows."""
    top = splits * min_rows + 2 * min_rows + 3
    for length in sorted({0, 1, 2, min_rows - 1, min_rows, min_rows + 1,
                          4096, 3000, top, *range(0, top, 13)}):
        for split in range(splits):
            assert port._decode_rows(length, splits, min_rows, split) == \
                _device_decode_rows(length, splits, min_rows, split), \
                (length, split)


def test_one_block_cut_is_the_kernels_shortcut():
    """With one block a sequence the kernel skips decode_rows for
    ``{len > 0, 0, len}``: the same cut."""
    text = (build.CSRC / "flash_decode.cu").read_text()
    assert re.search(r"splits == 1 \? DecodeRows\{len > 0, 0, len\}", text)
    for length in range(0, 600, 7):
        for min_rows in (1, 32, port.DECODE_MIN_ROWS):
            assert port._decode_rows(length, 1, min_rows, 0) == (
                int(length > 0), 0, length)


@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 63, 100, 3000, 4096,
                                    8191])
def test_decode_rows_cut_the_valid_rows_evenly(length):
    """The live blocks cover rows 0 .. length-1 once, in order, no two
    more than one row apart, and no more of them than rows of
    DECODE_MIN_ROWS need; the blocks past them take nothing."""
    for splits in (1, 3, 64, 128):
        cut = [port._decode_rows(length, splits, port.DECODE_MIN_ROWS, j)
               for j in range(splits)]
        live = cut[0][0]
        assert live == min(splits, -(-length // port.DECODE_MIN_ROWS))
        assert all(c[0] == live for c in cut)
        rows = [c[2] for c in cut]
        assert sum(rows) == length and not any(rows[live:])
        assert all(cut[j][1] == sum(rows[:j]) for j in range(live))
        if live:
            assert max(rows[:live]) - min(rows[:live]) <= 1
            assert min(rows[:live]) >= 1
            assert (live - 1) * port.DECODE_MIN_ROWS < length


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
    ("attention", torch.bfloat16, 32, 16, "flash_attn_fwd_tc"),
    ("attention", torch.float16, 16, 300, "flash_attn_fwd_tc"),
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


@pytest.mark.parametrize("bh,L,d,dtype,want_splits", [
    # the serving shape: K and V at capacity take 40 KB, one block reads
    # them faster than a split merges
    (8, 160, 32, torch.float32, 1),
    (1, 127, 64, torch.bfloat16, 1),
    (1, 512, 64, torch.bfloat16, 1),            # 128 KB: just one block
    (1, 513, 64, torch.bfloat16, 5),            # past it: ceil(513 / 128)
    # the long-cache case: about one block an SM over 4 sequences, capped
    # by the cache's rows at DECODE_MIN_ROWS
    (4, 4096, 128, torch.bfloat16, 32),
    (4, 8192, 128, torch.bfloat16, 33),
    (66, 4096, 64, torch.bfloat16, 2),          # two blocks a sequence
    (132, 4096, 64, torch.bfloat16, 1),         # the grid covers the card
    (2, 1000, 32, torch.float32, 8),            # capped by the cache's rows
    (1, 1 << 20, 64, torch.float16, port.DECODE_MAX_SPLITS),
])
def test_plan_decode_splits(bh, L, d, dtype, want_splits):
    plan = port._plan("decode", CUDA, dtype, d, bh=bh, sk=L)
    assert plan.splits == want_splits
    assert 1 <= plan.splits <= port.DECODE_MAX_SPLITS
    if plan.splits > 1:
        assert 2 * L * d * dtype.itemsize > port.DECODE_SPLIT_BYTES
        # no more blocks than a full cache fills at DECODE_MIN_ROWS rows
        assert (plan.splits - 1) * port.DECODE_MIN_ROWS < L
        assert (bh * plan.splits >= port.DECODE_GRID_BLOCKS
                or plan.splits * port.DECODE_MIN_ROWS >= L
                or plan.splits == port.DECODE_MAX_SPLITS)


def test_decode_constants_match_the_source():
    """The plan's cap on blocks a sequence is the kernel's (kMaxSplits),
    and the kernel's merge covers it in whole rounds of loads."""
    text = (build.CSRC / "flash_decode.cu").read_text()
    m = re.search(r"constexpr int kMaxSplits = (\d+);", text)
    assert m and int(m.group(1)) == port.DECODE_MAX_SPLITS
    threads = 32 * int(re.search(r"constexpr int kWarps = (\d+);",
                                 text).group(1))
    for d in port.KERNEL_HEAD_DIMS:
        assert port.DECODE_MAX_SPLITS * d // 4 % threads == 0


class _Stream:
    def __init__(self, handle):
        self.cuda_stream = handle


def test_decode_workspace_is_per_stream_zeroed_and_grows(monkeypatch):
    """One workspace per (device, stream): reused while it holds what a
    call needs, made anew and zeroed when a call needs more, never shared
    by two streams."""
    current = {"s": _Stream(7)}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: current["s"])
    monkeypatch.setattr(port, "_workspaces", {})
    dev = torch.device("cpu")
    part, tickets = port._decode_workspace(dev, 4 * 66 * 130, 4)
    assert part.numel() == 4 * 66 * 130 and tickets.numel() == 4
    assert not part.any() and not tickets.any()
    assert tickets.dtype == torch.int32 and part.dtype == torch.float32
    part.fill_(1.0)
    again = port._decode_workspace(dev, 2 * 66 * 130, 2)
    assert again[0] is part and again[1] is tickets      # no new memset
    grown = port._decode_workspace(dev, 8 * 66 * 130, 8)
    assert grown[0] is not part and grown[0].numel() == 8 * 66 * 130
    assert grown[1].numel() == 8 and not grown[0].any()
    current["s"] = _Stream(9)
    other = port._decode_workspace(dev, 8, 1)
    assert other[0] is not grown[0] and other[1] is not grown[1]
    current["s"] = _Stream(7)
    assert port._decode_workspace(dev, 8, 1)[0] is grown[0]


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
    # k tiles q tile t sees under a top-left causal mask (64 x 64 tiles,
    # sq = sk): the count must not grow along the order
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
    """flash_attn_fwd_tc takes fp16/bf16 at head dim 16/32/64/128; fp32,
    and a head dim neither tile kernel takes, are refused before a launch
    (``_plan`` never sends them there)."""
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 48)):
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


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rounding_bound_holds_for_tc_numerics_and_rejects_a_dropped_tile(
        dtype, causal, d):
    """chip_smoke.py's check of the 16-bit kernels: the tc kernel's own
    roundings stay inside ``_rounding_bound``, at every head dim it takes
    below 128, and dropping the last 64 keys does not."""
    rng = np.random.RandomState(15)
    q, k, v = (torch.from_numpy(rng.randn(2, n, d).astype(np.float32))
               .to(dtype).float() for n in (256, 256, 256))
    scale = d ** -0.5
    want = port._flash_plain(q, k, v, scale, causal, 64)
    bound = port._rounding_bound(
        want, dtype, port._flash_plain(q, k, v.abs(), scale, causal, 64))
    got = _tc_numerics(q, k, v, causal, dtype)
    assert ((got - want).abs() <= bound).all()
    dropped = port._flash_plain(q, k[:, :-64], v[:, :-64], scale, causal,
                                64)
    assert ((dropped - want).abs() > bound).any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rounding_bound_rejects_a_dropped_split(dtype):
    """flash_decode rounds only its output: the plain split decode rounded
    to ``dtype`` passes, the same with one block's partial dropped fails."""
    q, k, v = (torch.from_numpy(x).to(dtype).float()
               for x in _cache(16, 4, 512, 64))
    lens = torch.tensor([0, 1, 512, 300], dtype=torch.int32)
    m, l, o = port._decode_partials_plain(q, k, v, lens, 64 ** -0.5, 4,
                                          min_rows=128)
    want = port._decode_combine_plain(m, l, o, torch.float32)
    bound = port._rounding_bound(want, dtype)
    assert ((want.to(dtype).float() - want).abs() <= bound).all()
    l[:, 1] = 0.0
    dropped = port._decode_combine_plain(m, l, o, torch.float32)
    assert ((dropped - want).abs() > bound).any()
