"""The port's mesh collectives and sequence-parallel attention against
brpc_tpu's, on the CPU.

Every test of tests/test_parallel.py and test_ops.py's
``TestRingAttention``/``TestUlyssesAttention`` runs on brpc_tpu's
8-device CPU mesh and on the port's ``make_rpc_mesh(devices=["cpu"] *
8)``, with the same numpy inputs from a seed; the port's output must
equal brpc_tpu's (and brpc_tpu's its own expected value) within the
reference's tolerance, 2e-5. The port keeps no sharded output
(``test_output_stays_sequence_sharded`` has no counterpart: its outputs
are global tensors on the mesh's first device), so that case checks the
output's device instead. Then the single-process bring-up:
``init_pod`` does nothing, ``pod_endpoints`` gives one ``cudad://``
endpoint, ``pod_mesh`` and ``make_rpc_mesh`` without devices raise here
(no card), and a bad grid raises as brpc_tpu's does.

The cases run inside one collected test (``_run_cases``), so every other
test file keeps its place in pytest-xdist's ``--dist loadfile`` queue
(see test_torch_iobuf.py).
"""

import traceback

import jax.numpy as jnp
import numpy as np
import torch

from brpc_tpu import parallel as ref
from brpc_tpu.ops import attention_reference as ref_attention
from brpc_tpu.ops import ring_attention as ref_ring_attention
from brpc_tpu.ops import ulysses_attention as ref_ulysses_attention
from brpc_tpu_torch import parallel as port
from brpc_tpu_torch.ops import ring_attention, ulysses_attention
from brpc_tpu_torch.parallel import distributed

TOL = dict(atol=2e-5, rtol=2e-5)
CPU8 = ["cpu"] * 8


def _run_cases(cases):
    """Run every (name, fn, args) case in order; every failure is
    reported, each with its traceback."""
    failed = []
    for name, fn, args in cases:
        try:
            fn(*args)
        except Exception:
            failed.append(f"--- {name}\n{traceback.format_exc()}")
    assert not failed, "\n".join(failed)


def _meshes(n_replicas=1, n_shards=8):
    return (port.make_rpc_mesh(n_replicas, n_shards, devices=CPU8),
            ref.make_rpc_mesh(n_replicas=n_replicas, n_shards=n_shards))


def _same(port_out, ref_out, want=None):
    """The port's output equals brpc_tpu's, and both the expected value."""
    assert isinstance(port_out, torch.Tensor)
    got, ref_got = port_out.numpy(), np.asarray(ref_out)
    assert got.shape == ref_got.shape, (got.shape, ref_got.shape)
    np.testing.assert_allclose(got, ref_got, **TOL)
    if want is not None:
        np.testing.assert_allclose(ref_got, want, **TOL)
        np.testing.assert_allclose(got, want, **TOL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ test_parallel.py

def _scatter_gather_concat():
    pm, rm = _meshes()
    x = np.arange(16.0, dtype=np.float32)
    _same(port.CollectiveChannel(pm, merge="concat").call(
              lambda s: s * 2, _t(x)),
          ref.CollectiveChannel(rm, merge="concat").call(
              lambda s: s * 2, jnp.asarray(x)), x * 2)


def _allreduce_sum(seed):
    pm, rm = _meshes()
    x = np.random.RandomState(seed).randn(8, 4).astype(np.float32)
    _same(port.CollectiveChannel(pm).call(lambda s: s.sum(0), _t(x),
                                          merge="sum"),
          ref.CollectiveChannel(rm).call(lambda s: s.sum(axis=0),
                                         jnp.asarray(x), merge="sum"),
          x.sum(0))


def _merge_ops(seed):
    pm, rm = _meshes()
    x = np.random.RandomState(seed).randn(8).astype(np.float32)
    for op, want in (("sum", x.sum()), ("max", x.max()), ("min", x.min()),
                     ("mean", x.mean())):
        _same(port.CollectiveChannel(pm).all_reduce(_t(x), op),
              ref.CollectiveChannel(rm).all_reduce(jnp.asarray(x), op),
              np.array([want]))
    for merge in ("stack", "none"):   # both P(SHARD) in the reference
        _same(port.CollectiveChannel(pm, merge).call(lambda s: s + 1, _t(x)),
              ref.CollectiveChannel(rm, merge).call(lambda s: s + 1,
                                                    jnp.asarray(x)), x + 1)


def _all_gather(seed):
    pm, rm = _meshes()
    x = np.random.RandomState(seed).randn(8, 3).astype(np.float32)
    _same(port.CollectiveChannel(pm).all_gather(_t(x)),
          ref.CollectiveChannel(rm).all_gather(jnp.asarray(x)), x)


def _reduce_scatter(seed):
    pm, rm = _meshes()
    x = np.random.RandomState(seed).randn(16, 2).astype(np.float32)
    _same(port.CollectiveChannel(pm).reduce_scatter(_t(x)),
          ref.CollectiveChannel(rm).reduce_scatter(jnp.asarray(x)), x * 8)


def _matmul_service_sharded(seed):
    pm, rm = _meshes()
    rng = np.random.RandomState(seed)
    w = rng.randn(16, 16).astype(np.float32)
    x = rng.randn(8, 16).astype(np.float32)
    tw, jw = _t(w), jnp.asarray(w)
    _same(port.CollectiveChannel(pm, "concat").call(lambda s: s @ tw, _t(x)),
          ref.CollectiveChannel(rm, "concat").call(lambda s: s @ jw,
                                                   jnp.asarray(x)), x @ w)


def _replicated_call():
    pm, rm = _meshes(2, 4)
    _same(port.replicated_call(pm, lambda x: x + 1, torch.zeros(4)),
          ref.replicated_call(rm, lambda x: x + 1, jnp.zeros((4,))),
          np.ones(4))


def _ring_shift():
    pm, rm = _meshes()
    x = np.arange(8.0, dtype=np.float32)
    _same(port.ring_shift(pm, _t(x)), ref.ring_shift(rm, jnp.asarray(x)),
          np.roll(x, 1))
    y = np.arange(16.0, dtype=np.float32)
    _same(port.ring_shift(pm, _t(y), step=3),
          ref.ring_shift(rm, jnp.asarray(y), step=3), np.roll(y, 6))


def _ring_allreduce(seed):
    pm, rm = _meshes()
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    _same(port.ring_allreduce(pm, _t(x)),
          ref.ring_allreduce(rm, jnp.asarray(x)), x * 8)
    x = np.random.RandomState(seed).randn(8, 5).astype(np.float32)
    _same(port.ring_allreduce(pm, _t(x)),
          ref.ring_allreduce(rm, jnp.asarray(x)), x * 8)
    try:
        port.ring_allreduce(pm, torch.zeros(4, 4))
    except ValueError:
        return
    raise AssertionError("a [4, chunk] input on 8 shards must raise")


def _ring_scan():
    pm, rm = _meshes()
    x = np.arange(8.0, dtype=np.float32)
    _same(port.ring_scan(pm, _t(x), combine=lambda c, b: c + b),
          ref.ring_scan(rm, jnp.asarray(x), combine=lambda c, b: c + b),
          np.full((8,), 28.0))
    _same(port.ring_scan(pm, _t(x), combine=lambda c, b: c * 0 + b,
                         init=_t(np.zeros(1, np.float32))),
          ref.ring_scan(rm, jnp.asarray(x), combine=lambda c, b: c * 0 + b,
                        init=jnp.zeros(1)), np.roll(x, 7))


def _ulysses_reshard():
    pm, rm = _meshes()
    x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    out = port.all_to_all_reshard(pm, _t(x), concat_axis=0, split_axis=1)
    _same(out, ref.all_to_all_reshard(rm, jnp.asarray(x), concat_axis=0,
                                      split_axis=1), x)
    _same(port.all_to_all_reshard(pm, out, concat_axis=1, split_axis=0),
          ref.all_to_all_reshard(rm, jnp.asarray(x), concat_axis=1,
                                 split_axis=0), x)


def _mesh_shapes():
    m = port.make_rpc_mesh(n_replicas=2, n_shards=4, devices=CPU8)
    assert m.shape == ref.make_rpc_mesh(n_replicas=2, n_shards=4).shape \
        == {"replica": 2, "shard": 4}
    m = port.make_rpc_mesh(devices=CPU8)
    assert m.shape == dict(ref.make_rpc_mesh().shape) \
        == {"replica": 1, "shard": 8}
    assert port.endpoint_for_coords(m, 0, 5) == torch.device("cpu")
    spec = port.shard_spec(None, port.SHARD_AXIS)
    assert tuple(spec) == tuple(ref.shard_spec(None, ref.SHARD_AXIS))
    pieces = port.sharding(port.make_rpc_mesh(2, 4, devices=CPU8),
                           port.SHARD_AXIS).place(torch.arange(8.0))
    assert [[p.tolist() for p in row] for row in pieces] == \
        [[[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]] * 2
    for kind, make in (("port", lambda: port.make_rpc_mesh(3, 3, CPU8)),
                       ("ref", lambda: ref.make_rpc_mesh(3, 3))):
        try:
            make()
        except ValueError:
            continue
        raise AssertionError(f"{kind}: a 3x3 grid over 8 devices must raise")


# -------------------------------------------- test_ops.py: ring, Ulysses

def _qkv(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _ring_matches_reference(seed, causal):
    pm, rm = _meshes()
    q, k, v = _qkv(seed, (64, 16))
    want = np.asarray(ref_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=causal))
    _same(ring_attention(pm, *map(_t, (q, k, v)), causal=causal),
          ref_ring_attention(rm, *map(jnp.asarray, (q, k, v)),
                             causal=causal), want)


def _ring_batched(seed):
    pm, rm = _meshes()
    for shape in ((3, 16, 8), (2, 3, 32, 8)):
        q, k, v = _qkv(seed, shape)
        want = np.asarray(ref_attention(*map(jnp.asarray, (q, k, v))))
        _same(ring_attention(pm, *map(_t, (q, k, v))),
              ref_ring_attention(rm, *map(jnp.asarray, (q, k, v))), want)
    q, k, v = _qkv(seed, (2, 32, 8))
    _same(ring_attention(pm, *map(_t, (q, k, v)), causal=True),
          ref_ring_attention(rm, *map(jnp.asarray, (q, k, v)), causal=True),
          np.asarray(ref_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=True)))


def _ring_output_device(seed):
    """The reference leaves the output spread over the ring; the port's
    is a global tensor on the mesh's first device."""
    pm, _ = _meshes()
    q, k, v = _qkv(seed, (64, 8))
    out = ring_attention(pm, *map(_t, (q, k, v)))
    assert out.device == pm.first_device and out.shape == (64, 8)


def _ulysses_matches_reference(seed, causal):
    pm, rm = _meshes()
    q, k, v = _qkv(seed, (8, 64, 8))
    want = np.asarray(ref_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=causal))
    _same(ulysses_attention(pm, *map(_t, (q, k, v)), causal=causal),
          ref_ulysses_attention(rm, *map(jnp.asarray, (q, k, v)),
                                causal=causal), want)


def _ulysses_rejects_indivisible(seed):
    pm, rm = _meshes()
    q, k, v = _qkv(seed, (4, 64, 8))
    for fn, args in ((ulysses_attention, (pm, *map(_t, (q, k, v)))),
                     (ref_ulysses_attention,
                      (rm, *map(jnp.asarray, (q, k, v))))):
        try:
            fn(*args)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__module__}: 4 heads on 8 shards must "
                             f"raise")


# ------------------------------------------------- single-process bring-up

def _distributed_single_process():
    from brpc_tpu.parallel.distributed import pod_endpoints as ref_endpoints
    distributed.init_pod()
    assert not torch.distributed.is_initialized()
    eps = distributed.pod_endpoints(base_port=9100)
    ref_eps = ref_endpoints(base_port=9100)
    assert len(eps) == len(ref_eps) == 1
    assert eps[0] == "cudad://127.0.0.1:9100"
    assert ref_eps[0] == "tpud://127.0.0.1:9100"
    assert distributed.pod_endpoints(hosts=["a"]) == ["cudad://a:8750"]
    for fn in (distributed.pod_mesh, port.make_rpc_mesh):
        try:
            fn()                # no card here: the default devices fail
        except RuntimeError:
            continue
        raise AssertionError(f"{fn.__name__} without CUDA must raise")


CASES = [
    ("scatter_gather_concat", _scatter_gather_concat, ()),
    ("allreduce_sum", _allreduce_sum, (301,)),
    ("merge_ops", _merge_ops, (302,)),
    ("all_gather", _all_gather, (303,)),
    ("reduce_scatter", _reduce_scatter, (304,)),
    ("matmul_service_sharded", _matmul_service_sharded, (305,)),
    ("replicated_call", _replicated_call, ()),
    ("ring_shift", _ring_shift, ()),
    ("ring_allreduce", _ring_allreduce, (306,)),
    ("ring_scan", _ring_scan, ()),
    ("ulysses_reshard", _ulysses_reshard, ()),
    ("mesh shapes", _mesh_shapes, ()),
    ("ring attention", _ring_matches_reference, (307, False)),
    ("ring attention causal", _ring_matches_reference, (308, True)),
    ("ring attention batched", _ring_batched, (309,)),
    ("ring attention output device", _ring_output_device, (310,)),
    ("ulysses attention", _ulysses_matches_reference, (311, False)),
    ("ulysses attention causal", _ulysses_matches_reference, (312, True)),
    ("ulysses rejects indivisible", _ulysses_rejects_indivisible, (313,)),
    ("single-process bring-up", _distributed_single_process, ()),
]


def test_parallel_and_sequence_attention():
    _run_cases(CASES)
