"""The port's serving lane against brpc_tpu's, on the CPU.

Weights carry over bit for bit; ``decode_step``, ``generate`` and the
continuous batcher give the reference's tokens; the unary Generate path
works end to end over TCP, port to port and across the wire in both
directions with brpc_tpu's Channel and Server; its decode steps run on
the server's fiber workers, through the engine's WorkerModule hook.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from brpc_tpu.rpc import Channel as RefChannel
from brpc_tpu.rpc import Server as RefServer
from brpc_tpu.rpc import ServerOptions as RefServerOptions
from brpc_tpu.rpc.controller import Controller as RefController
from brpc_tpu.serving import TinyDecoder as RefDecoder
from brpc_tpu.serving import TinyDecoderConfig as RefConfig
from brpc_tpu.serving import add_generate_service as ref_add_generate_service
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller, Server
from brpc_tpu_torch.rpc import errno_codes as berr
from brpc_tpu_torch.serving import (CANCELED, COMPLETED, DEFAULT_SEED,
                                    EVICTED, ContinuousBatcher, GenRequest,
                                    RequestTooLong, TinyDecoder,
                                    TinyDecoderConfig, add_generate_service)
from brpc_tpu_torch.serving.convert import (from_jax_decoder,
                                            params_from_numpy, same_weights)
from brpc_tpu_torch.serving.model import PARAM_NAMES, init_params
from brpc_tpu_torch.serving.service import _parse_request

PROMPTS = [b"hello world", b"a", b"the second prompt", b"\x00\xff bytes",
           b"determinism"]


@pytest.fixture(scope="module")
def ref_model():
    return RefDecoder(RefConfig(cache_len=96))


@pytest.fixture(scope="module")
def model():
    return TinyDecoder(TinyDecoderConfig(cache_len=96), device="cpu")


def _ref_arrays(m):
    return {n: getattr(m, n) for n in PARAM_NAMES}


def _deadline_cntl(ms: float) -> Controller:
    cntl = Controller()
    cntl.set_deadline(ms)
    return cntl


def _drain(batcher, limit=500):
    steps = 0
    while batcher.has_work() and steps < limit:
        batcher.step()
        steps += 1
    return steps


# ---------------------------------------------------------------- weights

@pytest.mark.parametrize("seed", [DEFAULT_SEED, 99])
@pytest.mark.parametrize("cache_len", [96, 160])
def test_weights_carry_over_bit_for_bit(seed, cache_len):
    ref = RefDecoder(RefConfig(cache_len=cache_len, seed=seed))
    mine = TinyDecoder(TinyDecoderConfig(cache_len=cache_len, seed=seed),
                       device="cpu")
    assert same_weights(mine, _ref_arrays(ref))
    assert same_weights(from_jax_decoder(ref, device="cpu"),
                        _ref_arrays(ref))
    for n, arr in init_params(mine.config).items():
        assert arr.tobytes() == getattr(ref, n).tobytes()


def test_same_weights_notices_one_bit():
    ref = RefDecoder(RefConfig(cache_len=96))
    arrays = {n: a.copy() for n, a in _ref_arrays(ref).items()}
    mine = from_jax_decoder(ref, device="cpu")
    arrays["wo"].view(np.int32)[3, 4] ^= 1
    assert not same_weights(mine, arrays)
    with pytest.raises(KeyError):
        params_from_numpy({"emb": arrays["emb"]})
    bad = dict(arrays, wq=arrays["wq"][:, :4])
    with pytest.raises(ValueError):
        params_from_numpy(bad)


# ------------------------------------------------------------------ model

def test_prefill_matches_reference(ref_model, model):
    """The reference's prefill is numpy fp32, the port's torch: the last
    bits may differ, which is why the tolerance."""
    for p in PROMPTS:
        kr, vr, hr = ref_model.prefill(list(p))
        k, v, h = model.prefill(list(p))
        np.testing.assert_allclose(k.numpy(), kr, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), vr, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h.numpy(), hr, rtol=1e-5, atol=1e-5)


def _slot_state(m, prompts, batch, cache_len, dim):
    """A slot batch holding ``prompts`` in its first slots, idle rest."""
    k = np.zeros((batch, cache_len, dim), np.float32)
    v = np.zeros_like(k)
    h = np.zeros((batch, dim), np.float32)
    lens = np.ones((batch,), np.int64)
    for i, p in enumerate(prompts):
        kp, vp, hl = m.prefill(list(p))
        k[i, :len(p)], v[i, :len(p)], h[i] = kp, vp, hl
        lens[i] = len(p)
    return k, v, h, lens


def test_decode_step_matches_reference(ref_model, model):
    cfg = ref_model.config
    k, v, h, lens = _slot_state(ref_model, PROMPTS[:3] + [b"x" * 95], 6,
                                cfg.cache_len, cfg.dim)
    lens[4] = 0                           # a length-0 slot, too
    want = ref_model.decode_step(k, v, h, lens)
    got = model.decode_step(torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(h),
                            torch.from_numpy(lens.astype(np.int32)))
    assert got[0].tolist() == want[0].tolist()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [DEFAULT_SEED, 99])
def test_generate_matches_reference(seed):
    ref = RefDecoder(RefConfig(cache_len=96, seed=seed))
    mine = TinyDecoder(TinyDecoderConfig(cache_len=96, seed=seed),
                       device="cpu")
    for p in PROMPTS:
        assert mine.generate(list(p), 24) == ref.generate(list(p), 24)
    # the slot capacity stops generation where the reference stops
    long = list(b"z" * 90)
    assert mine.generate(long, 20) == ref.generate(long, 20)
    assert len(mine.generate(long, 20)) == 6


# ---------------------------------------------------------------- batcher

class TestBatcherScheduling:
    """The cases of tests/test_serving.py's TestBatcherScheduling, on the
    port's batcher with its device-resident (here: CPU) KV slots."""

    def test_mid_flight_admission(self, model):
        b = ContinuousBatcher(model, max_batch=4, max_waiting=8)
        order = []
        fin = {}

        def track(tag):
            def on_token(req, tok):
                order.append(tag)
            return on_token

        rA = GenRequest(list(b"aaaa"), 30, on_token=track("A"),
                        on_finish=lambda r, s: fin.setdefault("A", s))
        assert b.submit(rA)
        for _ in range(5):
            b.step()
        assert order.count("A") == 5 and b.running_count() == 1
        rB = GenRequest(list(b"bbbb"), 10, on_token=track("B"),
                        on_finish=lambda r, s: fin.setdefault("B", s))
        assert b.submit(rB)
        b.step()
        assert order.count("B") == 1 and order.count("A") == 6
        assert b.running_count() == 2
        _drain(b)
        assert fin == {"A": COMPLETED, "B": COMPLETED}
        assert b.batch_hist[1] > 0 and b.batch_hist[2] > 0

    def test_deadline_eviction_frees_kv_and_sets_timeout(self, model):
        b = ContinuousBatcher(model, max_batch=2, max_waiting=8)
        fin = {}
        victim = GenRequest(list(b"victim"), 80, cntl=_deadline_cntl(60),
                            on_finish=lambda r, s: fin.setdefault("v", s))
        keeper = GenRequest(list(b"keeper"), 80,
                            on_finish=lambda r, s: fin.setdefault("k", s))
        assert b.submit(victim) and b.submit(keeper)
        deadline = time.monotonic() + 5
        while "v" not in fin and time.monotonic() < deadline:
            b.step()
            time.sleep(0.002)     # the CPU step is fast: let the budget run
        assert fin["v"] == EVICTED
        assert victim.error_code == berr.ERPCTIMEDOUT
        assert 0 < victim.ntokens < 80
        assert victim.slot is None
        late = GenRequest(list(b"late"), 5,
                          on_finish=lambda r, s: fin.setdefault("l", s))
        assert b.submit(late)
        _drain(b)
        assert fin["k"] == COMPLETED and fin["l"] == COMPLETED
        assert b.evicted == 1 and b.kv_occupancy() == 0.0

    def test_expired_before_admission_evicts_from_queue(self, model):
        b = ContinuousBatcher(model, max_batch=1, max_waiting=8)
        fin = {}
        hog = GenRequest(list(b"hog"), 20,
                         on_finish=lambda r, s: fin.setdefault("h", s))
        dead = GenRequest(list(b"dead"), 20, cntl=_deadline_cntl(1e-6),
                          on_finish=lambda r, s: fin.setdefault("d", s))
        assert b.submit(hog) and b.submit(dead)
        b.step()
        _drain(b)
        assert fin["d"] == EVICTED and dead.error_code == berr.ERPCTIMEDOUT
        assert dead.ntokens == 0
        assert fin["h"] == COMPLETED

    def test_shed_when_wait_queue_full(self, model):
        b = ContinuousBatcher(model, max_batch=1, max_waiting=2)
        reqs = [GenRequest(list(b"x"), 5) for _ in range(4)]
        assert b.submit(reqs[0]) and b.submit(reqs[1])
        assert not b.submit(reqs[2])
        assert reqs[2].state == "shed"
        assert reqs[2].error_code == berr.ELIMIT
        assert b.shed == 1
        _drain(b)
        assert b.submit(reqs[3])
        _drain(b)
        assert reqs[3].state == COMPLETED

    def test_retirement_order_independence(self, model, ref_model):
        prompts = [b"first prompt", b"the second", b"prompt iii"]
        budgets = [18, 7, 12]
        oracle = [ref_model.generate(list(p), n)
                  for p, n in zip(prompts, budgets)]
        b = ContinuousBatcher(model, max_batch=2, max_waiting=8)
        fin = {}
        reqs = [GenRequest(list(p), n,
                           on_finish=lambda r, s, i=i: fin.setdefault(i, s))
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        assert b.submit(reqs[0])
        b.step(); b.step(); b.step()
        assert b.submit(reqs[1]) and b.submit(reqs[2])
        _drain(b)
        assert fin == {0: COMPLETED, 1: COMPLETED, 2: COMPLETED}
        for req, want in zip(reqs, oracle):
            assert req.tokens == want

    def test_prompt_too_long_rejected(self, model):
        b = ContinuousBatcher(model, max_batch=1)
        with pytest.raises(RequestTooLong):
            b.submit(GenRequest(list(range(96)), 5))

    def test_cancel_frees_slot(self, model):
        b = ContinuousBatcher(model, max_batch=1, max_waiting=4)
        fin = {}
        r = GenRequest(list(b"gone"), 50,
                       on_finish=lambda r_, s: fin.setdefault("g", s))
        assert b.submit(r)
        b.step(); b.step()
        b.cancel(r)
        b.step()
        assert fin["g"] == CANCELED and b.running_count() == 0
        assert b.canceled == 1

    def test_stop_retires_everything(self, model):
        b = ContinuousBatcher(model, max_batch=1, max_waiting=4)
        fin = []
        reqs = [GenRequest(list(b"s%d" % i), 40,
                           on_finish=lambda r, s: fin.append(s))
                for i in range(3)]
        for r in reqs:
            assert b.submit(r)
        b.step()
        assert len(b.stop()) == 3
        assert fin == [CANCELED] * 3 and not b.has_work()
        assert not b.submit(GenRequest(list(b"after"), 3))

    @pytest.mark.parametrize("when", ["before_prefill", "during_prefill"])
    def test_stop_during_a_step_spares_the_step(self, model, when):
        """A server stopped while a step is outside the batcher's lock
        retires the step's admissions; the step then finishes without
        writing them, and leaves the retired slots idle-safe."""
        b = ContinuousBatcher(model, max_batch=2, max_waiting=4)
        fin = []
        reqs = [GenRequest(list(b"race%d" % i), 20,
                           on_finish=lambda r, s: fin.append(s))
                for i in range(2)]
        for r in reqs:
            assert b.submit(r)
        calls = []
        if when == "during_prefill":
            class Stopping:
                config, device = model.config, model.device

                def prefill(self, tokens):
                    calls.append(len(tokens))
                    b.stop()
                    return model.prefill(tokens)

                def decode_step(self, *a):
                    return model.decode_step(*a)
            b.model = Stopping()
        else:
            lock = b._lock

            class StopOnRelease:
                # the step's admission releases the lock, then stop() runs
                def __enter__(self):
                    return lock.__enter__()

                def __exit__(self, *exc):
                    lock.__exit__(*exc)
                    if not b.stopped and b.running_count():
                        b.stop()
            b._lock = StopOnRelease()
        assert b.step()
        assert fin == [CANCELED, CANCELED]
        assert all(r.slot is None for r in reqs)
        assert b._lens == [1, 1] and not b.has_work()
        assert len(calls) == (1 if when == "during_prefill" else 0)

    def test_full_batch_equals_oracle(self, model, ref_model):
        """Eight slots at once, staggered budgets, each sequence equal to
        the reference's single-sequence oracle."""
        prompts = [b"p%d %s" % (i, b"x" * i) for i in range(11)]
        budgets = [5 + 3 * i for i in range(11)]
        b = ContinuousBatcher(model, max_batch=8, max_waiting=16)
        reqs = [GenRequest(list(p), n) for p, n in zip(prompts, budgets)]
        for r in reqs:
            assert b.submit(r)
        _drain(b)
        assert b.batch_hist[8] > 0
        for r, p, n in zip(reqs, prompts, budgets):
            assert r.state == COMPLETED
            assert r.tokens == ref_model.generate(list(p), n)


def test_parse_request():
    assert _parse_request(b'{"prompt": "ab", "max_tokens": 3}') == \
        ([97, 98], 3, None)
    assert _parse_request(b"raw") == ([114, 97, 119], 32, None)
    assert _parse_request(b'{"prompt": "a", "stop_token": 5}')[2] == 5
    for bad in (b"", b"{", b'{"prompt": ""}', b'{"prompt": "a", '
                b'"max_tokens": 0}'):
        with pytest.raises(ValueError):
            _parse_request(bad)


# ------------------------------------------------------------- end to end

def _gen_body(prompt: bytes, max_tokens: int) -> bytes:
    return json.dumps({"prompt": prompt.decode("latin-1"),
                       "max_tokens": max_tokens}).encode()


def _latin1_tokens(prompt: bytes):
    # the request JSON carries the prompt as text; its UTF-8 bytes are
    # the tokens the server decodes
    return list(prompt.decode("latin-1").encode("utf-8"))


@pytest.fixture
def port_server():
    servers = []

    def start(**kw):
        server = Server()
        gs = add_generate_service(server, device="cpu", **kw)
        ep = server.start("tcp://127.0.0.1:0")
        servers.append(server)
        return server, gs, ep

    yield start
    for s in servers:
        s.stop()
        s.join(5)


class TestUnaryE2E:
    def test_concurrent_unary_calls_equal_oracle(self, port_server):
        server, gs, ep = port_server()
        oracle = RefDecoder(RefConfig(cache_len=160))
        results = {}
        errors = []

        def client(t):
            ch = Channel(str(ep), ChannelOptions(timeout_ms=30000))
            try:
                for j in range(2):
                    p = b"client %d call %d" % (t, j)
                    c = ch.call_sync("GenerateService", "Generate",
                                     _gen_body(p, 16))
                    if c.failed():
                        errors.append((p, c.error_code, c.error_text))
                    else:
                        results[p] = json.loads(c.response)
            finally:
                ch.close()

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not errors and len(results) == 12
        for p, doc in results.items():
            assert doc["status"] == "completed" and doc["n"] == 16
            assert doc["tokens"] == oracle.generate(list(p), 16)
        stats = gs._payload()
        assert stats["completed"] == 12 and stats["ttft_ms"]["count"] == 12
        assert gs.engine.steps > 0 and gs.engine.warmup_steps == 1

    def test_decode_runs_on_fiber_workers(self, port_server):
        """The reference's check that decode ran on fiber workers
        (tests/test_serving.py:280-281), and more: every step ran on a
        worker of the server's control, and no decode thread or handler
        pool exists."""
        server, gs, ep = port_server()
        ch = Channel(str(ep), ChannelOptions(timeout_ms=30000))
        try:
            for p in PROMPTS[:3]:
                c = ch.call_sync("GenerateService", "Generate",
                                 _gen_body(p, 8))
                assert not c.failed(), c.error_text
        finally:
            ch.close()
        assert gs.engine.steps > 0
        assert sum(gs.batcher.steps_by_group.values()) \
            == gs.batcher.decode_steps > 0
        assert gs._payload()["steps_by_group"] == dict(
            sorted(gs.batcher.steps_by_group.items()))
        names = {t.ident: t.name for t in threading.enumerate()}
        prefix = f"{server.control.name}_w"
        assert all(names.get(tid, "").startswith(prefix)
                   for tid in gs.engine.threads_seen), gs.engine.threads_seen
        assert gs.engine.snapshot()["worker_threads_used"] \
            == len(gs.engine.threads_seen) >= 1
        names = [t.name for t in threading.enumerate()]
        assert "serving-decode" not in names
        assert not any(n.startswith("rpc-handler") for n in names)

    def test_errors_and_eviction(self, port_server):
        server, gs, ep = port_server(cache_len=4096)
        ch = Channel(str(ep), ChannelOptions(timeout_ms=20000))
        try:
            c = ch.call_sync("GenerateService", "Nope", b"")
            assert c.error_code == berr.ENOMETHOD
            c = ch.call_sync("NoService", "Generate", b"")
            assert c.error_code == berr.ENOSERVICE
            c = ch.call_sync("GenerateService", "Generate", b"{bad")
            assert c.error_code == berr.EREQUEST
            c = ch.call_sync("GenerateService", "Generate",
                             b"y" * 5000)
            assert c.error_code == berr.EREQUEST and "fit" in c.error_text
            # a unary call whose budget dies mid-generation fails with
            # ERPCTIMEDOUT (the server's eviction or the client's own
            # deadline: the same verdict)
            c = ch.call_sync("GenerateService", "Generate",
                             _gen_body(b"long", 4000),
                             cntl=Controller(timeout_ms=300))
            assert c.failed() and c.error_code == berr.ERPCTIMEDOUT
            # the engine stays healthy
            c = ch.call_sync("GenerateService", "Generate", b"after")
            assert not c.failed(), c.error_text
            assert json.loads(c.response)["n"] == 32    # default budget
        finally:
            ch.close()

    def test_shed_when_engine_full(self, port_server):
        server, gs, ep = port_server(max_batch=1, max_waiting=1,
                                     cache_len=4096)
        outcomes = []

        def hog():
            ch = Channel(str(ep), ChannelOptions(timeout_ms=3000,
                                                 share_connections=False))
            try:
                outcomes.append(ch.call_sync(
                    "GenerateService", "Generate",
                    _gen_body(b"hog", 4000)).error_code)
            finally:
                ch.close()

        def wait_for(cond):
            deadline = time.monotonic() + 5
            while not cond() and time.monotonic() < deadline:
                time.sleep(0.005)
            assert cond()

        # a gate in front of the engine's step: while the worker running
        # it is parked there, no sweep or retirement can free the slot or
        # the queue
        go, parked = threading.Event(), threading.Event()
        real_step = gs.batcher.step

        def gated_step(group_index=None):
            if not go.is_set():
                parked.set()
                go.wait()
            return real_step(group_index)

        go.set()
        gs.batcher.step = gated_step
        hogs = [threading.Thread(target=hog) for _ in range(2)]
        try:
            hogs[0].start()
            wait_for(lambda: gs.batcher.running_count() == 1)
            go.clear()
            assert parked.wait(5)
            assert gs.batcher.running_count() == 1
            hogs[1].start()
            wait_for(lambda: gs.batcher.waiting_count() == 1)
            ch = Channel(str(ep), ChannelOptions(timeout_ms=5000,
                                                 share_connections=False))
            try:
                c = ch.call_sync("GenerateService", "Generate",
                                 _gen_body(b"extra", 4))
                assert c.error_code == berr.ELIMIT, (c.error_code,
                                                     c.error_text)
                assert gs.batcher.shed >= 1
            finally:
                ch.close()
            # still parked: both hogs run out their deadlines
            for t in hogs:
                t.join(10)
        finally:
            go.set()
        assert outcomes == [berr.ERPCTIMEDOUT] * 2
        wait_for(lambda: gs.batcher.running_count()
                 + gs.batcher.waiting_count() == 0)
        assert gs.batcher.evicted == 2

    def test_stop_fails_inflight_and_refuses(self, port_server):
        server, gs, ep = port_server(cache_len=4096)
        ch = Channel(str(ep), ChannelOptions(timeout_ms=20000))
        box = []
        t = threading.Thread(target=lambda: box.append(ch.call_sync(
            "GenerateService", "Generate", _gen_body(b"stopped", 4000))))
        t.start()
        deadline = time.monotonic() + 5
        while not gs.batcher.running_count() and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        server.stop()
        t.join(10)
        assert not t.is_alive()
        assert box[0].failed()
        assert box[0].error_code in (berr.EINTERNAL, berr.EFAILEDSOCKET)
        server.join(5)
        ch.close()


# -------------------------------------------------------- across the wire

def test_reference_channel_to_port_server(port_server):
    server, gs, ep = port_server()
    oracle = RefDecoder(RefConfig(cache_len=160))
    ch = RefChannel(f"tcp://127.0.0.1:{ep.port}")
    try:
        for p in PROMPTS[:3]:
            cntl = RefController()
            cntl.timeout_ms = 20000
            cntl = ch.call_sync("GenerateService", "Generate",
                                _gen_body(p, 12), cntl=cntl)
            assert not cntl.failed(), cntl.error_text
            doc = json.loads(cntl.response_payload.to_bytes())
            assert doc["tokens"] == oracle.generate(_latin1_tokens(p), 12)
        # a failure travels back with its code
        cntl = RefController()
        cntl.timeout_ms = 5000
        cntl = ch.call_sync("GenerateService", "Generate", b"{bad",
                            cntl=cntl)
        assert cntl.error_code == berr.EREQUEST
    finally:
        ch.close()


def test_port_channel_to_reference_server():
    server = RefServer(RefServerOptions(enable_builtin_services=False))
    ref_add_generate_service(server, cache_len=160, warmup=True)
    ep = server.start("tcp://127.0.0.1:0")
    mine = TinyDecoder(TinyDecoderConfig(), device="cpu")
    ch = Channel(f"tcp://127.0.0.1:{ep.port}",
                 ChannelOptions(timeout_ms=30000))
    try:
        for p in PROMPTS[:3]:
            c = ch.call_sync("GenerateService", "Generate", _gen_body(p, 12))
            assert not c.failed(), c.error_text
            doc = json.loads(c.response)
            assert doc["tokens"] == mine.generate(_latin1_tokens(p), 12)
        c = ch.call_sync("GenerateService", "Generate", b"{bad")
        assert c.error_code == berr.EREQUEST
        c = ch.call_sync("GenerateService", "Missing", b"")
        assert c.failed()
    finally:
        ch.close()
        server.stop()
        server.join(5)
