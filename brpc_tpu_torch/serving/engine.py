"""ServingEngine: the model replica as a WorkerModule (the port of
brpc_tpu/serving/engine.py): decode slices co-scheduled WITH the fiber
workers instead of on a thread of their own.

Every fiber worker's loop polls ``has_task()`` and runs
``process(group_index)`` before it looks at its run queues
(``fiber/worker_module.py``), so decode steps interleave with RPC fibers
on the same threads: under RPC load the workers spend their iterations
on fibers and steps squeeze between them; on a quiet server every
worker offers the engine a slice.

Only one worker decodes at a time (``_decode_lock`` try-acquire): the KV
slots are shared state, and a second concurrent step would race their
writes. A worker that loses the race returns ``False`` (no progress), so
its loop may park instead of spinning on a batch a sibling is decoding;
``contended`` counts those misses, ``threads_seen`` the steps each
worker thread ran.

The warm-up step runs once, on the thread that starts the server, as the
reference's does. The workers are not warmed one by one: on the H100,
neither a prefill nor the whole warm-up step on every worker at start
shortened a worker's first step or the first burst's time to first
token (PERF.md, section 6).
"""

from __future__ import annotations

import threading
from collections import Counter

import torch

from brpc_tpu_torch.fiber.worker_module import WorkerModule

from . import serving_stats as _sstats
from .batcher import ContinuousBatcher


class ServingEngine(WorkerModule):
    def __init__(self, batcher: ContinuousBatcher,
                 label: str = "GenerateService.Generate"):
        self.batcher = batcher
        # a sampler attributes decode slices to the serving method
        # (worker_module.active_label reads this while process runs)
        self.attribution_label = label
        self._decode_lock = threading.Lock()
        self._decoding = 0              # the thread in a slice, else 0
        self.steps = 0
        self.warmup_steps = 0
        self.contended = 0
        self.threads_seen: Counter = Counter()

    # ------------------------------------------------- WorkerModule hooks
    def has_task(self) -> bool:
        return self.batcher.has_work()

    def process(self, group_index: int) -> bool:
        """Run ONE decode slice (sweep + admit + one step). False when no
        progress was made: another worker holds the slice, or there was
        nothing to do."""
        if not self._decode_lock.acquire(False):
            self.contended += 1
            return False
        self._decoding = threading.get_ident()
        # names the decode slice for a sampler when no module label is
        # live (brpc_tpu/serving/engine.py:64-77)
        stats_on = _sstats.enabled()
        if stats_on:
            _sstats.stamp_serving_thread("serving:decode")
        try:
            did = self.batcher.step(group_index)
        finally:
            self._decoding = 0
            self._decode_lock.release()
            if stats_on:
                _sstats.unstamp_serving_thread()
        if did:
            self.steps += 1
            self.threads_seen[threading.get_ident()] += 1
        return did

    def quiesce(self) -> bool:
        """Wait out the decode slice in flight (``Server.stop``, after
        the engine is unregistered and the batcher stopped). A fiber
        worker is a daemon thread: one still in torch, or freeing a
        step's tensors, when the interpreter exits aborts the process
        ("terminate called without an active exception"). False after
        30 s (a wedged step), or when called from the slice itself."""
        if self._decoding == threading.get_ident():
            return False
        if not self._decode_lock.acquire(timeout=30.0):
            return False
        self._decode_lock.release()
        return True

    # ------------------------------------------------------ observability
    def snapshot(self) -> dict:
        return {
            "steps": self.steps,
            "warmup_steps": self.warmup_steps,
            "decode_lock_contended": self.contended,
            "worker_threads_used": len(self.threads_seen),
        }

    def warm_up(self) -> None:
        """One throwaway step at the slot shape (prefill, decode, cache
        write, token download), so that the first request's time to first
        token measures scheduling, not the kernel's first-use build and
        load."""
        stats_on = _sstats.enabled()
        if stats_on:
            _sstats.stamp_serving_thread("serving:warmup")
        try:
            self._warm_step()
        finally:
            if stats_on:
                _sstats.unstamp_serving_thread()
        self.warmup_steps += 1

    def _warm_step(self) -> None:
        m = self.batcher.model
        cfg, dev = m.config, m.device
        b = self.batcher.max_batch
        k = torch.zeros((b, cfg.cache_len, cfg.dim), device=dev)
        v = torch.zeros_like(k)
        h = torch.zeros((b, cfg.dim), device=dev)
        lens = torch.ones((b,), dtype=torch.int32, device=dev)
        with self._decode_lock:
            kp, vp, hl = m.prefill([0])
            k[0, :1], v[0, :1], h[0] = kp, vp, hl
            nxt, k_new, v_new, h_new = m.decode_step(k, v, h, lens)
            rows = torch.arange(b, device=dev)
            k[rows, lens.long()] = k_new
            v[rows, lens.long()] = v_new
            h.copy_(h_new)
            nxt.tolist()
