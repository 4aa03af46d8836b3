"""ServingEngine: drives the batcher from one decode thread (the port of
brpc_tpu/serving/engine.py).

The reference co-schedules decode slices on its fiber workers through a
WorkerModule hook; the port has no fiber scheduler yet, so the server
starts one decode thread per engine. The thread steps while the batcher
has work and otherwise sleeps on an Event that ``submit`` sets, so the
first token of a request arriving at an idle server does not wait out a
poll interval. ``has_task``/``process`` keep the WorkerModule shape.

The warm-up step runs on the decode thread itself, before it takes
work: PyTorch keeps a cuBLAS handle per thread, so a warm-up on any
other thread would leave the first real step to create one.
"""

from __future__ import annotations

import logging
import threading

import torch

from .batcher import ContinuousBatcher

log = logging.getLogger("brpc_tpu_torch.serving")


class ServingEngine:
    def __init__(self, batcher: ContinuousBatcher):
        self.batcher = batcher
        self._decode_lock = threading.Lock()
        self._wakeup = threading.Event()
        self._stopping = threading.Event()
        self._thread = None
        self.steps = 0
        self.warmup_steps = 0

    # ------------------------------------------------- WorkerModule shape
    def has_task(self) -> bool:
        return self.batcher.has_work()

    def process(self) -> bool:
        """Run ONE decode slice (sweep + admit + one step). False when
        nothing was done."""
        with self._decode_lock:
            did = self.batcher.step()
        if did:
            self.steps += 1
        return did

    def wake(self) -> None:
        self._wakeup.set()

    # ------------------------------------------------------ decode thread
    def _run(self) -> None:
        while not self._stopping.is_set():
            if self.has_task():
                try:
                    self.process()
                except Exception:       # boundary: keep the lane alive
                    log.exception("decode step failed")
                    self._stopping.wait(0.01)
                continue
            self._wakeup.wait(0.5)
            self._wakeup.clear()

    def start(self, timeout_s: float = 600.0) -> None:
        """Start the decode thread. It first runs one throwaway step;
        start() returns once that step is done, or raises what it
        raised."""
        if self._thread is not None:
            return
        ready = threading.Event()
        failure = []

        def run():
            try:
                self.warm_up()
            except Exception as e:      # reported to start()'s caller
                failure.append(e)
                return
            finally:
                ready.set()
            self._run()

        self._thread = threading.Thread(target=run,
                                        name="serving-decode",
                                        daemon=True)
        self._thread.start()
        if not ready.wait(timeout_s):
            raise RuntimeError(f"decode warm-up took over {timeout_s}s")
        if failure:
            self._thread = None
            raise failure[0]

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stopping.set()
        self._wakeup.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None

    # ------------------------------------------------------ observability
    def snapshot(self) -> dict:
        return {
            "steps": self.steps,
            "warmup_steps": self.warmup_steps,
            "decode_thread_alive": bool(self._thread
                                        and self._thread.is_alive()),
        }

    def warm_up(self) -> None:
        """One throwaway step at the slot shape (prefill, decode, cache
        write, token download), so that the first request's time to first
        token measures scheduling, not the kernel's first-use build and
        load or the first use of each operation on this thread."""
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
        self.warmup_steps += 1
