"""Window / PerSecond over a reducer, fed by a background Sampler
(the port of brpc_tpu/bvar/window.py; bvar/window.h:174,197;
bvar/detail/sampler.h:45).

The Sampler thread ticks once per second, snapshotting every registered
windowed variable into a ring of per-second samples. Windows read the last
N samples. Two sampling modes, chosen by the reducer's SERIES_MODE (the
reference's ReducerSampler makes the same split):

  cumulative — subtractable reducers (Adder): store get_value snapshots,
               window value = newest - oldest.
  delta      — op-combined reducers (Maxer/Miner): store per-tick
               reducer.reset() values, window value = op over last N ticks
               (a plain subtraction of cumulative maxima would be
               meaningless).

Tests can drive ``take_sample()`` manually instead of sleeping.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Optional, Tuple

from brpc_tpu_torch.bvar.variable import Variable
# the trend rings ride this module's tick: bound at load, never inside
# take_sample (the sampler thread does not import)
from brpc_tpu_torch.bvar.series import series_sample_tick

_MAX_WINDOW = 120


class _SeriesSampler:
    """Keeps per-second samples of one reducer."""

    def __init__(self, reducer):
        self.reducer = reducer
        self.mode = getattr(reducer, "SERIES_MODE", "cumulative")
        self.samples: Deque[Tuple[float, object]] = deque(maxlen=_MAX_WINDOW + 1)

    def take_sample(self, now: float):
        if self.mode == "delta":
            self.samples.append((now, self.reducer.reset()))
        else:
            self.samples.append((now, self.reducer.get_value()))


class Sampler:
    """One background thread samples all windowed vars 1/s
    (bvar/detail/sampler.cpp)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: list = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def register(self, series: _SeriesSampler):
        with self._lock:
            self._series.append(series)
        self._ensure_thread()

    def take_sample(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        with self._lock:
            series = list(self._series)
        for s in series:
            s.take_sample(now)
        if self is global_sampler:
            # the trend rings and the anomaly watchdog ride the same 1/s
            # stamp (bvar/series.py, on the wall clock); only the global
            # sampler: a private test sampler's clock must not reach the
            # process's rings
            series_sample_tick()

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="bvar_sampler", daemon=True)
            self._thread.start()

    def _run(self):
        while not self._stop.wait(1.0):
            self.take_sample()

    def stop(self):
        self._stop.set()


global_sampler = Sampler()


def _postfork_reset() -> None:
    """Fork hygiene: the sampler thread exists only in the parent, and
    that dead thread may hold its lock (a fork mid-sample). A fresh lock,
    and the tick thread restarted when anything is registered: the
    inherited windows go on sampling in the child."""
    global_sampler._lock = threading.Lock()
    global_sampler._stop = threading.Event()
    global_sampler._thread = None
    if global_sampler._series:
        global_sampler._ensure_thread()


from brpc_tpu_torch.butil import postfork as _postfork  # noqa: E402

_postfork.register("bvar.window", _postfork_reset)


class Window(Variable):
    """Value accumulated over the last ``window_size`` seconds."""

    def __init__(self, reducer, window_size: int = 10, sampler: Optional[Sampler] = None):
        super().__init__()
        self._reducer = reducer
        self.window_size = min(window_size, _MAX_WINDOW)
        self._series = _SeriesSampler(reducer)
        (sampler or global_sampler).register(self._series)

    def _window_samples(self):
        s = self._series.samples
        if not s:
            return []
        return list(s)[-(self.window_size + 1):]

    def get_value(self):
        samples = self._window_samples()
        if self._series.mode == "delta":
            # combine the last window_size per-tick deltas with the op
            ticks = [v for (_, v) in samples[-self.window_size:]]
            op = self._reducer._op
            val = None
            for v in ticks:
                val = v if val is None else op(val, v)
            return val
        if len(samples) < 2:
            # window not warm yet: report the total so far
            return self._reducer.get_value()
        (t0, v0), (t1, v1) = samples[0], samples[-1]
        try:
            return v1 - v0
        except TypeError:
            return v1

    def get_span_seconds(self) -> float:
        samples = self._window_samples()
        if len(samples) < 2:
            return 0.0
        return samples[-1][0] - samples[0][0]


class PerSecond(Window):
    """Windowed delta divided by elapsed seconds (qps etc.). Only
    meaningful over cumulative-mode reducers (Adder)."""

    def get_value(self):
        samples = self._window_samples()
        if len(samples) < 2:
            return 0.0
        (t0, v0), (t1, v1) = samples[0], samples[-1]
        dt = t1 - t0
        if dt <= 0:
            return 0.0
        if self._series.mode == "delta":
            total = sum(v for (_, v) in samples[1:] if v is not None)
            return total / dt
        return (v1 - v0) / dt
