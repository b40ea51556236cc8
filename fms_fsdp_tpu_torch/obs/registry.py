"""Metric registry: named counters / gauges / EWMAs / windowed histograms.

Hot-path discipline: every update is a couple of float ops on host
Python objects — no jax, no IO, no locks on the common path (the train
loop is single-threaded; background producers like DeviceFeed get their
own counters and only ever ``add`` — a GIL-atomic float += on a
dedicated cell). Aggregation (percentiles, means, window resets) happens
only in :meth:`MetricRegistry.snapshot`, called once per report
interval.
"""

from collections import deque
from typing import Dict, Optional


class Counter:
    """Monotonic accumulator. ``snapshot`` exposes both the cumulative
    total (``name``) and the delta since the last snapshot
    (``name_window``)."""

    __slots__ = ("value", "_last")

    def __init__(self):
        self.value = 0.0
        self._last = 0.0

    def add(self, n: float = 1.0) -> None:
        self.value += n

    def window(self) -> float:
        # single read of self.value: a concurrent add() between a
        # delta read and a second read for _last would be lost from
        # every window (the feed thread adds while the loop snapshots)
        v = self.value
        delta = v - self._last
        self._last = v
        return delta


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class EWMA:
    """Exponentially-weighted moving average; ``None`` until first update."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, v: float) -> None:
        v = float(v)
        self.value = v if self.value is None else (
            self.alpha * v + (1 - self.alpha) * self.value
        )


class WindowedHistogram:
    """Bounded sample window; reduced to mean/p50/p90/max at snapshot
    (then cleared, so each report describes its own window)."""

    __slots__ = ("samples",)

    def __init__(self, maxlen: int = 512):
        self.samples: deque = deque(maxlen=maxlen)

    def record(self, v: float) -> None:
        self.samples.append(float(v))

    def reduce(self, clear: bool = True) -> Dict[str, float]:
        if not self.samples:
            return {}
        xs = sorted(self.samples)
        n = len(xs)
        out = {
            "mean": sum(xs) / n,
            "p50": xs[n // 2],
            "p90": xs[min(n - 1, (9 * n) // 10)],
            "max": xs[-1],
        }
        if clear:
            self.samples.clear()
        return out


class MetricRegistry:
    """Create-on-first-use registry of named metrics.

    Names are flat strings (dot-separated by convention, e.g.
    ``feed.queue_wait_s``); ``snapshot()`` flattens everything into one
    ``{name: float}`` dict suitable for a sink record's ``extra`` map.
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._ewmas: Dict[str, EWMA] = {}
        self._hists: Dict[str, WindowedHistogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def ewma(self, name: str, alpha: float = 0.1) -> EWMA:
        e = self._ewmas.get(name)
        if e is None:
            e = self._ewmas[name] = EWMA(alpha)
        return e

    def hist(self, name: str, maxlen: int = 512) -> WindowedHistogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = WindowedHistogram(maxlen)
        return h

    def snapshot(self, clear_windows: bool = True) -> Dict[str, float]:
        """One flat dict of everything registered. Counters contribute
        cumulative and per-window values; histograms contribute their
        window reductions (and reset when ``clear_windows``)."""
        out: Dict[str, float] = {}
        for name, c in self._counters.items():
            out[name] = c.value
            out[name + "_window"] = c.window()
        for name, g in self._gauges.items():
            out[name] = g.value
        for name, e in self._ewmas.items():
            if e.value is not None:
                out[name] = e.value
        for name, h in self._hists.items():
            for stat, v in h.reduce(clear=clear_windows).items():
                out[f"{name}_{stat}"] = v
        return out
