"""Step-phase wall-time decomposition and goodput accounting.

Counterpart of ``fms_fsdp_tpu/obs/timing.py``, on host clocks only. The
loop's wall clock splits into phases:

- ``data_wait`` — the loop waiting on ``next()`` of its batch iterator;
- ``compute``  — the train step (eager: its launches and its one host
  sync) plus the report-time fetch of the window's metrics;
- ``checkpoint`` — inside a save (the blocking snapshot under the async
  manager);
- ``ici_collective`` / ``dcn_collective`` — the multi-slice collective
  split, 0.0 on one card;
- ``other``    — the remainder (Python, prints, sinks).

Goodput is compute time scaled by the window's clean-step fraction over
wall time: data stalls, checkpoint stalls and skipped steps pull it below
what MFU alone says.
"""

import time
from contextlib import contextmanager
from typing import Callable, Dict


PHASES = (
    "data_wait",
    "compute",
    "checkpoint",
    "ici_collective",
    "dcn_collective",
    "other",
)


class PhaseTimer:
    """Accumulates wall seconds per phase; windowed at report cadence.

    ``clock`` is injectable for tests (defaults to ``time.monotonic``).
    Phases nest: time inside an inner ``phase()`` (a save inside the loop
    body) is attributed to the inner phase only.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._acc: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._stack = []
        self._window_start = clock()

    def record(self, name: str, seconds: float) -> None:
        """Directly attribute ``seconds`` to ``name`` (for callers that
        measured a wait themselves)."""
        self._acc[name] = self._acc.get(name, 0.0) + seconds

    @contextmanager
    def phase(self, name: str):
        start = self._clock()
        if self._stack:
            # suspend the enclosing phase: attribute its elapsed-so-far
            # and let the inner phase own the clock from here
            outer_name, outer_start = self._stack[-1]
            self.record(outer_name, start - outer_start)
        self._stack.append((name, start))
        try:
            yield
        finally:
            end = self._clock()
            self.record(name, end - self._stack.pop()[1])
            if self._stack:
                # resume the outer phase from now
                self._stack[-1] = (self._stack[-1][0], end)

    def window(self) -> Dict[str, float]:
        """Close the current report window: return per-phase seconds with
        ``other`` as the unattributed remainder and ``wall`` as the
        window's total, then reset the accumulators."""
        now = self._clock()
        wall = max(0.0, now - self._window_start)
        self._window_start = now
        out = {p: self._acc.get(p, 0.0) for p in PHASES}
        for k in self._acc:
            if k not in out:
                out[k] = self._acc[k]
        attributed = sum(v for k, v in out.items() if k != "other")
        out["other"] += max(0.0, wall - attributed)
        out["wall"] = wall
        self._acc = {p: 0.0 for p in PHASES}
        return out


class GoodputTracker:
    """Folds phase windows and skipped-step counts into goodput.

    ``update`` consumes one report window and returns
    ``(goodput_window, goodput_overall)``. ``restart_downtime_s`` (the
    supervisor's restart ledger) pre-charges the overall wall clock: time
    the run spent dead between incarnations produced no progress.
    """

    def __init__(self, restart_downtime_s: float = 0.0):
        self.restart_downtime_s = max(0.0, float(restart_downtime_s))
        self.productive_s = 0.0
        self.wall_s = self.restart_downtime_s

    def update(
        self,
        window: Dict[str, float],
        steps: int,
        skipped_steps: int = 0,
    ):
        wall = window.get("wall", 0.0)
        compute = window.get("compute", 0.0)
        steps = max(1, steps)
        clean_frac = max(0.0, (steps - skipped_steps) / steps)
        productive = compute * clean_frac
        self.productive_s += productive
        self.wall_s += wall
        goodput_window = productive / wall if wall > 0 else 0.0
        goodput_overall = (
            self.productive_s / self.wall_s if self.wall_s > 0 else 0.0
        )
        return goodput_window, goodput_overall
