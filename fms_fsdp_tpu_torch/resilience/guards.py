"""Hot-loop anomaly guard: non-finite batch accounting.

Counterpart of ``fms_fsdp_tpu/resilience/guards.py::AnomalyGuard``. The
train step (``train/step.py``) flags a batch whose loss or gradient norm
is non-finite and skips its update; this host policy counts the skipped
batches and asks for an abort after ``max_consecutive`` bad steps in a
row. The step watchdog, slice monitor and the rest of the resilience
layer wait for ROADMAP.md A.12.
"""

from typing import Iterable


class AnomalyGuard:
    """Accumulates per-step non-finite flags, in step order."""

    def __init__(self, max_consecutive: int = 8):
        if max_consecutive <= 0:
            raise ValueError(f"max_consecutive must be positive, got {max_consecutive}")
        self.max_consecutive = max_consecutive
        self.skipped_batches = 0
        self.consecutive = 0

    def observe(self, flags: Iterable[float]) -> int:
        """Feed one report window's flags; returns the window's skip count."""
        window_skips = 0
        for f in flags:
            if f:
                window_skips += 1
                self.consecutive += 1
            else:
                self.consecutive = 0
        self.skipped_batches += window_skips
        return window_skips

    def should_abort(self) -> bool:
        return self.consecutive >= self.max_consecutive
