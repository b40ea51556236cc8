"""Hot-loop guards: non-finite batch accounting and a wall-clock step
watchdog.

Counterpart of ``fms_fsdp_tpu/resilience/guards.py``. The train step
(``train/step.py``) flags a batch whose loss or gradient norm is
non-finite and skips its update; ``AnomalyGuard`` counts the skipped
batches and asks for an abort after ``max_consecutive`` bad steps in a
row. ``StepWatchdog`` covers the opposite failure: a step that never
finishes (a wedged card, a stuck host). The loop beats it; if no beat
lands within the timeout it writes a stall report, dumps every thread's
stack and exits with the ``watchdog_stall`` code, so the supervisor
restarts the run instead of letting it burn the card's time.

This module imports nothing of torch: the watchdog's thread must not call
into ``torch.cuda``, whose context a wedged main thread may hold.
"""

import contextlib
import faulthandler
import json
import os
import sys
import threading
import time
from typing import Iterable

from fms_fsdp_tpu_torch.resilience.exits import EXIT_CODES, current_run_id


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


class StepWatchdog:
    """Wall-clock watchdog over training progress.

    ``beat()`` is called once per loop iteration (one monotonic read and
    a store). A daemon thread polls; if the gap since the last beat
    exceeds ``timeout_s`` it writes the stall report, dumps every
    thread's stack via faulthandler and ``os._exit``\\ s with
    :data:`EXIT_CODE`.

    ``heartbeat_path`` (optional) is the observer's heartbeat file
    (obs/sinks.py::Heartbeat); the stall report quotes its last contents,
    so the post-mortem states how far the run got. ``process_index`` is
    passed in by the trainer (the thread asks no library for it) and tags
    the report. ``run_id`` (default: the supervisor's ``FMS_RUN_ID``)
    labels a heartbeat left by an earlier incarnation as stale, so a
    restarted run's report never claims the dead run's progress.
    """

    EXIT_CODE = EXIT_CODES["watchdog_stall"]

    def __init__(
        self,
        timeout_s: float,
        poll_s: float = None,
        heartbeat_path=None,
        process_index=None,
        run_id=None,
    ):
        if not timeout_s > 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = timeout_s
        self.poll_s = min(1.0, timeout_s / 4) if poll_s is None else poll_s
        self.heartbeat_path = heartbeat_path
        self.process_index = process_index
        self.run_id = current_run_id() if run_id is None else run_id
        if process_index is None:
            self._tag = "step watchdog"
        else:
            self._tag = f"step watchdog [proc {process_index}]"
        self._last_beat = time.monotonic()
        self._paused = 0
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> "StepWatchdog":
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="step-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def beat(self) -> None:
        self._last_beat = time.monotonic()

    @contextlib.contextmanager
    def paused(self):
        """Suspend the deadline around a known-long healthy host
        operation (a save must not be judged by a timeout sized for step
        windows). Re-arms with a fresh beat."""
        self._paused += 1
        try:
            yield
        finally:
            # beat BEFORE unpausing: the poller must never observe
            # paused==0 while _last_beat is still pre-pause stale
            self.beat()
            self._paused -= 1

    def stop(self) -> None:
        self._stop.set()

    def _stall_report(self, stalled: float) -> str:
        """The stall message (separate from the exit so tests can pin
        it without dying). A heartbeat stamped by a DIFFERENT
        incarnation (run_id mismatch) is quoted but labeled stale — a
        restarted run must not read the dead run's heartbeat as its own
        progress."""
        lines = [
            f"{self._tag}: no training progress for "
            f"{stalled:.1f}s (timeout {self.timeout_s}s); dumping "
            f"stacks and exiting {self.EXIT_CODE}"
        ]
        if self.heartbeat_path:
            # read inline (no project imports): the process is
            # wedged — the stall path must not risk an import
            # lock held by the stuck main thread
            try:
                with open(self.heartbeat_path) as f:
                    hb = json.load(f)
            except (OSError, ValueError):
                hb = None
            stale = ""
            if (
                isinstance(hb, dict)
                and self.run_id
                and hb.get("run_id") not in (None, self.run_id)
            ):
                stale = (
                    " [STALE: written by a previous incarnation "
                    f"(run_id {hb.get('run_id')!r}, ours "
                    f"{self.run_id!r}) — this run made no reported "
                    "progress]"
                )
            lines.append(
                f"{self._tag}: last heartbeat "
                f"({self.heartbeat_path}): {hb}{stale}"
            )
        return "\n".join(lines) + "\n"

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self._paused:
                continue
            stalled = time.monotonic() - self._last_beat
            if stalled > self.timeout_s:
                sys.stderr.write(self._stall_report(stalled))
                sys.stderr.flush()
                try:
                    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
                except Exception:  # noqa: BLE001 — already dying, exit anyway
                    pass
                sys.stderr.flush()
                os._exit(self.EXIT_CODE)
