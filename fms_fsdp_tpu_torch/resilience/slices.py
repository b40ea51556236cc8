"""Slice fault domains: per-slice liveness over a shared directory, and
the classifier of a cross-slice collective that failed.

Counterpart of ``fms_fsdp_tpu/resilience/slices.py``, with its file names,
run-id filter, staleness rule, messages and ``wait_classify``. On more
than one slice (the mesh's dcn axis) the slice is the unit capacity dies
in. To a surviving process a dead slice looks like a cross-slice
collective (the gradient all-reduce over the slices, or a report's sum)
that never completes, or one that fails in the transport (gloo's "Connection
closed by peer"). ``SliceHealthMonitor`` tells that apart from a wedged
step:

- every process writes a small heartbeat file (``slice<k>_proc<r>.hb``)
  into a shared directory from a daemon thread, so the file keeps
  changing while the main thread waits inside a collective: it tracks
  the process's liveness, not its progress;
- the same thread scans every peer's file. A file is stale when its
  mtime has not changed across local polls for more than ``timeout_s``
  (no clock of a shared file system is compared with this host's);
- when every process of another slice has gone silent, the slice is
  lost: the monitor prints one line on every healthy process (the dead
  slice, its last step, and the restart at one slice fewer, which the
  elastic resume allows: ``ckpt/elastic.py``) and exits with the
  ``slice_loss`` code, so the supervisor restarts the world one slice
  smaller (``resilience/supervisor.py``) instead of waiting in the dead
  slice's collective.

``wait_classify`` is the other half: the train loop holds an exception
from a collective until the liveness verdict is in, and raises
:class:`SliceLostError` ("slice K lost ...") when it names a dead
slice, which the entry's ``classified_exit`` maps to the same code.

The ``slice_kill`` and ``dcn_reduce_stall`` fault sites
(``resilience/faults.py``) fire at a rank's own slice in the train loop.
"""

import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

from fms_fsdp_tpu_torch.resilience.exits import EXIT_CODES, current_run_id

EXIT_CODE = EXIT_CODES["slice_loss"]

_HB_SUFFIX = ".hb"


class SliceLostError(RuntimeError):
    """A failure the liveness verdict classified as a lost fault domain
    ("slice K lost ... restart at world minus one fault domain"). Typed
    so the entry points' classified-exit wrapper
    (resilience/exits.py) maps it onto the ``slice_loss`` registry exit
    code — the same code the monitor thread's direct ``os._exit`` uses —
    whichever way the failure surfaced (hang vs dead-peer transport
    error)."""


def _hb_name(slice_index: int, process_index: int) -> str:
    return f"slice{slice_index}_proc{process_index}{_HB_SUFFIX}"


def _parse_hb_name(name: str):
    if not name.endswith(_HB_SUFFIX) or not name.startswith("slice"):
        return None
    try:
        s, p = name[len("slice") : -len(_HB_SUFFIX)].split("_proc")
        return int(s), int(p)
    except ValueError:
        return None


class SliceHealthMonitor:
    """Per-slice liveness over a shared heartbeat directory.

    ``beat(step)`` is called once per loop iteration (stores the step
    for the post-mortem message; the liveness file itself is written by
    the monitor thread, so a blocked main thread keeps beating liveness
    but not progress). ``on_dead`` (tests) replaces the default
    report-and-``os._exit`` action.

    ``run_id`` (defaults to the supervisor-exported ``FMS_RUN_ID``,
    identical on every host of one incarnation) stamps this process's
    liveness file and filters the scan: liveness files left behind by a
    PREVIOUS incarnation are ignored entirely — a freshly restarted
    world must not declare a slice lost off the dead world's stale
    files. Unsupervised runs (no run id) scan every file, as before;
    the supervisor additionally clears the directory between
    incarnations.
    """

    EXIT_CODE = EXIT_CODE

    def __init__(
        self,
        heartbeat_dir: str,
        num_slices: int,
        slice_index: int,
        process_index: int,
        timeout_s: float,
        poll_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        on_dead: Optional[Callable[[str], None]] = None,
        run_id: Optional[str] = None,
    ):
        assert timeout_s > 0 and num_slices > 1
        self.dir = heartbeat_dir
        self.num_slices = int(num_slices)
        self.slice_index = int(slice_index)
        self.process_index = int(process_index)
        self.timeout_s = float(timeout_s)
        self.poll_s = (
            min(1.0, self.timeout_s / 4) if poll_s is None else float(poll_s)
        )
        self._clock = clock
        self._on_dead = on_dead
        self.run_id = current_run_id() if run_id is None else (run_id or None)
        self._tag = (
            f"slice-health [proc {self.process_index} "
            f"slice {self.slice_index}]"
        )
        self._step = 0
        self._last_progress = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # path -> (mtime fingerprint, local clock when first seen at it,
        # the file's run_id stamp): staleness is "unchanged across local
        # polls", never a wall-clock age comparison against a possibly-
        # skewed storage server; the run_id filters out a previous
        # incarnation's leftovers
        self._marks: Dict[str, tuple] = {}
        self._dead: Optional[dict] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SliceHealthMonitor":
        os.makedirs(self.dir, exist_ok=True)
        self._write_own()
        self._thread = threading.Thread(
            target=self._run, name="slice-health", daemon=True
        )
        self._thread.start()
        return self

    def beat(self, step: int) -> None:
        self._step = int(step)
        self._last_progress = self._clock()

    def stop(self) -> None:
        self._stop.set()

    # -- liveness file -----------------------------------------------------

    def _write_own(self) -> None:
        path = os.path.join(
            self.dir, _hb_name(self.slice_index, self.process_index)
        )
        tmp = path + ".tmp"
        try:
            payload = {
                "slice": self.slice_index,
                "proc": self.process_index,
                "step": self._step,
                "time_unix": time.time(),
            }
            if self.run_id:
                payload["run_id"] = self.run_id
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:
            pass  # a transient shared-fs hiccup must not kill the writer

    # -- scanning ----------------------------------------------------------

    def _scan(self) -> Optional[dict]:
        """One liveness pass. Returns {"slice", "procs", "last_step",
        "silent_s"} for a lost slice, else None. Pure over the
        injectable clock (fake-clock testable)."""
        now = self._clock()
        try:
            names = os.listdir(self.dir)
        except OSError:
            return None
        by_slice: Dict[int, list] = {}
        for name in names:
            parsed = _parse_hb_name(name)
            if parsed is None:
                continue
            s, p = parsed
            path = os.path.join(self.dir, name)
            try:
                m = os.path.getmtime(path)
            except OSError:
                continue
            marked = self._marks.get(path)
            if marked is None or marked[0] != m:
                # (re)marking: read the file's incarnation stamp once
                # per mtime change (atomic replace — never torn)
                file_run = None
                try:
                    with open(path) as f:
                        file_run = json.load(f).get("run_id")
                except (OSError, ValueError):
                    pass
                marked = self._marks[path] = (m, now, file_run)
            age = now - marked[1]
            if (
                self.run_id
                and marked[2] is not None
                and marked[2] != self.run_id
            ):
                # a previous incarnation's file: its processes are dead
                # by definition (the world restarted) — not evidence of
                # a lost slice in THIS incarnation
                continue
            by_slice.setdefault(s, []).append((p, path, age))
        for s, entries in sorted(by_slice.items()):
            if s == self.slice_index or not entries:
                continue
            if all(age > self.timeout_s for _, _, age in entries):
                last_step = -1
                for _, path, _ in entries:
                    try:
                        with open(path) as f:
                            last_step = max(
                                last_step, int(json.load(f).get("step", -1))
                            )
                    except (OSError, ValueError):
                        pass
                return {
                    "slice": s,
                    "procs": sorted(p for p, _, _ in entries),
                    "last_step": last_step,
                    "silent_s": min(age for _, _, age in entries),
                }
        return None

    def describe_loss(self, dead: dict) -> str:
        """The one actionable line every healthy host prints."""
        blocked = self._clock() - self._last_progress
        stall = (
            f"; the local step has been blocked in a cross-slice "
            f"collective for {blocked:.0f}s — classified as slice loss, "
            f"not a local stall"
            if blocked > self.poll_s * 2
            else ""
        )
        step = dead.get("last_step", -1)
        at = f" (last progress at step {step})" if step >= 0 else ""
        return (
            f"{self._tag}: slice {dead['slice']} lost — all "
            f"{len(dead['procs'])} of its process(es) "
            f"{dead['procs']} silent for {dead['silent_s']:.0f}s{at}{stall}. "
            f"Restart at world minus one fault domain "
            f"({self.num_slices} -> {self.num_slices - 1} slice(s), same "
            f"per-slice shape): elastic resume restores the last committed "
            f"checkpoint, preserves the global batch, and reshards the "
            f"loader walk (docs/resilience.md, docs/checkpointing.md)."
        )

    # -- classifier --------------------------------------------------------

    def wait_classify(self, extra_wait_s: Optional[float] = None) -> Optional[dict]:
        """Block up to ``timeout_s + extra_wait_s`` waiting for a
        lost-slice verdict — the classifier for a cross-slice collective
        that ERRORED (dead-peer transport reset) rather than hung: the
        peer's files need a full timeout window to go stale, so the
        caller holding a transport exception waits here before deciding
        whether it is a slice loss or an unrelated failure."""
        deadline = self._clock() + self.timeout_s + (
            self.poll_s * 2 if extra_wait_s is None else extra_wait_s
        )
        while True:
            dead = self._dead or self._scan()
            if dead is not None or self._clock() >= deadline:
                return dead
            if self._stop.wait(self.poll_s):
                return self._dead

    # -- thread ------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self._write_own()
            dead = self._scan()
            if dead is None:
                continue
            self._dead = dead
            msg = self.describe_loss(dead)
            if self._on_dead is not None:
                self._on_dead(msg)
                return
            sys.stderr.write(msg + "\n")
            sys.stderr.flush()
            # fail-fast on every healthy host: parking the world in the
            # dead slice's DCN collective burns the reservation and
            # yields no post-mortem
            os._exit(self.EXIT_CODE)
