"""The exit-code registry: every fail-fast site exits with a code the run
supervisor maps to a restart policy.

Counterpart of ``fms_fsdp_tpu/resilience/exits.py``, with the same codes,
so either package's supervisor reads the other's children:

==================  ====  ===================================================
class               code  exited by
==================  ====  ===================================================
ok                  0     a run that reached num_steps, or a clean
                          preemption exit (the supervisor tells the two
                          apart by the heartbeat step against its target)
error               1     any unclassified exception (the interpreter's
                          default; never exited explicitly)
watchdog_stall      2     ``StepWatchdog`` (resilience/guards.py): no
                          progress inside ``step_timeout_s``
slice_loss          3     ``SliceHealthMonitor`` (resilience/slices.py):
                          every process of another slice went silent;
                          ``SliceLostError`` through the entry wrapper
anomaly_abort       4     ``AnomalyAbort`` through the entry wrapper: K
                          non-finite steps in a row, checkpoint saved,
                          aborting on purpose
loader_death        5     ``LoaderWorkerError`` through the entry wrapper,
                          and the ``loader_worker`` fault's ``action=exit``
preempted           6     a serving replica's drain-and-migrate exit
                          (``serve/replica.py``, after SIGTERM); the
                          training loop exits 0 after its preemption
                          save and the supervisor classifies it from the
                          heartbeat step
injected_kill       7     fault-injection hard kills (``slice_kill``,
                          ``ckpt_precommit_kill``) without ``code=``
corpus_loss         8     ``CorpusLossError`` through the entry wrapper:
                          fewer than ``min_live_corpora`` corpora live
state_divergence    9     ``StateDivergenceError``: the cross-replica compare
replica_loss        10    a serving replica died: ``ReplicaLostError`` (the
                          replica child's engine failure, the fleet lost)
==================  ====  ===================================================

``classify_world`` merges one incarnation's per-process codes into the
most causal class. The supervisor exports ``FMS_RUN_ID`` (the
incarnation) and ``FMS_RESTART_LEDGER`` (its ledger); ``current_run_id``
and ``read_restart_ledger`` are the child's readers: the heartbeat is
stamped with the run id, and the observer folds the ledger's restarts and
downtime into every record.
"""

import contextlib
import json
import os
import sys
import traceback
from typing import Dict, Iterable, Optional

ENV_RUN_ID = "FMS_RUN_ID"
ENV_LEDGER = "FMS_RESTART_LEDGER"

EXIT_CODES: Dict[str, int] = {
    "ok": 0,
    "error": 1,
    "watchdog_stall": 2,
    "slice_loss": 3,
    "anomaly_abort": 4,
    "loader_death": 5,
    "preempted": 6,
    "injected_kill": 7,
    "corpus_loss": 8,
    "state_divergence": 9,
    "replica_loss": 10,
}

# most causal first: when one incarnation's processes exit with different
# codes (the cause on one, its echoes on the others), the world classifies
# as the first class present in this order
CLASSIFY_PRIORITY = (
    "loader_death",
    "corpus_loss",
    "state_divergence",
    "anomaly_abort",
    "replica_loss",
    "slice_loss",
    "watchdog_stall",
    "preempted",
    "injected_kill",
    "error",
    "ok",
)


def classify_exit(code: Optional[int]) -> str:
    """Exit code -> class name. Unknown nonzero codes (signal deaths,
    which subprocess reports as negative codes, among them) classify as
    ``error``: the supervisor's bounded generic retry."""
    if code is None:
        return "error"
    for name, c in EXIT_CODES.items():
        if c == code:
            return name
    return "error"


def classify_world(codes: Iterable[Optional[int]]) -> str:
    """Merge one incarnation's per-process exit codes into the single
    most causal class (see CLASSIFY_PRIORITY)."""
    classes = {classify_exit(c) for c in codes}
    for name in CLASSIFY_PRIORITY:
        if name in classes:
            return name
    return "ok"


def current_run_id() -> Optional[str]:
    """The incarnation id the supervisor exported for this process, or
    None when running unsupervised."""
    return os.environ.get(ENV_RUN_ID) or None


def read_restart_ledger(path: Optional[str] = None) -> Optional[dict]:
    """The supervisor's restart ledger (written before each launch, so
    the child can fold earlier downtime into goodput), or None when
    absent or unreadable: a torn ledger must never block a restart."""
    path = path or os.environ.get(ENV_LEDGER) or ""
    if not path:
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def classify_exception(e: BaseException) -> Optional[str]:
    """Exit class of a classified failure type, or None (unclassified:
    the interpreter exits 1). The types are imported here, on the crash
    path, so that this module imports nothing of the trainer. The step
    watchdog needs no entry: it exits with its code itself, from its
    thread."""
    from fms_fsdp_tpu_torch.data.loader import LoaderWorkerError
    from fms_fsdp_tpu_torch.data.streaming import CorpusLossError
    from fms_fsdp_tpu_torch.resilience.divergence import StateDivergenceError
    from fms_fsdp_tpu_torch.resilience.slices import SliceLostError
    from fms_fsdp_tpu_torch.serve.fleet import ReplicaLostError
    from fms_fsdp_tpu_torch.utils.train_utils import AnomalyAbort

    for typ, name in (
        (AnomalyAbort, "anomaly_abort"),
        (SliceLostError, "slice_loss"),
        (LoaderWorkerError, "loader_death"),
        (CorpusLossError, "corpus_loss"),
        (StateDivergenceError, "state_divergence"),
        (ReplicaLostError, "replica_loss"),
    ):
        if isinstance(e, typ):
            return name
    return None


@contextlib.contextmanager
def classified_exit():
    """Entry-point wrapper: map classified failure types onto registry
    exit codes, so the supervisor reads the cause from the exit status.

    The traceback still prints; classification changes the exit code,
    not the post-mortem. Unclassified exceptions propagate untouched
    (exit 1, the registry's ``error``). Classified failures exit through
    ``os._exit``, like every other fail-fast site: interpreter teardown
    would join the process's non-daemon threads first."""
    try:
        yield
    except (SystemExit, KeyboardInterrupt):
        raise
    except BaseException as e:  # noqa: BLE001 — classification boundary
        name = classify_exception(e)
        if name is None:
            raise
        traceback.print_exc()
        sys.stderr.write(
            f"exit classified: {name} (exit {EXIT_CODES[name]})\n"
        )
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(EXIT_CODES[name])
