"""Pluggable metric sinks: JSONL, CSV summary, legacy tracker adapter,
and the heartbeat file.

Counterpart of ``fms_fsdp_tpu/obs/sinks.py``: the same file names, CSV
columns, tracker keys and heartbeat payload, so the tools that read one
package's run read the other's. Sinks receive one schema-validated
record per report step via ``emit(record)`` and must never raise into the
hot loop: IO failures log once and disable the sink (a full disk must not
kill a run).
"""

import csv
import json
import logging
import os
import tempfile
from typing import Callable, Dict, List, Optional

from fms_fsdp_tpu_torch.obs.schema import SCHEMA_FIELDS, SCHEMA_VERSION
from fms_fsdp_tpu_torch.resilience.exits import current_run_id

logger = logging.getLogger(__name__)


class Sink:
    def emit(self, record: Dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class _FileSink(Sink):
    """Shared broken-pipe discipline: first IO error disables the sink."""

    def __init__(self, path: str):
        self.path = path
        self._broken = False
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _write(self, record: Dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def emit(self, record: Dict) -> None:
        if self._broken:
            return
        try:
            self._write(record)
        except (OSError, ValueError, TypeError) as e:
            # OSError: disk/fs; ValueError: non-finite slipped to
            # json.dumps(allow_nan=False); TypeError: unserializable
            # value in a record — all disable the sink, never the run
            self._broken = True
            logger.warning("%s sink disabled: %s", self.path, e)


class JSONLSink(_FileSink):
    """One JSON object per line per report step, append-only, flushed per
    emit so a crash loses at most the in-flight line. The schema is
    versioned (schema.py); consumers key on ``schema_version``."""

    def __init__(self, path: str):
        super().__init__(path)
        self._f = None

    def _write(self, record: Dict) -> None:
        if self._f is None:
            self._f = open(self.path, "a", buffering=1)
        # allow_nan=False backstops the observer's non-finite -> null
        # mapping: a bare NaN/Infinity token is not strict JSON and
        # must never reach the stream (ValueError disables the sink
        # loudly instead)
        self._f.write(json.dumps(record, sort_keys=True, allow_nan=False) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None


class CSVSink(_FileSink):
    """Flat summary table: the scalar schema fields as columns (``extra``
    is dropped — it is open-ended; the JSONL stream has it). Header is
    written once on first emit."""

    COLUMNS = [n for n, (tag, _) in SCHEMA_FIELDS.items() if tag != "map"]

    def __init__(self, path: str):
        super().__init__(path)
        self._f = None
        self._writer = None

    def _write(self, record: Dict) -> None:
        if self._f is None:
            fresh = not (
                os.path.exists(self.path) and os.path.getsize(self.path) > 0
            )
            self._f = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(
                self._f, fieldnames=self.COLUMNS, extrasaction="ignore"
            )
            if fresh:
                self._writer.writeheader()
        self._writer.writerow({c: record.get(c) for c in self.COLUMNS})
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None


class TrackerSink(Sink):
    """Adapter over the legacy wandb/aim ``log_fn(dict, step)`` from
    ``get_tracker`` — the exact key names the pre-obs loop logged, so
    existing dashboards keep working unchanged; ``extra`` metrics ride
    along under their own names as before."""

    def __init__(self, log_fn: Callable):
        self.log_fn = log_fn
        self._broken = False

    def emit(self, record: Dict) -> None:
        if self._broken:
            return
        payload = {
            "learning rate": record.get("learning_rate"),
            "loss": record.get("loss"),
            "gradient norm": record.get("grad_norm"),
            "token seen": record.get("tokens_seen"),
            "current throughput (token per chip per sec)": record.get(
                "tokens_per_sec_per_chip"
            ),
            "overall throughput (token per chip per sec)": record.get(
                "tokens_per_sec_per_chip_overall"
            ),
            "chip reserved memory": record.get("memory_reserved_bytes"),
            "chip allocated memory": record.get("memory_allocated_bytes"),
            "skipped batches": record.get("skipped_steps"),
            **(record.get("extra") or {}),
        }
        try:
            self.log_fn(payload, step=record["step"])
        except Exception as e:  # noqa: BLE001 — tracker backends raise
            # anything (finished wandb run, aim db/network errors); the
            # sink contract is to disable itself, never kill training
            self._broken = True
            logger.warning("tracker sink disabled: %s", e)


class Heartbeat:
    """Tiny atomically-replaced JSON file — ``{step, time_unix, goodput,
    schema_version}`` — that the StepWatchdog's stall report and external
    orchestrators can poll to tell "alive and progressing" from "alive
    and wedged" without parsing the full metrics stream.

    Supervised runs (resilience/supervisor.py sets ``FMS_RUN_ID``) stamp
    the incarnation's ``run_id`` into every beat: the supervisor's
    crash-loop detector and the watchdog's stall report both need to
    tell a fresh incarnation's progress from the dead run's leftover
    file on shared storage. Unsupervised runs keep the exact legacy
    payload."""

    def __init__(self, path: str, run_id: Optional[str] = None):
        self.path = path
        self._broken = False
        if run_id is None:
            run_id = current_run_id()
        self.run_id = run_id or None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def beat(self, step: int, time_unix: float, goodput: float) -> None:
        if self._broken:
            return
        payload = {
            "step": int(step),
            "time_unix": float(time_unix),
            "goodput": float(goodput),
            "schema_version": SCHEMA_VERSION,
        }
        if self.run_id:
            payload["run_id"] = self.run_id
        try:
            d = os.path.dirname(os.path.abspath(self.path))
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".heartbeat.")
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(payload))
            os.replace(tmp, self.path)
        except OSError as e:
            self._broken = True
            logger.warning("heartbeat %s disabled: %s", self.path, e)


def read_heartbeat(path: str) -> Optional[Dict]:
    """Best-effort heartbeat read (for watchdog stall reports and tests);
    None when missing/unparseable."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def build_sinks(
    obs_dir: str,
    names: List[str],
    tracker_fn: Optional[Callable] = None,
) -> List[Sink]:
    """Instantiate the configured sinks. ``jsonl``/``csv`` need
    ``obs_dir``; ``tracker`` needs a live ``tracker_fn`` (rank-0 wandb/
    aim log function). Unknown names raise — a typo'd sink list must not
    silently drop the metrics stream."""
    sinks: List[Sink] = []
    for name in names:
        name = name.strip()
        if not name:
            continue
        if name == "jsonl":
            if obs_dir:
                sinks.append(JSONLSink(os.path.join(obs_dir, "metrics.jsonl")))
        elif name == "csv":
            if obs_dir:
                sinks.append(CSVSink(os.path.join(obs_dir, "metrics.csv")))
        elif name == "tracker":
            if tracker_fn is not None:
                sinks.append(TrackerSink(tracker_fn))
        else:
            raise ValueError(
                f"unknown obs sink {name!r} (expected jsonl|csv|tracker)"
            )
    return sinks
