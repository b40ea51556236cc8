"""The Observer facade the train loop drives.

Counterpart of ``fms_fsdp_tpu/obs/observer.py``. One object owns the
registry, phase timer, goodput tracker, sinks and heartbeat. The loop
touches it in three ways:

- ``wrap_data_iter(it)`` — times each ``next()`` as ``data_wait``;
- ``phase(name)`` — context manager around the step (``compute``) and
  saves (``checkpoint``);
- ``report(...)`` — once per report interval: folds the phase window,
  skipped-step counts and MFU/HFU into a schema-validated record and fans
  it out to every sink and the heartbeat.

Ranks other than 0 get the same timer and registry but no sinks. MFU and
HFU are against the card's peak (``utils/flops.py::peak_flops_per_card``)
and only on a card. The multi-slice collective split and the DCN overlap
estimate (``ici_collective_s``, ``dcn_collective_s``, ``dcn_overlap_frac``)
stay 0.0: the port has no slices and no collective probe yet (ROADMAP.md
A.6b). The trainer's records carry the world's ``process_count`` in
``extra``.
"""

import logging
import math
import os
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

from fms_fsdp_tpu_torch.obs.registry import MetricRegistry
from fms_fsdp_tpu_torch.obs.schema import SCHEMA_VERSION, validate_record
from fms_fsdp_tpu_torch.obs.sinks import Heartbeat, Sink, build_sinks
from fms_fsdp_tpu_torch.obs.timing import GoodputTracker, PhaseTimer
from fms_fsdp_tpu_torch.resilience.exits import read_restart_ledger
from fms_fsdp_tpu_torch.tune.lookup import attach_registry

logger = logging.getLogger(__name__)


def _nonfinite(v) -> bool:
    return isinstance(v, float) and not math.isfinite(v)


class Observer:
    def __init__(
        self,
        sinks: Optional[List[Sink]] = None,
        heartbeat: Optional[Heartbeat] = None,
        flops_per_token: Optional[float] = None,
        hfu_flops_per_token: Optional[float] = None,
        peak_flops: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        strict_schema: bool = False,
        kernel_tuning: Optional[str] = None,
        quantized_matmuls: Optional[str] = None,
        quantized_reduce: Optional[str] = None,
        restarts: int = 0,
        restart_downtime_s: float = 0.0,
    ):
        self.registry = MetricRegistry()
        # the step's build modes, stated in every record
        self.kernel_tuning = kernel_tuning
        self.quantized_matmuls = quantized_matmuls
        self.quantized_reduce = quantized_reduce
        self.timer = PhaseTimer(clock=clock)
        # the supervisor's restart accounting: the downtime is charged
        # into the goodput wall clock
        self.restarts = int(restarts)
        self.restart_downtime_s = float(restart_downtime_s)
        self.goodput = GoodputTracker(
            restart_downtime_s=self.restart_downtime_s
        )
        self.sinks = sinks or []
        self.heartbeat = heartbeat
        self.flops_per_token = flops_per_token
        self.hfu_flops_per_token = hfu_flops_per_token
        self.peak_flops = peak_flops
        self.strict_schema = strict_schema
        self.last_record: Optional[Dict] = None
        self._schema_warned = False
        # set by the async checkpoint manager when the loop attaches this
        # observer to it: drains the background-write window ({bg_s,
        # in_flight}) for checkpoint_bg_s / checkpoint_in_flight
        self._ckpt_stats: Optional[Callable[[], Dict]] = None
        # set by the loop: drains the verification window for
        # integrity_verify_s / scrub_verified / divergence_checks
        self._integrity_stats: Optional[Callable[[], Dict]] = None

    def attach_checkpoint_stats(self, fn: Callable[[], Dict]) -> None:
        self._ckpt_stats = fn

    def attach_integrity_stats(self, fn: Callable[[], Dict]) -> None:
        self._integrity_stats = fn

    # -- hot-loop hooks ----------------------------------------------------

    def phase(self, name: str):
        return self.timer.phase(name)

    def wrap_data_iter(self, it: Iterable) -> Iterator:
        """Yield from ``it`` with each ``next()`` timed as data_wait."""
        it = iter(it)
        while True:
            try:
                with self.timer.phase("data_wait"):
                    item = next(it)
            except StopIteration:
                return
            yield item

    # -- report cadence ----------------------------------------------------

    def report(
        self,
        step: int,
        steps_in_window: int,
        *,
        loss: float,
        tokens_per_sec_per_chip: float,
        skipped_steps_total: int = 0,
        skipped_steps_window: int = 0,
        grad_norm: Optional[float] = None,
        learning_rate: Optional[float] = None,
        tokens_seen: Optional[int] = None,
        tokens_per_sec_per_chip_overall: Optional[float] = None,
        step_time_s: Optional[float] = None,
        memory_reserved_bytes: Optional[int] = None,
        memory_allocated_bytes: Optional[int] = None,
        data_mix: Optional[Dict[str, float]] = None,
        serving: Optional[Dict[str, float]] = None,
        serving_fleet: Optional[Dict[str, float]] = None,
        extra: Optional[Dict[str, float]] = None,
    ) -> Dict:
        """Close the phase window, derive goodput/MFU, emit to sinks.

        Returns the record (also kept as ``last_record``)."""
        window = self.timer.window()
        goodput_w, goodput_all = self.goodput.update(
            window, steps_in_window, skipped_steps_window
        )
        mfu = hfu = None
        if self.flops_per_token and self.peak_flops:
            achieved = tokens_per_sec_per_chip * self.flops_per_token
            mfu = achieved / self.peak_flops
            if self.hfu_flops_per_token:
                hfu = (
                    tokens_per_sec_per_chip
                    * self.hfu_flops_per_token
                    / self.peak_flops
                )
        # both providers flush counters into the registry on this (the
        # main) thread, so they run BEFORE the snapshot: the writer's
        # committed saves and the scrubber's detections land in this
        # record's extras
        ckpt_stats = self._ckpt_stats() if self._ckpt_stats else {}
        integ = self._integrity_stats() if self._integrity_stats else {}
        extras = dict(self.registry.snapshot())
        if extra:
            extras.update(extra)
        wall = window["wall"]
        record = {
            "schema_version": SCHEMA_VERSION,
            "step": int(step),
            "time_unix": time.time(),
            "loss": float(loss),
            "grad_norm": None if grad_norm is None else float(grad_norm),
            "learning_rate": (
                None if learning_rate is None else float(learning_rate)
            ),
            "tokens_seen": None if tokens_seen is None else int(tokens_seen),
            "tokens_per_sec_per_chip": float(tokens_per_sec_per_chip),
            "tokens_per_sec_per_chip_overall": (
                None
                if tokens_per_sec_per_chip_overall is None
                else float(tokens_per_sec_per_chip_overall)
            ),
            "step_time_s": (
                None if step_time_s is None else float(step_time_s)
            ),
            "mfu": mfu,
            "hfu": hfu,
            "data_wait_s": window["data_wait"],
            "data_wait_frac": (
                window["data_wait"] / wall if wall > 0 else 0.0
            ),
            "compute_s": window["compute"],
            "checkpoint_s": window["checkpoint"],
            "checkpoint_bg_s": float(ckpt_stats.get("bg_s", 0.0)),
            "checkpoint_in_flight": int(ckpt_stats.get("in_flight", 0)),
            "ici_collective_s": window.get("ici_collective", 0.0),
            "dcn_collective_s": window.get("dcn_collective", 0.0),
            "dcn_overlap_frac": 0.0,
            "integrity_verify_s": float(integ.get("verify_s", 0.0)),
            "scrub_verified": int(integ.get("scrub_verified", 0)),
            "divergence_checks": int(integ.get("divergence_checks", 0)),
            "wall_s": wall,
            "goodput": goodput_w,
            "goodput_overall": goodput_all,
            "skipped_steps": int(skipped_steps_total),
            "skipped_steps_window": int(skipped_steps_window),
            "restarts": self.restarts,
            "restart_downtime_s": self.restart_downtime_s,
            "data_mix": dict(data_mix) if data_mix else None,
            "serving": dict(serving) if serving else None,
            "serving_fleet": (
                dict(serving_fleet) if serving_fleet else None
            ),
            "kernel_tuning": self.kernel_tuning,
            "quantized_matmuls": self.quantized_matmuls,
            "quantized_reduce": self.quantized_reduce,
            "memory_reserved_bytes": (
                None
                if memory_reserved_bytes is None
                else int(memory_reserved_bytes)
            ),
            "memory_allocated_bytes": (
                None
                if memory_allocated_bytes is None
                else int(memory_allocated_bytes)
            ),
            "extra": extras,
        }
        # non-finite scalars become null: a bare NaN would make the JSONL
        # line unparseable by strict parsers exactly when it matters
        record = {
            k: (None if _nonfinite(v) else v) for k, v in record.items()
        }
        record["extra"] = {
            k: (None if _nonfinite(v) else v) for k, v in extras.items()
        }
        errs = validate_record(record)
        if errs:
            if self.strict_schema:
                raise ValueError(f"metrics record violates schema: {errs}")
            if not self._schema_warned:
                self._schema_warned = True
                logger.warning(
                    "metrics record violates schema (emitting anyway; "
                    "set obs_strict_schema=True to raise): %s", errs
                )
        self.last_record = record
        for sink in self.sinks:
            sink.emit(record)
        if self.heartbeat:
            self.heartbeat.beat(step, record["time_unix"], goodput_w)
        return record

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()


def build_observer(
    cfg,
    rank: int,
    model_cfg=None,
    tracker_fn: Optional[Callable] = None,
    clock: Callable[[], float] = time.monotonic,
    device=None,
) -> Observer:
    """Build the Observer from TrainConfig knobs.

    File sinks and the heartbeat attach only on rank 0 and only when
    ``cfg.obs_dir`` is set; the tracker sink attaches whenever a live
    ``tracker_fn`` exists. MFU/HFU need ``model_cfg`` (the FLOPs model)
    and a CUDA ``device`` (the card's peak); else they are null.
    ``obs_chip_hint`` names a TPU generation in the JAX package and is
    refused here: the peak is the card's own.
    """
    import torch

    if getattr(cfg, "obs_chip_hint", ""):
        raise ValueError(
            f"obs_chip_hint={cfg.obs_chip_hint!r} names a TPU generation for "
            f"the JAX package's MFU peak; the port reads the peak of the card "
            f"it runs on (utils/flops.py::peak_flops_per_card)"
        )
    obs_dir = getattr(cfg, "obs_dir", "") or ""
    names = [
        s for s in (getattr(cfg, "obs_sinks", "jsonl") or "").split(",") if s
    ]
    # the tracker rides as a sink whenever configured
    if tracker_fn is not None and "tracker" not in [n.strip() for n in names]:
        names.append("tracker")
    sinks = build_sinks(obs_dir if rank == 0 else "", names, tracker_fn)
    heartbeat = None
    if rank == 0 and obs_dir and getattr(cfg, "obs_heartbeat", True):
        heartbeat = Heartbeat(os.path.join(obs_dir, "heartbeat.json"))

    flops = hfu_flops = peak = None
    if model_cfg is not None:
        from fms_fsdp_tpu_torch.models import get_model_api
        from fms_fsdp_tpu_torch.parallel.ac import selective_ac_mask
        from fms_fsdp_tpu_torch.utils.flops import (
            peak_flops_per_card,
            train_flops_per_token,
        )

        flops = train_flops_per_token(model_cfg, cfg.seq_length)
        ac_actual = 0.0
        if cfg.fsdp_activation_checkpointing:
            mask = selective_ac_mask(
                get_model_api(model_cfg)[2], cfg.selective_checkpointing
            )
            ac_actual = sum(mask) / len(mask)
        hfu_flops = train_flops_per_token(
            model_cfg, cfg.seq_length, ac_fraction=ac_actual
        )
        if device is not None and torch.device(device).type == "cuda":
            peak = peak_flops_per_card(torch.cuda.get_device_name(device))

    ledger = read_restart_ledger() or {}
    obs = Observer(
        sinks=sinks,
        heartbeat=heartbeat,
        flops_per_token=flops,
        hfu_flops_per_token=hfu_flops,
        peak_flops=peak,
        clock=clock,
        strict_schema=bool(getattr(cfg, "obs_strict_schema", False)),
        kernel_tuning=getattr(cfg, "kernel_tuning", None),
        quantized_matmuls=getattr(cfg, "quantized_matmuls", None),
        quantized_reduce=getattr(cfg, "quantized_reduce", None),
        restarts=int(ledger.get("restarts", 0) or 0),
        restart_downtime_s=float(ledger.get("restart_downtime_s", 0.0) or 0.0),
    )
    # resolved kernel tiles (kernel.tune.* gauges) land in this observer's
    # registry; choices recorded before the attach are replayed
    attach_registry(obs.registry)
    return obs
