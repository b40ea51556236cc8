"""Observability: the metric registry, step-phase timing, goodput and MFU
accounting, the sinks (metrics.jsonl, metrics.csv, the tracker adapter),
the heartbeat, and the ``Observer`` the train loop drives.

Counterpart of ``fms_fsdp_tpu/obs/``, host code only: its inputs are host
timestamps and the metric scalars the loop fetches once per report
interval. The collective probe of multi-slice runs waits for ROADMAP.md
A.6b.
"""

from fms_fsdp_tpu_torch.obs.observer import Observer, build_observer
from fms_fsdp_tpu_torch.obs.registry import MetricRegistry
from fms_fsdp_tpu_torch.obs.schema import (
    SCHEMA_VERSION,
    schema_digest,
    validate_record,
)
from fms_fsdp_tpu_torch.obs.sinks import (
    CSVSink,
    Heartbeat,
    JSONLSink,
    TrackerSink,
)
from fms_fsdp_tpu_torch.obs.timing import GoodputTracker, PhaseTimer

__all__ = [
    "Observer",
    "build_observer",
    "MetricRegistry",
    "SCHEMA_VERSION",
    "schema_digest",
    "validate_record",
    "JSONLSink",
    "CSVSink",
    "TrackerSink",
    "Heartbeat",
    "PhaseTimer",
    "GoodputTracker",
]
