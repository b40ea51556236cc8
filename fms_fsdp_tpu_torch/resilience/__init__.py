"""Resilience of the trainer: fault injection (``faults``), the exit-code
registry and the classified-exit wrapper (``exits``), the anomaly guard
and the step watchdog (``guards``), the run supervisor (``supervisor``),
retrying shard IO (``retry``), checkpoint manifests (``integrity``) and
the checkpoint scrubber with its verdict cache (``scrub``), the
cross-replica divergence compare (``divergence``) and the slice health
monitor with its ``SliceLostError`` (``slices``). Counterpart of
``fms_fsdp_tpu/resilience/``."""

from fms_fsdp_tpu_torch.resilience.slices import SliceHealthMonitor, SliceLostError

__all__ = ["SliceHealthMonitor", "SliceLostError"]
