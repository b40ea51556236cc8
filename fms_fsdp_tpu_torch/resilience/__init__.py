"""Resilience of the trainer: fault injection (``faults``), the exit-code
registry and the classified-exit wrapper (``exits``), the anomaly guard
and the step watchdog (``guards``), the run supervisor (``supervisor``),
retrying shard IO (``retry``), checkpoint manifests (``integrity``) and
the checkpoint scrubber with its verdict cache (``scrub``) and the
cross-replica divergence compare (``divergence``). Counterpart of
``fms_fsdp_tpu/resilience/``; the slice monitor waits for ROADMAP.md
A.6b."""
