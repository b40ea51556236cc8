"""Async multi-tier checkpointing.

``AsyncCheckpointManager`` takes a blocking device-to-host snapshot at the
step boundary and commits payload + manifest + metadata from a background
writer thread, with at most one save in flight and a mandatory
``finalize()`` on loop exit. ``utils.checkpointing.Checkpointer`` remains
as the synchronous layer (and the per-tier backend).
"""

from fms_fsdp_tpu_torch.ckpt.elastic import (
    check_rescale,
    current_fingerprint,
    topology_digest,
)
from fms_fsdp_tpu_torch.ckpt.manager import (
    AsyncCheckpointManager,
    CheckpointTier,
    build_checkpoint_manager,
)

__all__ = [
    "AsyncCheckpointManager",
    "CheckpointTier",
    "build_checkpoint_manager",
    "check_rescale",
    "current_fingerprint",
    "topology_digest",
]
