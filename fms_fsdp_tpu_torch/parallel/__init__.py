"""Parallelism: the device mesh (``mesh``), the placement of the train
state over it and the data-parallel step's collectives (``sharding``),
dtype policies and the selective activation-checkpointing mask."""

from fms_fsdp_tpu_torch.parallel import mesh, sharding

__all__ = ["mesh", "sharding"]
