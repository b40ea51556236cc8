"""Kernel tuning: measured tile selection with a persistent per-card
tuning table.

Counterpart of ``fms_fsdp_tpu/tune/``, three layers:

- :mod:`candidates` -- enumerate the legal tile configs per kernel and
  prune them statically against a block's shared memory on the card (the
  kernels' own byte counts; no device, no timing);
- :mod:`table` -- the schema-versioned JSON tuning table committed in the
  package (``kernel_tuning_h100.json``), keyed by (kernel, shape
  signature, dtype, chip kind);
- :mod:`lookup` -- resolution wired into ``ops/flash_attention.py``,
  ``ops/ssd.py``, the train step's fused CE and the serving engine's paged
  decode (``resolve_paged_decode``, answered once at engine build): exact
  table match first, nearest signature next, the static defaults last.
  Pure table + cost model: the lookup path never times anything.

The sweep on the card that fills the table is
``scripts/torch_autotune_kernels.py``.
"""

from fms_fsdp_tpu_torch.tune.lookup import (  # noqa: F401
    attach_registry,
    choices,
    configure_kernel_tuning,
    resolve_ce_chunk,
    resolve_flash,
    resolve_paged_decode,
    resolve_ssd_chunk,
)
from fms_fsdp_tpu_torch.tune.table import (  # noqa: F401
    TUNING_SCHEMA_VERSION,
    TuningTable,
    default_table_path,
    validate_table,
)
