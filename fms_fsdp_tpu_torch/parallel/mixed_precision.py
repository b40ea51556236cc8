"""Mixed precision (dtype) policies.

Counterpart of ``fms_fsdp_tpu/parallel/mixed_precision.py``, with torch
dtypes. The presets of the reference's FSDP ``MixedPrecision``
(ref:fms_fsdp/policies/mixed_precision.py:5-27):

- ``bfSixteen``: params and Adam moments fp32, the forward and backward
  on a bf16 copy, so gradients come out bf16 and are upcast per leaf for
  the update;
- ``bfSixteen_working``: params genuinely bf16;
- ``fpSixteen``: the fp16 variant;
- ``fp32_policy``: everything fp32.

``reduce_dtype`` is recorded for parity; on one card there is no
cross-device reduction. ``reduce_quant`` other than "none" is the
quantized gradient reduce, not ported yet (ROADMAP.md A.7).
"""

from dataclasses import dataclass

import torch

REDUCE_QUANT_MODES = ("none", "int8", "fp8", "fp8_delayed")


@dataclass(frozen=True)
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32  # storage (and optimizer) dtype
    compute_dtype: torch.dtype = torch.bfloat16  # matmul / activation dtype
    reduce_dtype: torch.dtype = torch.bfloat16  # gradient reduction dtype
    reduce_quant: str = "none"


bfSixteen = DtypePolicy(torch.float32, torch.bfloat16, torch.bfloat16)
bfSixteen_working = DtypePolicy(torch.bfloat16, torch.bfloat16, torch.float32)
fpSixteen = DtypePolicy(torch.float32, torch.float16, torch.float16)
fp32_policy = DtypePolicy(torch.float32, torch.float32, torch.float32)


def get_dtype_policy(cfg) -> DtypePolicy:
    """train config -> policy, as JAX: fp32 without ``mixed_precision``,
    bfSixteen_working with ``pure_bf16``, else bfSixteen."""
    rq = getattr(cfg, "quantized_reduce", "none") or "none"
    if rq not in REDUCE_QUANT_MODES:
        raise ValueError(f"quantized_reduce={rq!r}: expected one of {REDUCE_QUANT_MODES}")
    if rq != "none":
        raise NotImplementedError(
            f"quantized_reduce={rq!r} is not ported yet: ROADMAP.md A.7"
        )
    if not getattr(cfg, "mixed_precision", True):
        return fp32_policy
    if getattr(cfg, "pure_bf16", False):
        return bfSixteen_working
    return bfSixteen
