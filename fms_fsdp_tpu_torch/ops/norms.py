"""Normalization ops.

RMSNorm as used by the Llama family (no bias, no mean subtraction).
Statistics are computed in fp32 whatever the input dtype, then the
result is cast back (``fms_fsdp_tpu/ops/norms.py::rms_norm``).
"""

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """y = x / rms(x) * weight, computed in fp32, returned in x.dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
