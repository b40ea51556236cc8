"""Normalization ops.

RMSNorm as used by the Llama family (no bias, no mean subtraction), and
the full LayerNorm (mean subtraction and bias) of the GPTBigCode base.
Statistics are computed in fp32 whatever the input dtype, then the
result is cast back (``fms_fsdp_tpu/ops/norms.py``).
"""

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """y = x / rms(x) * weight, computed in fp32, returned in x.dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    """Full LayerNorm for the GPT-family bases: fp32 statistics, the
    result in x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)
