"""KV-cache page storage format: per-row absmax int8 or e4m3 fp8.

Counterpart of ``fms_fsdp_tpu/ops/quant.py::kv_quantize`` /
``kv_dequantize`` (the quantized matmuls and gradient wires come with
the quantized-training slice, ROADMAP.md A.7). A row is one (position,
kv head) vector along the head dim; it stores 1-byte values plus one
fp32 scale.

- int8: scale = absmax / 127, values rounded half-to-even
  (``torch.round`` rounds as ``jnp.round`` does) and clipped to ±127.
- fp8: e4m3fn, scale = absmax / 448, values clamped to ±448 BEFORE the
  cast — e4m3fn has no infinity and overflows to NaN.
- An all-zero row gets scale 0 and stores zeros.

The absmax is divided in the input's dtype and then widened to fp32,
as the JAX expression ``(amax / 127.0).astype(float32)`` does.
"""

import torch

FP8_E4M3 = torch.float8_e4m3fn
FP8_E4M3_MAX = 448.0


def _absmax_scale(x: torch.Tensor, fmax: float):
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = (amax / fmax).float()
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    return scale, safe


def kv_quantize(x: torch.Tensor, wire: str):
    """Returns (q, scale) with scale keeping the reduced dim as 1."""
    if wire == "int8":
        scale, safe = _absmax_scale(x, 127.0)
        q = torch.round(x.float() / safe).clamp(-127, 127).to(torch.int8)
    elif wire == "fp8":
        scale, safe = _absmax_scale(x, FP8_E4M3_MAX)
        q = (x.float() / safe).clamp(-FP8_E4M3_MAX, FP8_E4M3_MAX).to(FP8_E4M3)
    else:
        raise ValueError(f"unknown kv wire: {wire!r}")
    return q, torch.where(scale == 0, torch.zeros_like(scale), scale)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    """Inverse of :func:`kv_quantize`: q * scale in fp32, cast to ``dtype``."""
    return (q.float() * scale).to(dtype)
