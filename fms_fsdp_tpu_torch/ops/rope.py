"""Rotary position embeddings, half-split ("rotate_half") layout.

Counterpart of ``fms_fsdp_tpu/ops/rope.py``: fp32 (S, head_dim/2) cos/sin
tables, applied to the two halves of the head dim — the HF Llama layout.
"""

from typing import Optional

import torch


def rope_table(seq_len: int, head_dim: int, theta: float = 10000.0,
               device=None, offset: int = 0):
    """Return (cos, sin), each (seq_len, head_dim // 2), fp32, for the
    positions offset .. offset + seq_len - 1 (a context rank's part of the
    sequence: the same rows as the whole table's)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = 1.0 / (theta ** exponent)
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(pos, freqs)  # (S, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 positions: Optional[torch.Tensor] = None):
    """Apply half-split rotary embedding.

    x: (..., S, n_heads, head_dim); cos/sin: (S_table, head_dim/2) fp32.
    positions: optional (..., S) integer positions into the table (decode
    time); default = arange(S).
    """
    if positions is None:
        seq_len = x.shape[-3]
        c = cos[:seq_len][:, None, :]  # (S, 1, half), broadcast over heads
        s = sin[:seq_len][:, None, :]
    else:
        c = cos[positions][..., None, :]
        s = sin[positions][..., None, :]
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
