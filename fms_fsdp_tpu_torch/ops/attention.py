"""Prefill attention: grouped-query einsum attention with an fp32 softmax.

Counterpart of ``fms_fsdp_tpu/ops/attention.py::xla_attention``, which
the JAX serving prefill calls with ``impl="xla"`` — it runs outside any
Pallas kernel there, so plain PyTorch is its faithful port. The flash
kernels that serve training come with the training slice (ROADMAP.md
A.2).

q: (B, S, Nq, H); k/v: (B, S, Nkv, H) with Nq % Nkv == 0. The GQA group
is folded into the query head dim, so kv heads are never repeated.
"""

from typing import Optional

import torch


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None):
    """Reference einsum attention with an fp32 softmax; returns q's dtype."""
    b, sq, nq, h = q.shape
    nkv = k.shape[2]
    scale = scale if scale is not None else h**-0.5
    group = nq // nkv
    qg = q.reshape(b, sq, nkv, group, h)
    # fp32 operands: exact products of the compute-dtype values with an
    # fp32 sum, as preferred_element_type=float32 asks of XLA
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    if causal:
        sk = k.shape[1]
        # top-left alignment for sq != sk: query i attends keys <= i
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, nq, h)
