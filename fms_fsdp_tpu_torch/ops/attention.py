"""Attention ops.

Counterpart of ``fms_fsdp_tpu/ops/attention.py``. Two implementations
behind one dispatcher:

- ``xla_attention``: grouped-query einsum attention with an fp32 softmax,
  the JAX package's ``xla_attention``. The serving prefill calls it; it
  materialises the (B, N, Sq, Sk) scores.
- the flash kernels (``ops/flash_attention.py``): the hand-written CUDA
  forward/backward for CUDA tensors, O(S) memory, GQA native.

q: (B, S, Nq, H); k/v: (B, S, Nkv, H) with Nq % Nkv == 0. The GQA group
is folded into the query head dim, so kv heads are never repeated.
"""

from typing import Optional

import torch

from fms_fsdp_tpu_torch.ops import flash_attention as _fa

IMPLS = ("auto", "pallas", "xla")


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


def use_kernel(impl: str, q_shape, k_shape, device_type: str) -> bool:
    """Whether :func:`attention` runs the flash kernels (True) or the
    einsum path (False) for this ``impl``, these shapes and this device;
    raises where the kernels are asked for and cannot run:

    - "pallas": the kernels. ``NotImplementedError`` on shapes they do not
      take (``flash_attention.supports``) and on any but CUDA tensors;
    - "auto": the einsum path for CPU tensors, as JAX's "auto" off the
      TPU; otherwise as "pallas". Unlike JAX, a shape the kernels do not
      take raises on the card rather than falling to the einsum path, which
      would hold the (B, N, Sq, Sk) scores there: pass "xla" for that;
    - "xla": the einsum path.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}: expected one of {IMPLS}")
    if impl == "xla" or (impl == "auto" and device_type == "cpu"):
        return False
    if not _fa.supports(q_shape, k_shape):
        raise NotImplementedError(
            f"attention_kernel={impl!r} runs the flash kernels, which take "
            f"head_dim 128, sequence lengths that are multiples of 64 and Nq "
            f"a multiple of Nkv (at most {_fa.MAX_KERNEL_SEQ} keys while the "
            f"resident contract is pinned); got q{tuple(q_shape)} "
            f"k{tuple(k_shape)}. attention_kernel='xla' runs the einsum path"
        )
    if device_type != "cuda":
        raise NotImplementedError(
            f"attention_kernel={impl!r} runs the CUDA kernels and needs CUDA "
            f"tensors; got {device_type}"
        )
    return True


def attention(q, k, v, *, causal: bool = True, impl: str = "auto"):
    """Attention with JAX's ``impl`` values ("auto", "pallas", "xla"), so
    one CLI line runs both packages; :func:`use_kernel` picks the path."""
    if use_kernel(impl, q.shape, k.shape, q.device.type):
        return _fa.flash_attention(q, k, v, causal=causal)
    return xla_attention(q, k, v, causal=causal)
