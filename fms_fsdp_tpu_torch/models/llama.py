"""Llama-family parameters.

Counterpart of ``fms_fsdp_tpu/models/llama.py::init_llama_params``. The
params are a plain dict with every layer weight stacked on a leading L
axis and the JAX names and ``x @ W`` layouts:

    embedding (V, d); norm (d,); lm_head (d, V)
    layers: attn_norm/ffn_norm (L, d); wq (L, d, nq*hd); wk/wv
            (L, d, nkv*hd); wo (L, nq*hd, d); w1/w3 (L, d, h); w2 (L, h, d)

so ``bridge.py`` moves JAX weights in and out without a transpose.
``llama_forward`` (training) comes with the training slice (ROADMAP.md
A.2).
"""

from typing import Dict, Optional

import torch

from fms_fsdp_tpu_torch.models.configs import LlamaConfig


def init_llama_params(
    generator: torch.Generator,
    cfg: LlamaConfig,
    dtype=torch.float32,
    nlayers: Optional[int] = None,
) -> Dict:
    """Initialize the full param dict on ``generator``'s device.

    Truncated normal (±3 std) with std 0.02 everywhere, with the
    residual-output projections (wo, w2) scaled by 1/sqrt(2*nlayers)
    (GPT-2-style depth scaling), as the JAX init. The draws are fp32, one
    layer at a time, then cast to ``dtype``; the numbers differ from
    ``jax.random``'s for the same seed.
    """
    nlayers = nlayers if nlayers is not None else cfg.nlayers
    device = generator.device
    d, h, hd = cfg.emb_dim, cfg.hidden_dim, cfg.head_dim
    nq, nkv = cfg.nheads, cfg.n_kv_heads
    v = cfg.src_vocab_size
    std = 0.02
    out_std = std / (2 * nlayers) ** 0.5

    def tn(shape, s, stacked=True):
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out if stacked else [out]):
            buf = torch.empty(part.shape, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(
                buf, std=s, a=-3 * s, b=3 * s, generator=generator
            )
            part.copy_(buf)
        return out

    L = nlayers
    layers = {
        "attn_norm": torch.ones((L, d), dtype=dtype, device=device),
        "wq": tn((L, d, nq * hd), std),
        "wk": tn((L, d, nkv * hd), std),
        "wv": tn((L, d, nkv * hd), std),
        "wo": tn((L, nq * hd, d), out_std),
        "ffn_norm": torch.ones((L, d), dtype=dtype, device=device),
        "w1": tn((L, d, h), std),
        "w3": tn((L, d, h), std),
        "w2": tn((L, h, d), out_std),
    }
    return {
        "embedding": tn((v, d), std, stacked=False),
        "layers": layers,
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": tn((d, v), std, stacked=False),
    }
