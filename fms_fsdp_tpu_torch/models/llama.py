"""Llama-family parameters.

Counterpart of ``fms_fsdp_tpu/models/llama.py::init_llama_params``. The
params are a plain dict with every layer weight stacked on a leading L
axis and the JAX names and ``x @ W`` layouts:

    embedding (V, d); norm (d,); lm_head (d, V)
    layers: attn_norm/ffn_norm (L, d); wq (L, d, nq*hd); wk/wv
            (L, d, nkv*hd); wo (L, nq*hd, d); w1/w3 (L, d, h); w2 (L, h, d)

so ``bridge.py`` moves JAX weights in and out without a transpose.

``llama_forward`` is the training forward of
``fms_fsdp_tpu/models/llama.py:178``: RMSNorm, rotary, GQA attention
through ``ops/attention.py::attention`` (the flash kernels on the card),
SwiGLU, untied lm_head, with selective activation checkpointing by
``torch.utils.checkpoint``. With ``ring`` (a context exchange of
``ops/ring_attention.py``, more than one rank) the tokens are this
rank's part of the sequence: rotary runs at the part's positions and the
attention is ring attention, as JAX's under a context axis
(``llama.py:138-143``). ``quant`` routes wq, wk, wv, wo, w1, w3 and w2
through ``ops/quant.py::matmul`` (int8 / fp8); the lm_head stays 16-bit,
as in JAX. ``params["layers"]`` may also be a sequence of
per-layer dicts (the train step differentiates such per-layer leaves, so
no gradient is scattered into a stacked tensor); a data-parallel step
passes one that gathers a layer's weights when it is indexed
(``parallel/sharding.py::GatheredLayers``), and a checkpointed layer
indexes it inside its checkpoint, so its recomputed forward gathers
again instead of keeping the weights.

With ``tp`` (``parallel/tensor.py::TensorParallel``, more than one rank)
the layers are this rank's blocks of JAX's Megatron layout
(``fms_fsdp_tpu/models/llama.py:129,172,249``): wq, wk, wv, w1 and w3 by
columns, wo and w2 by rows with a reduce after each, the norms whole,
the embedding's rows and the lm_head's columns by vocabulary. The
attention runs on this rank's heads, or on all of them under JAX's GQA
guard (``ops/attention.py::project_qkv``); the logits are this rank's
vocabulary block, which the loss reduces over tensor
(``ops/fused_ce.py``). A leaf the tensor extent does not divide is whole
and its product is whole compute on every rank.
"""

import functools
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.obs.scopes import scoped
from fms_fsdp_tpu_torch.ops.attention import attention, project_out, project_qkv
from fms_fsdp_tpu_torch.ops.norms import rms_norm
from fms_fsdp_tpu_torch.ops.ring_attention import ring_attention
from fms_fsdp_tpu_torch.ops.rope import apply_rotary, rope_table
from fms_fsdp_tpu_torch.parallel.sharding import ServeLayers
from fms_fsdp_tpu_torch.parallel.tensor import column_linears, is_split, row_linear
from fms_fsdp_tpu_torch.utils.tree import tree_map


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


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@scoped("attn")
def attention_block(x, layer: Dict, cfg, cos, sin, *, attn_impl: str,
                    quant: str = "none", ring=None, tp=None):
    """x + Attn(RMS(x)), the attention half of a Llama block. ``layer``
    holds attn_norm / wq / wk / wv / wo, already in the compute dtype
    (under ``tp`` this rank's blocks); ``ring`` a context exchange (ring
    attention) or None."""
    hd = cfg.head_dim
    nq, nkv = cfg.nheads, cfg.n_kv_heads
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q, k, v, local = project_qkv(h, layer["wq"], layer["wk"], layer["wv"], nq, nkv, hd,
                                 tp, quant)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    if ring is not None and ring.cp > 1:
        o = ring_attention(q, k, v, ring, causal=True, impl=attn_impl)
    else:
        o = attention(q, k, v, causal=True, impl=attn_impl)
    return x + project_out(o, layer["wo"], nq, hd, tp, local, quant)


def swiglu(h, w1, w3, w2, hidden: int, tp=None, quant: str = "none", expert: bool = False):
    """SwiGLU(h) = (silu(h @ w1) * (h @ w3)) @ w2 in ``quant`` (per expert
    with ``expert``); under ``tp`` w1 and w3 split by columns and w2 by
    rows, reduced after (each whole where the tensor extent does not
    divide ``hidden``)."""
    (gate, up), split = column_linears(h, (w1, w3), (hidden, hidden), tp, quant, expert)
    return row_linear(F.silu(gate) * up, w2, hidden, tp, split[0], quant, expert)


def _llama_block(x, layer: Dict, cfg: LlamaConfig, cos, sin, *, attn_impl: str,
                 quant: str = "none", ring=None, tp=None):
    """One decoder block: x + Attn(RMS(x)); then x + SwiGLU(RMS(x))."""
    x = attention_block(x, layer, cfg, cos, sin, attn_impl=attn_impl, quant=quant,
                        ring=ring, tp=tp)
    with record_function("ffn"):
        h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        return x + swiglu(h, layer["w1"], layer["w3"], layer["w2"], cfg.hidden_dim, tp,
                          quant)


def embed(table, tokens, vocab: int, tp=None):
    """The token embedding: under ``tp`` a vocabulary-split table's
    clamp / select / sum (``parallel/tensor.py::TensorParallel.embed``)."""
    if is_split(tp, table.shape[0], vocab):
        return tp.embed(table, tokens)
    return F.embedding(tokens, table)


def lm_head(x, w, vocab: int, tp=None):
    """x @ lm_head: under ``tp`` a vocabulary-split lm_head gives this
    rank's block of the logits, its input entering the parallel region."""
    if is_split(tp, w.shape[-1], vocab):
        x = tp.enter(x)
    return x @ w


def _indexed_block(x, *, layers, i: int, **kwargs):
    return _llama_block(x, layer_params(layers, i), **kwargs)


def layer_params(layers, i: int) -> Dict:
    """Layer ``i`` of stacked (L, ...) params, or of a per-layer sequence;
    of a serving replica's fsdp-split layers, gathered
    (``parallel/sharding.py::ServeLayers``)."""
    if isinstance(layers, ServeLayers):
        return layers.layer(i)
    if isinstance(layers, dict):
        return {name: w[i] for name, w in layers.items()}
    return layers[i]


def n_layers_of(params) -> int:
    layers = params["layers"]
    if isinstance(layers, dict):
        return layers["wq"].shape[0]
    return len(layers)


def llama_forward(
    params: Dict,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    *,
    compute_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    ac_mask: Optional[List[bool]] = None,
    scan_layers: bool = True,
    return_embeds: bool = False,
    return_hidden: bool = False,
    quant: str = "none",
    ring=None,
    tp=None,
):
    """tokens (B, S) integer -> logits (B, S, V) in the compute dtype
    (under ``tp`` with a split lm_head, this rank's (B, S, V / tp) block).

    The params are cast to the compute dtype at entry (a no-op for leaves
    already in it), as JAX does (``llama.py:201``). Layers whose
    ``ac_mask`` entry is True run under ``torch.utils.checkpoint``
    (non-reentrant): their activations are recomputed in the backward.
    ``scan_layers`` has no effect (the stack is a Python loop).
    ``return_hidden`` returns the final normed hidden states instead of
    logits (the fused-CE input); ``return_embeds`` returns (logits,
    hidden). Logits are not upcast: the loss upcasts inside its
    reductions.
    """
    del scan_layers
    nlayers = n_layers_of(params)
    params = tree_map(lambda w: w.to(compute_dtype), params)
    with record_function("embed"):
        x = embed(params["embedding"], tokens, cfg.src_vocab_size, tp)
    seq_len = tokens.shape[1]
    offset = ring.seq_offset(seq_len) if ring is not None else 0
    cos, sin = rope_table(seq_len, cfg.head_dim, cfg.rope_theta, device=tokens.device,
                          offset=offset)
    ac_mask = ac_mask if ac_mask is not None else [False] * nlayers
    if len(ac_mask) != nlayers:
        raise ValueError(f"ac_mask has {len(ac_mask)} entries for {nlayers} layers")
    for i in range(nlayers):
        block = functools.partial(
            _indexed_block, layers=params["layers"], i=i, cfg=cfg,
            cos=cos, sin=sin, attn_impl=attn_impl, quant=quant, ring=ring, tp=tp,
        )
        if ac_mask[i]:
            x = checkpoint(block, x, use_reentrant=False)
        else:
            x = block(x)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    if return_hidden:
        return x
    with record_function("lm_head"):
        logits = lm_head(x, params["lm_head"], cfg.src_vocab_size, tp)
    if return_embeds:
        return logits, x
    return logits
