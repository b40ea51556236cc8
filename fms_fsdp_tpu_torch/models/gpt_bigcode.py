"""GPTBigCode (StarCoder family): the frozen speculator base.

Counterpart of ``fms_fsdp_tpu/models/gpt_bigcode.py``, the reference's
``EmbedGPTBigCode`` base (ref:speculator/train_speculator_utils.py:430-500):
a forward that also yields the final hidden states, forward only (the
base is frozen). The params are a plain dict with JAX's names, every
layer weight stacked on a leading L axis, ``x @ W`` layouts:

    wte (V, d); wpe (P, d); ln_f_w/ln_f_b (d,)
    layers: ln1_w/ln1_b/ln2_w/ln2_b (L, d); c_attn (L, d, d + 2*hd);
            attn_proj (L, d, d); c_fc (L, d, h); mlp_proj (L, h, d)

- learned absolute position embeddings (wte + wpe);
- multi-query attention: one kv head shared by every query head, through
  ``ops/attention.py::attention`` with ``impl="xla"`` as JAX's
  (``gpt_bigcode.py:155``): no kernel sits on this model;
- the fused c_attn projection (q | k | v), the tanh GELU MLP, full
  LayerNorm with bias, the tied lm_head (logits = h @ wte^T).

``generate_simple`` is the cache-less generation by full re-forward that
the non-Llama speculator bases share (the Mixtral base uses it too).
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from fms_fsdp_tpu_torch.ops.attention import attention
from fms_fsdp_tpu_torch.ops.norms import layer_norm
from fms_fsdp_tpu_torch.utils.tree import tree_map


@dataclass(frozen=True)
class GPTBigCodeConfig:
    src_vocab_size: int = 49152
    emb_dim: int = 2048
    nheads: int = 16
    nlayers: int = 24
    hidden_grow_factor: float = 4.0
    max_expected_seq_len: int = 2048
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.emb_dim // self.nheads

    @property
    def hidden_dim(self) -> int:
        return int(self.emb_dim * self.hidden_grow_factor)


def init_gpt_bigcode_params(generator: torch.Generator, cfg: GPTBigCodeConfig,
                            dtype=torch.float32) -> Dict:
    """Initialize the param dict on ``generator``'s device: truncated
    normal (±3 std), std 0.02, norms one and zero, as the JAX init. Drawn
    in fp32 one layer at a time and cast to ``dtype``; the numbers differ
    from ``jax.random``'s."""
    device = generator.device
    d, hd, h, L = cfg.emb_dim, cfg.head_dim, cfg.hidden_dim, cfg.nlayers
    std = 0.02

    def tn(shape, stacked=True):
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out if stacked else [out]):
            buf = torch.empty(part.shape, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(buf, std=std, a=-3 * std, b=3 * std,
                                        generator=generator)
            part.copy_(buf)
        return out

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    layers = {
        "ln1_w": const((L, d), 1.0),
        "ln1_b": const((L, d), 0.0),
        # the fused MQA projection: q (d) | k (hd) | v (hd)
        "c_attn": tn((L, d, d + 2 * hd)),
        "attn_proj": tn((L, d, d)),
        "ln2_w": const((L, d), 1.0),
        "ln2_b": const((L, d), 0.0),
        "c_fc": tn((L, d, h)),
        "mlp_proj": tn((L, h, d)),
    }
    return {
        "wte": tn((cfg.src_vocab_size, d), stacked=False),
        "wpe": tn((cfg.max_expected_seq_len, d), stacked=False),
        "layers": layers,
        "ln_f_w": const((d,), 1.0),
        "ln_f_b": const((d,), 0.0),
    }


def gpt_bigcode_forward(
    params: Dict,
    tokens: torch.Tensor,
    cfg: GPTBigCodeConfig,
    *,
    compute_dtype=torch.bfloat16,
    positions: Optional[torch.Tensor] = None,
    return_embeds: bool = False,
    return_hidden: bool = False,
    **_unused,
):
    """tokens (B, S) -> logits (B, S, V) in the compute dtype; with
    ``return_embeds`` also the final hidden states (the Embed* contract),
    with ``return_hidden`` those alone (the lm_head product skipped). The
    params are cast to the compute dtype at entry, as JAX does. Other
    keywords (``attn_impl``, ``quant``) are accepted and ignored, as
    JAX's ``**_unused``: the attention is always the einsum path."""
    params = tree_map(lambda w: w.to(compute_dtype), params)
    b, s = tokens.shape
    assert s <= cfg.max_expected_seq_len, (
        f"sequence length {s} exceeds max_expected_seq_len "
        f"{cfg.max_expected_seq_len}: the wpe gather would clamp silently"
    )
    d, hd = cfg.emb_dim, cfg.head_dim
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None, :]
    x = F.embedding(tokens, params["wte"]) + params["wpe"][positions]

    layers = params["layers"]
    for i in range(layers["c_attn"].shape[0]):
        lp = {name: w[i] for name, w in layers.items()}
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        qkv = h @ lp["c_attn"]
        q = qkv[..., :d].reshape(b, s, cfg.nheads, hd)
        k = qkv[..., d:d + hd].reshape(b, s, 1, hd)
        v = qkv[..., d + hd:].reshape(b, s, 1, hd)
        o = attention(q, k, v, causal=True, impl="xla")
        x = x + o.reshape(b, s, d) @ lp["attn_proj"]
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        x = x + F.gelu(h @ lp["c_fc"], approximate="tanh") @ lp["mlp_proj"]

    embeds = layer_norm(x, params["ln_f_w"], params["ln_f_b"], cfg.ln_eps)
    if return_hidden:
        return embeds
    logits = embeds @ params["wte"].T  # the tied lm head
    if return_embeds:
        return logits, embeds
    return logits


@torch.no_grad()
def generate_simple(
    params,
    input_ids,
    cfg,
    forward_fn,
    *,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 8,
    do_sample: bool = False,
    temperature: float = 1.0,
    include_embeds: bool = False,
    **_unused,
):
    """Greedy or sampled generation by re-running ``forward_fn`` over the
    whole sequence for every new token. The sequence lives in a fixed
    (B, P+T) buffer written in place, as JAX's ``fori_loop`` does: causal
    attention keeps the trailing zeros invisible to earlier positions.
    Sampling draws from ``generator`` over the full vocabulary (no top-k),
    as JAX's. With ``include_embeds`` also returns the hidden states that
    predicted each generated token (B, T, D)."""
    b, plen = input_ids.shape
    total = plen + max_new_tokens
    toks = torch.zeros((b, total), dtype=input_ids.dtype, device=input_ids.device)
    toks[:, :plen] = input_ids
    for i in range(plen, total):
        out = forward_fn(params, toks, cfg)
        logits_all = out[0] if isinstance(out, tuple) else out
        logits = logits_all[:, i - 1]
        if do_sample:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        toks[:, i] = nxt.to(toks.dtype)
    if include_embeds:
        _, embeds = forward_fn(params, toks, cfg, return_embeds=True)
        return toks, embeds[:, plen - 1:plen - 1 + max_new_tokens]
    return toks
