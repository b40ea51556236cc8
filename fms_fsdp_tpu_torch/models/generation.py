"""Prefill and cached decode for the Llama family.

Counterpart of ``fms_fsdp_tpu/models/generation.py``: ``prefill``,
``decode_layer_qkv`` / ``decode_layer_out`` (shared with the paged decode
step in ``serve/decode.py``, so both run the same ops), ``decode_chunk``,
``decode_step``, ``sample_token`` and ``generate``, the kv-cached
generation that feeds the speculator's second training stage. JAX's
``lax.scan`` over the generated tokens is a Python loop here.

The JAX functions cast the params to the compute dtype on every call,
which costs nothing under ``jit``. Eagerly, at 8B, it would be 16 GB of
casts per token, so here the caller casts once (the serving engine does
at build) and these functions raise if the params are in another dtype.

The dense cache is a dict {"k", "v"} of (L, B, S_max, Nkv, H) tensors.
The layer loop is a Python loop over the stacked L axis.

Under tensor parallelism (``tp``, ``parallel/tensor.py``: the frozen base
of the speculator's ``"tp"`` strategy) the params are this rank's blocks
of the Megatron layout, as the training forward's (``models/llama.py``):
the projections on this rank's heads (or all of them under the GQA
guard), the cache of its KV heads, the FFN's blocks reduced over tensor,
and the logits gathered whole over tensor before sampling, so every
tensor rank draws the same tokens from the same generator.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.models.llama import embed, lm_head, swiglu
from fms_fsdp_tpu_torch.ops.attention import (
    heads_split,
    project_out,
    project_qkv,
    xla_attention,
)
from fms_fsdp_tpu_torch.ops.norms import rms_norm
from fms_fsdp_tpu_torch.ops.paged_attention import gqa_attend
from fms_fsdp_tpu_torch.ops.rope import apply_rotary, rope_table


def check_params_dtype(params, compute_dtype) -> None:
    """Raise unless the params are already in ``compute_dtype``."""
    if params["embedding"].dtype != compute_dtype:
        raise ValueError(
            f"params are {params['embedding'].dtype}, compute dtype is "
            f"{compute_dtype}: cast them once before decoding"
        )


def layer_params(params, i: int):
    """Layer i's weights: views into the stacked (L, ...) tensors."""
    return {name: w[i] for name, w in params["layers"].items()}


def _rope(cfg: LlamaConfig, seq_len: int, device, rope: Optional[Tuple]):
    if rope is not None:
        return rope
    return rope_table(seq_len, cfg.head_dim, cfg.rope_theta, device=device)


def _ffn(x, layer, cfg: LlamaConfig, tp=None):
    h2 = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
    if tp is None:
        # serving's path: the products direct, no tensor bookkeeping
        return (F.silu(h2 @ layer["w1"]) * (h2 @ layer["w3"])) @ layer["w2"]
    return swiglu(h2, layer["w1"], layer["w3"], layer["w2"], cfg.hidden_dim, tp)


def _logits(x, params, cfg: LlamaConfig, tp=None):
    """x @ lm_head, whole: under ``tp`` a vocabulary block gathered."""
    if tp is None or params["lm_head"].shape[-1] == cfg.src_vocab_size:
        return x @ params["lm_head"]
    return tp.gather(lm_head(x, params["lm_head"], cfg.src_vocab_size, tp), -1)


def _qkv(h, layer, cfg: LlamaConfig, tp):
    """(q, k, v, heads local) of one layer: under ``tp`` this rank's
    heads, or all of them under the GQA guard."""
    if tp is None:
        b, m = h.shape[:2]
        hd, nkv = cfg.head_dim, cfg.n_kv_heads
        return ((h @ layer["wq"]).reshape(b, m, cfg.nheads, hd),
                (h @ layer["wk"]).reshape(b, m, nkv, hd),
                (h @ layer["wv"]).reshape(b, m, nkv, hd), False)
    return project_qkv(h, layer["wq"], layer["wk"], layer["wv"], cfg.nheads,
                       cfg.n_kv_heads, cfg.head_dim, tp)


def _out(o, layer, cfg: LlamaConfig, tp, local: bool):
    """The attention output ``o`` (B, m, heads, hd or heads * hd) @ wo;
    under ``tp`` reduced over tensor where ``local``."""
    if tp is None:
        return o.reshape(*o.shape[:2], -1) @ layer["wo"]
    return project_out(o, layer["wo"], cfg.nheads, cfg.head_dim, tp, local)


def prefill(
    params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    max_seq_len: int,
    compute_dtype=torch.bfloat16,
    full_logits: bool = False,
    rope: Optional[Tuple] = None,
    tp=None,
):
    """Run the prompt through the model, building the kv cache.

    tokens (B, S) integer. Returns (logits, embeds (B, S, D), cache).
    ``logits`` covers only the final position (B, 1, V) unless
    ``full_logits``. The cache holds max_seq_len positions; positions
    >= S are zeros. ``rope`` is an optional precomputed (cos, sin) table
    of at least max_seq_len rows.
    """
    check_params_dtype(params, compute_dtype)
    b, s = tokens.shape
    hd, nkv = cfg.head_dim, cfg.n_kv_heads
    nlayers = params["layers"]["wq"].shape[0]
    cos, sin = _rope(cfg, max_seq_len, tokens.device, rope)
    x = embed(params["embedding"], tokens, cfg.src_vocab_size, tp)
    # the KV heads this rank holds
    local_nkv = nkv // tp.size if heads_split(cfg.nheads, nkv, tp) else nkv
    cache_shape = (nlayers, b, max_seq_len, local_nkv, hd)
    k_cache = torch.zeros(cache_shape, dtype=compute_dtype, device=tokens.device)
    v_cache = torch.zeros_like(k_cache)
    for i in range(nlayers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v, local = _qkv(h, layer, cfg, tp)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        o = xla_attention(q, k, v, causal=True)
        x = x + _out(o, layer, cfg, tp, local)
        x = x + _ffn(x, layer, cfg, tp)
        k_cache[i, :, :s] = k
        v_cache[i, :, :s] = v
    embeds = rms_norm(x, params["norm"], cfg.norm_eps)
    src = embeds if full_logits else embeds[:, -1:]
    logits = _logits(src, params, cfg, tp)
    return logits, embeds, {"k": k_cache, "v": v_cache}


def decode_layer_qkv(x, layer, cfg: LlamaConfig, cos, sin, positions, tp=None):
    """Pre-attention half of one decode layer: norm -> q/k/v projections
    -> rotary at ``positions`` (B, m); under ``tp`` this rank's heads, or
    all of them under the GQA guard."""
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q, k, v, _ = _qkv(h, layer, cfg, tp)
    q = apply_rotary(q, cos, sin, positions)
    k = apply_rotary(k, cos, sin, positions)
    return q, k, v


def decode_layer_out(x, layer, cfg: LlamaConfig, o, tp=None):
    """Post-attention half of one decode layer: residual + SwiGLU FFN.
    ``o`` is (B, m, heads * hd); under ``tp`` of this rank's heads when
    they split (``ops/attention.py::heads_split``)."""
    local = o.shape[-1] != cfg.nheads * cfg.head_dim
    x = x + _out(o, layer, cfg, tp, local)
    return x + _ffn(x, layer, cfg, tp)


def decode_chunk(params, cache, tokens, pos: int, cfg: LlamaConfig,
                 compute_dtype=torch.bfloat16, rope: Optional[Tuple] = None, tp=None):
    """Cached decode of m tokens at positions pos..pos+m-1 in one forward.
    Updates ``cache`` in place (the JAX version returns a new one) and
    returns (logits (B, m, V), embeds (B, m, D), cache)."""
    check_params_dtype(params, compute_dtype)
    b, m = tokens.shape
    max_seq = cache["k"].shape[2]
    cos, sin = _rope(cfg, max_seq, tokens.device, rope)
    positions = pos + torch.arange(m, device=tokens.device)[None, :]
    positions = positions.expand(b, m)
    x = embed(params["embedding"], tokens, cfg.src_vocab_size, tp)
    for i in range(params["layers"]["wq"].shape[0]):
        layer = layer_params(params, i)
        q, k, v = decode_layer_qkv(x, layer, cfg, cos, sin, positions, tp)
        cache["k"][i, :, pos:pos + m] = k
        cache["v"][i, :, pos:pos + m] = v
        o = gqa_attend(q, cache["k"][i], cache["v"][i], positions)
        x = decode_layer_out(x, layer, cfg, o, tp)
    embeds = rms_norm(x, params["norm"], cfg.norm_eps)
    logits = _logits(embeds, params, cfg, tp)
    return logits, embeds, cache


def decode_step(params, cache, token, pos: int, cfg: LlamaConfig,
                compute_dtype=torch.bfloat16, rope: Optional[Tuple] = None, tp=None):
    """One cached decode step. token (B, 1) at position ``pos``. Returns
    (logits (B, V), embeds (B, D), cache) — the m=1 case of decode_chunk."""
    logits, embeds, cache = decode_chunk(
        params, cache, token, pos, cfg, compute_dtype, rope, tp
    )
    return logits[:, 0], embeds[:, 0], cache


def sample_token(logits, generator: Optional[torch.Generator], temperature,
                 top_k, do_sample):
    """Greedy argmax or temperature / top-k sampling of one token per row.
    Sampling draws from ``generator``; its numbers differ from
    ``jax.random``'s, so only greedy decode is compared with JAX."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def generate(
    params,
    input_ids,
    cfg: LlamaConfig,
    *,
    generator: Optional[torch.Generator] = None,
    max_seq_len: int = 2048,
    max_new_tokens: int = 256,
    temperature: float = 1.0,
    top_k: int = 10,
    do_sample: bool = True,
    include_embeds: bool = True,
    compute_dtype=None,
    tp=None,
):
    """Autoregressive generation (``generation.py:172`` in JAX).

    input_ids (B, P) -> result (B, P + max_new_tokens); with
    ``include_embeds`` also embeds (B, max_new_tokens, D): the final
    hidden state that predicted each generated token. It prefills, then
    samples and runs ``decode_step`` one token at a time. Sampling draws
    from ``generator``. ``compute_dtype`` defaults to the params' own
    dtype (JAX casts them to bf16 on every call; here the caller casts
    once). ``tp``: the params are this rank's tensor blocks (module
    docstring).
    """
    b, prompt_len = input_ids.shape
    assert prompt_len + max_new_tokens <= max_seq_len, (
        f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) exceeds "
        f"max_seq_len ({max_seq_len}): the kv cache would overflow"
    )
    if compute_dtype is None:
        compute_dtype = params["embedding"].dtype
    rope = rope_table(max_seq_len, cfg.head_dim, cfg.rope_theta, device=input_ids.device)
    logits, prefill_embeds, cache = prefill(
        params, input_ids, cfg, max_seq_len, compute_dtype, rope=rope, tp=tp
    )
    last_logits = logits[:, -1]
    last_embed = prefill_embeds[:, -1]
    tokens, embeds = [], []
    for t in range(max_new_tokens):
        tok = sample_token(last_logits, generator, temperature, top_k, do_sample)
        tokens.append(tok)
        embeds.append(last_embed)
        if t + 1 < max_new_tokens:
            # the last step's logits are never sampled: JAX's scan computes
            # them and drops them
            last_logits, last_embed, cache = decode_step(
                params, cache, tok[:, None], prompt_len + t, cfg, compute_dtype, rope, tp
            )
    result = torch.cat([input_ids, torch.stack(tokens, dim=1).to(input_ids.dtype)], dim=1)
    if include_embeds:
        return result, torch.stack(embeds, dim=1)
    return result
