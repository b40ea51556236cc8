"""The paged decode step: one ragged token step over the page pool.

Counterpart of ``fms_fsdp_tpu/serve/decode.py::paged_decode_step``. It
runs the same ``decode_layer_qkv`` / attend / ``decode_layer_out`` ops
as the dense decode path, with two differences: k/v land in the paged
pool at each row's (page, slot) write target, and each batch row carries
its own position (``seq_lens``). ``paged_verify_step`` scores m
candidate tokens per row in one forward, the verify step of speculative
serving.

The pools are written in place with ``index_put_`` (JAX scatters into
donated buffers, which XLA also updates in place).
"""

from typing import Optional, Tuple

import torch

from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.models.generation import (
    check_params_dtype,
    decode_layer_out,
    decode_layer_qkv,
    layer_params,
)
from fms_fsdp_tpu_torch.ops.norms import rms_norm
from fms_fsdp_tpu_torch.ops.paged_attention import (
    gather_pages,
    gqa_attend,
    paged_attention_kernel,
)
from fms_fsdp_tpu_torch.ops.quant import kv_dequantize, kv_quantize
from fms_fsdp_tpu_torch.ops.rope import rope_table


def paged_decode_step(
    params,
    pools,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    *,
    page_size: int,
    compute_dtype=torch.bfloat16,
    quant: str = "none",
    attn_impl: str = "reference",
    block_kv=None,
    rope: Optional[Tuple] = None,
):
    """One decode step for a ragged batch.

    tokens (B,) — the next token of each row, written at cache position
    ``seq_lens[b]`` (the row then attends to positions <= seq_lens[b]);
    page_table (B, max_pages) int32; seq_lens (B,) int32; pools is the
    PagedKVCache.pools dict (leading L dim per leaf), updated in place.
    Returns (logits (B, V), embeds (B, D), pools). Under the kernel impl,
    quantized pools are read natively (the kernel dequantises as it
    stages each tile). ``rope`` is an optional precomputed (cos, sin)
    table covering max_pages * page_size positions.
    """
    check_params_dtype(params, compute_dtype)
    b = tokens.shape[0]
    max_seq = page_table.shape[1] * page_size
    if rope is None:
        rope = rope_table(max_seq, cfg.head_dim, cfg.rope_theta, device=tokens.device)
    cos, sin = rope
    positions = seq_lens[:, None].long()  # (B, 1)
    x = params["embedding"][tokens[:, None].long()]  # (B, 1, D)

    rows = torch.arange(b, device=tokens.device)
    page_ids = page_table[rows, (seq_lens // page_size).long()].long()  # (B,)
    slots = (seq_lens % page_size).long()
    quantized = quant != "none"

    def attend(q, lp):
        if attn_impl == "kernel":
            return paged_attention_kernel(
                q[:, 0], lp["k"], lp["v"], page_table, seq_lens,
                k_scales=lp.get("k_scale"), v_scales=lp.get("v_scale"),
                block_kv=block_kv, compute_dtype=compute_dtype,
            )[:, None]
        if attn_impl != "reference":
            raise ValueError(f"unknown paged attention impl: {attn_impl!r}")
        if quantized:
            k = kv_dequantize(gather_pages(lp["k"], page_table),
                              gather_pages(lp["k_scale"], page_table), compute_dtype)
            v = kv_dequantize(gather_pages(lp["v"], page_table),
                              gather_pages(lp["v_scale"], page_table), compute_dtype)
        else:
            k = gather_pages(lp["k"], page_table)
            v = gather_pages(lp["v"], page_table)
        return gqa_attend(q, k, v, positions)

    for i in range(params["layers"]["wq"].shape[0]):
        layer = layer_params(params, i)
        lp = {name: pool[i] for name, pool in pools.items()}
        q, k, v = decode_layer_qkv(x, layer, cfg, cos, sin, positions)
        # this step's k/v to each row's (page, slot); idle rows' tables
        # point every slot at the scratch page
        if quantized:
            qk, sk = kv_quantize(k[:, 0], quant)
            qv, sv = kv_quantize(v[:, 0], quant)
            lp["k"].index_put_((page_ids, slots), qk)
            lp["v"].index_put_((page_ids, slots), qv)
            lp["k_scale"].index_put_((page_ids, slots), sk)
            lp["v_scale"].index_put_((page_ids, slots), sv)
        else:
            lp["k"].index_put_((page_ids, slots), k[:, 0])
            lp["v"].index_put_((page_ids, slots), v[:, 0])
        o = attend(q, lp)
        x = decode_layer_out(x, layer, cfg, o)
    embeds = rms_norm(x, params["norm"], cfg.norm_eps)
    logits = embeds @ params["lm_head"]
    return logits[:, 0], embeds[:, 0], pools


def paged_verify_step(
    params,
    pools,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    *,
    page_size: int,
    compute_dtype=torch.bfloat16,
    quant: str = "none",
    rope: Optional[Tuple] = None,
):
    """Score m candidate tokens per row in one ragged forward: the
    speculative verify step (``serve/decode.py:133`` in JAX).

    tokens (B, m): token j of row b is written at cache position
    ``seq_lens[b] + j`` and attends to positions <= its own, the
    ``decode_chunk`` rule, so under the gather path the per-position
    logits equal feeding the same tokens one at a time through
    ``paged_decode_step``'s reference branch. Attention goes through the
    gather path under every impl, as in JAX: the decode kernel takes one
    query a row. Quantized pools take the same quantize / dequantize
    round trip as that branch. Returns (logits (B, m, V), embeds (B, m,
    D), pools), the pools written in place. Positions past a row's
    accepted prefix keep stale k/v, which the <= position mask hides
    until a later write replaces them.
    """
    check_params_dtype(params, compute_dtype)
    b, m = tokens.shape
    max_seq = page_table.shape[1] * page_size
    if rope is None:
        rope = rope_table(max_seq, cfg.head_dim, cfg.rope_theta, device=tokens.device)
    cos, sin = rope
    positions = (seq_lens[:, None].long()
                 + torch.arange(m, device=tokens.device)[None, :])  # (B, m)
    x = params["embedding"][tokens.long()]  # (B, m, D)
    rows = torch.arange(b, device=tokens.device)[:, None]
    page_ids = page_table[rows, positions // page_size].long()  # (B, m)
    slots = positions % page_size
    quantized = quant != "none"

    def attend(q, lp):
        if quantized:
            k = kv_dequantize(gather_pages(lp["k"], page_table),
                              gather_pages(lp["k_scale"], page_table), compute_dtype)
            v = kv_dequantize(gather_pages(lp["v"], page_table),
                              gather_pages(lp["v_scale"], page_table), compute_dtype)
        else:
            k = gather_pages(lp["k"], page_table)
            v = gather_pages(lp["v"], page_table)
        return gqa_attend(q, k, v, positions)

    for i in range(params["layers"]["wq"].shape[0]):
        layer = layer_params(params, i)
        lp = {name: pool[i] for name, pool in pools.items()}
        q, k, v = decode_layer_qkv(x, layer, cfg, cos, sin, positions)
        if quantized:
            qk, sk = kv_quantize(k, quant)
            qv, sv = kv_quantize(v, quant)
            lp["k"].index_put_((page_ids, slots), qk)
            lp["v"].index_put_((page_ids, slots), qv)
            lp["k_scale"].index_put_((page_ids, slots), sk)
            lp["v_scale"].index_put_((page_ids, slots), sv)
        else:
            lp["k"].index_put_((page_ids, slots), k)
            lp["v"].index_put_((page_ids, slots), v)
        x = decode_layer_out(x, layer, cfg, attend(q, lp))
    embeds = rms_norm(x, params["norm"], cfg.norm_eps)
    logits = embeds @ params["lm_head"]
    return logits, embeds, pools
