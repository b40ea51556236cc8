"""Mixtral (sparse-MoE Llama family): trainable model and serving decode.

Counterpart of ``fms_fsdp_tpu/models/mixtral.py``. Llama's attention half
(``models/llama.py::attention_block``: GQA, rotary, RMSNorm, the flash
kernels on the card) with the FFN replaced by a top-k-of-E SwiGLU mixture.
The params are a plain dict in JAX's layout, every layer weight stacked
on a leading L axis:

    embedding (V, d); norm (d,); lm_head (d, V)
    layers: attn_norm/ffn_norm (L, d); wq/wk/wv/wo as Llama's;
            gate (L, d, E); w1/w3 (L, E, d, h); w2 (L, E, h, d)

MoE implementations, by ``moe_impl``:

- ``"dense"``: every expert computes every token, mixed by the
  renormalised top-k softmax weights (exact; the prefill and the parity
  mode of decode);
- ``"dispatch"`` (the training path): capacity-based routing. Each expert
  takes at most ``capacity = ceil(capacity_factor * top_k * S / E)``
  tokens per batch row; first choices claim buffer slots before second
  choices, in sequence order; an overflowing choice drops that expert's
  contribution. Tokens move by one ``index_add`` into the flat E-major
  (E*B*C + 1)-row buffer (dropped choices go to the trailing dump row)
  and one gather back; the expert GEMMs are ``torch.bmm`` over (E, B*C, d);
- ``"dispatch_einsum"``: the same routing as GShard-style one-hot
  einsums, the oracle the scatter path is tested against.

The forward's ``return_aux`` stats hold, besides JAX's ``balance`` (the
weighted load-balancing loss, summed over layers) and ``drop_frac`` (the
layer mean of dropped choices), the sums they are made of (``route``):
per layer the choices per expert, the summed router probabilities and
the kept choices, and the token count. A data-parallel step sums them
over the ranks before forming the loss (``train/step.py``), so the loss
is the global batch's, as JAX computes it.

Long context (``ring``, an ``ops/ring_attention.py`` exchange): the
attention runs the ring, the rotary table starts at the chunk's
position, and the capacity routing is that of the whole sequence, as
JAX's GSPMD program computes it along the full sequence dim
(:func:`context_slots`): each chunk's per-round, per-expert choice
counts (B, K, E) are gathered over the context group, a choice's slot
is its in-round cumsum in its chunk plus every chunk's counts of the
earlier rounds plus the earlier chunks' counts of its round, and the
capacity is that of the whole length. Each chunk fills and computes
its own kept choices in a buffer of the whole sequence's C rows per
expert (the rows other chunks claim stay zero: up to cp times a chunk's
share of the expert FLOPs). The dense mix is token by token and needs
no exchange. The route sums are this process's chunks'; the step sums
them over the world, the context group included.

Routed decode (serving) groups the rows of a step by expert: each chosen
expert's weights are read once, by three matmuls over its rows, and the
weighted outputs are added back per row. That takes one host sync per
layer (the rows per expert). The expert-parallel all-to-all
(``_moe_ffn_dispatch_a2a``) is ROADMAP.md A.4b.

Tensor parallelism (``tp``, ``parallel/tensor.py``): the attention and
the top-level leaves as Llama's; each expert's w1 and w3 split by
columns and w2 by rows, as JAX's ``models/mixtral.py:103-130,424-434``,
the router whole. The router reads the whole hidden state, so the
routing is the same on every tensor rank; each rank runs its block of
every expert's FFN over the dispatched rows and the expert outputs are
reduced over tensor before the combine, so the router weights' gradient
is whole on every rank. The route sums are counted once per data rank,
not once per tensor rank (``DataParallel.sum_route``).
"""

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from fms_fsdp_tpu_torch.models.configs import MixtralConfig
from fms_fsdp_tpu_torch.models.generation import _rope, check_params_dtype, decode_layer_qkv
from fms_fsdp_tpu_torch.models.llama import (
    attention_block,
    embed,
    layer_params,
    lm_head,
    n_layers_of,
    swiglu,
)
from fms_fsdp_tpu_torch.obs.scopes import scoped
from fms_fsdp_tpu_torch.ops.attention import xla_attention
from fms_fsdp_tpu_torch.ops.norms import rms_norm
from fms_fsdp_tpu_torch.ops.paged_attention import gather_pages, gqa_attend
from fms_fsdp_tpu_torch.ops.quant import check_quant_mode
from fms_fsdp_tpu_torch.ops.rope import apply_rotary, rope_table
from fms_fsdp_tpu_torch.parallel.tensor import is_split
from fms_fsdp_tpu_torch.utils.tree import tree_map

MOE_IMPLS = ("dense", "dispatch", "dispatch_einsum")


def init_mixtral_params(
    generator: torch.Generator,
    cfg: MixtralConfig,
    dtype=torch.float32,
    nlayers: Optional[int] = None,
) -> Dict:
    """Initialize the param dict on ``generator``'s device: truncated
    normal (±3 std), std 0.02, wo and w2 scaled by 1/sqrt(2*nlayers), as
    the JAX init. Drawn in fp32 one layer at a time and cast to
    ``dtype``, so a bf16 model never exists whole in fp32; the numbers
    differ from ``jax.random``'s."""
    nlayers = nlayers if nlayers is not None else cfg.nlayers
    device = generator.device
    d, hd, h, E = cfg.emb_dim, cfg.head_dim, cfg.hidden_dim, cfg.num_experts
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
            del buf
        return out

    L = nlayers
    layers = {
        "attn_norm": torch.ones((L, d), dtype=dtype, device=device),
        "wq": tn((L, d, cfg.nheads * hd), std),
        "wk": tn((L, d, cfg.n_kv_heads * hd), std),
        "wv": tn((L, d, cfg.n_kv_heads * hd), std),
        "wo": tn((L, cfg.nheads * hd, d), out_std),
        "ffn_norm": torch.ones((L, d), dtype=dtype, device=device),
        "gate": tn((L, d, E), std),
        "w1": tn((L, E, d, h), std),
        "w3": tn((L, E, d, h), std),
        "w2": tn((L, E, h, d), out_std),
    }
    return {
        "embedding": tn((v, d), std, stacked=False),
        "layers": layers,
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": tn((d, v), std, stacked=False),
    }


def moe_capacity(cfg: MixtralConfig, seq_len: int) -> int:
    """Per-expert buffer rows per batch row."""
    return max(1, int(math.ceil(
        cfg.capacity_factor * cfg.top_k * seq_len / cfg.num_experts)))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def top_k_lower_first(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest values on the last dim, equal values
    in ascending index order (``lax.top_k``'s rule; ``torch.topk`` does
    not promise one): a stable descending sort."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


@scoped("moe_router")
def _router(h, gate_w, cfg: MixtralConfig):
    """(top_idx (B, S, K) int64, top_w (B, S, K) fp32 renormalised,
    probs (B, S, E) fp32). The logits are ``h @ gate_w`` in the compute
    dtype, then fp32, as JAX rounds them."""
    logits = (h @ gate_w).float()
    probs = torch.softmax(logits, dim=-1)
    top_idx = top_k_lower_first(probs, cfg.top_k)
    top_vals = probs.gather(-1, top_idx)
    top_w = top_vals / top_vals.sum(-1, keepdim=True)
    return top_idx, top_w, probs


def _route(top_idx, probs, keep, E: int) -> Dict[str, torch.Tensor]:
    """One layer's routing sums: choices per expert (E,), summed router
    probabilities (E,) (differentiable), kept choices, tokens."""
    counts = F.one_hot(top_idx, E).sum(dim=(0, 1, 2)).float()
    n_choices = float(top_idx.numel())
    kept = (keep.sum().float() if keep is not None
            else torch.tensor(n_choices, device=probs.device))
    tokens = torch.tensor(float(probs.shape[0] * probs.shape[1]), device=probs.device)
    return {"counts": counts, "probs": probs.sum(dim=(0, 1)), "kept": kept,
            "tokens": tokens}


def moe_stats(route: Dict[str, torch.Tensor], cfg: MixtralConfig) -> Dict:
    """{"balance", "drop_frac"} of JAX's ``_moe_stats`` from routing sums
    stacked over layers (``counts``/``probs`` (L, E), ``kept`` (L,),
    ``tokens`` a scalar): per layer ``aux_loss_weight * E * sum_e f_e *
    p_e`` with f the fraction of choices routed to e and p its mean
    router probability, summed over layers; the dropped share of choices,
    averaged over layers. 1.0 * aux_loss_weight per layer at uniform
    routing."""
    n, K, E = route["tokens"], cfg.top_k, cfg.num_experts
    f = route["counts"] / (n * K)
    p = route["probs"] / n
    balance = cfg.aux_loss_weight * E * (f * p).sum()
    drop = (1.0 - route["kept"] / (n * K)).mean()
    return {"balance": balance, "drop_frac": drop}


def _stack_routes(routes: List[Dict]) -> Dict[str, torch.Tensor]:
    out = {k: torch.stack([r[k] for r in routes]) for k in ("counts", "probs", "kept")}
    out["tokens"] = routes[0]["tokens"]
    return out


def _priority_slots(top_idx, E: int, C: int):
    """Per-choice buffer slots under priority routing: choice round k
    claims an expert's slots after rounds < k, tokens in sequence order
    within a round. Returns (slot, keep), both (B, S, K)."""
    counts = torch.zeros((top_idx.shape[0], 1, E), dtype=torch.long,
                         device=top_idx.device)
    slots = []
    for k in range(top_idx.shape[-1]):
        mask_k = F.one_hot(top_idx[:, :, k], E)
        pos_k = torch.cumsum(mask_k, dim=1) - mask_k + counts
        slots.append(pos_k.gather(-1, top_idx[:, :, k, None])[..., 0])
        counts = counts + mask_k.sum(dim=1, keepdim=True)
    slot = torch.stack(slots, dim=-1)
    return slot, slot < C


def context_slots(top_idx: List[torch.Tensor], ring, E: int, C: int) -> List[Tuple]:
    """:func:`_priority_slots` of the whole sequence for this process's
    chunks of it (``top_idx`` one (B, S / cp, K) tensor a chunk, in
    ``ring.split`` order): the chunks' per-round choice counts (B, K, E)
    gathered over the context group (``ring.gather``); chunk r's slot of a
    round-k choice is its cumsum within chunk r and round k, plus all
    chunks' counts of rounds < k, plus chunks < r's counts of round k.
    Returns one (slot, keep) a chunk, ``keep = slot < C``."""
    counts = [F.one_hot(t, E).sum(dim=1) for t in top_idx]  # (B, K, E)
    every = torch.stack(ring.gather(counts))  # (cp, B, K, E), context-rank order
    rounds = every.sum(dim=0)
    offset = (torch.cumsum(rounds, dim=1) - rounds)[None] + (
        torch.cumsum(every, dim=0) - every)
    out = []
    for t, r in zip(top_idx, ring.slots):
        slots = []
        for k in range(t.shape[-1]):
            mask_k = F.one_hot(t[:, :, k], E)
            pos_k = torch.cumsum(mask_k, dim=1) - mask_k + offset[r][:, None, k]
            slots.append(pos_k.gather(-1, t[:, :, k, None])[..., 0])
        slot = torch.stack(slots, dim=-1)
        out.append((slot, slot < C))
    return out


def _routed_chunks(h, lp, cfg: MixtralConfig, ring):
    """The capacity routing of ``h`` (B, S, d) cut into ``ring``'s chunks
    (one chunk without a ring): (chunks, their (top_idx, top_w, probs),
    their (slot, keep), the capacity C of the whole sequence)."""
    E = cfg.num_experts
    if ring is None or ring.cp == 1:
        C = moe_capacity(cfg, h.shape[1])
        routed = [_router(h, lp["gate"], cfg)]
        return [h], routed, [_priority_slots(routed[0][0], E, C)], C
    parts = ring.split(h)
    C = moe_capacity(cfg, parts[0].shape[1] * ring.cp)
    routed = [_router(p, lp["gate"], cfg) for p in parts]
    return parts, routed, context_slots([r[0] for r in routed], ring, E, C), C


def _sum_routes(routes: List[Dict]) -> Dict[str, torch.Tensor]:
    """One layer's routing sums over this process's chunks."""
    if len(routes) == 1:
        return routes[0]
    return {k: torch.stack([r[k] for r in routes]).sum(dim=0) for k in routes[0]}


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------


@scoped("moe_dense")
def _moe_ffn_dense(h, lp, cfg: MixtralConfig, tp=None):
    """Every expert computes every token. h (B, S, d). Token by token: under
    a context ring each process mixes its own chunk."""
    top_idx, top_w, probs = _router(h, lp["gate"], cfg)
    E = cfg.num_experts
    mix = (F.one_hot(top_idx, E).float() * top_w[..., None]).sum(dim=-2)  # (B, S, E)
    split = is_split(tp, lp["w1"].shape[-1], cfg.hidden_dim)
    hs = tp.enter(h) if split else h
    hidden = (F.silu(torch.einsum("bsd,edh->bseh", hs, lp["w1"]))
              * torch.einsum("bsd,edh->bseh", hs, lp["w3"]))
    expert_out = torch.einsum("bseh,ehd->bsed", hidden, lp["w2"])
    if split:
        expert_out = tp.reduce(expert_out)
    y = torch.einsum("bse,bsed->bsd", mix.to(h.dtype), expert_out)
    return y, _route(top_idx, probs, None, E)


@scoped("expert_ffn")
def _expert_ffn(xd, lp, quant: str = "none", tp=None, hidden: Optional[int] = None):
    """Each expert's SwiGLU over its E-major (E, B, C, d) buffer, as
    batched GEMMs over (E, B*C, d), or their int8 / fp8 forms
    (``ops/quant.py::expert_matmul``). Under ``tp`` this rank's block of
    the ``hidden`` columns, the output reduced over tensor."""
    E, B, C, D = xd.shape
    x = xd.reshape(E, B * C, D)
    hidden = hidden or lp["w1"].shape[-1]
    out = swiglu(x, lp["w1"], lp["w3"], lp["w2"], hidden, tp, quant, expert=True)
    return out.reshape(E, B, C, D)


def _fill_expert_buffer(h, top_idx, slot, keep, C: int, E: int):
    """Scatter the rows into the flat E-major buffer. Returns (dest
    (B*S*K,) flat row per choice, the dump row for a dropped one; the
    (E, B, C, d) buffer without the dump row). Only the dump row takes
    more than one add."""
    B, S, D = h.shape
    K = top_idx.shape[-1]
    b_ix = torch.arange(B, device=h.device)[:, None, None]
    dest = torch.where(keep, (top_idx * B + b_ix) * C + slot,
                       torch.full_like(top_idx, E * B * C)).reshape(B * S * K)
    src = h[:, :, None, :].expand(B, S, K, D).reshape(B * S * K, D)
    buf = h.new_zeros((E * B * C + 1, D)).index_add(0, dest, src)
    return dest, buf[: E * B * C].reshape(E, B, C, D)


def _combine_from_buffer(out_e, dest, top_w, S: int):
    """Gather each choice's expert output back (the dump row reads as a
    zero row) and mix with the router weights: the products of the
    compute-dtype values summed in fp32 and rounded once, as JAX's einsum."""
    E, B, C, D = out_e.shape
    K = top_w.shape[-1]
    out_flat = torch.cat([out_e.reshape(E * B * C, D), out_e.new_zeros((1, D))])
    gathered = out_flat.index_select(0, dest).reshape(B, S, K, D)
    w = top_w.to(out_e.dtype).float()
    return (gathered.float() * w[..., None]).sum(dim=2).to(out_e.dtype)


@scoped("moe_dispatch")
def _moe_ffn_dispatch(h, lp, cfg: MixtralConfig, quant: str = "none", ring=None,
                      tp=None):
    """Capacity dispatch by scatter/gather (the training path), chunk by
    chunk under a context ``ring``."""
    E = cfg.num_experts
    parts, routed, slots, C = _routed_chunks(h, lp, cfg, ring)
    ys, routes = [], []
    for hp, (top_idx, top_w, probs), (slot, keep) in zip(parts, routed, slots):
        dest, xd = _fill_expert_buffer(hp, top_idx, slot, keep, C, E)
        out_e = _expert_ffn(xd, lp, quant, tp, cfg.hidden_dim)
        ys.append(_combine_from_buffer(out_e, dest, top_w, hp.shape[1]))
        routes.append(_route(top_idx, probs, keep, E))
    y = ys[0] if len(ys) == 1 else ring.join(ys)
    return y, _sum_routes(routes)


def _moe_ffn_dispatch_einsum(h, lp, cfg: MixtralConfig, quant: str = "none", ring=None,
                             tp=None):
    """The same routing as (B, S, E, C) one-hot einsums: the oracle of
    :func:`_moe_ffn_dispatch`."""
    E, K = cfg.num_experts, cfg.top_k
    parts, routed, slots, C = _routed_chunks(h, lp, cfg, ring)
    ys, routes = [], []
    for hp, (top_idx, top_w, probs), (slot, keep) in zip(parts, routed, slots):
        B, S, _ = hp.shape
        dispatch = hp.new_zeros((B, S, E, C))
        combine = hp.new_zeros((B, S, E, C))
        for k in range(K):
            # a slot past the buffer one-hots to zeros, as jax.nn.one_hot
            slot_1h = F.one_hot(slot[:, :, k].clamp(max=C), C + 1)[..., :C].float()
            d_k = (F.one_hot(top_idx[:, :, k], E).float()[..., None]
                   * slot_1h[:, :, None, :] * keep[:, :, k, None, None]).to(hp.dtype)
            dispatch = dispatch + d_k
            combine = combine + d_k * top_w[:, :, k, None, None].to(hp.dtype)
        xd = torch.einsum("bsec,bsd->ebcd", dispatch, hp)
        out_e = _expert_ffn(xd, lp, quant, tp, cfg.hidden_dim)
        ys.append(torch.einsum("bsec,ebcd->bsd", combine, out_e))
        routes.append(_route(top_idx, probs, keep, E))
    y = ys[0] if len(ys) == 1 else ring.join(ys)
    return y, _sum_routes(routes)


_MOE_FFN = {"dense": _moe_ffn_dense, "dispatch": _moe_ffn_dispatch,
            "dispatch_einsum": _moe_ffn_dispatch_einsum}


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------


def _mixtral_block(x, layer: Dict, cfg: MixtralConfig, cos, sin, *, attn_impl: str,
                   quant: str, moe_impl: str, ring=None, tp=None):
    """x + Attn(RMS(x)); then x + MoE(RMS(x)). Returns (x, the layer's
    routing sums)."""
    x = attention_block(x, layer, cfg, cos, sin, attn_impl=attn_impl, quant=quant,
                        ring=ring, tp=tp)
    with record_function("moe"):
        h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        if moe_impl == "dense":  # unquantized, as JAX's
            y, route = _moe_ffn_dense(h, layer, cfg, tp)
        else:
            y, route = _MOE_FFN[moe_impl](h, layer, cfg, quant, ring, tp)
    return x + y, route


def _indexed_block(x, *, layers, i: int, **kwargs):
    return _mixtral_block(x, layer_params(layers, i), **kwargs)


def mixtral_forward(
    params: Dict,
    tokens: torch.Tensor,
    cfg: MixtralConfig,
    *,
    compute_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    ac_mask: Optional[List[bool]] = None,
    scan_layers: bool = True,
    moe_impl: str = "dense",
    return_embeds: bool = False,
    return_hidden: bool = False,
    return_aux: bool = False,
    quant: str = "none",
    ring=None,
    tp=None,
):
    """tokens (B, S) -> logits (B, S, V) in the compute dtype, the
    counterpart of ``fms_fsdp_tpu/models/mixtral.py:706``; under ``tp``
    this rank's vocabulary block of them (module docstring).

    ``return_aux`` also returns the stats dict: ``balance``,
    ``drop_frac`` and their ``route`` sums (module docstring).
    ``return_hidden`` returns the final normed hidden states instead of
    logits; ``return_embeds`` returns (logits, hidden). Layers whose
    ``ac_mask`` entry is True run under ``torch.utils.checkpoint`` and
    index their weights inside it, as ``llama_forward``'s (so a
    data-parallel step's ``GatheredLayers`` gathers again in the
    recomputation). ``scan_layers`` has no effect. ``ring`` is a context
    exchange (module docstring): ``tokens`` are this process's part of
    the sequence, as ``llama_forward``'s.
    """
    del scan_layers
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {moe_impl!r}: expected one of {MOE_IMPLS}")
    check_quant_mode(quant)
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
    routes = []
    for i in range(nlayers):
        block = functools.partial(
            _indexed_block, layers=params["layers"], i=i, cfg=cfg, cos=cos, sin=sin,
            attn_impl=attn_impl, quant=quant, moe_impl=moe_impl, ring=ring, tp=tp,
        )
        if ac_mask[i]:
            x, route = checkpoint(block, x, use_reentrant=False)
        else:
            x, route = block(x)
        routes.append(route)
    route = _stack_routes(routes)
    aux = dict(moe_stats(route, cfg), route=route)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    if return_hidden:
        return (x, aux) if return_aux else x
    with record_function("lm_head"):
        logits = lm_head(x, params["lm_head"], cfg.src_vocab_size, tp)
    if return_embeds:
        return logits, x
    if return_aux:
        return logits, aux
    return logits


# ---------------------------------------------------------------------------
# serving: prefill and cached decode
# ---------------------------------------------------------------------------


@scoped("moe_routed")
def _moe_routed(h, lp, cfg: MixtralConfig):
    """The top-k mixture of the rows of ``h`` (B, m, d), grouped by
    expert: each chosen expert's weights are read once, by three matmuls
    over the rows that chose it, and its outputs, times the router
    weights, are added back per row in fp32. Reads the rows per expert on
    the host (one sync)."""
    b, m, d = h.shape
    E, K = cfg.num_experts, cfg.top_k
    top_idx, top_w, _ = _router(h, lp["gate"], cfg)
    x = h.reshape(b * m, d)
    choice = top_idx.reshape(-1)
    weight = top_w.to(h.dtype).float().reshape(-1)
    rows = torch.arange(b * m, device=h.device).repeat_interleave(K)
    order = torch.argsort(choice, stable=True)
    per_expert = torch.bincount(choice, minlength=E).tolist()
    out = torch.zeros((b * m, d), dtype=torch.float32, device=h.device)
    start = 0
    for e, n in enumerate(per_expert):
        if n == 0:
            continue
        sel = order[start:start + n]
        start += n
        r = rows[sel]
        xe = x.index_select(0, r)
        ye = (F.silu(xe @ lp["w1"][e]) * (xe @ lp["w3"][e])) @ lp["w2"][e]
        out.index_add_(0, r, ye.float() * weight[sel, None])
    return out.to(h.dtype).reshape(b, m, d)


def _moe_token(h, lp, cfg: MixtralConfig, moe_impl: str = "dense"):
    """The MoE FFN of decode positions; h (B, m, d) after ffn_norm."""
    if moe_impl == "dense":
        return _moe_ffn_dense(h, lp, cfg)[0]
    if moe_impl != "routed":
        raise ValueError(f"unknown decode moe_impl {moe_impl!r}")
    return _moe_routed(h, lp, cfg)


def _mixtral_decode_layer_out(x, layer, cfg: MixtralConfig, o, moe_impl: str):
    """Post-attention half of one decode layer: residual + MoE."""
    x = x + o @ layer["wo"]
    h2 = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
    return x + _moe_token(h2, layer, cfg, moe_impl)


def mixtral_prefill(
    params,
    tokens: torch.Tensor,
    cfg: MixtralConfig,
    max_seq_len: int,
    compute_dtype=torch.bfloat16,
    full_logits: bool = False,
    rope: Optional[Tuple] = None,
):
    """The prompt through the model (plain attention, the dense MoE),
    building the dense kv cache (L, B, max_seq_len, Nkv, H), zeros past
    the prompt. Returns (logits (B, 1 or S, V), embeds, {"k", "v"}). The
    params must already be in ``compute_dtype``."""
    check_params_dtype(params, compute_dtype)
    b, s = tokens.shape
    hd, nkv = cfg.head_dim, cfg.n_kv_heads
    nlayers = params["layers"]["wq"].shape[0]
    cos, sin = _rope(cfg, max_seq_len, tokens.device, rope)
    x = params["embedding"][tokens]
    cache_shape = (nlayers, b, max_seq_len, nkv, hd)
    k_cache = torch.zeros(cache_shape, dtype=compute_dtype, device=tokens.device)
    v_cache = torch.zeros_like(k_cache)
    for i in range(nlayers):
        layer = layer_params(params["layers"], i)
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = (h @ layer["wq"]).reshape(b, s, cfg.nheads, hd)
        k = (h @ layer["wk"]).reshape(b, s, nkv, hd)
        v = (h @ layer["wv"]).reshape(b, s, nkv, hd)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        o = xla_attention(q, k, v, causal=True)
        x = x + o.reshape(b, s, cfg.nheads * hd) @ layer["wo"]
        h2 = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        x = x + _moe_ffn_dense(h2, layer, cfg)[0]
        k_cache[i, :, :s] = k
        v_cache[i, :, :s] = v
    embeds = rms_norm(x, params["norm"], cfg.norm_eps)
    src = embeds if full_logits else embeds[:, -1:]
    logits = src @ params["lm_head"]
    return logits, embeds, {"k": k_cache, "v": v_cache}


def mixtral_decode_step(params, cache, token, pos: int, cfg: MixtralConfig,
                        compute_dtype=torch.bfloat16, moe_impl: str = "dense",
                        rope: Optional[Tuple] = None):
    """One dense-cache decode step (the family's parity walk): token
    (B, 1) at position ``pos``; the cache is updated in place. Returns
    (logits (B, V), cache)."""
    check_params_dtype(params, compute_dtype)
    b, m = token.shape
    max_seq = cache["k"].shape[2]
    cos, sin = _rope(cfg, max_seq, token.device, rope)
    positions = (pos + torch.arange(m, device=token.device)[None, :]).expand(b, m)
    x = params["embedding"][token]
    for i in range(params["layers"]["wq"].shape[0]):
        layer = layer_params(params["layers"], i)
        q, k, v = decode_layer_qkv(x, layer, cfg, cos, sin, positions)
        cache["k"][i, :, pos:pos + m] = k
        cache["v"][i, :, pos:pos + m] = v
        o = gqa_attend(q, cache["k"][i], cache["v"][i], positions)
        x = _mixtral_decode_layer_out(x, layer, cfg, o, moe_impl)
    embeds = rms_norm(x, params["norm"], cfg.norm_eps)
    logits = embeds @ params["lm_head"]
    return logits[:, 0], cache


def mixtral_paged_decode_step(
    params,
    pools,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    tokens: torch.Tensor,
    cfg: MixtralConfig,
    *,
    page_size: int,
    compute_dtype=torch.bfloat16,
    moe_impl: str = "dense",
    rope: Optional[Tuple] = None,
):
    """One ragged paged decode step: ``serve/decode.py::paged_decode_step``
    with the MoE FFN and the reference attention over gathered pages (JAX's
    Mixtral serving runs no attention kernel). tokens (B,) at positions
    ``seq_lens``; the pools are updated in place. Returns (logits (B, V),
    pools)."""
    check_params_dtype(params, compute_dtype)
    b = tokens.shape[0]
    max_seq = page_table.shape[1] * page_size
    cos, sin = _rope(cfg, max_seq, tokens.device, rope)
    positions = seq_lens[:, None].long()
    x = params["embedding"][tokens[:, None].long()]
    rows = torch.arange(b, device=tokens.device)
    page_ids = page_table[rows, (seq_lens // page_size).long()].long()
    slots = (seq_lens % page_size).long()
    for i in range(params["layers"]["wq"].shape[0]):
        layer = layer_params(params["layers"], i)
        q, k, v = decode_layer_qkv(x, layer, cfg, cos, sin, positions)
        pk, pv = pools["k"][i], pools["v"][i]
        pk.index_put_((page_ids, slots), k[:, 0])
        pv.index_put_((page_ids, slots), v[:, 0])
        o = gqa_attend(q, gather_pages(pk, page_table), gather_pages(pv, page_table),
                       positions)
        x = _mixtral_decode_layer_out(x, layer, cfg, o, moe_impl)
    embeds = rms_norm(x, params["norm"], cfg.norm_eps)
    logits = embeds @ params["lm_head"]
    return logits[:, 0], pools
