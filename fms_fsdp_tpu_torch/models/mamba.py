"""Mamba2 hybrid LM.

Counterpart of ``fms_fsdp_tpu/models/mamba.py``: a stack of pre-norm
blocks where each block is  residual + mixer(norm(residual)), then
residual + mlp(norm2(residual)) (when d_intermediate > 0), with

- mixer = Mamba2 on most layers: fused in_proj -> (z | xBC | dt), depthwise
  causal conv1d with silu over xBC, softplus dt with learned bias,
  negative-exponential A per head, chunked SSD selective scan (ops/ssd.py;
  the hand-written CUDA kernel on the card), gated RMSNorm
  (norm(y * silu(z))), out_proj;
- mixer = causal MHA on ``attn_layer_idx`` layers (9/18/27 for mamba_9.8b)
  with GQA 32/8 heads, head_dim 128, partial rotary over the first 64 dims,
  through ``ops/attention.py::attention`` (the flash kernels on the card);
- swiglu MLP (d_intermediate) after every mixer;
- fp32 residual stream (``residual_in_fp32``), RMSNorm everywhere, untied
  embeddings with vocab padded to pad_vocab_size_multiple.

Layers are heterogeneous, so the params keep JAX's names and nesting with
``layers`` a **list** of per-layer dicts, and ``bridge.py`` moves JAX
weights in and out without a transpose.

The second half is the recurrent decode of the serving path
(``serve/families/mamba.py``): one token per step from O(1) state.
"""

import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fms_fsdp_tpu_torch.models.configs import MambaConfig
from fms_fsdp_tpu_torch.obs.scopes import scoped
from fms_fsdp_tpu_torch.ops.attention import attention
from fms_fsdp_tpu_torch.ops.norms import rms_norm
from fms_fsdp_tpu_torch.ops.paged_attention import gather_pages, gqa_attend
from fms_fsdp_tpu_torch.ops.quant import check_quant_mode
from fms_fsdp_tpu_torch.ops.quant import matmul as qmatmul
from fms_fsdp_tpu_torch.ops.ring_attention import ring_attention
from fms_fsdp_tpu_torch.ops.rope import apply_rotary, rope_table
from fms_fsdp_tpu_torch.ops.ssd import causal_conv1d_cp, ssd_scan, ssd_scan_cp
from fms_fsdp_tpu_torch.utils.tree import tree_map

Params = Dict[str, Any]


def _conv_dim(cfg: MambaConfig) -> int:
    return cfg.d_inner + 2 * cfg.ngroups * cfg.d_state


def _in_proj_dim(cfg: MambaConfig) -> int:
    return 2 * cfg.d_inner + 2 * cfg.ngroups * cfg.d_state + cfg.nheads


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_mamba_params(generator: torch.Generator, cfg: MambaConfig,
                      dtype=torch.float32) -> Params:
    """The full param dict on ``generator``'s device, with the recipes of
    the JAX init: truncated normal (±3 std) at std 0.02, the residual
    output projections (out_proj, wo, w2) scaled by 1/sqrt(2*n_layer), the
    conv weight at 10x std; dt_bias the inverse softplus of
    dt ~ LogUniform[1e-3, 1e-1], A ~ Uniform[1, 16] stored as log. The
    draws are fp32, then cast; the numbers differ from ``jax.random``'s for
    the same seed."""
    device = generator.device
    d = cfg.d_model
    v = cfg.padded_vocab_size
    H = cfg.nheads
    std = 0.02
    out_std = std / (2 * cfg.n_layer) ** 0.5

    def tn(shape, s):
        buf = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(buf, std=s, a=-3 * s, b=3 * s, generator=generator)
        return buf.to(dtype)

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, dtype=torch.float32, device=device, generator=generator)
        return u * (hi - lo) + lo

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def mamba_mixer():
        # dt bias: softplus^-1 of dt ~ LogUniform[1e-3, 1e-1] (mamba2 init)
        u = uniform((H,))
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        dt = torch.clamp(dt, min=1e-4)
        dt_bias = dt + torch.log(-torch.expm1(-dt))
        # A ~ Uniform[1, 16]
        A = uniform((H,), 1.0, 16.0)
        return {
            "in_proj": tn((d, _in_proj_dim(cfg)), std),
            "conv_w": tn((_conv_dim(cfg), cfg.d_conv), std * 10),
            "conv_b": torch.zeros((_conv_dim(cfg),), dtype=dtype, device=device),
            "dt_bias": dt_bias.to(dtype),
            "A_log": torch.log(A).to(dtype),
            "D": ones((H,)),
            "norm": ones((cfg.d_inner,)),
            "out_proj": tn((cfg.d_inner, d), out_std),
        }

    def attn_mixer():
        a = cfg.attn_cfg
        hd = a.head_dim
        return {
            "wq": tn((d, a.num_heads * hd), std),
            "wk": tn((d, a.num_heads_kv * hd), std),
            "wv": tn((d, a.num_heads_kv * hd), std),
            "wo": tn((a.num_heads * hd, d), out_std),
        }

    layers: List[Params] = []
    for i in range(cfg.n_layer):
        layer = {
            "norm": ones((d,)),
            "mixer": attn_mixer() if i in cfg.attn_layer_idx else mamba_mixer(),
        }
        if cfg.d_intermediate > 0:
            layer["norm2"] = ones((d,))
            layer["mlp"] = {
                "w1": tn((d, cfg.d_intermediate), std),
                "w3": tn((d, cfg.d_intermediate), std),
                "w2": tn((cfg.d_intermediate, d), out_std),
            }
        layers.append(layer)

    return {
        "embedding": tn((v, d), std),
        "layers": layers,
        "norm_f": ones((d,)),
        "lm_head": tn((d, v), std),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@scoped("mamba_mixer")
def _mamba_mixer(x, p: Params, cfg: MambaConfig, kernel="auto", quant="none", ring=None):
    """x (B, S, D) compute dtype -> (B, S, D). Under a context ``ring``
    the conv takes its halo from the previous rank and the scan is
    ``ssd_scan_cp`` (JAX's ``mamba.py:154-165``, where GSPMD places the
    conv's boundary)."""
    B, S, _ = x.shape
    H, Pd, G, N = cfg.nheads, cfg.headdim, cfg.ngroups, cfg.d_state
    d_inner = cfg.d_inner

    zxbcdt = qmatmul(x, p["in_proj"], quant=quant)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner : d_inner + _conv_dim(cfg)]
    dt_raw = zxbcdt[..., d_inner + _conv_dim(cfg) :]  # (B, S, H)

    xBC = causal_conv1d_cp(xBC, p["conv_w"], p["conv_b"], ring, activation="silu")
    xs = xBC[..., :d_inner].reshape(B, S, H, Pd)
    Bm = xBC[..., d_inner : d_inner + G * N].reshape(B, S, G, N)
    Cm = xBC[..., d_inner + G * N :].reshape(B, S, G, N)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if ring is not None and ring.cp > 1:
        y = ssd_scan_cp(xs, dt, A, Bm, Cm, p["D"], ring=ring, chunk_size=cfg.chunk_size,
                        kernel=kernel)
    else:
        y = ssd_scan(xs, dt, A, Bm, Cm, p["D"], chunk_size=cfg.chunk_size, kernel=kernel)
    y = y.reshape(B, S, d_inner)

    # gated RMSNorm: norm(y * silu(z)) (mamba2 norm_before_gate=False)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return qmatmul(y, p["out_proj"], quant=quant)


def _partial_rotary(q, k, a, cos, sin, positions=None):
    """Rotary over the first ``rotary_emb_dim`` dims of each head."""
    r = a.rotary_emb_dim
    if r and r < a.head_dim:
        q = torch.cat([apply_rotary(q[..., :r], cos, sin, positions), q[..., r:]], dim=-1)
        k = torch.cat([apply_rotary(k[..., :r], cos, sin, positions), k[..., r:]], dim=-1)
    elif r:
        q = apply_rotary(q, cos, sin, positions)
        k = apply_rotary(k, cos, sin, positions)
    return q, k


@scoped("attn_mixer")
def _attn_mixer(x, p: Params, cfg: MambaConfig, cos, sin, attn_impl, quant="none",
                ring=None):
    B, S, _ = x.shape
    a = cfg.attn_cfg
    hd = a.head_dim
    q = qmatmul(x, p["wq"], quant=quant).reshape(B, S, a.num_heads, hd)
    k = qmatmul(x, p["wk"], quant=quant).reshape(B, S, a.num_heads_kv, hd)
    v = qmatmul(x, p["wv"], quant=quant).reshape(B, S, a.num_heads_kv, hd)
    q, k = _partial_rotary(q, k, a, cos, sin)
    if ring is not None and ring.cp > 1:
        o = ring_attention(q, k, v, ring, causal=a.causal, impl=attn_impl)
    else:
        o = attention(q, k, v, causal=a.causal, impl=attn_impl)
    return qmatmul(o.reshape(B, S, a.num_heads * hd), p["wo"], quant=quant)


@scoped("mlp")
def _mlp(x, p: Params, quant="none"):
    gate = F.silu(qmatmul(x, p["w1"], quant=quant))
    return qmatmul(gate * qmatmul(x, p["w3"], quant=quant), p["w2"], quant=quant)


def _block(residual, layer, *, cfg, is_attn, cos, sin, attn_impl, mamba_kernel,
           compute_dtype, quant="none", ring=None):
    h = rms_norm(residual.to(compute_dtype), layer["norm"], cfg.norm_eps)
    if is_attn:
        out = _attn_mixer(h, layer["mixer"], cfg, cos, sin, attn_impl, quant, ring)
    else:
        out = _mamba_mixer(h, layer["mixer"], cfg, kernel=mamba_kernel, quant=quant,
                           ring=ring)
    residual = residual + out.float()
    if "mlp" in layer:
        h = rms_norm(residual.to(compute_dtype), layer["norm2"], cfg.norm_eps)
        residual = residual + _mlp(h, layer["mlp"], quant).float()
    return residual


def _indexed_block(residual, *, layers, i: int, **kwargs):
    return _block(residual, layers[i], **kwargs)


def mamba_forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: MambaConfig,
    *,
    compute_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    ac_mask: Optional[List[bool]] = None,
    scan_layers: bool = False,  # heterogeneous layers: always a Python loop
    return_hidden: bool = False,
    quant: str = "none",
    mamba_kernel: str = "auto",
    ring=None,
):
    """tokens (B, S) integer -> logits (B, S, padded_vocab) in the compute
    dtype. The whole tree is cast to the compute dtype first, as JAX does
    (``mamba.py:236``): under bf16 ``A_log``, ``dt_bias``, ``D`` and the
    norms are rounded to bf16 before their fp32 use. Layers whose
    ``ac_mask`` entry is True run under ``torch.utils.checkpoint``
    (non-reentrant), so their forward, the SSD kernel included, runs a
    second time in the backward. With a context ``ring`` the tokens are
    this rank's part of the sequence (rotary at its positions, the conv's
    halo, ``ssd_scan_cp``, ring attention)."""
    del scan_layers
    check_quant_mode(quant)
    params = tree_map(lambda w: w.to(compute_dtype), params)
    n_layer = len(params["layers"])
    ac_mask = ac_mask if ac_mask is not None else [False] * n_layer
    if len(ac_mask) != n_layer:
        raise ValueError(f"ac_mask has {len(ac_mask)} entries for {n_layer} layers")

    residual = F.embedding(tokens, params["embedding"]).float()  # residual_in_fp32

    a = cfg.attn_cfg
    offset = ring.seq_offset(tokens.shape[1]) if ring is not None else 0
    cos, sin = rope_table(tokens.shape[1], a.rotary_emb_dim or a.head_dim, 10000.0,
                          device=tokens.device, offset=offset)

    layers = params["layers"]
    for i in range(n_layer):
        # the layer is fetched inside a checkpoint: under a data-parallel
        # step (parallel/sharding.py::GatheredLayers) fetching gathers it
        fn = functools.partial(
            _indexed_block, layers=layers, i=i, cfg=cfg,
            is_attn=i in cfg.attn_layer_idx, cos=cos, sin=sin,
            attn_impl=attn_impl, mamba_kernel=mamba_kernel, compute_dtype=compute_dtype,
            quant=quant, ring=ring,
        )
        if ac_mask[i]:
            residual = checkpoint(fn, residual, use_reentrant=False)
        else:
            residual = fn(residual)

    x = rms_norm(residual.to(compute_dtype), params["norm_f"], cfg.norm_eps)
    if return_hidden:
        return x
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# recurrent decode (serving path: serve/families/mamba.py)
# ---------------------------------------------------------------------------
#
# Serving decodes one token per step from O(1) recurrent state instead of a
# growing kv cache: per mamba layer a conv window (the last d_conv-1 xBC
# inputs) plus the fp32 SSD state h (H, headdim, d_state), together a
# fixed-size slab whose bytes never grow with generated length. Every op
# below replays the exact per-token math of the sequence path
# (``causal_conv1d``'s shifted multiply-add sum, ``ssd_scan_reference``'s
# recurrence, the gated RMSNorm). Hybrid configs' attention layers ride a
# kv cache supplied by the caller through ``attn_cb`` (dense buffers in
# prefill, the paged pools in serve-side decode).


def init_mamba_decode_state(cfg: MambaConfig, batch: int, compute_dtype=torch.float32,
                            device="cpu") -> List[Params]:
    """Per-layer recurrent decode state for ``batch`` slots.

    Mamba layers: {"conv": (B, d_conv-1, conv_dim) compute dtype, the
    sliding window of pre-conv xBC inputs; "ssd": (B, H, headdim, d_state)
    fp32, the carried SSD state}. Attention layers of hybrid configs hold
    no slab here ({}): their kv lives in the caller's paged pool."""
    state: List[Params] = []
    for i in range(cfg.n_layer):
        if i in cfg.attn_layer_idx:
            state.append({})
        else:
            state.append({
                "conv": torch.zeros((batch, cfg.d_conv - 1, _conv_dim(cfg)),
                                    dtype=compute_dtype, device=device),
                "ssd": torch.zeros((batch, cfg.nheads, cfg.headdim, cfg.d_state),
                                   dtype=torch.float32, device=device),
            })
    return state


def mamba_state_bytes_per_stream(cfg: MambaConfig, compute_dtype=torch.float32) -> int:
    """Slab bytes one decode stream holds, constant in generated length."""
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    n_mamba = cfg.n_layer - len(cfg.attn_layer_idx)
    conv = (cfg.d_conv - 1) * _conv_dim(cfg) * itemsize
    ssd = cfg.nheads * cfg.headdim * cfg.d_state * 4  # fp32
    return n_mamba * (conv + ssd)


def _mamba_mixer_step(x, st: Params, p: Params, cfg: MambaConfig):
    """One token through a Mamba2 mixer. x (B, D) post-norm hidden in the
    compute dtype; st the layer's {"conv", "ssd"} slab. Returns
    (out (B, D), new st). Op-for-op the single-position case of
    ``_mamba_mixer``: same split points, the conv as the same ascending-w
    fp32 multiply-add sum ``causal_conv1d`` writes out, the state update
    as the same einsums ``ssd_scan_reference`` loops over."""
    B, _ = x.shape
    H, Pd, G, N = cfg.nheads, cfg.headdim, cfg.ngroups, cfg.d_state
    d_inner = cfg.d_inner

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_inner]
    xBC_in = zxbcdt[..., d_inner : d_inner + _conv_dim(cfg)]
    dt_raw = zxbcdt[..., d_inner + _conv_dim(cfg) :]  # (B, H)

    # causal conv over the window of the last d_conv inputs (current
    # token included): the position-t row of causal_conv1d's output
    window = torch.cat([st["conv"], xBC_in[:, None, :]], dim=1)
    wf = p["conv_w"].float()
    xBC = window[:, 0].float() * wf[None, :, 0]
    for w in range(1, cfg.d_conv):
        xBC = xBC + window[:, w].float() * wf[None, :, w]
    xBC = xBC + p["conv_b"].float()[None, :]
    xBC = F.silu(xBC).to(x.dtype)

    xs = xBC[..., :d_inner].reshape(B, H, Pd)
    Bm = xBC[..., d_inner : d_inner + G * N].reshape(B, G, N)
    Cm = xBC[..., d_inner + G * N :].reshape(B, G, N)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B, H) fp32
    Af = -torch.exp(p["A_log"].float())
    rep = H // G
    xf = xs.float()
    Bf = Bm.float().repeat_interleave(rep, dim=1)
    Cf = Cm.float().repeat_interleave(rep, dim=1)

    h_ssd = st["ssd"] * torch.exp(dt * Af)[:, :, None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt, Bf, xf
    )
    y = torch.einsum("bhn,bhpn->bhp", Cf, h_ssd)
    y = y + p["D"].float()[None, :, None] * xf
    y = y.to(x.dtype).reshape(B, d_inner)

    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"conv": window[:, 1:], "ssd": h_ssd}


def _attn_qkv_step(h, p: Params, a, cos, sin, positions):
    """Projections + partial rotary for one decode position of a hybrid
    attn mixer. h (B, 1, D) post-norm; positions (B, 1) integer. Returns
    q (B, 1, nq, hd), k/v (B, 1, nkv, hd)."""
    B, m, _ = h.shape
    hd = a.head_dim
    q = (h @ p["wq"]).reshape(B, m, a.num_heads, hd)
    k = (h @ p["wk"]).reshape(B, m, a.num_heads_kv, hd)
    v = (h @ p["wv"]).reshape(B, m, a.num_heads_kv, hd)
    q, k = _partial_rotary(q, k, a, cos, sin, positions)
    return q, k, v


def _stack_step(params: Params, x_t, cfg: MambaConfig, states, attn_cb):
    """One token through the whole (heterogeneous) layer stack.

    x_t (B, D) embedding row in the compute dtype; ``attn_cb(j, h, mixer)
    -> (B, D)`` runs hybrid attn layer j (qkv + cache interaction + wo)
    against whatever cache the caller owns. Returns (residual (B, D)
    fp32, new per-layer states)."""
    compute_dtype = x_t.dtype
    residual = x_t.float()
    new_states = []
    attn_j = 0
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(residual.to(compute_dtype), layer["norm"], cfg.norm_eps)
        if i in cfg.attn_layer_idx:
            out = attn_cb(attn_j, h[:, None], layer["mixer"])
            attn_j += 1
            new_states.append(states[i])
        else:
            out, st = _mamba_mixer_step(h, states[i], layer["mixer"], cfg)
            new_states.append(st)
        residual = residual + out.float()
        if "mlp" in layer:
            h2 = rms_norm(residual.to(compute_dtype), layer["norm2"], cfg.norm_eps)
            residual = residual + _mlp(h2, layer["mlp"]).float()
    return residual, new_states


def row_mask(live, like):
    """(B,) row flags shaped to broadcast over ``like`` (B, ...)."""
    return live.reshape((live.shape[0],) + (1,) * (like.dim() - 1))


@torch.no_grad()
def mamba_prefill(
    params: Params,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    cfg: MambaConfig,
    *,
    compute_dtype=torch.float32,
    kv_len: int = 0,
):
    """Prompt prefill by running the recurrent step over the positions, a
    Python loop where JAX has ``lax.scan``.

    tokens (B, S_pad) integer, lengths (B,) actual prompt lengths
    (<= S_pad; state freezes per row past its length, so bucketed padding
    never corrupts the slab). Returns (logits (B, V) of each row's last
    real position, per-layer state, kv) where kv is a dense {"k", "v"}
    cache (n_attn, B, kv_len, nkv, hd) for hybrid attn layers (None when
    the config has none); a page-multiple ``kv_len`` feeds
    PagedKVCache.write_prompt directly. Because every position runs the
    exact ops of the recurrent decode step, prefill state equals the
    state a token-by-token decode of the prompt would carry."""
    params = tree_map(lambda w: w.to(compute_dtype), params)
    device = tokens.device
    B, S_pad = tokens.shape
    a = cfg.attn_cfg
    n_attn = len(cfg.attn_layer_idx)
    states = init_mamba_decode_state(cfg, B, compute_dtype, device)
    lengths = lengths.to(device)

    kv = None
    cos = sin = None
    if n_attn:
        kv_len = kv_len or S_pad
        if kv_len < S_pad:
            raise ValueError(f"kv_len {kv_len} < padded prompt {S_pad}")
        shape = (n_attn, B, kv_len, a.num_heads_kv, a.head_dim)
        kv = {"k": torch.zeros(shape, dtype=compute_dtype, device=device),
              "v": torch.zeros(shape, dtype=compute_dtype, device=device)}
        cos, sin = rope_table(kv_len, a.rotary_emb_dim or a.head_dim, 10000.0,
                              device=device)

    last_res = torch.zeros((B, cfg.d_model), dtype=torch.float32, device=device)
    for i in range(S_pad):
        live = i < lengths  # (B,) rows still inside their prompt
        x_t = params["embedding"][tokens[:, i].long()]

        def attn_cb(j, h, mixer):
            positions = torch.full((B, 1), i, dtype=torch.long, device=device)
            q, k, v = _attn_qkv_step(h, mixer, a, cos, sin, positions)
            # padded rows write zeros: the pages this buffer lands in keep
            # the zero-beyond-prompt discipline of the paged cache
            keep = live[:, None, None, None]
            kv["k"][j, :, i] = torch.where(keep, k, 0)[:, 0]
            kv["v"][j, :, i] = torch.where(keep, v, 0)[:, 0]
            o = gqa_attend(q, kv["k"][j], kv["v"][j], positions)
            return o[:, 0] @ mixer["wo"]

        residual, new_states = _stack_step(params, x_t, cfg, states, attn_cb)
        states = tree_map(lambda n, o: torch.where(row_mask(live, n), n, o),
                          new_states, states)
        last_res = torch.where((i == lengths - 1)[:, None], residual, last_res)

    x = rms_norm(last_res.to(compute_dtype), params["norm_f"], cfg.norm_eps)
    return x @ params["lm_head"], states, kv


@torch.no_grad()
def mamba_decode_step(
    params: Params,
    state,
    kv_pools,
    page_table,
    seq_lens: torch.Tensor,
    tokens: torch.Tensor,
    cfg: MambaConfig,
    *,
    page_size: int = 0,
    compute_dtype=torch.float32,
    rope=None,
):
    """One recurrent decode step for a ragged batch.

    tokens (B,) integer, each row's current token at position
    ``seq_lens[b]``; ``state`` the per-layer slab (all B slots step
    together; the caller masks idle rows). Hybrid attn layers scatter k/v
    into ``kv_pools`` ({"k", "v"}: (n_attn, pages, page_size, nkv, hd)),
    in place with ``index_put_`` where JAX scatters into donated buffers,
    and attend through ``gather_pages`` + ``gqa_attend``; pure-Mamba
    configs pass ``None`` and touch no cache at all. The slab is returned
    as new tensors. ``rope`` is an optional precomputed (cos, sin) table
    over max_pages * page_size positions. Returns (logits (B, V), state,
    kv_pools)."""
    params = tree_map(lambda w: w.to(compute_dtype), params)
    B = tokens.shape[0]
    a = cfg.attn_cfg
    x_t = params["embedding"][tokens.long()]

    if cfg.attn_layer_idx:
        if rope is None:
            max_seq = page_table.shape[1] * page_size
            rope = rope_table(max_seq, a.rotary_emb_dim or a.head_dim, 10000.0,
                              device=tokens.device)
        cos, sin = rope
        positions = seq_lens[:, None].long()
        rows = torch.arange(B, device=tokens.device)
        page_ids = page_table[rows, (seq_lens // page_size).long()].long()
        slots = (seq_lens % page_size).long()

        def attn_cb(j, h, mixer):
            q, k, v = _attn_qkv_step(h, mixer, a, cos, sin, positions)
            k_pool, v_pool = kv_pools["k"][j], kv_pools["v"][j]
            k_pool.index_put_((page_ids, slots), k[:, 0])
            v_pool.index_put_((page_ids, slots), v[:, 0])
            o = gqa_attend(q, gather_pages(k_pool, page_table),
                           gather_pages(v_pool, page_table), positions)
            return o[:, 0] @ mixer["wo"]

    else:

        def attn_cb(j, h, mixer):  # pragma: no cover - unreachable
            raise AssertionError("attn layer in a config without attn_layer_idx")

    residual, state = _stack_step(params, x_t, cfg, state, attn_cb)
    x = rms_norm(residual.to(compute_dtype), params["norm_f"], cfg.norm_eps)
    return x @ params["lm_head"], state, kv_pools
