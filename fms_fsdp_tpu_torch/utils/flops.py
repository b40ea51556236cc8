"""Model FLOPs accounting for MFU/HFU reporting.

Counterpart of ``fms_fsdp_tpu/utils/flops.py``,
the PaLM appendix-B convention the reference publishes (ref:README.md:22-30):

- matmul params contribute 2 FLOPs/param/token forward (the embedding
  gather none; the lm_head matmul counts);
- causal attention contributes 2 * S * d_attn FLOPs/token/layer forward;
- backward = 2x forward; train = 3x forward;
- HFU additionally counts the recomputed forward of remat'ed blocks;
- a MoE layer counts its router and its ``top_k`` activated experts only
  (capacity slack and dispatch movement are work that does not count).

The peak is the card's dense bf16 tensor rate from NVIDIA's data sheet.
"""

from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MambaConfig, MixtralConfig

# Peak dense bf16 FLOP/s per card (H100 SXM data sheet, at 700 W).
GPU_PEAK_FLOPS = {"h100": 989e12}


def llama_matmul_params(cfg: LlamaConfig) -> int:
    """Params participating in matmuls (everything but the embedding table)."""
    return cfg.n_params(include_embeddings=False) + cfg.src_vocab_size * cfg.emb_dim


def llama_fwd_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    mm = 2 * llama_matmul_params(cfg)
    attn_dim = cfg.nheads * cfg.head_dim
    attn = cfg.nlayers * 2 * seq_len * attn_dim  # causal: S/2 keys avg, x4
    return mm + attn


def llama_train_flops_per_token(
    cfg: LlamaConfig, seq_len: int, ac_fraction: float = 0.0
) -> float:
    """Model FLOPs (MFU numerator) per token for fwd+bwd; ``ac_fraction``
    > 0 gives the HFU numerator (remat'ed blocks replay their forward)."""
    return llama_fwd_flops_per_token(cfg, seq_len) * (3 + ac_fraction)


def mamba_matmul_params(cfg: MambaConfig) -> int:
    """Matmul-participating params of the hybrid Mamba2 stack (everything
    but the embedding gather; lm_head counts), by the layer shapes of
    ``models/mamba.py::init_mamba_params``."""
    d = cfg.d_model
    ipd = 2 * cfg.d_inner + 2 * cfg.ngroups * cfg.d_state + cfg.nheads
    a = cfg.attn_cfg
    total = d * cfg.padded_vocab_size  # lm_head
    for i in range(cfg.n_layer):
        if i in cfg.attn_layer_idx:
            total += d * (a.num_heads + 2 * a.num_heads_kv) * a.head_dim
            total += a.num_heads * a.head_dim * d
        else:
            total += d * ipd + cfg.d_inner * d
        if cfg.d_intermediate > 0:
            total += 3 * d * cfg.d_intermediate
    return total


def ssd_scan_flops_per_token(cfg: MambaConfig, seq_len: int) -> float:
    """Forward FLOPs/token of one layer's chunked SSD scan: C.B^T
    (2*L*G*N), the intra-chunk product with x (2*L*H*P), the chunk states
    and the inter-chunk output (2*N*H*P each)."""
    L = min(cfg.chunk_size, seq_len)  # ssd_scan clamps the chunk the same way
    G, N = cfg.ngroups, cfg.d_state
    H, P = cfg.nheads, cfg.headdim
    return 2 * L * G * N + 2 * L * H * P + 4 * N * H * P


def mamba_fwd_flops_per_token(cfg: MambaConfig, seq_len: int) -> float:
    """Forward FLOPs/token: matmuls + the chunked SSD scan + conv1d + the
    hybrid attention layers (causal convention as in the Llama
    accounting)."""
    mm = 2 * mamba_matmul_params(cfg)
    G, N = cfg.ngroups, cfg.d_state
    n_mamba = cfg.n_layer - len(cfg.attn_layer_idx)
    scan = n_mamba * ssd_scan_flops_per_token(cfg, seq_len)
    conv = n_mamba * 2 * (cfg.d_inner + 2 * G * N) * cfg.d_conv
    a = cfg.attn_cfg
    attn = len(cfg.attn_layer_idx) * 2 * seq_len * a.num_heads * a.head_dim
    return mm + scan + conv + attn


def mamba_train_flops_per_token(cfg: MambaConfig, seq_len: int,
                                ac_fraction: float = 0.0) -> float:
    return mamba_fwd_flops_per_token(cfg, seq_len) * (3 + ac_fraction)


def mixtral_matmul_params_active(cfg: MixtralConfig) -> int:
    """Matmul params a token touches: attention, the router, the
    ``top_k`` activated expert SwiGLUs and lm_head."""
    d, h = cfg.emb_dim, cfg.hidden_dim
    attn_dim = cfg.nheads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    per_layer = (
        d * attn_dim  # wq
        + 2 * d * kv_dim  # wk, wv
        + attn_dim * d  # wo
        + d * cfg.num_experts  # router gate
        + cfg.top_k * 3 * d * h  # activated expert SwiGLU
    )
    return cfg.nlayers * per_layer + cfg.src_vocab_size * d  # + lm_head


def mixtral_fwd_flops_per_token(cfg: MixtralConfig, seq_len: int) -> float:
    mm = 2 * mixtral_matmul_params_active(cfg)
    attn = cfg.nlayers * 2 * seq_len * cfg.nheads * cfg.head_dim
    return mm + attn


def mixtral_train_flops_per_token(cfg: MixtralConfig, seq_len: int,
                                  ac_fraction: float = 0.0) -> float:
    return mixtral_fwd_flops_per_token(cfg, seq_len) * (3 + ac_fraction)


def train_flops_per_token(model_cfg, seq_len: int, ac_fraction: float = 0.0) -> float:
    """Family dispatch for MFU/HFU accounting."""
    if isinstance(model_cfg, MixtralConfig):
        return mixtral_train_flops_per_token(model_cfg, seq_len, ac_fraction)
    if isinstance(model_cfg, LlamaConfig):
        return llama_train_flops_per_token(model_cfg, seq_len, ac_fraction)
    if isinstance(model_cfg, MambaConfig):
        return mamba_train_flops_per_token(model_cfg, seq_len, ac_fraction)
    raise TypeError(f"no FLOPs model for {type(model_cfg).__name__}")


def peak_flops_per_card(kind: str = "h100") -> float:
    """Peak dense bf16 FLOP/s of the named card."""
    key = kind.lower()
    for name, peak in GPU_PEAK_FLOPS.items():
        if name in key:
            return peak
    raise ValueError(f"no peak FLOP/s known for card {kind!r}: {sorted(GPU_PEAK_FLOPS)}")
