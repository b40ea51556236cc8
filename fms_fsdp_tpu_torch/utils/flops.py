"""Model FLOPs accounting for MFU/HFU reporting.

Counterpart of the Llama part of ``fms_fsdp_tpu/utils/flops.py``, the
PaLM appendix-B convention the reference publishes (ref:README.md:22-30):

- matmul params contribute 2 FLOPs/param/token forward (the embedding
  gather none; the lm_head matmul counts);
- causal attention contributes 2 * S * d_attn FLOPs/token/layer forward;
- backward = 2x forward; train = 3x forward;
- HFU additionally counts the recomputed forward of remat'ed blocks.

The peak is the card's dense bf16 tensor rate from NVIDIA's data sheet.
"""

from fms_fsdp_tpu_torch.models.configs import LlamaConfig

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


def peak_flops_per_card(kind: str = "h100") -> float:
    """Peak dense bf16 FLOP/s of the named card."""
    key = kind.lower()
    for name, peak in GPU_PEAK_FLOPS.items():
        if name in key:
            return peak
    raise ValueError(f"no peak FLOP/s known for card {kind!r}: {sorted(GPU_PEAK_FLOPS)}")
