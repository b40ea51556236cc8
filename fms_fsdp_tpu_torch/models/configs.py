"""Model architecture configs: Llama, the Mamba2 hybrid and Mixtral.

Copies of ``fms_fsdp_tpu/models/configs.py``. ``LlamaConfig``: the same
architectural degrees of freedom the reference variant table exercises
(emb_dim, nheads, kvheads for GQA, nlayers, hidden_grow_factor +
multiple_of SwiGLU rounding, max_expected_seq_len, rope_theta, vocab).
``MambaAttnConfig`` / ``MambaConfig``: the hybrid Mamba2 stack of
``models/mamba.py`` with the mamba_ssm layer defaults. ``MixtralConfig``:
the sparse-MoE Llama family of ``models/mixtral.py`` (top-k of E SwiGLU
experts, capacity-routed in training).
"""

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class LlamaConfig:
    src_vocab_size: int = 32000
    emb_dim: int = 4096
    norm_eps: float = 1e-5
    nheads: int = 32
    kvheads: int = 0  # 0 -> MHA (kvheads = nheads), else GQA group count
    nlayers: int = 32
    hidden_grow_factor: float = 8 / 3
    multiple_of: int = 256
    max_expected_seq_len: int = 4096
    rope_theta: float = 10000.0
    p_dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.emb_dim // self.nheads

    @property
    def n_kv_heads(self) -> int:
        return self.kvheads if self.kvheads else self.nheads

    @property
    def hidden_dim(self) -> int:
        """SwiGLU inner width with multiple_of rounding (fms GatedLinearUnit)."""
        hidden = int(self.emb_dim * self.hidden_grow_factor)
        if self.multiple_of:
            hidden = self.multiple_of * (
                (hidden + self.multiple_of - 1) // self.multiple_of
            )
        return hidden

    def n_params(self, include_embeddings: bool = True) -> int:
        """Exact parameter count (untied input/output embeddings)."""
        d, h = self.emb_dim, self.hidden_dim
        kv_dim = self.n_kv_heads * self.head_dim
        per_layer = (
            d * d  # wq
            + 2 * d * kv_dim  # wk, wv
            + d * d  # wo
            + 3 * d * h  # w1 and w3 (d->h each), w2 (h->d)
            + 2 * d  # attn norm + ffn norm
        )
        total = self.nlayers * per_layer + d  # final norm
        if include_embeddings:
            total += 2 * self.src_vocab_size * d  # embed + lm head
        return int(total)


@dataclass(frozen=True)
class MambaAttnConfig:
    """Attention sub-config for hybrid Mamba (ref:config_utils.py:170-179)."""

    causal: bool = True
    d_conv: int = 0
    head_dim: int = 128
    num_heads: int = 32
    num_heads_kv: int = 8
    out_proj_bias: bool = False
    qkv_proj_bias: bool = False
    rotary_emb_dim: int = 64


@dataclass(frozen=True)
class MambaConfig:
    d_model: int = 4096
    d_intermediate: int = 14336  # MLP width; 0 -> no MLP block
    n_layer: int = 32
    vocab_size: int = 128256
    ssm_layer: str = "Mamba2"
    attn_layer_idx: Tuple[int, ...] = ()
    attn_cfg: MambaAttnConfig = field(default_factory=MambaAttnConfig)
    rms_norm: bool = True
    residual_in_fp32: bool = True
    fused_add_norm: bool = True
    pad_vocab_size_multiple: int = 16
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # Mamba2 layer hyperparameters (mamba_ssm defaults)
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk_size: int = 256

    @property
    def padded_vocab_size(self) -> int:
        m = self.pad_vocab_size_multiple
        return m * ((self.vocab_size + m - 1) // m)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim

    def n_params(self) -> int:
        """Exact parameter count of the hybrid stack (see models/mamba.py)."""
        d = self.d_model
        conv_dim = self.d_inner + 2 * self.ngroups * self.d_state
        in_proj = 2 * self.d_inner + 2 * self.ngroups * self.d_state + self.nheads
        per_mamba = (
            d * in_proj
            + conv_dim * (self.d_conv + 1)  # conv weight + bias
            + 3 * self.nheads  # dt_bias, A_log, D
            + self.d_inner  # gated norm
            + self.d_inner * d  # out_proj
        )
        a = self.attn_cfg
        per_attn = d * a.head_dim * (a.num_heads * 2 + a.num_heads_kv * 2)
        per_mlp = 3 * d * self.d_intermediate + d if self.d_intermediate else 0
        n_attn = len(self.attn_layer_idx)
        total = (
            (self.n_layer - n_attn) * per_mamba
            + n_attn * per_attn
            + self.n_layer * (per_mlp + d)  # mlp (+norm2) and mixer norm
            + d  # final norm
            + 2 * self.padded_vocab_size * d
        )
        return int(total)


@dataclass(frozen=True)
class MixtralConfig:
    """Sparse-MoE Llama family (Mixtral)."""

    src_vocab_size: int = 32000
    emb_dim: int = 4096
    nheads: int = 32
    kvheads: int = 8
    nlayers: int = 32
    hidden_dim: int = 14336
    num_experts: int = 8
    top_k: int = 2
    max_expected_seq_len: int = 4096
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    # training-only knobs (the dense path ignores them):
    # per-expert buffer size = capacity_factor * top_k * S / num_experts
    capacity_factor: float = 2.0
    # load-balancing auxiliary loss coefficient (HF router_aux_loss_coef)
    aux_loss_weight: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.emb_dim // self.nheads

    @property
    def n_kv_heads(self) -> int:
        return self.kvheads if self.kvheads else self.nheads

    def n_params(self, include_embeddings: bool = True) -> int:
        d, h, E = self.emb_dim, self.hidden_dim, self.num_experts
        kv_dim = self.n_kv_heads * self.head_dim
        per_layer = (
            d * d  # wq
            + 2 * d * kv_dim  # wk, wv
            + d * d  # wo
            + d * E  # router gate
            + 3 * E * d * h  # per-expert w1, w3, w2
            + 2 * d  # norms
        )
        total = self.nlayers * per_layer + d
        if include_embeddings:
            total += 2 * self.src_vocab_size * d
        return int(total)
