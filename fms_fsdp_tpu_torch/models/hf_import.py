"""HF -> the port's param trees, for the speculator's frozen bases.

Counterpart of ``fms_fsdp_tpu/models/hf_import.py``. The reference loads
its speculator bases from HF checkpoints through
``fms.models.get_model(..., source="hf")``
(ref:speculator/train_speculator.py:115-131). Here a local HF checkpoint
directory is read with transformers and its state dict, torch tensors
widened to fp32, is mapped onto the port's trees: stacked (L, ...) layer
weights, Linear weights (out, in) transposed to ``x @ W``'s (in, out).
For Llama this is the exact inverse of
``fms_to_hf_llama.py::params_to_hf_state_dict``.

Supported architectures (the reference's Embed* registry,
ref:speculator/train_speculator_utils.py:430-569):

    llama       -> models/llama.py tree
    gpt_bigcode -> models/gpt_bigcode.py tree
    mixtral     -> models/mixtral.py tree

Host work only: the tensors come back on the CPU, and the caller moves
them. transformers is imported inside the functions (importing it can
pull JAX into the interpreter).
"""

import os
from typing import Dict

import torch

from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MixtralConfig
from fms_fsdp_tpu_torch.models.gpt_bigcode import GPTBigCodeConfig


def is_hf_checkpoint(path: str) -> bool:
    """A HuggingFace model directory: one that holds ``config.json``."""
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json"))


def rope_theta_of(hf_cfg, default: float = 10000.0) -> float:
    """An HF config's rotary base: transformers 5 keeps it in
    ``rope_parameters``, 4.x in ``rope_theta``."""
    rope = getattr(hf_cfg, "rope_parameters", None)
    if isinstance(rope, dict) and "rope_theta" in rope:
        return rope["rope_theta"]
    return getattr(hf_cfg, "rope_theta", default)


def _sd(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu").float() for k, v in model.state_dict().items()}


def _to(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).contiguous()


def _stack(sd, fmt: str, nlayers: int, dtype, transpose: bool = True) -> torch.Tensor:
    """Per-layer weights -> one stacked (L, ...) tensor in ``dtype``;
    Linear weights (out, in) transpose to the port's (in, out). Each
    layer is cast and placed in one pass."""
    mats = [sd[fmt.format(i)] for i in range(nlayers)]
    if transpose:
        mats = [m.T for m in mats]
    out = torch.empty((nlayers, *mats[0].shape), dtype=dtype)
    for i, m in enumerate(mats):
        out[i].copy_(m)
    return out


# ---------------------------------------------------------------------------
# llama
# ---------------------------------------------------------------------------


def llama_config_from_hf(hf_cfg) -> LlamaConfig:
    return LlamaConfig(
        src_vocab_size=hf_cfg.vocab_size,
        emb_dim=hf_cfg.hidden_size,
        nheads=hf_cfg.num_attention_heads,
        kvheads=(
            0
            if hf_cfg.num_key_value_heads == hf_cfg.num_attention_heads
            else hf_cfg.num_key_value_heads
        ),
        nlayers=hf_cfg.num_hidden_layers,
        # +0.5 then truncate: hidden_dim == intermediate_size exactly,
        # whatever the float rounding of the ratio
        hidden_grow_factor=(hf_cfg.intermediate_size + 0.5) / hf_cfg.hidden_size,
        multiple_of=1,
        max_expected_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=rope_theta_of(hf_cfg),
        norm_eps=hf_cfg.rms_norm_eps,
    )


def hf_to_llama_params(model, cfg: LlamaConfig, dtype=torch.bfloat16) -> Dict:
    """transformers LlamaForCausalLM -> the port's Llama tree."""
    sd = _sd(model)

    def stack(fmt, transpose=True):
        return _stack(sd, fmt, cfg.nlayers, dtype, transpose)

    return {
        "embedding": _to(sd["model.embed_tokens.weight"], dtype),
        "layers": {
            "attn_norm": stack("model.layers.{}.input_layernorm.weight", False),
            "wq": stack("model.layers.{}.self_attn.q_proj.weight"),
            "wk": stack("model.layers.{}.self_attn.k_proj.weight"),
            "wv": stack("model.layers.{}.self_attn.v_proj.weight"),
            "wo": stack("model.layers.{}.self_attn.o_proj.weight"),
            "ffn_norm": stack("model.layers.{}.post_attention_layernorm.weight", False),
            "w1": stack("model.layers.{}.mlp.gate_proj.weight"),
            "w3": stack("model.layers.{}.mlp.up_proj.weight"),
            "w2": stack("model.layers.{}.mlp.down_proj.weight"),
        },
        "norm": _to(sd["model.norm.weight"], dtype),
        "lm_head": _to(sd["lm_head.weight"].T, dtype),
    }


# ---------------------------------------------------------------------------
# gpt_bigcode
# ---------------------------------------------------------------------------


def gpt_bigcode_config_from_hf(hf_cfg) -> GPTBigCodeConfig:
    if not getattr(hf_cfg, "multi_query", True):
        raise ValueError(
            "GPTBigCode import supports the multi_query=True layout only "
            "(the StarCoder family); this checkpoint uses full MHA"
        )
    return GPTBigCodeConfig(
        src_vocab_size=hf_cfg.vocab_size,
        emb_dim=hf_cfg.n_embd,
        nheads=hf_cfg.n_head,
        nlayers=hf_cfg.n_layer,
        hidden_grow_factor=(hf_cfg.n_inner or 4 * hf_cfg.n_embd) / hf_cfg.n_embd,
        max_expected_seq_len=hf_cfg.n_positions,
        ln_eps=hf_cfg.layer_norm_epsilon,
    )


def hf_to_gpt_bigcode_params(model, cfg: GPTBigCodeConfig, dtype=torch.bfloat16) -> Dict:
    """transformers GPTBigCodeForCausalLM -> the port's GPTBigCode tree."""
    sd = _sd(model)

    def stack(fmt, transpose=True):
        return _stack(sd, fmt, cfg.nlayers, dtype, transpose)

    return {
        "wte": _to(sd["transformer.wte.weight"], dtype),
        "wpe": _to(sd["transformer.wpe.weight"], dtype),
        "layers": {
            "ln1_w": stack("transformer.h.{}.ln_1.weight", False),
            "ln1_b": stack("transformer.h.{}.ln_1.bias", False),
            "c_attn": stack("transformer.h.{}.attn.c_attn.weight"),
            "attn_proj": stack("transformer.h.{}.attn.c_proj.weight"),
            "ln2_w": stack("transformer.h.{}.ln_2.weight", False),
            "ln2_b": stack("transformer.h.{}.ln_2.bias", False),
            "c_fc": stack("transformer.h.{}.mlp.c_fc.weight"),
            "mlp_proj": stack("transformer.h.{}.mlp.c_proj.weight"),
        },
        "ln_f_w": _to(sd["transformer.ln_f.weight"], dtype),
        "ln_f_b": _to(sd["transformer.ln_f.bias"], dtype),
    }


# ---------------------------------------------------------------------------
# mixtral
# ---------------------------------------------------------------------------


def mixtral_config_from_hf(hf_cfg) -> MixtralConfig:
    return MixtralConfig(
        src_vocab_size=hf_cfg.vocab_size,
        emb_dim=hf_cfg.hidden_size,
        nheads=hf_cfg.num_attention_heads,
        kvheads=hf_cfg.num_key_value_heads,
        nlayers=hf_cfg.num_hidden_layers,
        hidden_dim=hf_cfg.intermediate_size,
        num_experts=hf_cfg.num_local_experts,
        top_k=hf_cfg.num_experts_per_tok,
        max_expected_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=rope_theta_of(hf_cfg),
        norm_eps=hf_cfg.rms_norm_eps,
        aux_loss_weight=getattr(hf_cfg, "router_aux_loss_coef", 0.02),
    )


def _fused_to_per_expert(sd, cfg: MixtralConfig) -> None:
    """transformers 5 holds a Mixtral layer's experts fused in the model:
    ``mlp.experts.gate_up_proj`` (E, 2H, D), rows [w1 (gate); w3 (up)], and
    ``mlp.experts.down_proj`` (E, D, H), with the router at ``mlp.gate``.
    Adds 4.x's per-expert keys (the layout its checkpoints keep) to
    ``sd`` as views."""
    h = cfg.hidden_dim
    for i in range(cfg.nlayers):
        lp = f"model.layers.{i}"
        gate_up = sd[f"{lp}.mlp.experts.gate_up_proj"]
        down = sd[f"{lp}.mlp.experts.down_proj"]
        sd[f"{lp}.block_sparse_moe.gate.weight"] = sd[f"{lp}.mlp.gate.weight"]
        for e in range(cfg.num_experts):
            ep = f"{lp}.block_sparse_moe.experts.{e}"
            sd[f"{ep}.w1.weight"] = gate_up[e, :h]
            sd[f"{ep}.w3.weight"] = gate_up[e, h:]
            sd[f"{ep}.w2.weight"] = down[e]


def hf_to_mixtral_params(model, cfg: MixtralConfig, dtype=torch.bfloat16) -> Dict:
    """transformers MixtralForCausalLM -> the port's Mixtral tree, the
    experts stacked (L, E, in, out)."""
    sd = _sd(model)
    if "model.layers.0.mlp.experts.gate_up_proj" in sd:
        _fused_to_per_expert(sd, cfg)

    def stack(fmt, transpose=True):
        return _stack(sd, fmt, cfg.nlayers, dtype, transpose)

    def stack_experts(fmt):
        return _to(torch.stack([
            torch.stack([sd[fmt.format(i, e)].T for e in range(cfg.num_experts)])
            for i in range(cfg.nlayers)
        ]), dtype)

    experts = "model.layers.{}.block_sparse_moe.experts.{}"
    return {
        "embedding": _to(sd["model.embed_tokens.weight"], dtype),
        "layers": {
            "attn_norm": stack("model.layers.{}.input_layernorm.weight", False),
            "wq": stack("model.layers.{}.self_attn.q_proj.weight"),
            "wk": stack("model.layers.{}.self_attn.k_proj.weight"),
            "wv": stack("model.layers.{}.self_attn.v_proj.weight"),
            "wo": stack("model.layers.{}.self_attn.o_proj.weight"),
            "ffn_norm": stack("model.layers.{}.post_attention_layernorm.weight", False),
            "gate": stack("model.layers.{}.block_sparse_moe.gate.weight"),
            "w1": stack_experts(experts + ".w1.weight"),
            "w3": stack_experts(experts + ".w3.weight"),
            "w2": stack_experts(experts + ".w2.weight"),
        },
        "norm": _to(sd["model.norm.weight"], dtype),
        "lm_head": _to(sd["lm_head.weight"].T, dtype),
    }


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

_ARCHS = {
    "llama": (llama_config_from_hf, hf_to_llama_params),
    "gpt_bigcode": (gpt_bigcode_config_from_hf, hf_to_gpt_bigcode_params),
    "mixtral": (mixtral_config_from_hf, hf_to_mixtral_params),
}


def load_hf_base(path: str, dtype=torch.bfloat16):
    """Load a local HF checkpoint directory. Returns (arch, the port's
    config, params on the CPU in ``dtype``)."""
    from transformers import AutoConfig, AutoModelForCausalLM

    hf_cfg = AutoConfig.from_pretrained(path)
    arch = hf_cfg.model_type
    if arch not in _ARCHS:
        raise ValueError(
            f"unsupported HF base architecture {arch!r}; supported: {sorted(_ARCHS)}"
        )
    model = AutoModelForCausalLM.from_pretrained(path, torch_dtype="float32")
    cfg_fn, map_fn = _ARCHS[arch]
    cfg = cfg_fn(hf_cfg)
    params = map_fn(model, cfg, dtype=dtype)
    del model
    return arch, cfg, params
