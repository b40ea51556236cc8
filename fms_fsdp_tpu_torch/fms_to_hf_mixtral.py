"""Convert a Mixtral checkpoint of the port to the HuggingFace format.

Counterpart of ``fms_to_hf_mixtral.py`` at the repo root, the inverse of
``models/hf_import.py::hf_to_mixtral_params``:

    embedding (V, D)          -> model.embed_tokens.weight
    layers.wq[i] (D, N*hd)    -> model.layers.i.self_attn.q_proj.weight^T
    layers.gate[i] (D, E)     -> model.layers.i.block_sparse_moe.gate.weight^T
    layers.w1[i] (E, D, H)[e] -> ...block_sparse_moe.experts.e.w1.weight^T
    layers.w2[i] (E, H, D)[e] -> ...block_sparse_moe.experts.e.w2.weight^T
    lm_head (D, V)            -> lm_head.weight^T

Host work only, in fp32 as JAX's numpy convert: nothing runs on the card,
so there is no ``device`` argument.

    python -m fms_fsdp_tpu_torch.fms_to_hf_mixtral --model_variant=mixtral_8x7b \\
        --load_path=/ckpts/run1/checkpoints/step_1000_ckp \\
        --save_path=/out/hf_model [--tokenizer_name_or_path=/tok]
"""

import sys
from typing import Dict

import torch

from fms_fsdp_tpu_torch.fms_to_hf_llama import (
    _f32,
    _t,
    hf_model_with,
    load_params,
    save_tokenizer,
    with_rope_theta,
)
from fms_fsdp_tpu_torch.models.configs import MixtralConfig
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config


def params_to_hf_state_dict(params: Dict, cfg: MixtralConfig) -> Dict[str, torch.Tensor]:
    """The port's Mixtral params -> the HF MixtralForCausalLM state dict
    (fp32 CPU tensors)."""
    sd = {
        "model.embed_tokens.weight": _f32(params["embedding"]),
        "model.norm.weight": _f32(params["norm"]),
        "lm_head.weight": _t(params["lm_head"]),
    }
    layers = params["layers"]
    for i in range(layers["wq"].shape[0]):
        lp = f"model.layers.{i}"
        layer = {k: v[i] for k, v in layers.items()}
        sd[f"{lp}.self_attn.q_proj.weight"] = _t(layer["wq"])
        sd[f"{lp}.self_attn.k_proj.weight"] = _t(layer["wk"])
        sd[f"{lp}.self_attn.v_proj.weight"] = _t(layer["wv"])
        sd[f"{lp}.self_attn.o_proj.weight"] = _t(layer["wo"])
        sd[f"{lp}.input_layernorm.weight"] = _f32(layer["attn_norm"])
        sd[f"{lp}.post_attention_layernorm.weight"] = _f32(layer["ffn_norm"])
        sd[f"{lp}.block_sparse_moe.gate.weight"] = _t(layer["gate"])
        for e in range(cfg.num_experts):
            ep = f"{lp}.block_sparse_moe.experts.{e}"
            sd[f"{ep}.w1.weight"] = _t(layer["w1"][e])
            sd[f"{ep}.w3.weight"] = _t(layer["w3"][e])
            sd[f"{ep}.w2.weight"] = _t(layer["w2"][e])
    return sd


def hf_config(cfg: MixtralConfig):
    from transformers import MixtralConfig as HFMixtralConfig

    return with_rope_theta(HFMixtralConfig(
        vocab_size=cfg.src_vocab_size,
        hidden_size=cfg.emb_dim,
        intermediate_size=cfg.hidden_dim,
        num_hidden_layers=cfg.nlayers,
        num_attention_heads=cfg.nheads,
        num_key_value_heads=cfg.n_kv_heads,
        num_local_experts=cfg.num_experts,
        num_experts_per_tok=cfg.top_k,
        max_position_embeddings=cfg.max_expected_seq_len,
        rms_norm_eps=cfg.norm_eps,
        rope_theta=cfg.rope_theta,
        router_aux_loss_coef=cfg.aux_loss_weight,
        tie_word_embeddings=False,
    ), cfg.rope_theta)


def convert_to_hf(params: Dict, cfg: MixtralConfig):
    """A transformers MixtralForCausalLM (fp32, CPU) carrying the params."""
    from transformers import MixtralForCausalLM

    return hf_model_with(MixtralForCausalLM, hf_config(cfg), params_to_hf_state_dict(params, cfg))


def main(**kwargs):
    cfg = get_model_config(kwargs.get("model_variant", "mixtral_8x7b"))
    update_config(cfg, **kwargs)
    save_path = kwargs["save_path"]
    model = convert_to_hf(load_params(kwargs["load_path"]), cfg)
    model.save_pretrained(save_path, safe_serialization=True)
    print(f"HF model saved to {save_path}")
    if kwargs.get("tokenizer_name_or_path"):
        save_tokenizer(kwargs["tokenizer_name_or_path"], save_path)


if __name__ == "__main__":
    main(**parse_cli_args(sys.argv[1:]))
