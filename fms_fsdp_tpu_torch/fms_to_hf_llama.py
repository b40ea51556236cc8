"""Convert a Llama checkpoint of the port to the HuggingFace format.

Counterpart of ``fms_to_hf_llama.py`` at the repo root
(ref:fms_to_hf_llama.py:11-167). The reference splits fms's fused qkv and
gate-up projections and un-permutes its interleaved rotary layout; the
port's layout is JAX's, which already matches HF's conventions
(separate projections, half-split rotary), so the conversion is
transposes and names, with no permutation of q or k:

    embedding (V, D)        -> model.embed_tokens.weight
    layers.wq[i] (D, N*hd)  -> model.layers.i.self_attn.q_proj.weight^T
    layers.w1[i] (D, H)     -> model.layers.i.mlp.gate_proj.weight^T
    ...
    lm_head (D, V)          -> lm_head.weight^T

Host work only, in fp32 as JAX's numpy convert: nothing runs on the card,
so there is no ``device`` argument. transformers is imported inside the
functions (importing it can pull JAX into the interpreter).

    python -m fms_fsdp_tpu_torch.fms_to_hf_llama --model_variant=llama3_8b_4k \\
        --load_path=/ckpts/run1/checkpoints/step_1000_ckp \\
        --save_path=/out/hf_model [--tokenizer_name_or_path=/tok]

``--load_path`` takes what ``utils/checkpointing.py::load_params_only``
takes: a ``step_N_ckp`` dir, a ``checkpoints/`` root (its newest
committed step) or a params pickle. The model config comes from
``--model_variant`` and the dotted overrides (``--LlamaConfig.nlayers=2``)
and must match the checkpoint's shapes.
"""

import sys
from typing import Dict

import torch

# ckpt before utils.checkpointing: the other order is a circular import
import fms_fsdp_tpu_torch.ckpt  # noqa: F401
from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.utils.checkpointing import load_params_only
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(device="cpu", dtype=torch.float32).contiguous()


def _t(x: torch.Tensor) -> torch.Tensor:
    """The transpose of a 2-D weight in fp32 on the host, cast and
    transposed in one pass."""
    x = x.detach().to("cpu")
    return torch.empty((x.shape[1], x.shape[0]), dtype=torch.float32).copy_(x.T)


def params_to_hf_state_dict(params: Dict, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The port's Llama params -> the HF LlamaForCausalLM state dict (fp32
    CPU tensors)."""
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
        sd[f"{lp}.mlp.gate_proj.weight"] = _t(layer["w1"])
        sd[f"{lp}.mlp.up_proj.weight"] = _t(layer["w3"])
        sd[f"{lp}.mlp.down_proj.weight"] = _t(layer["w2"])
        sd[f"{lp}.input_layernorm.weight"] = _f32(layer["attn_norm"])
        sd[f"{lp}.post_attention_layernorm.weight"] = _f32(layer["ffn_norm"])
    return sd


def with_rope_theta(hf_cfg, theta: float):
    """``hf_cfg`` with its rotary base set where the installed transformers
    reads it: transformers 5 takes it from ``rope_parameters`` (its
    ``rope_theta`` keyword alone is not applied), 4.x from ``rope_theta``."""
    rope = getattr(hf_cfg, "rope_parameters", None)
    if isinstance(rope, dict):
        rope["rope_theta"] = theta
    return hf_cfg


def hf_config(cfg: LlamaConfig):
    from transformers import LlamaConfig as HFLlamaConfig

    return with_rope_theta(HFLlamaConfig(
        vocab_size=cfg.src_vocab_size,
        hidden_size=cfg.emb_dim,
        intermediate_size=cfg.hidden_dim,
        num_hidden_layers=cfg.nlayers,
        num_attention_heads=cfg.nheads,
        num_key_value_heads=cfg.n_kv_heads,
        max_position_embeddings=cfg.max_expected_seq_len,
        rms_norm_eps=cfg.norm_eps,
        rope_theta=cfg.rope_theta,
        tie_word_embeddings=False,
    ), cfg.rope_theta)


def hf_model_with(model_cls, hf_cfg, sd: Dict[str, torch.Tensor]):
    """A transformers model of ``model_cls`` (fp32, CPU) carrying ``sd``,
    through ``from_pretrained``'s state-dict path: no random init of
    weights that are all overwritten, and a key missing from ``sd`` or
    left over raises, as a strict ``load_state_dict`` does."""
    model, info = model_cls.from_pretrained(None, config=hf_cfg, state_dict=sd,
                                            torch_dtype=torch.float32,
                                            output_loading_info=True)
    bad = {k: info[k] for k in ("missing_keys", "unexpected_keys", "mismatched_keys")
           if info.get(k)}
    if bad:
        raise KeyError(f"the state dict does not fit {model_cls.__name__}: {bad}")
    return model


def convert_to_hf(params: Dict, cfg: LlamaConfig):
    """A transformers LlamaForCausalLM (fp32, CPU) carrying the params."""
    from transformers import LlamaForCausalLM

    return hf_model_with(LlamaForCausalLM, hf_config(cfg), params_to_hf_state_dict(params, cfg))


def load_params(load_path: str) -> Dict:
    """The params (only) of a checkpoint dir or a params pickle, as CPU
    tensors in the dtype they were saved in."""
    return load_params_only(load_path)


def save_tokenizer(tok: str, save_path: str) -> None:
    from transformers import AutoTokenizer

    AutoTokenizer.from_pretrained(tok).save_pretrained(save_path)
    print("Tokenizer copied.")


def main(**kwargs):
    cfg = get_model_config(kwargs.get("model_variant", "llama2_7b"))
    update_config(cfg, **kwargs)
    save_path = kwargs["save_path"]
    model = convert_to_hf(load_params(kwargs["load_path"]), cfg)
    model.save_pretrained(save_path, safe_serialization=True)
    print(f"HF model saved to {save_path}")
    if kwargs.get("tokenizer_name_or_path"):
        save_tokenizer(kwargs["tokenizer_name_or_path"], save_path)


if __name__ == "__main__":
    main(**parse_cli_args(sys.argv[1:]))
