"""Export a Mamba hybrid checkpoint of the port to the mamba_ssm layout.

Counterpart of ``fms_to_hf_mamba.py`` at the repo root
(ref:fms_to_hf_mamba.py:9-33): the ``save_pretrained`` layout of
mamba_ssm's ``MambaLMHeadModel``, a directory holding ``config.json``
(the MambaConfig dict) and ``pytorch_model.bin`` with mamba_ssm's
parameter names:

    backbone.embedding.weight
    backbone.layers.N.norm.weight / .norm2.weight
    backbone.layers.N.mixer.{in_proj,conv1d,dt_bias,A_log,D,norm,out_proj}
    backbone.layers.N.mixer.{in_proj (qkv fused),out_proj}  (attn layers)
    backbone.layers.N.mlp.{fc1 (up|gate fused),fc2}
    backbone.norm_f.weight, lm_head.weight

Host work only, in fp32 as JAX's numpy export: nothing runs on the card,
so there is no ``device`` argument. mamba_ssm is not needed: the export
is checked by its structure and its parameter count.

    python -m fms_fsdp_tpu_torch.fms_to_hf_mamba --model_variant=mamba_9.8b \\
        --load_path=/ckpts/run1/checkpoints --save_path=/out/mamba_model
"""

import json
import os
import sys
from dataclasses import asdict
from typing import Dict

import torch

from fms_fsdp_tpu_torch.fms_to_hf_llama import _f32, _t, load_params
from fms_fsdp_tpu_torch.models.configs import MambaConfig
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config


def params_to_mamba_ssm_state_dict(params: Dict, cfg: MambaConfig) -> Dict[str, torch.Tensor]:
    """The port's Mamba params (``layers`` a list) -> the mamba_ssm state
    dict (fp32 CPU tensors)."""
    sd = {
        "backbone.embedding.weight": _f32(params["embedding"]),
        "backbone.norm_f.weight": _f32(params["norm_f"]),
        "lm_head.weight": _t(params["lm_head"]),
    }
    for i, layer in enumerate(params["layers"]):
        lp = f"backbone.layers.{i}"
        sd[f"{lp}.norm.weight"] = _f32(layer["norm"])
        m = layer["mixer"]
        if i in cfg.attn_layer_idx:
            # mamba_ssm MHA: one fused in_proj, (nq + 2*nkv) * hd rows
            sd[f"{lp}.mixer.in_proj.weight"] = torch.cat(
                [_t(m["wq"]), _t(m["wk"]), _t(m["wv"])], dim=0)
            sd[f"{lp}.mixer.out_proj.weight"] = _t(m["wo"])
        else:
            sd[f"{lp}.mixer.in_proj.weight"] = _t(m["in_proj"])
            # torch's conv1d weight layout: (channels, 1, width)
            sd[f"{lp}.mixer.conv1d.weight"] = _f32(m["conv_w"])[:, None, :]
            sd[f"{lp}.mixer.conv1d.bias"] = _f32(m["conv_b"])
            sd[f"{lp}.mixer.dt_bias"] = _f32(m["dt_bias"])
            sd[f"{lp}.mixer.A_log"] = _f32(m["A_log"])
            sd[f"{lp}.mixer.D"] = _f32(m["D"])
            sd[f"{lp}.mixer.norm.weight"] = _f32(m["norm"])
            sd[f"{lp}.mixer.out_proj.weight"] = _t(m["out_proj"])
        if "mlp" in layer:
            sd[f"{lp}.norm2.weight"] = _f32(layer["norm2"])
            # mamba_ssm's GatedMLP splits fc1's output as (y, gate) with
            # the activation on the SECOND chunk: rows [up (w3); gate (w1)]
            sd[f"{lp}.mlp.fc1.weight"] = torch.cat(
                [_t(layer["mlp"]["w3"]), _t(layer["mlp"]["w1"])], dim=0)
            sd[f"{lp}.mlp.fc2.weight"] = _t(layer["mlp"]["w2"])
    return sd


def mamba_ssm_config_dict(cfg: MambaConfig) -> dict:
    """The MambaConfig dict that mamba_ssm reads
    (ref:config_utils.py:162-185)."""
    return {
        "d_model": cfg.d_model,
        "d_intermediate": cfg.d_intermediate,
        "n_layer": cfg.n_layer,
        "vocab_size": cfg.vocab_size,
        "ssm_cfg": {"layer": cfg.ssm_layer},
        "attn_layer_idx": list(cfg.attn_layer_idx),
        "attn_cfg": asdict(cfg.attn_cfg),
        "rms_norm": cfg.rms_norm,
        "residual_in_fp32": cfg.residual_in_fp32,
        "fused_add_norm": cfg.fused_add_norm,
        "pad_vocab_size_multiple": cfg.pad_vocab_size_multiple,
        "tie_embeddings": cfg.tie_embeddings,
    }


def save_pretrained(params: Dict, cfg: MambaConfig, save_path: str) -> None:
    os.makedirs(save_path, exist_ok=True)
    torch.save(params_to_mamba_ssm_state_dict(params, cfg),
               os.path.join(save_path, "pytorch_model.bin"))
    with open(os.path.join(save_path, "config.json"), "w") as f:
        json.dump(mamba_ssm_config_dict(cfg), f, indent=2)


def main(**kwargs):
    cfg = get_model_config(kwargs.get("model_variant", "mamba_9.8b"))
    update_config(cfg, **kwargs)
    save_path = kwargs["save_path"]
    save_pretrained(load_params(kwargs["load_path"]), cfg, save_path)
    print(f"mamba_ssm-format model saved to {save_path}")


if __name__ == "__main__":
    main(**parse_cli_args(sys.argv[1:]))
