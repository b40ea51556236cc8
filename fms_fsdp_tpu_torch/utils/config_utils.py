"""Config overrides and the model-variant table.

``update_config`` is a copy of ``fms_fsdp_tpu/utils/config_utils.py:33``
(ref:fms_fsdp/utils/config_utils.py:6-22): set matching attributes,
support dotted ``ClassName.param`` addressing, warn on unknown keys.

A copy of the Llama rows of ``fms_fsdp_tpu/utils/config_utils.py``
(reference: fms_fsdp/utils/config_utils.py:25-161): llama2 {1.4b, 7b,
13b, 34b, 70b} and llama3 {194m_4k, 1.8b, 3.2b, 8b, 70b} with their
``_4k`` context variants, ``mamba_9.8b`` (``:148-172``) and
``mixtral_8x7b`` (``:173-189``).
"""

import dataclasses

from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.models.configs import (
    LlamaConfig,
    MambaAttnConfig,
    MambaConfig,
    MixtralConfig,
)


def _set(config, name, value):
    # model configs are frozen dataclasses; the CLI override path is the
    # one sanctioned mutation site
    if dataclasses.is_dataclass(config) and config.__dataclass_params__.frozen:
        object.__setattr__(config, name, value)
    else:
        setattr(config, name, value)


def update_config(config, **kwargs):
    if isinstance(config, (tuple, list)):
        for c in config:
            update_config(c, **kwargs)
        return
    for k, v in kwargs.items():
        if hasattr(config, k):
            _set(config, k, v)
        elif "." in k:
            config_name, param_name = k.split(".")
            if type(config).__name__ == config_name:
                if hasattr(config, param_name):
                    _set(config, param_name, v)
                else:
                    print(f"Warning: {config_name} does not accept parameter: {k}")
        elif isinstance(config, TrainConfig):
            print(f"Warning: unknown parameter {k}")

_LLAMA_VARIANTS = {
    "llama2_70b": dict(
        emb_dim=8192,
        multiple_of=4096,
        nheads=64,
        kvheads=8,
        nlayers=80,
        hidden_grow_factor=28672 / 8192,
    ),
    "llama2_34b": dict(
        emb_dim=8192,
        nheads=64,
        kvheads=8,
        nlayers=48,
        hidden_grow_factor=22016 / 8192,
        max_expected_seq_len=16384,
        rope_theta=1000000.0,
    ),
    "llama2_13b": dict(
        emb_dim=5120,
        nheads=40,
        nlayers=40,
        hidden_grow_factor=13824 / 5120,
    ),
    "llama2_7b": dict(
        hidden_grow_factor=11008 / 4096,
        kvheads=32,
    ),
    "llama2_1.4b": dict(
        emb_dim=2048,
        nheads=16,
        nlayers=24,
        hidden_grow_factor=3,
        kvheads=4,
    ),
    "llama3_8b": dict(
        src_vocab_size=128256,
        emb_dim=4096,
        nheads=32,
        kvheads=8,
        nlayers=32,
        hidden_grow_factor=3.5,
        max_expected_seq_len=8192,
        rope_theta=500000.0,
    ),
    "llama3_1.8b": dict(
        src_vocab_size=128256,
        emb_dim=2048,
        nheads=16,
        kvheads=8,
        nlayers=24,
        hidden_grow_factor=3.5,
        max_expected_seq_len=8192,
        rope_theta=500000.0,
    ),
    "llama3_3.2b": dict(
        src_vocab_size=128256,
        emb_dim=3072,
        nheads=24,
        kvheads=8,
        nlayers=24,
        hidden_grow_factor=8 / 3,
        max_expected_seq_len=8192,
        rope_theta=500000.0,
    ),
    "llama3_70b": dict(
        src_vocab_size=128256,
        emb_dim=8192,
        nheads=64,
        kvheads=8,
        nlayers=80,
        hidden_grow_factor=3.5,
        max_expected_seq_len=8192,
        rope_theta=500000.0,
    ),
    "llama3_194m_4k": dict(
        src_vocab_size=128256,
        emb_dim=1024,
        nheads=8,
        nlayers=10,
        max_expected_seq_len=4096,
        rope_theta=500000.0,
    ),
}

# llama3 *_4k variants: same architecture with a 4096 context window
# (reference: fms_fsdp/utils/config_utils.py:76-86,98-108,120-130,142-152).
for _name in ["llama3_8b", "llama3_1.8b", "llama3_3.2b", "llama3_70b"]:
    _LLAMA_VARIANTS[_name + "_4k"] = dict(
        _LLAMA_VARIANTS[_name], max_expected_seq_len=4096
    )

def get_model_config(model_variant):
    if model_variant in _LLAMA_VARIANTS:
        return LlamaConfig(**_LLAMA_VARIANTS[model_variant])
    if model_variant == "mamba_9.8b":
        # ref:fms_fsdp/utils/config_utils.py:162-185
        return MambaConfig(
            d_model=4096,
            d_intermediate=14336,
            n_layer=32,
            vocab_size=128256,
            ssm_layer="Mamba2",
            attn_layer_idx=(9, 18, 27),
            attn_cfg=MambaAttnConfig(
                causal=True,
                d_conv=0,
                head_dim=128,
                num_heads=32,
                num_heads_kv=8,
                out_proj_bias=False,
                qkv_proj_bias=False,
                rotary_emb_dim=64,
            ),
            rms_norm=True,
            residual_in_fp32=True,
            fused_add_norm=True,
            pad_vocab_size_multiple=16,
            tie_embeddings=False,
        )
    if model_variant == "mixtral_8x7b":
        # Mixtral-8x7B (46.7B total / 12.9B active params)
        return MixtralConfig(
            src_vocab_size=32000,
            emb_dim=4096,
            nheads=32,
            kvheads=8,
            nlayers=32,
            hidden_dim=14336,
            num_experts=8,
            top_k=2,
            max_expected_seq_len=4096,
            rope_theta=1e6,
        )
    raise ValueError(f"model variant {model_variant} not supported.")
