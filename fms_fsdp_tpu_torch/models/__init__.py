"""Model families of the port: Llama and the Mamba2 hybrid (Mixtral comes
with its slice, ROADMAP.md A.4)."""

from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MambaConfig

__all__ = ["LlamaConfig", "MambaConfig", "get_model_api"]


def get_model_api(model_cfg):
    """Dispatch a model config to (init_fn, forward_fn, n_layers), the
    counterpart of ``fms_fsdp_tpu/models/__init__.py:12`` without the
    sharding specs (one card)."""
    if isinstance(model_cfg, LlamaConfig):
        from fms_fsdp_tpu_torch.models.llama import init_llama_params, llama_forward

        return init_llama_params, llama_forward, model_cfg.nlayers
    if isinstance(model_cfg, MambaConfig):
        from fms_fsdp_tpu_torch.models.mamba import init_mamba_params, mamba_forward

        return init_mamba_params, mamba_forward, model_cfg.n_layer
    name = type(model_cfg).__name__
    if "Mixtral" in name:
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md A.4")
    raise TypeError(f"unknown model config type: {name}")
