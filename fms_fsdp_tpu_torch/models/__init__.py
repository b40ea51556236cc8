"""Model families of the port: Llama, the Mamba2 hybrid and Mixtral."""

from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MambaConfig, MixtralConfig

__all__ = ["LlamaConfig", "MambaConfig", "MixtralConfig", "get_model_api"]


def get_model_api(model_cfg):
    """Dispatch a model config to (init_fn, forward_fn, n_layers), the
    counterpart of ``fms_fsdp_tpu/models/__init__.py:12`` without the
    sharding specs (``parallel/sharding.py::param_specs`` holds them)."""
    if isinstance(model_cfg, MixtralConfig):
        from fms_fsdp_tpu_torch.models.mixtral import init_mixtral_params, mixtral_forward

        return init_mixtral_params, mixtral_forward, model_cfg.nlayers
    if isinstance(model_cfg, LlamaConfig):
        from fms_fsdp_tpu_torch.models.llama import init_llama_params, llama_forward

        return init_llama_params, llama_forward, model_cfg.nlayers
    if isinstance(model_cfg, MambaConfig):
        from fms_fsdp_tpu_torch.models.mamba import init_mamba_params, mamba_forward

        return init_mamba_params, mamba_forward, model_cfg.n_layer
    raise TypeError(f"unknown model config type: {type(model_cfg).__name__}")
