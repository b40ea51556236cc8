"""Model families of the port: Llama (Mamba and Mixtral come with their
slices, ROADMAP.md A.3 and A.4)."""

from fms_fsdp_tpu_torch.models.configs import LlamaConfig

__all__ = ["LlamaConfig", "get_model_api"]


def get_model_api(model_cfg):
    """Dispatch a model config to (init_fn, forward_fn, n_layers), the
    counterpart of ``fms_fsdp_tpu/models/__init__.py:12`` without the
    sharding specs (one card)."""
    if isinstance(model_cfg, LlamaConfig):
        from fms_fsdp_tpu_torch.models.llama import init_llama_params, llama_forward

        return init_llama_params, llama_forward, model_cfg.nlayers
    name = type(model_cfg).__name__
    if "Mamba" in name:
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md A.3")
    if "Mixtral" in name:
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md A.4")
    raise TypeError(f"unknown model config type: {name}")
