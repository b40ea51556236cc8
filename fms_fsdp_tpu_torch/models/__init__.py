"""Model families of the port: Llama, the Mamba2 hybrid and Mixtral, and
the GPTBigCode speculator base."""

from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MambaConfig, MixtralConfig

__all__ = ["LlamaConfig", "MambaConfig", "MixtralConfig", "get_model_api",
           "BaseModelAPI", "get_base_api"]


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


class BaseModelAPI:
    """The frozen speculator base (``fms_fsdp_tpu/models/__init__.py:89``):
    a forward that yields the final hidden states, and a generate that can
    return per-position embeds.

    - ``forward_hidden(params, tokens, cfg, **kw) -> embeds``: JAX's
      ``forward_embeds`` without the lm_head product (JAX's jit drops the
      unused logits; an eager forward would compute them);
    - ``generate(params, prompts, cfg, generator=..., ...)`` -> tokens
      and, with ``include_embeds``, embeds.

    The Llama and Mixtral bases take ``tp`` (``parallel/tensor.py``) in
    both: the params are then this rank's tensor blocks, and generation
    samples from the logits gathered whole over tensor.
    """

    def __init__(self, arch, init_fn, forward_hidden, generate_fn):
        self.arch = arch
        self.init = init_fn
        self.forward_hidden = forward_hidden
        self.generate = generate_fn


def get_base_api(arch: str) -> BaseModelAPI:
    """arch: the reference's model_arch values, embedllama /
    embedmixtral / embedgptbigcode (bare names accepted too)."""
    key = arch.lower().removeprefix("embed")
    if key == "llama":
        from fms_fsdp_tpu_torch.models.generation import generate
        from fms_fsdp_tpu_torch.models.llama import init_llama_params, llama_forward

        def hidden(params, tokens, cfg, **kw):
            return llama_forward(params, tokens, cfg, return_hidden=True, **kw)

        return BaseModelAPI("llama", init_llama_params, hidden, generate)
    if key in ("gptbigcode", "gpt_bigcode"):
        from fms_fsdp_tpu_torch.models.gpt_bigcode import (
            generate_simple,
            gpt_bigcode_forward,
            init_gpt_bigcode_params,
        )

        def hidden(params, tokens, cfg, **kw):
            return gpt_bigcode_forward(params, tokens, cfg, return_hidden=True, **kw)

        def gen(params, prompts, cfg, **kw):
            # JAX's generate_simple runs gpt_bigcode_forward at its
            # defaults (the einsum attention); the dtype is the params'
            dtype = params["wte"].dtype

            def forward(p, toks, c, **fkw):
                return gpt_bigcode_forward(p, toks, c, compute_dtype=dtype, **fkw)

            return generate_simple(params, prompts, cfg, forward, **kw)

        return BaseModelAPI("gpt_bigcode", init_gpt_bigcode_params, hidden, gen)
    if key == "mixtral":
        from fms_fsdp_tpu_torch.models.gpt_bigcode import generate_simple
        from fms_fsdp_tpu_torch.models.mixtral import init_mixtral_params, mixtral_forward

        def hidden(params, tokens, cfg, **kw):
            return mixtral_forward(params, tokens, cfg, return_hidden=True, **kw)

        def gen(params, prompts, cfg, tp=None, **kw):
            # JAX's generate_simple runs mixtral_forward at its defaults:
            # the einsum attention, dense experts; the dtype is the params'
            dtype = params["embedding"].dtype
            whole = tp is None or params["lm_head"].shape[-1] == cfg.src_vocab_size

            def forward(p, toks, c, **fkw):
                out = mixtral_forward(p, toks, c, attn_impl="xla", compute_dtype=dtype,
                                      tp=tp, **fkw)
                if whole:
                    return out
                # sample from the whole vocabulary on every tensor rank
                if isinstance(out, tuple):
                    return (tp.gather(out[0], -1),) + tuple(out[1:])
                return tp.gather(out, -1)

            return generate_simple(params, prompts, cfg, forward, **kw)

        return BaseModelAPI("mixtral", init_mixtral_params, hidden, gen)
    raise ValueError(f"unknown speculator base arch: {arch!r}")
