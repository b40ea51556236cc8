"""Family adapters: one serving engine, per-family device work.

Counterpart of ``fms_fsdp_tpu/serve/families/__init__.py``.
The engine owns admission, continuous batching, eviction, sampling and
metrics; a :class:`FamilyAdapter` owns what differs per model family:
the decode state a stream holds, how a prompt prefills into it, what one
ragged batched decode step computes, and how params resolve to a family.

``llama`` (paged KV, ragged paged-decode kernel), ``mamba`` (a constant
recurrent slab, plus paged KV for the hybrid attention layers) and
``mixtral`` (paged KV through the reference attention, routed top-k
experts).
"""

from typing import Optional

from fms_fsdp_tpu_torch.models.configs import (
    LlamaConfig,
    MambaAttnConfig,
    MambaConfig,
    MixtralConfig,
)

# the wire encoding of a family in numeric-only maps (serving_stats)
FAMILY_CODES = {"llama": 0, "mamba": 1, "mixtral": 2}

_CONFIG_FAMILIES = (
    (MambaConfig, "mamba"),
    (MixtralConfig, "mixtral"),
    (LlamaConfig, "llama"),
)


def family_of(model_cfg) -> str:
    """Model config dataclass -> family name."""
    for cls, name in _CONFIG_FAMILIES:
        if isinstance(model_cfg, cls):
            return name
    raise ValueError(
        f"unknown model config type {type(model_cfg).__name__}: expected "
        f"LlamaConfig, MambaConfig or MixtralConfig "
        f"(fms_fsdp_tpu_torch/models/configs.py)"
    )


def load_model_config(d: dict):
    """Plain dict (a fleet model_cfg.json) -> the right config dataclass.

    An explicit ``"family"`` key wins; otherwise the family is inferred
    from architecture-distinguishing keys (``d_model`` -> mamba,
    ``num_experts`` -> mixtral, else llama)."""
    d = dict(d)
    family = d.pop("family", None)
    if family is None:
        if "d_model" in d or "n_layer" in d:
            family = "mamba"
        elif "num_experts" in d or "top_k" in d:
            family = "mixtral"
        else:
            family = "llama"
    if family not in FAMILY_CODES:
        raise ValueError(
            f"unknown model family {family!r} in model config: expected "
            f"one of {sorted(FAMILY_CODES)} — set \"family\" explicitly "
            f"or drop it to infer from the config keys"
        )
    try:
        if family == "mamba":
            # JSON round-trips tuples as lists and the nested attn
            # config as a dict
            if isinstance(d.get("attn_cfg"), dict):
                d["attn_cfg"] = MambaAttnConfig(**d["attn_cfg"])
            if d.get("attn_layer_idx") is not None:
                d["attn_layer_idx"] = tuple(d["attn_layer_idx"])
            return MambaConfig(**d)
        if family == "mixtral":
            return MixtralConfig(**d)
        return LlamaConfig(**d)
    except TypeError as e:
        raise ValueError(
            f"model config keys do not match the {family} family "
            f"({type(e).__name__}: {e}) — if the family was inferred "
            f"wrongly, set \"family\" explicitly in the model config"
        ) from None


def check_params_family(params, family: str) -> None:
    """Validate a params dict actually belongs to ``family``: mamba
    stacks layers as a list of per-layer dicts, mixtral's stacked layer
    dict carries the router ``gate``, llama's carries ``wq`` without it."""
    layers = params.get("layers") if hasattr(params, "get") else None
    if isinstance(layers, (list, tuple)):
        actual = "mamba"
    elif isinstance(layers, dict) and "gate" in layers:
        actual = "mixtral"
    elif isinstance(layers, dict) and "wq" in layers:
        actual = "llama"
    else:
        raise ValueError(
            "params do not look like any serveable family (no "
            "recognizable 'layers' structure): expected init_llama_params"
            " / init_mamba_params / init_mixtral_params output or a "
            "checkpoint thereof"
        )
    if actual != family:
        raise ValueError(
            f"checkpoint/model-config family mismatch: params look like "
            f"{actual!r} but the model config says {family!r} — pass the "
            f"matching config dataclass (or fix \"family\" in "
            f"model_cfg.json)"
        )


def init_params_for(model_cfg):
    """Family -> its params initializer, ``fn(generator) -> params``."""
    family = family_of(model_cfg)
    if family == "mamba":
        from fms_fsdp_tpu_torch.models.mamba import init_mamba_params

        return lambda generator: init_mamba_params(generator, model_cfg)
    if family == "mixtral":
        from fms_fsdp_tpu_torch.models.mixtral import init_mixtral_params

        return lambda generator: init_mixtral_params(generator, model_cfg)
    from fms_fsdp_tpu_torch.models.llama import init_llama_params

    return lambda generator: init_llama_params(generator, model_cfg)


def resolve_adapter(params, model_cfg, serve_cfg, compute_dtype, device):
    """Params + config -> the family's adapter."""
    family = family_of(model_cfg)
    check_params_family(params, family)
    if family == "mamba":
        from fms_fsdp_tpu_torch.serve.families.mamba import MambaAdapter

        return MambaAdapter(params, model_cfg, serve_cfg, compute_dtype, device)
    if family == "mixtral":
        from fms_fsdp_tpu_torch.serve.families.mixtral import MixtralAdapter

        return MixtralAdapter(params, model_cfg, serve_cfg, compute_dtype, device)
    from fms_fsdp_tpu_torch.serve.families.llama import LlamaAdapter

    return LlamaAdapter(params, model_cfg, serve_cfg, compute_dtype, device)


class FamilyAdapter:
    """The protocol the engine drives:

    - ``admission_error(prompt_len, max_new)`` — worst-case capacity
      check at submit; a message means reject (reason=too_large).
    - ``can_admit(rid, prompt_len)`` — would a prefill of this resumed
      prompt fit right now (nothing allocated yet)?
    - ``prefill(rid, slot, prompt)`` — allocate the stream's state, run
      the family prefill; returns the (V,) logits row of the last real
      prompt position.
    - ``grow(rid, n_tokens)`` — make room for the next token; False
      triggers the engine's LIFO eviction loop.
    - ``release(rid, slot)`` — return the stream's state.
    - ``decode(slot_rids, lens, tokens, generator)`` — one ragged decode
      step over all max_batch slots; returns (sampled tokens (B,)
      np.int32, logits (B, V)).
    - ``decode_spec(slot_rids, lens, tokens)`` — speculative adapters
      only: draft ``spec_draft_tokens`` tokens a row, verify them in one
      forward; returns (tokens to commit (B, n+1), how many of them (B,),
      the logits row of the last committed position (B, V)).
    - ``pages_in_use`` / ``state_bytes_per_stream`` — obs.

    Handoff, chunked prefill and serving layouts come with the serving
    extensions (ROADMAP.md A.10).
    """

    family: str = "?"
    supports_handoff: bool = False
    cache = None  # PagedKVCache when the family uses pages, else None
    page_size: int = 0
    max_pages: int = 0
    attn_impl: str = "none"
    block_kv: int = 0
    # speculative serving (ServeConfig.speculator_path): an adapter that
    # loaded a speculator sets ``speculative``; the engine then steps
    # through ``decode_spec`` and budgets ``spec_draft_tokens`` positions
    speculative: bool = False
    spec_draft_tokens: int = 0

    def admission_error(self, prompt_len: int, max_new: int) -> Optional[str]:
        raise NotImplementedError

    def can_admit(self, rid: int, prompt_len: int) -> bool:
        raise NotImplementedError

    def prefill(self, rid: int, slot: int, prompt):
        raise NotImplementedError

    def grow(self, rid: int, n_tokens: int) -> bool:
        raise NotImplementedError

    def release(self, rid: int, slot: int) -> None:
        raise NotImplementedError

    def decode(self, slot_rids, lens, tokens, generator):
        raise NotImplementedError

    def decode_spec(self, slot_rids, lens, tokens):
        raise NotImplementedError

    @property
    def pages_in_use(self) -> int:
        return self.cache.pages_in_use if self.cache is not None else 0

    @property
    def state_bytes_per_stream(self) -> int:
        """Constant per-stream recurrent-state bytes (0 for families
        whose only decode state is paged KV)."""
        return 0

    def _padded_len(self, n: int, bucket: int) -> int:
        b = max(1, bucket)
        return -(-n // b) * b


__all__ = [
    "FAMILY_CODES",
    "FamilyAdapter",
    "check_params_family",
    "family_of",
    "init_params_for",
    "load_model_config",
    "resolve_adapter",
]
