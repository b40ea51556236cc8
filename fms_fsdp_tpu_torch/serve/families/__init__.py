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

Serving layouts (``ServeConfig.serve_layout``, JAX's ``:282-330``):
families that set ``supports_layout`` (Llama, Mixtral) call
:meth:`FamilyAdapter._init_layout` first, which builds the replica's
``ServeMesh`` (``parallel/sharding.py``) and keeps this rank's blocks of
the params by the family's training rulebook (``serve_param_specs``).
Their pools hold the rank's KV heads (``serve_kv_pool_specs``: Nkv / tp
where the heads split), and the page handoff gathers a page's KV-head
blocks over tensor into JAX's head order on export and gives each rank
its block on import: a layout replica's ``FMSH`` frames have a one-card
replica's header and leaves, and a page set written in and read out
again is the same bytes.
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


def paged_decode_tiles(model_cfg, scfg, tp=None):
    """(page_size, block_kv, how) of a paged family's pool and decode
    split, resolved once at engine build through the tuning table
    (``tune/lookup.py::resolve_paged_decode``) on the full signature; the
    table keys the pool's element type ("bfloat16", "int8",
    "float8_e4m3fn"), so quantized pools get their own entries.

    Under a layout whose heads split over ``tp`` the split is looked up
    at the heads the kernel runs (Nq / tp, Nkv / tp) while the page size
    stays the whole model's, so a layout replica's pages are a one-card
    replica's (the handoff carries them); a local entry at another page
    size gives the planner's split at the whole model's page size (JAX
    keys both by the whole heads)."""
    from fms_fsdp_tpu_torch.ops.attention import heads_split
    from fms_fsdp_tpu_torch.tune.lookup import resolve_paged_decode

    dtype = {"int8": "int8", "fp8": "float8_e4m3fn"}.get(scfg.kv_quant, scfg.compute_dtype)
    nq, nkv = model_cfg.nheads, model_cfg.n_kv_heads

    def resolve(parts):
        return resolve_paged_decode(
            scfg.max_batch, nq // parts, nkv // parts, model_cfg.head_dim,
            scfg.max_seq_len, dtype, requested_page_size=scfg.page_size or None,
        )

    whole = resolve(1)
    if not heads_split(nq, nkv, tp):
        return whole
    page_size, block_kv, how = resolve(tp.size)
    if page_size != whole[0]:
        return whole[0], whole[0], "default"
    return page_size, block_kv, how


def adapter_class(model_cfg):
    """Config -> the family's adapter class."""
    family = family_of(model_cfg)
    if family == "mamba":
        from fms_fsdp_tpu_torch.serve.families.mamba import MambaAdapter

        return MambaAdapter
    if family == "mixtral":
        from fms_fsdp_tpu_torch.serve.families.mixtral import MixtralAdapter

        return MixtralAdapter
    from fms_fsdp_tpu_torch.serve.families.llama import LlamaAdapter

    return LlamaAdapter


def resolve_adapter(params, model_cfg, serve_cfg, compute_dtype, device):
    """Params + config -> the family's adapter."""
    check_params_family(params, family_of(model_cfg))
    return adapter_class(model_cfg)(params, model_cfg, serve_cfg, compute_dtype, device)


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
    - ``defrag()`` — compact the page pool (paged families).
    - ``pages_in_use`` / ``state_bytes_per_stream`` — obs.

    Serving layouts: ``supports_layout`` families call
    :meth:`_init_layout` before they build anything; ``mesh`` (the
    ``ServeMesh``), ``tp`` and ``kv_split`` (whether the pools hold
    this rank's KV heads) say what it found. The engine drives such an
    adapter on the leader rank through ``serve/layout.py``, which sends
    every call that writes state or launches work to the other ranks
    first.

    Disaggregation: paged families set ``supports_handoff`` and inherit
    the generic ``export_handoff`` / ``check_handoff_header`` /
    ``import_handoff`` below (the transferable state IS the page set);
    Mamba overrides all three with its slab codec. Chunked prefill:
    families that can advance a prompt in slices set
    ``supports_chunked_prefill`` and implement ``prefill_start`` /
    ``prefill_chunk``.
    """

    family: str = "?"
    supports_handoff: bool = False
    supports_chunked_prefill: bool = False
    cache = None  # PagedKVCache when the family uses pages, else None
    page_size: int = 0
    max_pages: int = 0
    attn_impl: str = "none"
    block_kv: int = 0
    # how the tuning table answered resolve_paged_decode at build ("exact",
    # "nearest", "default", "pinned", "off"; "n/a" for a family without it)
    tune_how: str = "n/a"
    # speculative serving (ServeConfig.speculator_path): an adapter that
    # loaded a speculator sets ``speculative``; the engine then steps
    # through ``decode_spec`` and budgets ``spec_draft_tokens`` positions
    speculative: bool = False
    spec_draft_tokens: int = 0
    # serving layout (ServeConfig.serve_layout): set by _init_layout
    supports_layout: bool = False
    mesh = None  # the ServeMesh, None on one card
    tp = None  # the mesh's TensorParallel, None without a tensor axis
    kv_split: bool = False  # the pools hold this rank's KV heads

    @classmethod
    def check_layout(cls, scfg) -> None:
        """Refuse ``scfg.serve_layout`` where the family serves on one
        card only; a fleet replica asks before it starts a rank."""
        if scfg.serve_layout and not cls.supports_layout:
            raise ValueError(
                f"serve_layout={scfg.serve_layout!r} is not supported for the "
                f"{cls.family} family yet — run it single-card"
            )

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

    # -- serving layout (ServeConfig.serve_layout) ---------------------------

    def _init_layout(self, scfg, params, compute_dtype, device):
        """Build the replica's serving mesh for ``scfg.serve_layout`` and
        return this rank's blocks of the whole ``params`` (cast, then on
        ``device``); on one card (no layout, ``"tp=1"``) ``params`` as
        they are: the engine moved them already."""
        from fms_fsdp_tpu_torch.ops.attention import heads_split
        from fms_fsdp_tpu_torch.parallel.sharding import build_serve_mesh, serve_param_specs

        self.mesh = build_serve_mesh(scfg.serve_layout, device)
        if self.mesh is None:
            return params
        self.tp = self.mesh.tp
        self.kv_split = heads_split(self.model_cfg.nheads, self.model_cfg.n_kv_heads, self.tp)
        return self.mesh.place(params, serve_param_specs(self.family), device, compute_dtype)

    @property
    def kv_heads(self) -> int:
        """The KV heads this rank's pools hold."""
        nkv = self.model_cfg.n_kv_heads
        return nkv // self.tp.size if self.kv_split else nkv

    def defrag(self) -> int:
        """Compact the page pool (``PagedKVCache.defrag``)."""
        self._require_pages()
        return self.cache.defrag()

    # -- chunked prefill (ServeConfig.prefill_chunk_tokens) ----------------

    def prefill_start(self, rid: int, slot: int, prompt) -> None:
        """Allocate the stream's state and stage ``prompt`` for
        incremental prefill; no forward runs yet."""
        raise NotImplementedError

    def prefill_chunk(self, rid: int):
        """Advance a staged prefill by one chunk. None while incomplete;
        on the final chunk, commits the state and returns the (V,) logits
        row of the last real prompt position."""
        raise NotImplementedError

    # -- disaggregation (the generic paged implementation) -----------------

    def export_handoff(self, rid: int, slot: Optional[int] = None):
        """rid's transferable decode state: (header fields, leaf tensors)
        for ``serve/disagg/handoff.py::pack_handoff``. The pages ship in
        their storage dtype; the engine adds the sampling fields. ``slot``
        is unused here (the page set is keyed by rid) and read by families
        with slot-indexed state (the Mamba slab). Under a layout whose
        pools hold this rank's KV heads, each leaf's head blocks are
        gathered over tensor, in rank order, which is JAX's head order:
        every tensor rank must call it."""
        from fms_fsdp_tpu_torch.serve.disagg.handoff import PAGE_CODEC_VERSION

        self._require_pages()
        cache = self.cache
        if self.kv_split:
            arrays = {name: self.tp.all_gather(a, 3).cpu()
                      for name, a in cache.gather_pages(rid, to_host=False).items()}
        else:
            arrays = cache.gather_pages(rid)
        return (
            {
                "family": self.family,
                "codec": "pages",
                "codec_version": PAGE_CODEC_VERSION,
                "quant": cache.quant,
                "page_size": cache.page_size,
                "n_kv_heads": self.model_cfg.n_kv_heads,
                "head_dim": cache.head_dim,
                "n_layers": cache.n_layers,
                "alloc_tokens": cache.tokens_of(rid),
            },
            arrays,
        )

    def check_handoff_header(self, header) -> None:
        """Raise HandoffError when a handoff's pool geometry does not
        match this replica's: prefill and decode replicas that disagree on
        the model config or the pool are misconfigured, a typed error."""
        from fms_fsdp_tpu_torch.serve.disagg.handoff import (
            PAGE_CODEC_VERSION,
            HandoffError,
            check_codec_version,
        )

        self._require_pages()
        check_codec_version(header, "pages", PAGE_CODEC_VERSION)
        cache = self.cache
        for field, mine in (
            ("family", self.family),
            ("quant", cache.quant),
            ("page_size", cache.page_size),
            ("n_kv_heads", self.model_cfg.n_kv_heads),
            ("head_dim", cache.head_dim),
            ("n_layers", cache.n_layers),
        ):
            if header.get(field) != mine:
                raise HandoffError(
                    f"handoff {field}={header.get(field)!r} does not "
                    f"match this replica's {field}={mine!r}: prefill "
                    f"and decode replicas must share one model config "
                    f"and ServeConfig pool geometry"
                )

    def import_handoff(self, rid: int, slot: int, header, arrays) -> bool:
        """Allocate rid's pages in this pool and write the shipped leaves
        in, bit-exact. False when the pool cannot hold them right now.
        Under a layout whose pools hold this rank's KV heads, the rank
        writes its block of each leaf's heads."""
        self.check_handoff_header(header)
        if self.kv_split:
            arrays = {name: self.tp.block(a, 3).contiguous() for name, a in arrays.items()}
        return self.cache.scatter_pages(rid, arrays, int(header["alloc_tokens"]))

    def handoff_page_bytes(self) -> int:
        """The bytes one page adds to a handoff: every KV head's."""
        parts = self.tp.size if self.kv_split else 1
        return self.cache.page_bytes() * parts

    def _require_pages(self) -> None:
        if not self.supports_handoff or self.cache is None:
            raise ValueError(f"{self.family} does not support page handoff")

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
    "adapter_class",
    "check_params_family",
    "family_of",
    "init_params_for",
    "load_model_config",
    "resolve_adapter",
]
