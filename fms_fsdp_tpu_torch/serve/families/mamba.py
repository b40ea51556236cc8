"""Mamba family adapter: constant-memory recurrent decode.

Counterpart of ``fms_fsdp_tpu/serve/families/mamba.py`` (capacity,
prefill, release, decode, obs). A stream's decode state is a fixed-size
slab (``models/mamba.py::init_mamba_decode_state``): per mamba layer the
conv window plus the fp32 SSD state. No paging, no growth: ``grow`` is
always True and the slab bytes a stream holds
(``state_bytes_per_stream``) are constant in generated length.

Hybrid configs (attn_layer_idx non-empty) ride the ``PagedKVCache`` for
their attention layers: page accounting, LIFO eviction and
recompute-on-resume behave exactly like llama, over n_attn layers
instead of all of them. Those layers decode through ``gather_pages`` +
``gqa_attend``, as in JAX, so this path launches no kernel: the prefill
is the per-position recurrence and the SSD scan kernel belongs to
training.

Slab lifecycle: ``release`` zeroes the slot's slab slice (eviction,
expiry and completion all land there), and the decode step masks its
state writes to live rows, so an idle slot's slab stays exactly zero
between streams. The slab is one set of tensors over ``max_batch``
slots, written in place per slot (JAX donates it through its jit).

Handoff: a stream's slab slice travels through the slab codec
(``serve/disagg/slab.py``): per mamba layer the conv window (compute
dtype) and the fp32 SSD state, plus the hybrid attention layers' pages
through the shared pool, in the same ``FMSH`` frame Llama and Mixtral use
for pages. That serves disaggregated prefill/decode and drain-and-migrate
(``ServingEngine.pack_stream``) for Mamba.
"""

from typing import Dict, Optional

import numpy as np
import torch

from fms_fsdp_tpu_torch.models.generation import sample_token
from fms_fsdp_tpu_torch.models.mamba import (
    _conv_dim,
    init_mamba_decode_state,
    mamba_decode_step,
    mamba_prefill,
    mamba_state_bytes_per_stream,
    row_mask,
)
from fms_fsdp_tpu_torch.ops.rope import rope_table
from fms_fsdp_tpu_torch.serve.disagg.handoff import HandoffError
from fms_fsdp_tpu_torch.serve.disagg.slab import (
    SLAB_CODEC_VERSION,
    check_slab_header,
    pack_slab_leaves,
    split_slab_leaves,
)
from fms_fsdp_tpu_torch.serve.families import FamilyAdapter
from fms_fsdp_tpu_torch.serve.kv_cache import RESERVED_PAGES, PagedKVCache
from fms_fsdp_tpu_torch.utils.tree import tree_map


class MambaAdapter(FamilyAdapter):
    family = "mamba"
    supports_handoff = True  # through the slab codec, not the page codec

    @classmethod
    def check_layout(cls, scfg) -> None:
        if scfg.serve_layout:
            raise ValueError(
                "mamba serving has no sharded layout yet: the recurrent "
                "slab (conv window + SSD state) has no sharding rulebook"
                " — run mamba replicas single-chip (serve_layout=\"\") "
                "and scale them out data-parallel through the fleet "
                "router"
            )

    def __init__(self, params, model_cfg, scfg, compute_dtype, device):
        self.params = params
        self.model_cfg = model_cfg
        self.scfg = scfg
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        cfg = model_cfg
        self._hybrid = bool(cfg.attn_layer_idx)

        self.check_layout(scfg)
        if scfg.attn_impl == "kernel":
            raise ValueError(
                "mamba serving has no paged-attention kernel path yet: "
                "set attn_impl to 'auto' or 'reference' (the recurrent "
                "mixer is not attention; hybrid attn layers decode "
                "through the reference gqa_attend)"
            )
        if scfg.kv_quant != "none":
            raise ValueError(
                "mamba serving stores its recurrent slab unquantized and "
                "hybrid attn pages full-width: set kv_quant='none'"
            )
        if getattr(scfg, "speculator_path", ""):
            raise ValueError(
                "mamba serving has no speculative decode path yet: the "
                "MLPSpeculator draft/verify loop is llama-only (the "
                "verify step replays positions through paged KV, which "
                "the recurrent slab cannot roll back) — unset "
                "speculator_path"
            )
        self.attn_impl = "reference" if self._hybrid else "none"

        self.rope = None
        if self._hybrid:
            a = cfg.attn_cfg
            # default page size 16: it divides max_seq_len in every
            # config the tests use, as in JAX
            self.page_size = scfg.page_size or 16
            if scfg.max_seq_len % self.page_size != 0:
                raise ValueError(
                    f"ServeConfig.page_size={self.page_size} does not divide "
                    f"max_seq_len={scfg.max_seq_len}"
                )
            self.max_pages = scfg.max_seq_len // self.page_size
            num_pages = scfg.num_pages or (
                scfg.max_batch * self.max_pages + RESERVED_PAGES
            )
            self.cache = PagedKVCache(
                len(cfg.attn_layer_idx),
                num_pages,
                self.page_size,
                a.num_heads_kv,
                a.head_dim,
                dtype=compute_dtype,
                quant="none",
                device=self.device,
            )
            # built once on the device; JAX rebuilds it inside each jitted
            # step, where XLA folds it to a constant
            self.rope = rope_table(scfg.max_seq_len, a.rotary_emb_dim or a.head_dim,
                                   10000.0, device=self.device)

        # the whole fleet of slots steps as one fixed-shape batch: one
        # slab covering max_batch streams
        self._state = init_mamba_decode_state(
            cfg, scfg.max_batch, compute_dtype, self.device
        )
        self._table_key = None
        self._table_dev = None

    # -- capacity ----------------------------------------------------------

    def _padded(self, n: int) -> int:
        return self._padded_len(n, self.scfg.prefill_bucket)

    def admission_error(self, prompt_len: int, max_new: int) -> Optional[str]:
        if not self._hybrid:
            return None  # constant slab: fits iff a slot exists
        worst = self._padded(prompt_len + max_new - 1) + 1
        need = self.cache.pages_needed(worst)
        total = self.cache.num_pages - RESERVED_PAGES
        if need > total:
            return (
                f"request needs up to {need} attn pages but the pool "
                f"holds {total}; raise num_pages or shrink "
                f"prompt/max_new_tokens"
            )
        return None

    def can_admit(self, rid: int, prompt_len: int) -> bool:
        if not self._hybrid:
            return True
        return self.cache.can_ensure(rid, self._padded(prompt_len) + 1)

    def grow(self, rid: int, n_tokens: int) -> bool:
        if not self._hybrid:
            return True
        return self.cache.ensure(rid, n_tokens)

    def release(self, rid: int, slot: int) -> None:
        # zero the slab slice: an idle slot must hold no residue of the
        # evicted stream (and the decode step's live-mask keeps it zero)
        tree_map(lambda s: s[slot].zero_(), self._state)
        if self._hybrid:
            self.cache.free(rid)

    # -- prefill -----------------------------------------------------------

    def prefill(self, rid: int, slot: int, prompt):
        p = len(prompt)
        p_pad = self._padded(p)
        kv_len = 0
        if self._hybrid:
            kv_len = self.cache.pages_needed(p_pad) * self.page_size
            if not self.cache.ensure(rid, p_pad):
                raise RuntimeError("admission checked capacity; ensure cannot fail here")
        toks = torch.zeros((1, p_pad), dtype=torch.long)
        toks[0, :p] = torch.as_tensor(prompt, dtype=torch.long)
        logits, st1, kv = mamba_prefill(
            self.params, toks.to(self.device),
            torch.tensor([p], dtype=torch.long, device=self.device),
            self.model_cfg, compute_dtype=self.compute_dtype, kv_len=kv_len,
        )
        # land the 1-row prefill state in the stream's slab slice
        tree_map(lambda s, n: s[slot].copy_(n[0]), self._state, st1)
        if self._hybrid:
            self.cache.write_prompt(rid, kv["k"][:, 0], kv["v"][:, 0])
        # prefill already selects each row's last real position
        return logits[0]

    # -- decode ------------------------------------------------------------

    def decode(self, slot_rids, lens, tokens, generator):
        scfg = self.scfg
        lens_dev = torch.from_numpy(np.asarray(lens, np.int32)).to(self.device)
        toks_dev = torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device)
        pools = table = None
        if self._hybrid:
            # cached device page table, keyed on (allocator version, slot
            # membership): steady-state decode re-uploads nothing
            tkey = (self.cache.table_version, tuple(slot_rids))
            if tkey != self._table_key:
                self._table_key = tkey
                self._table_dev = torch.from_numpy(
                    self.cache.page_table(list(slot_rids), self.max_pages)
                ).to(self.device)
            pools, table = self.cache.pools, self._table_dev
        logits, new_state, _ = mamba_decode_step(
            self.params, self._state, pools, table, lens_dev, toks_dev,
            self.model_cfg, page_size=self.page_size,
            compute_dtype=self.compute_dtype, rope=self.rope,
        )
        # idle rows (lens 0: a prompt is never empty) must not smear
        # garbage into released, zeroed slab slices
        live = lens_dev > 0
        self._state = tree_map(
            lambda n, o: torch.where(row_mask(live, n), n, o), new_state, self._state
        )
        tok = sample_token(
            logits, generator, scfg.temperature, scfg.top_k, scfg.do_sample
        )
        return tok.to(torch.int32).cpu().numpy(), logits

    # -- disaggregation: the slab codec (serve/disagg/slab.py) -------------

    def _slab_geometry(self) -> Dict:
        """The geometry fields the slab header carries and
        ``check_handoff_header`` compares (JSON-native types only)."""
        cfg = self.model_cfg
        geo = {
            "family": self.family,
            "compute_dtype": str(self.compute_dtype).replace("torch.", ""),
            "n_layer": int(cfg.n_layer),
            "attn_layers": sorted(int(i) for i in cfg.attn_layer_idx),
            "conv_shape": [int(cfg.d_conv - 1), int(_conv_dim(cfg))],
            "ssd_shape": [int(cfg.nheads), int(cfg.headdim), int(cfg.d_state)],
        }
        if self._hybrid:
            geo.update(
                quant=self.cache.quant,
                page_size=self.cache.page_size,
                n_kv_heads=self.cache.n_kv_heads,
                head_dim=self.cache.head_dim,
                n_attn_layers=self.cache.n_layers,
            )
        return geo

    def export_handoff(self, rid: int, slot: Optional[int] = None):
        if slot is None:
            raise ValueError("the mamba slab export needs the stream's slot")
        layer_states = {
            i: {"conv": layer["conv"][slot].cpu(), "ssd": layer["ssd"][slot].cpu()}
            for i, layer in enumerate(self._state)
            if layer
        }
        kv = self.cache.gather_pages(rid) if self._hybrid else None
        header = dict(self._slab_geometry())
        header.update(
            codec="mamba_slab",
            codec_version=SLAB_CODEC_VERSION,
            alloc_tokens=self.cache.tokens_of(rid) if self._hybrid else 0,
        )
        return header, pack_slab_leaves(layer_states, kv)

    def check_handoff_header(self, header) -> None:
        check_slab_header(header, self._slab_geometry())

    def import_handoff(self, rid: int, slot: int, header, arrays) -> bool:
        self.check_handoff_header(header)
        layer_states, kv = split_slab_leaves(arrays)
        # everything checkable is checked BEFORE any allocation: a frame
        # rejected after pages or slab were touched must not leak them
        expected = {i for i, layer in enumerate(self._state) if layer}
        if set(layer_states) != expected:
            raise HandoffError(
                f"slab frame covers layers {sorted(layer_states)}; this "
                f"replica's mamba layers are {sorted(expected)}"
            )
        for i in expected:
            for part in ("conv", "ssd"):
                want = tuple(self._state[i][part].shape[1:])
                got = tuple(layer_states[i][part].shape)
                if got != want or layer_states[i][part].dtype != self._state[i][part].dtype:
                    raise HandoffError(
                        f"slab leaf layer {i} {part!r} is "
                        f"{layer_states[i][part].dtype} of shape {got}, this "
                        f"replica expects {self._state[i][part].dtype} of {want}"
                    )
        if self._hybrid:
            if not kv:
                raise HandoffError(
                    "hybrid mamba handoff is missing its attention-layer "
                    "'kv.*' page leaves"
                )
            if not self.cache.scatter_pages(rid, kv, int(header["alloc_tokens"])):
                return False  # pool full right now: the engine defers
        elif kv:
            raise HandoffError(
                "non-hybrid mamba handoff carries attention page leaves "
                "this replica has no pool for"
            )
        try:
            for i in expected:
                for part in ("conv", "ssd"):
                    self._state[i][part][slot].copy_(layer_states[i][part])
        except Exception as e:
            # free the pages and re-zero the slab slice this import
            # touched: accounting returns to its pre-import value
            if self._hybrid:
                self.cache.free(rid)
            tree_map(lambda t: t[slot].zero_(), self._state)
            raise HandoffError(
                f"slab import failed after allocation (pages freed, slab "
                f"slice zeroed): {e}"
            ) from e
        return True

    # -- obs ---------------------------------------------------------------

    @property
    def state_bytes_per_stream(self) -> int:
        return mamba_state_bytes_per_stream(self.model_cfg, self.compute_dtype)

    def slab_slice(self, slot: int):
        """The slot's slab (debug/tests): list over layers of {"conv",
        "ssd"} rows ({} for hybrid attn layers)."""
        return tree_map(lambda s: s[slot], self._state)
