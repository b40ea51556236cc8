"""Mixtral family adapter: paged-KV attention + expert-routed FFN.

Counterpart of ``fms_fsdp_tpu/serve/families/mixtral.py``. The attention
half is Llama's paged path over Mixtral's GQA shapes (the same
``PagedKVCache``, page accounting, admission and prefill padding),
decoded through the reference attention over gathered pages: JAX's
Mixtral serving refuses the ragged kernel, so this family launches none.
The FFN half routes each decoded token through its top-k experts
(``models/mixtral.py::_moe_token``): ``moe_impl="routed"`` (the default)
runs each chosen expert once over the rows that chose it, ``"dense"``
runs every expert and mixes (the parity mode). Both compute the same
mixture; they differ by rounding only. The page handoff is the base
class's generic one (``supports_handoff``). Serving layouts as Llama's:
the attention at this rank's heads, each expert's FFN split inside the
expert over tensor (E stays whole: the serving mesh has no expert axis).
"""

from typing import Optional

import numpy as np
import torch

from fms_fsdp_tpu_torch.models.generation import sample_token
from fms_fsdp_tpu_torch.models.mixtral import mixtral_paged_decode_step, mixtral_prefill
from fms_fsdp_tpu_torch.ops.rope import rope_table
from fms_fsdp_tpu_torch.serve.families import FamilyAdapter, paged_decode_tiles
from fms_fsdp_tpu_torch.serve.kv_cache import RESERVED_PAGES, PagedKVCache

MOE_IMPLS = ("routed", "dense")


class MixtralAdapter(FamilyAdapter):
    family = "mixtral"
    supports_handoff = True  # the generic page codec
    supports_layout = True

    def __init__(self, params, model_cfg, scfg, compute_dtype, device):
        moe_impl = getattr(scfg, "moe_impl", "routed")
        if moe_impl not in MOE_IMPLS:
            raise ValueError(
                f"unknown moe_impl {moe_impl!r}: Mixtral decode supports "
                "'routed' (each chosen expert over its rows) or 'dense' "
                "(every expert, the parity mode)"
            )
        if scfg.attn_impl == "kernel":
            raise ValueError(
                "Mixtral serving decodes attention through the reference "
                "gqa_attend over gathered pages: set attn_impl to 'auto' or "
                "'reference' (the ragged kernel serves Llama only)"
            )
        if scfg.attn_impl not in ("auto", "reference"):
            raise ValueError(f"unknown attn_impl: {scfg.attn_impl!r}")
        if scfg.kv_quant != "none":
            raise ValueError(
                "Mixtral serving stores attention pages full-width: set "
                "kv_quant='none'"
            )
        if getattr(scfg, "speculator_path", ""):
            raise ValueError(
                "Mixtral serving has no speculative decode path (the "
                "speculator's verify loop is Llama's): unset speculator_path"
            )
        self.model_cfg = model_cfg
        self.scfg = scfg
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.moe_impl = moe_impl
        self.attn_impl = "reference"
        self.params = params = self._init_layout(scfg, params, compute_dtype, self.device)

        nlayers = int(params["layers"]["wq"].shape[0])
        page_size, self.block_kv, self.tune_how = paged_decode_tiles(model_cfg, scfg, self.tp)
        self.page_size = page_size
        self.max_pages = scfg.max_seq_len // page_size
        num_pages = scfg.num_pages or (
            scfg.max_batch * self.max_pages + RESERVED_PAGES
        )
        self.cache = PagedKVCache(
            nlayers,
            num_pages,
            page_size,
            self.kv_heads,
            model_cfg.head_dim,
            dtype=compute_dtype,
            quant="none",
            device=self.device,
        )
        self.rope = rope_table(
            scfg.max_seq_len, model_cfg.head_dim, model_cfg.rope_theta,
            device=self.device,
        )
        self._table_key = None
        self._table_dev = None

    # -- capacity (Llama's page math) ---------------------------------------

    def _padded(self, n: int) -> int:
        return self._padded_len(n, self.scfg.prefill_bucket)

    def admission_error(self, prompt_len: int, max_new: int) -> Optional[str]:
        worst = self._padded(prompt_len + max_new - 1) + 1
        need = self.cache.pages_needed(worst)
        total = self.cache.num_pages - RESERVED_PAGES
        if need > total:
            return (
                f"request needs up to {need} pages but the pool holds "
                f"{total}; raise num_pages or shrink "
                f"prompt/max_new_tokens"
            )
        return None

    def can_admit(self, rid: int, prompt_len: int) -> bool:
        return self.cache.can_ensure(rid, self._padded(prompt_len) + 1)

    def grow(self, rid: int, n_tokens: int) -> bool:
        return self.cache.ensure(rid, n_tokens)

    def release(self, rid: int, slot: int) -> None:
        self.cache.free(rid)

    # -- prefill -------------------------------------------------------------

    def prefill(self, rid: int, slot: int, prompt):
        p = len(prompt)
        p_pad = self._padded(p)
        s_pad = self.cache.pages_needed(p_pad) * self.page_size
        if not self.cache.ensure(rid, p_pad):
            raise RuntimeError("admission checked capacity; ensure cannot fail here")
        toks = torch.zeros((1, p_pad), dtype=torch.long)
        toks[0, :p] = torch.as_tensor(prompt, dtype=torch.long)
        full_logits = p_pad != p
        logits, _, kv = mixtral_prefill(
            self.params,
            toks.to(self.device),
            self.model_cfg,
            max_seq_len=s_pad,
            compute_dtype=self.compute_dtype,
            full_logits=full_logits,
            rope=self.rope,
            tp=self.tp,
        )
        self.cache.write_prompt(rid, kv["k"][:, 0], kv["v"][:, 0])
        # logits of the last REAL position predict the next token
        return logits[0, p - 1] if full_logits else logits[0, 0]

    # -- decode --------------------------------------------------------------

    def decode(self, slot_rids, lens, tokens, generator):
        tkey = (self.cache.table_version, tuple(slot_rids))
        if tkey != self._table_key:
            self._table_key = tkey
            self._table_dev = torch.from_numpy(
                self.cache.page_table(list(slot_rids), self.max_pages)
            ).to(self.device)
        scfg = self.scfg
        logits, _ = mixtral_paged_decode_step(
            self.params,
            self.cache.pools,
            self._table_dev,
            torch.from_numpy(np.asarray(lens, np.int32)).to(self.device),
            torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device),
            self.model_cfg,
            page_size=self.page_size,
            compute_dtype=self.compute_dtype,
            moe_impl=self.moe_impl,
            rope=self.rope,
            tp=self.tp,
        )
        tok = sample_token(
            logits, generator, scfg.temperature, scfg.top_k, scfg.do_sample
        )
        return tok.to(torch.int32).cpu().numpy(), logits
