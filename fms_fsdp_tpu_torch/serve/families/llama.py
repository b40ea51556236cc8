"""Llama family adapter: paged-KV serving over the ragged decode kernel.

Counterpart of ``fms_fsdp_tpu/serve/families/llama.py`` (pool build,
capacity, prefill, release, decode with the page-table upload cache).
The rotary table is built once per adapter on its device; the JAX path
rebuilds it inside each jitted step, where XLA folds it to a constant.
"""

from typing import Optional

import numpy as np
import torch

from fms_fsdp_tpu_torch.models.generation import prefill, sample_token
from fms_fsdp_tpu_torch.ops.rope import rope_table
from fms_fsdp_tpu_torch.serve.decode import paged_decode_step
from fms_fsdp_tpu_torch.serve.families import FamilyAdapter
from fms_fsdp_tpu_torch.serve.kv_cache import RESERVED_PAGES, PagedKVCache
from fms_fsdp_tpu_torch.tune.lookup import resolve_paged_decode


class LlamaAdapter(FamilyAdapter):
    family = "llama"

    def __init__(self, params, model_cfg, scfg, compute_dtype, device):
        self.params = params
        self.model_cfg = model_cfg
        self.scfg = scfg
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)

        nlayers = int(params["layers"]["wq"].shape[0])
        page_size, self.block_kv, _ = resolve_paged_decode(
            scfg.max_seq_len, requested_page_size=scfg.page_size or None
        )
        self.page_size = page_size
        self.max_pages = scfg.max_seq_len // page_size
        num_pages = scfg.num_pages or (
            scfg.max_batch * self.max_pages + RESERVED_PAGES
        )
        self.cache = PagedKVCache(
            nlayers,
            num_pages,
            page_size,
            model_cfg.n_kv_heads,
            model_cfg.head_dim,
            dtype=compute_dtype,
            quant=scfg.kv_quant,
            device=self.device,
        )
        impl = scfg.attn_impl
        if impl == "auto":
            impl = "kernel" if self.device.type == "cuda" else "reference"
        if impl not in ("kernel", "reference"):
            raise ValueError(f"unknown attn_impl: {scfg.attn_impl!r}")
        self.attn_impl = impl
        self.rope = rope_table(
            scfg.max_seq_len, model_cfg.head_dim, model_cfg.rope_theta,
            device=self.device,
        )
        self._table_key = None
        self._table_dev = None

    # -- capacity ----------------------------------------------------------

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

    # -- prefill -----------------------------------------------------------

    def prefill(self, rid: int, slot: int, prompt):
        p = len(prompt)
        p_pad = self._padded(p)
        s_pad = self.cache.pages_needed(p_pad) * self.page_size
        if not self.cache.ensure(rid, p_pad):
            raise RuntimeError("admission checked capacity; ensure cannot fail here")
        toks = torch.zeros((1, p_pad), dtype=torch.long)
        toks[0, :p] = torch.as_tensor(prompt, dtype=torch.long)
        full_logits = p_pad != p
        logits, _, kv = prefill(
            self.params,
            toks.to(self.device),
            self.model_cfg,
            max_seq_len=s_pad,
            compute_dtype=self.compute_dtype,
            full_logits=full_logits,
            rope=self.rope,
        )
        self.cache.write_prompt(rid, kv["k"][:, 0], kv["v"][:, 0])
        # logits of the last REAL position predict the next token
        return logits[0, p - 1] if full_logits else logits[0, 0]

    # -- decode ------------------------------------------------------------

    def decode(self, slot_rids, lens, tokens, generator):
        # cached device page table, keyed on (allocator version, slot
        # membership): steady-state decode re-uploads nothing
        tkey = (self.cache.table_version, tuple(slot_rids))
        if tkey != self._table_key:
            self._table_key = tkey
            self._table_dev = torch.from_numpy(
                self.cache.page_table(list(slot_rids), self.max_pages)
            ).to(self.device)
        scfg = self.scfg
        logits, _, _ = paged_decode_step(
            self.params,
            self.cache.pools,
            self._table_dev,
            torch.from_numpy(np.asarray(lens, np.int32)).to(self.device),
            torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device),
            self.model_cfg,
            page_size=self.page_size,
            compute_dtype=self.compute_dtype,
            quant=scfg.kv_quant,
            attn_impl=self.attn_impl,
            block_kv=self.block_kv,
            rope=self.rope,
        )
        tok = sample_token(
            logits, generator, scfg.temperature, scfg.top_k, scfg.do_sample
        )
        return tok.to(torch.int32).cpu().numpy(), logits
