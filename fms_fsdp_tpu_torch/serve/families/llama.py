"""Llama family adapter: paged-KV serving over the ragged decode kernel.

Counterpart of ``fms_fsdp_tpu/serve/families/llama.py`` (pool build,
capacity, prefill, chunked prefill, release, decode with the page-table
upload cache, speculative decode with ``ServeConfig.speculator_path``,
the page handoff of the base class, and serving layouts: this rank's
Megatron blocks and KV heads, the paged-decode kernel at Nq / tp and
Nkv / tp heads).
The rotary table is built once per adapter on its device; the JAX path
rebuilds it inside each jitted step, where XLA folds it to a constant.
"""

from typing import Optional

import numpy as np
import torch

from fms_fsdp_tpu_torch.models.generation import decode_chunk, prefill, sample_token
from fms_fsdp_tpu_torch.models.speculative import speculator_propose
from fms_fsdp_tpu_torch.ops.rope import rope_table
from fms_fsdp_tpu_torch.serve.decode import paged_decode_step, paged_verify_step
from fms_fsdp_tpu_torch.serve.families import FamilyAdapter, paged_decode_tiles
from fms_fsdp_tpu_torch.serve.kv_cache import RESERVED_PAGES, PagedKVCache


class LlamaAdapter(FamilyAdapter):
    family = "llama"
    supports_handoff = True
    supports_chunked_prefill = True
    supports_layout = True

    def __init__(self, params, model_cfg, scfg, compute_dtype, device):
        self.model_cfg = model_cfg
        self.scfg = scfg
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
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
        self._chunk_state = {}  # rid -> staged chunked prefill
        if scfg.speculator_path:
            self._init_speculative(scfg, model_cfg)

    # -- speculative serving (ServeConfig.speculator_path) ------------------

    def _init_speculative(self, scfg, cfg) -> None:
        from fms_fsdp_tpu_torch.models.speculator import load_speculator

        if scfg.do_sample:
            raise ValueError(
                "speculative serving is greedy-only: the accept rule "
                "compares drafts against the base model's argmax — set "
                "do_sample=False or unset speculator_path"
            )
        if scfg.role != "unified":
            raise ValueError(
                f"speculative serving is unified-only (role="
                f"{scfg.role!r}): the draft state (the last base "
                f"hidden state) is not part of the page handoff"
            )
        spec_params, spec_cfg = load_speculator(scfg.speculator_path, self.device)
        if (
            spec_cfg.emb_dim != cfg.emb_dim
            or spec_cfg.vocab_size != cfg.src_vocab_size
        ):
            raise ValueError(
                f"speculator geometry (emb_dim={spec_cfg.emb_dim}, "
                f"vocab={spec_cfg.vocab_size}) does not match the base "
                f"model (emb_dim={cfg.emb_dim}, "
                f"vocab={cfg.src_vocab_size})"
            )
        n = spec_cfg.n_predict
        if scfg.spec_draft_tokens:
            if scfg.spec_draft_tokens > spec_cfg.n_predict:
                raise ValueError(
                    f"spec_draft_tokens={scfg.spec_draft_tokens} "
                    f"exceeds the checkpoint's n_predict="
                    f"{spec_cfg.n_predict}"
                )
            n = scfg.spec_draft_tokens
        self.speculative = True
        self.spec_draft_tokens = n
        self._spec_params = spec_params
        self._spec_cfg = spec_cfg
        # each slot's draft input: the base hidden state that produced the
        # slot's pending token; prefill and decode_spec keep it current
        self._spec_embed = torch.zeros(
            (scfg.max_batch, cfg.emb_dim), dtype=self.compute_dtype, device=self.device
        )

    def propose(self, embed, tokens):
        """(B, n) drafts from the slots' hidden states and pending tokens:
        the chain of the checkpoint's FULL config (its variance-preserving
        weights depend on n_predict), sliced to n. Each head feeds only on
        the ones before it, so the slice is the full chain's prefix."""
        return speculator_propose(self._spec_params, embed, tokens,
                                  self._spec_cfg)[:, :self.spec_draft_tokens]

    def decode_spec(self, slot_rids, lens, tokens):
        """One speculative step over all slots: draft (:meth:`propose`),
        verify the n+1 candidates in one paged forward, and take per row
        the longest accepted prefix plus the base's own token after it.
        Returns (tokens (B, n+1) np.int32, counts (B,) np.int32 of them to
        commit, the logits row of each row's last committed position
        (B, V))."""
        self._upload_table(slot_rids)
        tok = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
        with torch.no_grad():
            props = self.propose(self._spec_embed, tok)
            cand = torch.cat([tok[:, None], props], dim=1)  # (B, n+1)
            logits, embeds, _ = paged_verify_step(
                self.params,
                self.cache.pools,
                self._table_dev,
                torch.from_numpy(np.asarray(lens, np.int32)).to(self.device),
                cand,
                self.model_cfg,
                page_size=self.page_size,
                compute_dtype=self.compute_dtype,
                quant=self.scfg.kv_quant,
                rope=self.rope,
                tp=self.tp,
            )
            base_next = torch.argmax(logits, dim=-1)  # (B, n+1)
            match = torch.cumprod((props == base_next[:, :-1]).long(), dim=1)
            k = match.sum(dim=1)  # accepted drafts, 0..n
            rows = torch.arange(tok.shape[0], device=self.device)
            # the base's own pick at the first mismatch (or after a full accept)
            bonus = base_next[rows, k]
            prop_pad = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
            n1 = prop_pad.shape[1]
            emit = torch.where(torch.arange(n1, device=self.device)[None, :] == k[:, None],
                               bonus[:, None], prop_pad)
            self._spec_embed = embeds[rows, k].contiguous()
        return (emit.to(torch.int32).cpu().numpy(), (k + 1).to(torch.int32).cpu().numpy(),
                logits[rows, k])

    # -- capacity ----------------------------------------------------------

    def _padded(self, n: int) -> int:
        return self._padded_len(n, self.scfg.prefill_bucket)

    def admission_error(self, prompt_len: int, max_new: int) -> Optional[str]:
        # a verify step writes the draft tokens past the committed length
        # before the accept rule rolls back: budget those positions too
        worst = self._padded(prompt_len + max_new - 1) + 1 + self.spec_draft_tokens
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
        self._chunk_state.pop(rid, None)
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
        logits, embeds, kv = prefill(
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
        if self.speculative:
            # seed the draft chain with the hidden state that produced
            # this stream's first token
            self._spec_embed[slot] = embeds[0, p - 1]
        # logits of the last REAL position predict the next token
        return logits[0, p - 1] if full_logits else logits[0, 0]

    # -- chunked prefill (ServeConfig.prefill_chunk_tokens) ----------------

    def prefill_start(self, rid: int, slot: int, prompt) -> None:
        """Stage ``prompt`` for incremental prefill: allocate the whole
        page budget now (so admission capacity stays honest), then advance
        through a zeroed dense mini-cache one chunk per ``prefill_chunk``.
        The mini-cache is ``p_pad`` long, not ``s_pad``: whole-prompt
        prefill attends over exactly ``p_pad`` key positions, and matching
        that length keeps the chunked logits equal to the whole path's; the
        page-granular tail is zero-padded only at the final write."""
        p = len(prompt)
        p_pad = self._padded(p)
        s_pad = self.cache.pages_needed(p_pad) * self.page_size
        if not self.cache.ensure(rid, p_pad):
            raise RuntimeError("admission checked capacity; ensure cannot fail here")
        toks = torch.zeros((1, p_pad), dtype=torch.long)
        toks[0, :p] = torch.as_tensor(prompt, dtype=torch.long)
        nlayers = int(self.params["layers"]["wq"].shape[0])
        shape = (nlayers, 1, p_pad, self.kv_heads, self.model_cfg.head_dim)
        self._chunk_state[rid] = {
            "slot": slot, "toks": toks.to(self.device), "p": p, "p_pad": p_pad,
            "s_pad": s_pad, "pos": 0, "row": None, "embed": None,
            "cache": {
                "k": torch.zeros(shape, dtype=self.compute_dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.compute_dtype, device=self.device),
            },
        }

    def prefill_chunk(self, rid: int):
        st = self._chunk_state[rid]
        pos = st["pos"]
        m = min(self.scfg.prefill_chunk_tokens, st["p_pad"] - pos)
        logits, embeds, _ = decode_chunk(
            self.params, st["cache"], st["toks"][:, pos:pos + m], pos,
            self.model_cfg, compute_dtype=self.compute_dtype, rope=self.rope, tp=self.tp,
        )
        last = st["p"] - 1
        if pos <= last < pos + m:
            # the chunk holding the last REAL prompt position carries the
            # first token's logits
            st["row"] = logits[0, last - pos]
            st["embed"] = embeds[0, last - pos]
        st["pos"] = pos + m
        if st["pos"] < st["p_pad"]:
            return None
        tail = st["s_pad"] - st["p_pad"]
        cache = {
            n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, tail))
            for n, a in st["cache"].items()
        }
        self.cache.write_prompt(rid, cache["k"][:, 0], cache["v"][:, 0])
        if self.speculative:
            self._spec_embed[st["slot"]] = st["embed"]
        del self._chunk_state[rid]
        return st["row"]

    # -- decode ------------------------------------------------------------

    def _upload_table(self, slot_rids) -> None:
        """The cached device page table, keyed on (allocator version, slot
        membership): steady-state decode re-uploads nothing."""
        tkey = (self.cache.table_version, tuple(slot_rids))
        if tkey != self._table_key:
            self._table_key = tkey
            self._table_dev = torch.from_numpy(
                self.cache.page_table(list(slot_rids), self.max_pages)
            ).to(self.device)

    def decode(self, slot_rids, lens, tokens, generator):
        self._upload_table(slot_rids)
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
            tp=self.tp,
        )
        tok = sample_token(
            logits, generator, scfg.temperature, scfg.top_k, scfg.do_sample
        )
        return tok.to(torch.int32).cpu().numpy(), logits
