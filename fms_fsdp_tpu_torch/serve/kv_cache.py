"""Paged KV-cache: a fixed-size-page pool with per-sequence page tables.

Counterpart of ``fms_fsdp_tpu/serve/kv_cache.py`` (allocator, page
tables, ``write_prompt``, quantized pools). The cache is a shared pool
of fixed-size pages, one pool per k and v:

    pools["k"]: (L, P, page_size, Nkv, H)   P = num_pages

and each sequence owns an ordered list of page ids; logical cache
position ``t`` of a sequence lives at (pages[t // page_size],
t % page_size). The page table handed to the decode step is the padded
(B, max_pages) int32 matrix of those lists.

Reserved pages (the allocator never hands them out):

- page 0, the **zero page**: every unallocated page-table slot points
  here. It is never written, so gathering a sequence's table yields the
  dense cache layout — real pages, then zeros.
- page 1, the **scratch page**: idle batch slots in the fixed-shape
  decode step still execute a write; their page-table rows point every
  slot here, where no live sequence ever reads.

Allocation is host-side Python (lowest index first via a heap) with
all-or-nothing semantics: ``ensure`` either extends a sequence to the
requested capacity or changes nothing and returns False.

The pools are updated in place with ``index_put_`` — the counterpart of
JAX's ``.at[].set`` on donated buffers, which XLA also turns into an
in-place write. Quantized storage (``quant="int8"|"fp8"``) keeps 1-byte
values plus fp32 per-row scales (``ops/quant.py``).

The pools live on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request the constructor raises, like
every entry point of the port (``utils/device.py``).

Page handoff: ``gather_pages`` reads a sequence's pages out in their
storage dtype (int8/fp8 values and their fp32 scales as stored, never
widened) and ``scatter_pages`` writes a shipped page set into freshly
allocated pages. ``defrag`` compacts allocated pages onto the lowest
indices. Both change page tables, so both bump ``table_version``, the key
of the adapters' cached device page table: a missed bump would leave the
kernel reading the old pages. Reserved pages never move and are never
written by either.
"""

import heapq
from typing import Dict, List, Optional

import numpy as np
import torch

from fms_fsdp_tpu_torch.ops.quant import FP8_E4M3, kv_quantize
from fms_fsdp_tpu_torch.utils.device import resolve_device

ZERO_PAGE = 0
SCRATCH_PAGE = 1
RESERVED_PAGES = 2

_QUANT_STORE_DTYPE = {"int8": torch.int8, "fp8": FP8_E4M3}


class PagedKVCache:
    """Device pools + the host-side page allocator."""

    def __init__(
        self,
        n_layers: int,
        num_pages: int,
        page_size: int,
        n_kv_heads: int,
        head_dim: int,
        dtype=torch.bfloat16,
        quant: str = "none",
        device=None,
    ):
        if num_pages <= RESERVED_PAGES:
            raise ValueError(
                f"num_pages={num_pages}: pages 0/1 are reserved (zero/scratch), "
                "the pool needs at least one allocatable page"
            )
        if quant not in ("none", "int8", "fp8"):
            raise ValueError(f"unknown kv cache quant: {quant!r}")
        self.n_layers = n_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.quant = quant
        self.device = resolve_device(device)

        store = _QUANT_STORE_DTYPE.get(quant, dtype)
        shape = (n_layers, num_pages, page_size, n_kv_heads, head_dim)
        self.pools = {
            "k": torch.zeros(shape, dtype=store, device=self.device),
            "v": torch.zeros(shape, dtype=store, device=self.device),
        }
        if quant != "none":
            sshape = shape[:-1] + (1,)
            self.pools["k_scale"] = torch.zeros(sshape, device=self.device)
            self.pools["v_scale"] = torch.zeros(sshape, device=self.device)

        self._free: List[int] = list(range(RESERVED_PAGES, num_pages))
        heapq.heapify(self._free)
        self._seq_pages: Dict[int, List[int]] = {}
        self._seq_tokens: Dict[int, int] = {}
        self.alloc_count = 0
        self.free_count = 0
        self.failed_allocs = 0
        self.defrag_moves = 0
        # bumped whenever any page table could have changed (alloc, free,
        # scatter, defrag); the adapter keys its cached device page table
        # on it
        self.table_version = 0

    # -- queries -----------------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return sum(len(p) for p in self._seq_pages.values())

    @property
    def pages_free(self) -> int:
        return len(self._free)

    def fragmentation(self) -> float:
        """Internal fragmentation: the fraction of allocated slots not
        holding a token (tail waste of each sequence's last page)."""
        pages = self.pages_in_use
        if pages == 0:
            return 0.0
        slots = pages * self.page_size
        tokens = sum(self._seq_tokens.values())
        return (slots - tokens) / slots

    def page_bytes(self) -> int:
        """Bytes one page holds across all pool leaves (k, v, scales)."""
        return sum(
            p.numel() * p.element_size() for p in self.pools.values()
        ) // self.num_pages

    def tokens_of(self, seq_id: int) -> int:
        return self._seq_tokens.get(seq_id, 0)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_ensure(self, seq_id: int, n_tokens: int) -> bool:
        have = len(self._seq_pages.get(seq_id, ()))
        return self.pages_needed(n_tokens) - have <= len(self._free)

    # -- alloc / free ------------------------------------------------------

    def ensure(self, seq_id: int, n_tokens: int) -> bool:
        """Grow seq_id's allocation to hold ``n_tokens`` cache slots.
        All-or-nothing: on insufficient free pages nothing changes and
        False is returned (the scheduler defers or evicts)."""
        pages = self._seq_pages.setdefault(seq_id, [])
        need = self.pages_needed(n_tokens) - len(pages)
        if need > len(self._free):
            self.failed_allocs += 1
            return False
        for _ in range(max(0, need)):
            pages.append(heapq.heappop(self._free))
            self.alloc_count += 1
        if need > 0:
            self.table_version += 1
        self._seq_tokens[seq_id] = max(
            self._seq_tokens.get(seq_id, 0), n_tokens
        )
        return True

    def free(self, seq_id: int) -> int:
        """Release every page of seq_id; returns how many."""
        pages = self._seq_pages.pop(seq_id, [])
        self._seq_tokens.pop(seq_id, None)
        for p in pages:
            heapq.heappush(self._free, p)
        self.free_count += len(pages)
        if pages:
            self.table_version += 1
        return len(pages)

    def pages_of(self, seq_id: int) -> List[int]:
        return list(self._seq_pages.get(seq_id, ()))

    # -- page tables -------------------------------------------------------

    def page_table_row(self, seq_id: Optional[int], max_pages: int):
        """One padded page-table row: allocated pages, then the zero page.
        ``None`` (an idle batch slot) maps every slot to the scratch page."""
        if seq_id is None:
            return [SCRATCH_PAGE] * max_pages
        pages = self._seq_pages.get(seq_id, [])
        if len(pages) > max_pages:
            raise ValueError(
                f"sequence {seq_id} holds {len(pages)} pages > max_pages="
                f"{max_pages} (max_seq_len / page_size mismatch)"
            )
        return pages + [ZERO_PAGE] * (max_pages - len(pages))

    def page_table(self, seq_ids: List[Optional[int]], max_pages: int):
        """(B, max_pages) int32 numpy page table for these slots."""
        return np.asarray(
            [self.page_table_row(s, max_pages) for s in seq_ids],
            dtype=np.int32,
        )

    # -- writes ------------------------------------------------------------

    def write_prompt(self, seq_id: int, k: torch.Tensor, v: torch.Tensor):
        """Scatter a prefilled (L, S_pad, Nkv, H) k/v pair into seq_id's
        pages, in place. ``S_pad`` must be a page multiple covering the
        prompt; positions past the prompt are the prefill's zeros, which
        keep page tails equal to the dense cache. Call ``ensure`` first."""
        L, s_pad = k.shape[0], k.shape[1]
        if s_pad % self.page_size:
            raise ValueError(f"S_pad={s_pad} is not a multiple of {self.page_size}")
        n = s_pad // self.page_size
        pages = self._seq_pages.get(seq_id, [])
        if n > len(pages):
            raise ValueError(
                f"write_prompt needs {n} pages, sequence {seq_id} holds "
                f"{len(pages)} — call ensure() first"
            )
        index = (
            torch.arange(L, device=self.device)[:, None],
            torch.tensor(pages[:n], device=self.device)[None, :],
        )
        shape = (L, n, self.page_size, self.n_kv_heads, self.head_dim)
        kp, vp = k.reshape(shape), v.reshape(shape)
        if self.quant == "none":
            self.pools["k"].index_put_(index, kp.to(self.dtype))
            self.pools["v"].index_put_(index, vp.to(self.dtype))
        else:
            qk, sk = kv_quantize(kp, self.quant)
            qv, sv = kv_quantize(vp, self.quant)
            self.pools["k"].index_put_(index, qk)
            self.pools["v"].index_put_(index, qv)
            self.pools["k_scale"].index_put_(index, sk)
            self.pools["v_scale"].index_put_(index, sv)

    # -- page export / import (serve/disagg/ handoff) ----------------------

    def gather_pages(self, seq_id: int) -> Dict[str, torch.Tensor]:
        """seq_id's pages as host tensors: leaf name -> (L, n_pages,
        page_size, Nkv, H|1) in the pool's STORAGE dtype."""
        pages = self._seq_pages.get(seq_id, [])
        if not pages:
            raise ValueError(f"sequence {seq_id} holds no pages to gather")
        ids = torch.tensor(pages, device=self.device)
        return {name: pool[:, ids].cpu() for name, pool in self.pools.items()}

    def scatter_pages(self, seq_id: int, arrays: Dict, n_tokens: int) -> bool:
        """The unpack half: allocate exactly the shipped page count for
        ``seq_id`` (all-or-nothing, like ``ensure``; False when the pool
        cannot hold it now) and write each leaf into the new page ids.
        ``n_tokens`` is the source pool's token accounting (``tokens_of``).
        Every structural mismatch is a typed HandoffError, checked before
        anything is allocated."""
        from fms_fsdp_tpu_torch.serve.disagg.handoff import HandoffError

        if set(arrays) != set(self.pools):
            raise HandoffError(
                f"handoff leaves {sorted(arrays)} do not match this "
                f"pool's {sorted(self.pools)} — kv_quant mismatch "
                f"between replicas"
            )
        n = int(arrays["k"].shape[1])
        for name, pool in self.pools.items():
            want = (pool.shape[0], n) + tuple(pool.shape[2:])
            got = tuple(arrays[name].shape)
            if got != want or arrays[name].dtype != pool.dtype:
                raise HandoffError(
                    f"handoff leaf {name!r} is {arrays[name].dtype} of shape "
                    f"{got}, this pool expects {pool.dtype} of {want} — page "
                    f"geometry mismatch"
                )
        if not self.ensure(seq_id, n * self.page_size):
            return False
        self._seq_tokens[seq_id] = n_tokens
        pages = self._seq_pages[seq_id]
        ids = torch.tensor(pages, device=self.device)
        try:
            for name, pool in self.pools.items():
                pool[:, ids] = arrays[name].to(self.device)
        except Exception as e:
            # free what this import allocated before surfacing: the pool
            # must account as before the attempt
            self.free(seq_id)
            raise HandoffError(
                f"handoff scatter failed after page allocation "
                f"(pages freed): {e}"
            ) from e
        return True

    # -- defrag ------------------------------------------------------------

    def defrag(self) -> int:
        """Compact allocated pages onto the lowest pool indices.

        Builds JAX's old->new permutation (sequence admission order, page
        order within each sequence, the free pages after them in index
        order), applies it to the pools in place on the positions it
        changes, rewrites the page lists, resets the free heap to the
        tail and bumps ``table_version``. Returns the number of allocated
        pages moved (also accumulated in ``defrag_moves``). Reserved pages
        never move."""
        perm = np.arange(self.num_pages)
        next_id = RESERVED_PAGES
        moves = 0
        new_lists: Dict[int, List[int]] = {}
        for seq_id in self._seq_pages:  # dict order = admission order
            new_pages = []
            for old in self._seq_pages[seq_id]:
                if old != next_id:
                    moves += 1
                perm[next_id] = old
                new_pages.append(next_id)
                next_id += 1
            new_lists[seq_id] = new_pages
        if moves:
            # free pages fill the tail; their content is junk by contract
            used = set(perm[:next_id].tolist())
            perm[next_id:] = [p for p in range(self.num_pages) if p not in used]
            dst = np.nonzero(perm != np.arange(self.num_pages))[0]
            dst_t = torch.from_numpy(dst).to(self.device)
            src_t = torch.from_numpy(perm[dst]).to(self.device)
            for pool in self.pools.values():
                # the gather copies the moved pages out before any write
                pool[:, dst_t] = pool[:, src_t]
            self._seq_pages = new_lists
            self.table_version += 1
        self._free = list(range(next_id, self.num_pages))
        heapq.heapify(self._free)
        self.defrag_moves += moves
        return moves
