"""Candidate tile configs per kernel + the static shared-memory cost model.

Counterpart of ``fms_fsdp_tpu/tune/candidates.py`` for the Hopper kernels
of ``fms_fsdp_tpu_torch/csrc/``. The signature functions (``flash_sig``,
``ssd_sig``, ``ce_sig``, ``paged_decode_sig``, ``dcn_bucket_sig``) are
JAX's, so both packages key one table the same way; the candidates and
the cost model are the H100's:

- the budget is a block's dynamic shared memory (``CHIP_SMEM_BYTES``),
  not a TPU core's VMEM;
- each kernel's bytes are the kernel's own formula, restated here from
  its source and checked against its ``*_smem_bytes`` C function on the
  card (``chip_smoke.py``'s tune phase):
  ``flash_fwd_sm90.cu`` / ``flash_bwd_sm90.cu`` (a ring of K/V tiles whose
  depth follows the key tile) and ``ssd_sm90.cu`` (``smem_bytes(hb, L)``);
- the candidate sets are the instantiations the kernels have: the 16-bit
  flash kernels take a 128-row query tile and a 64- or 128-key tile, the
  fp32 scalar kernels one 64 x 64 tile; the SSD kernels a chunk of 64,
  128 or 256 tokens (``kMaxL``); the paged decode a page size and a split
  length (``decode_splits``). The flash ``family`` picks which Pallas
  contract a launch fulfils (one CUDA kernel serves both) and ``quant``
  the operand wire in front of it (``ops/quant.py``);
- the fused CE is PyTorch, not a kernel: its fp32 logits tiles are
  budgeted against device memory.

Everything here is pure host arithmetic over python ints -- no torch, no
device, no clock -- so candidate generation and pruning run identically
on a CPU host and inside the lookup path.
"""

import math
from typing import Dict, List, Optional

# Dynamic shared memory a block may opt into (cudaFuncSetAttribute), by
# chip key: 232,448 bytes on sm_90 (227 KB of the SM's 256 KB). "cpu"
# prunes as the card does, so CPU tests see the card's candidates; an
# unknown chip gets the same sm_90 figure.
CHIP_SMEM_BYTES: Dict[str, int] = {"h100": 232448, "cpu": 232448}
DEFAULT_SMEM_BYTES = 232448

# Device-memory budget for the fused CE's fp32 logits tiles (they compete
# with params, moments and activations for the card's 80 GB). JAX's 8 GiB
# was set for a 16 GB chip. On an 80 GB H100 the Llama trainer of
# chip_smoke.py's train phase peaks near 56 GB, so half of the ~24 GB
# left, 12 GiB, admits chunk 8192 at vocab 128256 (an 8.4 GB tile pair)
# and refuses 16384 (16.8 GB).
CE_HBM_BUDGET_BYTES = 12 << 30

DTYPE_BYTES = {
    "bfloat16": 2,
    "float16": 2,
    "float32": 4,
    "int8": 1,
    "float8_e4m3fn": 1,
}

# The static defaults: the last link of the fallback chain, and what
# kernel_tuning="off" must reproduce exactly.
FLASH_DEFAULT_BLOCK_Q = 128
FLASH_DEFAULT_BLOCK_K = 128
SSD_DEFAULT_CHUNK = 256
CE_DEFAULT_CHUNK = 4096

# The resident Pallas kernels' sequence cap (JAX's MAX_KERNEL_SEQ): past
# it only the kvgrid contract is legal
MAX_KERNEL_SEQ = 8192
# 16-bit flash kernels: 128 query rows a block, keys a tile
FLASH_BLOCK_Q = 128
FLASH_BLOCK_K_CHOICES = (64, 128)
# K/V ring depth by key tile (kStages): 128-key tiles keep 2 stages, 64-key
# tiles take 4, the same bytes in flight
FLASH_STAGES = {64: 4, 128: 2}
# the fp32 scalar kernels' one tile (csrc/flash_attention.cu kBQ, kBK)
FLASH_FP32_BLOCK = 64
_FLASH_QUANT_CHOICES = (None, "int8", "fp8")

_HEAD = 128  # kHead of the flash kernels
_SSD_TILE = 64  # kT of the SSD kernels: a chunk is whole tiles
_SSD_MAX_CHUNK = 256  # kMaxL
_SSD_CHUNK_CHOICES = (64, 128, 256)
_CE_CHUNK_CHOICES = (1024, 2048, 4096, 8192, 16384)


def dtype_bytes(dtype: str) -> int:
    return DTYPE_BYTES.get(str(dtype), 4)


def smem_budget(chip: str) -> int:
    return CHIP_SMEM_BYTES.get(chip, DEFAULT_SMEM_BYTES)


def _sixteen_bit(dtype: str) -> bool:
    return str(dtype) in ("bfloat16", "float16")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def flash_sig(q_shape, k_shape) -> Dict[str, int]:
    """Shape signature of one attention call, (B, S, N, H) layout."""
    b, sq, nq, h = q_shape
    _, sk, nkv, _ = k_shape
    return {
        "batch": int(b),
        "nq": int(nq),
        "nkv": int(nkv),
        "seq_q": int(sq),
        "seq_k": int(sk),
        "head": int(h),
    }


def _tile_bytes(rows: int) -> int:
    """A 16-bit tile of ``rows`` x 128 elements (two 64-column halves)."""
    return rows * _HEAD * 2


def _barrier_bytes(stages: int) -> int:
    """The mbarriers (one for the resident operands, a full and an empty
    barrier a stage) in whole 64-byte lines."""
    return 64 * -(-(8 * (1 + 2 * stages)) // 64)


def flash_fwd_smem_bytes(block_k: int) -> int:
    """``flash_fwd_sm90.cu``: the 1024-byte swizzle alignment, Q, the K
    and V rings, the barriers."""
    stages = FLASH_STAGES[block_k]
    return (1024 + _tile_bytes(FLASH_BLOCK_Q) + 2 * stages * _tile_bytes(block_k)
            + _barrier_bytes(stages))


def flash_dq_smem_bytes(block_k: int) -> int:
    """``flash_bwd_sm90.cu`` dq: Q and dO, then the K and V rings."""
    stages = FLASH_STAGES[block_k]
    return (1024 + 2 * _tile_bytes(FLASH_BLOCK_Q) + 2 * stages * _tile_bytes(block_k)
            + _barrier_bytes(stages))


def flash_dkv_smem_bytes() -> int:
    """``flash_bwd_sm90.cu`` dk/dv (one tile: 128 keys, 64-row query
    tiles): K and V, three stages of q, q2, dO and their lse/delta."""
    stage = 3 * _tile_bytes(64) + 2 * 64 * 4
    return 1024 + 2 * _tile_bytes(128) + 3 * stage + 64


def flash_smem_bytes(family: str, sig: Dict[str, int], dtype: str,
                     block_q: int, block_k: int,
                     quant: Optional[str] = None) -> Optional[int]:
    """Largest dynamic shared memory of the kernels a training step runs
    (forward, dq, dk/dv) at this tile; None for fp32, whose scalar kernels
    have one tile and nothing to price. ``family`` and ``quant`` change
    no block's bytes: one kernel serves both contracts, and the wire runs
    before it in device memory."""
    del family, sig, block_q, quant
    if not _sixteen_bit(dtype):
        return None
    return max(flash_fwd_smem_bytes(block_k), flash_dq_smem_bytes(block_k),
               flash_dkv_smem_bytes())


def _flash_tiles(dtype: str):
    if _sixteen_bit(dtype):
        return [(FLASH_BLOCK_Q, bk) for bk in FLASH_BLOCK_K_CHOICES]
    return [(FLASH_FP32_BLOCK, FLASH_FP32_BLOCK)]


def _legal_block(seq: int, b: int) -> bool:
    return b <= seq and seq % b == 0


def _flash_fits(sig, dtype, family, block_q, block_k, quant, chip):
    if family == "resident" and max(sig["seq_q"], sig["seq_k"]) > MAX_KERNEL_SEQ:
        return False
    if not (_legal_block(sig["seq_q"], block_q) and _legal_block(sig["seq_k"], block_k)):
        return False
    smem = flash_smem_bytes(family, sig, dtype, block_q, block_k, quant)
    return smem is None or smem <= smem_budget(chip)


def flash_candidates(sig: Dict[str, int], dtype: str, chip: str) -> List[Dict]:
    """Legal (family, block_q, block_k, quant) configs: the kernels' tiles
    for the dtype that divide both lengths, resident only up to
    ``MAX_KERNEL_SEQ``."""
    out = []
    for family in ("resident", "kvgrid"):
        for quant in _FLASH_QUANT_CHOICES:
            for bq, bk in _flash_tiles(dtype):
                if not _flash_fits(sig, dtype, family, bq, bk, quant, chip):
                    continue
                c = {"family": family, "block_q": bq, "block_k": bk,
                     "smem_bytes": flash_smem_bytes(family, sig, dtype, bq, bk, quant)}
                if quant:
                    c["quant"] = quant
                out.append(c)
    return out


def flash_config_legal(config: Dict, sig: Dict[str, int], dtype: str,
                       chip: str) -> bool:
    """Is a table entry's config runnable for this exact shape? A
    nearest-signature hit must re-check: its tile may not divide our
    lengths, and a resident pick may pass the cap."""
    family = config.get("family")
    default_q, default_k = _flash_tiles(dtype)[-1]
    bq = config.get("block_q", default_q)
    bk = config.get("block_k", default_k)
    quant = config.get("quant")
    if family not in (None, "resident", "kvgrid"):
        return False
    if quant not in _FLASH_QUANT_CHOICES:
        return False
    if (bq, bk) not in _flash_tiles(dtype):
        return False
    return _flash_fits(sig, dtype, family, bq, bk, quant, chip)


# ---------------------------------------------------------------------------
# SSD (Mamba2 chunked scan)
# ---------------------------------------------------------------------------


def ssd_sig(x_shape, groups: int, dstate: int) -> Dict[str, int]:
    """x (B, S, H, P); groups/dstate from the B/C projections."""
    b, s, h, p = x_shape
    return {
        "batch": int(b),
        "seq": int(s),
        "heads": int(h),
        "headdim": int(p),
        "groups": int(groups),
        "dstate": int(dstate),
    }


def ssd_heads_per_block(sig: Dict[str, int]) -> int:
    """``ssd_sm90.cu``: two heads of one group a block where the group's
    heads pair up, else one."""
    return 2 if (sig["heads"] // max(1, sig["groups"])) % 2 == 0 else 1


def ssd_smem_bytes(sig: Dict[str, int], dtype: str, chunk: int) -> Optional[int]:
    """``ssd_sm90.cu::smem_bytes(hb, L)`` for 16-bit inputs at the
    kernel's widths (headdim 64, dstate 128): the B and x rings of L / 64
    slots, two C slots, round_T(s_prev) of each head, the fp32 score tile,
    dt and a of two chunks, rd and the column factors. None where no
    ``ssd_sm90`` block runs (fp32 runs ``ssd.cu``, whose shared memory
    does not depend on L; other widths run the einsums)."""
    p, n = 64, 128
    if not _sixteen_bit(dtype) or sig["headdim"] != p or sig["dstate"] != n:
        return None
    hb, t, ld_score = ssd_heads_per_block(sig), _SSD_TILE, 72
    L = chunk
    return 2 * (L * (n + hb * p) + 2 * t * n + hb * n * p) + 4 * (t * ld_score + 6 * hb * L)


def _ssd_legal(sig, dtype, L, chip):
    if L <= 0 or L % _SSD_TILE or L > _SSD_MAX_CHUNK:
        return False
    if L > sig["seq"] or sig["seq"] % L != 0:
        return False
    smem = ssd_smem_bytes(sig, dtype, L)
    return smem is None or smem <= smem_budget(chip)


def ssd_candidates(sig: Dict[str, int], dtype: str, chip: str) -> List[Dict]:
    return [{"chunk": L, "smem_bytes": ssd_smem_bytes(sig, dtype, L)}
            for L in _SSD_CHUNK_CHOICES if _ssd_legal(sig, dtype, L, chip)]


def ssd_config_legal(config: Dict, sig: Dict[str, int], dtype: str,
                     chip: str) -> bool:
    L = config.get("chunk")
    return isinstance(L, int) and not isinstance(L, bool) and _ssd_legal(sig, dtype, L, chip)


# ---------------------------------------------------------------------------
# fused CE (chunked lm-head + cross-entropy)
# ---------------------------------------------------------------------------


def ce_sig(d_model: int, vocab: int) -> Dict[str, int]:
    return {"d_model": int(d_model), "vocab": int(vocab)}


def ce_working_set_bytes(sig: Dict[str, int], dtype: str, chunk: int) -> int:
    """Live-tile bytes of one backward chunk: the fp32 (chunk, V) p and
    d_logits tiles plus the (chunk, D) x tile (ops/fused_ce.py)."""
    db = dtype_bytes(dtype)
    return 2 * chunk * sig["vocab"] * 4 + chunk * sig["d_model"] * db


def ce_candidates(sig: Dict[str, int], dtype: str, chip: str) -> List[Dict]:
    del chip  # the CE tile is budgeted against device memory
    out = []
    for c in _CE_CHUNK_CHOICES:
        ws = ce_working_set_bytes(sig, dtype, c)
        if ws > CE_HBM_BUDGET_BYTES:
            continue
        out.append({"chunk": c, "working_set_bytes": ws})
    return out


def ce_config_legal(config: Dict, sig: Dict[str, int], dtype: str,
                    chip: str) -> bool:
    del chip
    c = config.get("chunk")
    if not isinstance(c, int) or isinstance(c, bool) or c <= 0:
        return False
    return ce_working_set_bytes(sig, dtype, c) <= CE_HBM_BUDGET_BYTES


# ---------------------------------------------------------------------------
# paged decode (serving: the split-KV kernel of csrc/paged_decode.cu)
# ---------------------------------------------------------------------------

PAGED_DEFAULT_PAGE_SIZE = 64
# block_kv == page_size: the planner (ops/paged_attention.py::decode_splits)
# picks the split, as it does with tuning off
PAGED_DEFAULT_BLOCK_KV = 64
# keys of one cp.async stage of the kernel (kStageKeys): a split is whole
# stages and whole pages
PAGED_STAGE_KEYS = 64
PAGED_MAX_SPLIT_KEYS = 2048

_PAGE_SIZE_CHOICES = (16, 32, 64, 128, 256)


def paged_decode_sig(batch: int, nq: int, nkv: int, head: int,
                     max_seq: int) -> Dict[str, int]:
    """Shape signature of one serving decode step: the ragged batch
    width, head geometry, and the per-sequence cache capacity the page
    table spans (max_pages * page_size)."""
    return {
        "batch": int(batch),
        "nq": int(nq),
        "nkv": int(nkv),
        "head": int(head),
        "max_seq": int(max_seq),
    }


def split_unit(page_size: int) -> int:
    """The step of a split's length: whole pages and whole stages."""
    return math.lcm(PAGED_STAGE_KEYS, page_size)


def _paged_legal(sig, ps, bkv):
    if ps not in _PAGE_SIZE_CHOICES or ps > sig["max_seq"] or sig["max_seq"] % ps:
        return False
    if bkv == ps:
        return True
    return bkv % split_unit(ps) == 0 and PAGED_STAGE_KEYS <= bkv <= PAGED_MAX_SPLIT_KEYS


def paged_decode_candidates(sig: Dict[str, int], dtype: str,
                            chip: str) -> List[Dict]:
    """(page_size, block_kv) pairs: for every page size that divides the
    capacity, the planner's split (``block_kv == page_size``) and the
    split lengths ``split_unit(page) * 2^i`` up to ``PAGED_MAX_SPLIT_KEYS``
    and no longer than the capacity needs. The kernel's shared memory is a
    fixed ring of 64-key stages whatever the page and split (its
    ``paged_decode_smem_bytes`` depends on the dtypes alone), so nothing
    is pruned against the budget."""
    del dtype, chip
    out = []
    for ps in _PAGE_SIZE_CHOICES:
        if not _paged_legal(sig, ps, ps):
            continue
        out.append({"page_size": ps, "block_kv": ps})
        unit = split_unit(ps)
        cap = -(-sig["max_seq"] // unit) * unit
        bkv = unit
        while bkv <= min(PAGED_MAX_SPLIT_KEYS, cap):
            if bkv != ps:
                out.append({"page_size": ps, "block_kv": bkv})
            bkv *= 2
    return out


def paged_decode_config_legal(config: Dict, sig: Dict[str, int], dtype: str,
                              chip: str) -> bool:
    del dtype, chip
    ps = config.get("page_size")
    bkv = config.get("block_kv", ps)
    if not all(isinstance(x, int) and not isinstance(x, bool) for x in (ps, bkv)):
        return False
    return _paged_legal(sig, ps, bkv)


# ---------------------------------------------------------------------------
# dcn_bucket (bucketed cross-host gradient reduction; its caller,
# parallel/overlap.py, is not ported yet: ROADMAP.md A.6b)
# ---------------------------------------------------------------------------

DCN_BUCKET_DEFAULT_MB = 32

_DCN_BUCKET_MB_CHOICES = (4, 8, 16, 32, 64, 128)

# Per-card cross-host bandwidth for the bytes-on-wire cost model (bytes/s):
# one 400 Gb/s InfiniBand NDR port a card, the usual H100 node layout (a
# data-sheet rate, not measured here). Other chips get 12.5e9, a
# 100 Gb/s link a card; JAX's arithmetic below is unchanged.
CHIP_DCN_BANDWIDTH: Dict[str, float] = {"h100": 50e9}
DEFAULT_DCN_BANDWIDTH = 12.5e9
DCN_COLLECTIVE_LATENCY_S = 50e-6


def dcn_bucket_sig(grad_mb: int, leaves: int, slices: int,
                   wire_bytes: int) -> Dict[str, int]:
    """Signature of one gradient-reduction schedule: total wire MB of
    the grad tree (rounded up), its leaf count, the slice count, and the
    wire width (1 for the fp8/int8 reduce formats, 2 for bf16)."""
    return {
        "grad_mb": max(1, int(grad_mb)),
        "leaves": int(leaves),
        "slices": int(slices),
        "wire_bytes": int(wire_bytes),
    }


def dcn_bucket_cost_s(sig: Dict[str, int], bucket_mb: int,
                      chip: str) -> float:
    """Exposed-latency estimate for one bucket size: K buckets pay K
    collective launches, and the LAST bucket's wire time cannot hide
    under any remaining backward compute (2x for the ring all-reduce's
    reduce+broadcast halves across slices)."""
    bw = CHIP_DCN_BANDWIDTH.get(chip, DEFAULT_DCN_BANDWIDTH)
    total = sig["grad_mb"] << 20
    bucket = max(1, int(bucket_mb)) << 20
    k = max(1, -(-total // bucket))  # ceil
    tail_bytes = min(bucket, total)
    hops = 2 * (sig["slices"] - 1) / max(1, sig["slices"])
    return k * DCN_COLLECTIVE_LATENCY_S + tail_bytes * hops / bw


def dcn_bucket_candidates(sig: Dict[str, int], dtype: str,
                          chip: str) -> List[Dict]:
    """Legal bucket sizes with their modeled exposed cost; of the sizes
    that hold the whole tree only the smallest is kept."""
    del dtype  # the wire width is part of the signature
    out = []
    seen_single = False
    for mb in _DCN_BUCKET_MB_CHOICES:
        if mb >= sig["grad_mb"]:
            if seen_single:
                continue
            seen_single = True
        out.append({
            "bucket_mb": mb,
            "cost_us": round(dcn_bucket_cost_s(sig, mb, chip) * 1e6, 3),
        })
    return out


def dcn_bucket_config_legal(config: Dict, sig: Dict[str, int], dtype: str,
                            chip: str) -> bool:
    del sig, dtype, chip  # any positive size buckets any tree
    mb = config.get("bucket_mb")
    return isinstance(mb, int) and not isinstance(mb, bool) and mb > 0


LEGALITY = {
    "flash_attention": flash_config_legal,
    "ssd": ssd_config_legal,
    "fused_ce": ce_config_legal,
    "paged_decode": paged_decode_config_legal,
    "dcn_bucket": dcn_bucket_config_legal,
}

CANDIDATES = {
    "flash_attention": flash_candidates,
    "ssd": ssd_candidates,
    "fused_ce": ce_candidates,
    "paged_decode": paged_decode_candidates,
    "dcn_bucket": dcn_bucket_candidates,
}


def config_legal(kernel: str, config: Dict, sig: Dict[str, int], dtype: str,
                 chip: str) -> bool:
    fn = LEGALITY.get(kernel)
    return bool(fn and fn(config, sig, dtype, chip))
