"""Ragged paged-attention decode (serving path).

Counterpart of ``fms_fsdp_tpu/ops/paged_attention.py``. The KV cache
lives in fixed-size pages — (page_size, Nkv, H) tiles scattered through a
shared pool — with a per-sequence page table; one decode call serves a
batch whose rows sit at different positions.

Two implementations of one contract:

- ``paged_attention_reference``: plain PyTorch — gather the pages back
  into a contiguous (B, S, Nkv, H) cache and run :func:`gqa_attend`, the
  attend the dense decode path runs. Because unallocated table slots
  point at a zero page, the gathered cache equals the dense one.
- ``paged_attention_kernel``: the hand-written CUDA kernel
  (``csrc/paged_decode.cu``) for CUDA tensors, which replaces both Pallas
  kernels (v1 ``_paged_decode_kernel`` and v2 ``_paged_decode_kernel_v2``,
  int8/fp8 pools dequantised on chip). For CPU tensors it runs the plain
  version; that choice is made by the tensors' device alone.

``paged_attention`` dispatches: ``"auto"`` is the kernel for CUDA
tensors and the reference for CPU tensors.
"""

import ctypes
import math

import torch

from fms_fsdp_tpu_torch.ops.quant import kv_dequantize

LOG2E = 1.4426950408889634  # log2(e)

# launches of the CUDA kernel, by the Pallas kernel whose contract the
# call fulfils: "v1" (pools in the compute dtype, block_kv == page_size)
# and "v2" (quantized pools, or a wider block_kv). Counted where the
# kernel launches and nowhere else.
LAUNCHES = {"v1": 0, "v2": 0}
# launches by the query and KV head counts they ran at ("32/8"; "16/4" at a
# tensor rank's heads of llama3_8b at tp 2), counted with LAUNCHES
HEAD_LAUNCHES = {}

# dtype codes of csrc/paged_decode.cu
_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.int8: 3,
    torch.float8_e4m3fn: 4,
}
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)
_HEAD_DIM = 128  # kHead in the kernel: every Llama variant of the repo
_MAX_GROUP = 8  # kMaxGroup: query heads per kv head
STAGE_KEYS = 64  # kStageKeys: keys per cp.async stage of the kernel
SPLIT_KEYS = 256  # keys of one split, before the planner shrinks it
# bound on the kernel's relative error per row, ||kernel - plain|| / ||plain||
# over all the row's query heads, against the plain version, by q's dtype
# (quantized pools compute in q's 16-bit dtype). Set between readings of
# chip_smoke.py's kernels phase on an H100 (B=8 rows up to 2,048 keys in
# four pool types, one row of 16,383 keys): the kernel's error (16-bit
# compute 4.4e-3 to 6.1e-3, fp32 5.7e-7 at most) and that of a control,
# the plain version with the row's first split of keys left out (0.13 at
# least, on the row of 64 splits; 0.35 on the B=8 rows), which must fail.
REL_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-5}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    HEAD_LAUNCHES.clear()


def decode_splits(batch, nkv, capacity, page_size, sm_count, split_keys=None):
    """(split_keys, n_splits) of the kernel's grid (splits, Nkv, B).

    A split is a run of keys that is a whole number of pages and of
    ``STAGE_KEYS``-key stages. A ``split_keys`` resolved by the tuning
    table (``tune/lookup.py::resolve_paged_decode``'s ``block_kv``) is the
    split as it is and must be a multiple of that unit; without one the
    planner starts at ``SPLIT_KEYS`` and shrinks by the unit while the grid
    has fewer than two blocks per SM and a smaller split is possible.
    ``n_splits`` covers ``capacity`` (max_pages * page_size). Shapes alone
    decide: the rows' lengths are on the card and reading them would cost
    a host sync in every decode step.
    """
    if min(batch, nkv, capacity, page_size, sm_count) <= 0:
        raise ValueError(
            f"decode_splits needs positive sizes; got batch={batch}, nkv={nkv}, "
            f"capacity={capacity}, page_size={page_size}, sm_count={sm_count}"
        )
    unit = math.lcm(STAGE_KEYS, page_size)
    if split_keys is not None:
        if split_keys <= 0 or split_keys % unit:
            raise ValueError(
                f"split_keys={split_keys} must be a positive multiple of "
                f"lcm({STAGE_KEYS}, page_size={page_size}) = {unit}"
            )
        return split_keys, -(-capacity // split_keys)
    split = max(unit, -(-SPLIT_KEYS // unit) * unit)
    # no split longer than the cache
    split = min(split, -(-capacity // unit) * unit)
    while split > unit and batch * nkv * -(-capacity // split) < 2 * sm_count:
        split -= unit
    return split, -(-capacity // split)


_SM_COUNT = {}


def _sm_count(device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def gqa_attend(q, k_cache, v_cache, positions):
    """Grouped-query attention of m query positions against a cache.

    q (B, m, Nq, H); k_cache/v_cache (B, S, Nkv, H); positions (B, m)
    integer — query i of row b sits at positions[b, i] and sees cache
    entries <= it. Returns (B, m, Nq*H) in q's dtype: fp32 scores and
    softmax, probabilities cast to q's dtype before the PV product.
    """
    b, m, nq, hd = q.shape
    nkv = k_cache.shape[2]
    group = nq // nkv
    s = k_cache.shape[1]
    qg = q.reshape(b, m, nkv, group, hd)
    scores = torch.einsum(
        "bmkgh,bskh->bkgms", qg.float(), k_cache.float()
    ) * (hd**-0.5)
    idx = torch.arange(s, device=q.device)[None, None, None, None, :]
    qpos = positions[:, None, None, :, None]
    scores = scores.masked_fill(idx > qpos, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgms,bskh->bmkgh", probs, v_cache.to(q.dtype))
    return out.reshape(b, m, nq * hd)


def gather_pages(pages, page_table):
    """pages (P, ps, ...) + page_table (B, maxp) -> (B, maxp*ps, ...)."""
    b, maxp = page_table.shape
    ps = pages.shape[1]
    g = pages[page_table.long()]  # (B, maxp, ps, ...)
    return g.reshape(b, maxp * ps, *pages.shape[2:])


def paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens):
    """One ragged decode position per row, via gather + dense attend.

    q (B, Nq, H); k_pages/v_pages (P, ps, Nkv, H); page_table (B, maxp)
    int32; seq_lens (B,) int32 = the position each row's query sits at
    (it sees cache entries <= seq_lens[b]). Returns (B, Nq*H).
    """
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    return gqa_attend(q[:, None], k, v, seq_lens[:, None].long())[:, 0]


def paged_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                          k_scales=None, v_scales=None, compute_dtype=None):
    """The kernel's plain version: quantized pools are dequantised (only
    the gathered pages, never the pool) before the reference attend."""
    if k_scales is None:
        return paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens)
    dtype = compute_dtype or q.dtype
    k = kv_dequantize(gather_pages(k_pages, page_table),
                      gather_pages(k_scales, page_table), dtype)
    v = kv_dequantize(gather_pages(v_pages, page_table),
                      gather_pages(v_scales, page_table), dtype)
    return gqa_attend(q[:, None], k, v, seq_lens[:, None].long())[:, 0]


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _library():
    from fms_fsdp_tpu_torch.ops import cuda_build

    built = cuda_build.load("paged_decode")
    fn = built.lib.paged_decode
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: a default int would cut
        # them to 32 bits
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(q, k_pages, v_pages, page_table, seq_lens, k_scales,
                     v_scales, compute_dtype):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_table": page_table, "seq_lens": seq_lens}
    if k_scales is not None:
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(
            f"expected q (B, Nq, H) and pages (P, ps, Nkv, H); got "
            f"q{tuple(q.shape)} pages{tuple(k_pages.shape)}"
        )
    b, nq, hd = q.shape
    _, ps, nkv, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(
            f"pool shapes k{tuple(k_pages.shape)} v{tuple(v_pages.shape)} "
            f"do not match q{tuple(q.shape)}"
        )
    if nq % nkv:
        raise ValueError(f"Nq={nq} is not a multiple of Nkv={nkv}")
    if hd != _HEAD_DIM or nq // nkv > _MAX_GROUP:
        raise ValueError(
            f"the kernel takes head_dim {_HEAD_DIM} and at most {_MAX_GROUP} "
            f"query heads per kv head; got H={hd}, group={nq // nkv}"
        )
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("page_table and seq_lens must be int32")
    if page_table.dim() != 2 or page_table.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(
            f"page_table{tuple(page_table.shape)} / seq_lens"
            f"{tuple(seq_lens.shape)} do not match batch {b}"
        )
    if q.dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"q dtype {q.dtype} is not bf16, fp16 or fp32")
    if compute_dtype is not None and compute_dtype != q.dtype:
        raise ValueError(
            f"compute_dtype {compute_dtype} must be q's dtype {q.dtype}"
        )
    if v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages must share a dtype")
    if k_scales is None:
        if k_pages.dtype != q.dtype:
            raise ValueError(
                f"unquantized pools must be in q's dtype {q.dtype}, got "
                f"{k_pages.dtype}"
            )
    else:
        if k_pages.dtype not in _QUANT_DTYPES:
            raise ValueError(
                f"scaled pools must be int8 or float8_e4m3fn, got {k_pages.dtype}"
            )
        want = tuple(k_pages.shape[:3]) + (1,)
        for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
            if s.dtype != torch.float32 or tuple(s.shape) != want:
                raise ValueError(
                    f"{name} must be fp32 {want}, got {s.dtype} {tuple(s.shape)}"
                )


def _launch(q, k_pages, v_pages, page_table, seq_lens, k_scales, v_scales, split_keys):
    b, nq, hd = q.shape
    _, ps, nkv, _ = k_pages.shape
    maxp = page_table.shape[1]
    group = nq // nkv
    out = torch.empty((b, nq * hd), dtype=q.dtype, device=q.device)
    split_keys, n_splits = decode_splits(b, nkv, maxp * ps, ps, _sm_count(q.device),
                                         split_keys)
    # fp32 partials of every (row, kv head, split, query head): o, then m, l
    part_o = torch.empty((b, nkv, n_splits, group, hd), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((2, b, nkv, n_splits, group), dtype=torch.float32,
                          device=q.device)
    # scale * log2(e) folded into q; the constant is first rounded to q's
    # dtype, as JAX rounds a weakly typed python scalar
    q_scale = torch.tensor(hd**-0.5 * LOG2E, dtype=q.dtype).item()
    fn = _library()
    # the runtime launches on the thread's current device: make it q's
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if k_scales is not None else None,
            v_scales.data_ptr() if v_scales is not None else None,
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(),
            b, nq, nkv, hd, ps, maxp, split_keys, n_splits,
            _CODES[q.dtype], _CODES[k_pages.dtype], q_scale, stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError_t {err}")
    return out


def paged_attention_kernel(
    q, k_pages, v_pages, page_table, seq_lens, *,
    k_scales=None, v_scales=None, block_kv=None, compute_dtype=None,
):
    """Ragged paged-attention decode; contract of
    :func:`paged_attention_reference` (same shapes, same masking rule).

    CUDA tensors launch ``csrc/paged_decode.cu``: one block per (key
    split, kv head, row) of the grid :func:`decode_splits` plans, each
    writing fp32 partials that a second kernel of the same call merges;
    int8/e4m3 pools (with ``k_scales``/``v_scales``, per-row fp32 absmax
    scales (P, ps, Nkv, 1)) are dequantised in registers. CPU tensors run
    :func:`paged_attention_plain`.

    ``block_kv`` keeps the JAX contract -- a positive multiple of the page
    size, default the page size -- and picks which Pallas kernel's launch
    count a call adds to ("v2" where it differs from the page size). On
    the card a ``block_kv`` other than the page size is the split length
    (:func:`decode_splits`), so it must also be a multiple of
    lcm(``STAGE_KEYS``, page size); the page size leaves the split to the
    planner. ``compute_dtype`` must be q's dtype when given.
    """
    page_size = k_pages.shape[1]
    if block_kv is None:
        block_kv = page_size
    if block_kv % page_size != 0 or block_kv <= 0:
        raise ValueError(
            f"block_kv ({block_kv}) must be a positive multiple of the "
            f"pool page size ({page_size})"
        )
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, page_table, seq_lens, k_scales, v_scales,
            compute_dtype,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_kernel runs on cuda or cpu, not {q.device}")
    _check_cuda_args(q, k_pages, v_pages, page_table, seq_lens, k_scales,
                     v_scales, compute_dtype)
    out = _launch(q, k_pages, v_pages, page_table, seq_lens, k_scales, v_scales,
                  None if block_kv == page_size else block_kv)
    LAUNCHES["v2" if k_scales is not None or block_kv != page_size else "v1"] += 1
    heads = f"{q.shape[1]}/{k_pages.shape[2]}"
    HEAD_LAUNCHES[heads] = HEAD_LAUNCHES.get(heads, 0) + 1
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def paged_attention(
    q, k_pages, v_pages, page_table, seq_lens, *, impl="auto",
    k_scales=None, v_scales=None, block_kv=None, compute_dtype=None,
):
    """Ragged paged-attention decode: q (B, Nq, H) against paged k/v
    pools -> (B, Nq*H). ``impl``:

    - "reference": gather + dense attend. Quantized pools must be
      dequantised by the caller (serve/decode.py does);
    - "kernel": :func:`paged_attention_kernel`;
    - "auto": the kernel for CUDA tensors, the reference for CPU tensors.
    """
    if impl == "auto":
        impl = "kernel" if q.device.type == "cuda" else "reference"
    if impl == "reference":
        return paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens)
    if impl == "kernel":
        return paged_attention_kernel(
            q, k_pages, v_pages, page_table, seq_lens,
            k_scales=k_scales, v_scales=v_scales, block_kv=block_kv,
            compute_dtype=compute_dtype,
        )
    raise ValueError(f"unknown paged attention impl: {impl!r}")

