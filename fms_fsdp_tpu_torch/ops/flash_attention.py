"""Causal / full grouped-query flash attention (training path).

Counterpart of ``fms_fsdp_tpu/ops/flash_attention.py``. Public layout
q (B, Sq, Nq, H), k/v (B, Sk, Nkv, H) with Nq % Nkv == 0; query head h
reads kv head h // (Nq // Nkv). The numbers are those of the TPU kernels:

- q is scaled by ``scale * log2(e)`` (the constant rounded to q's dtype,
  as JAX rounds a weakly typed python scalar) and rounded back to q's
  dtype; scores and the softmax run in fp32, base 2; lse is returned in
  natural log, fp32 (B, Nq, Sq);
- p is rounded to v's dtype before P.V; dq and dk/dv recompute p from lse,
  with ``delta = sum(o * do)`` in fp32 (shifted by ``dlse`` when lse is a
  differentiable output), and ds is rounded to k's dtype before its
  products; dk and dv accumulate in fp32 over the GQA group and the query
  walk, and :func:`flash_dkv` returns them fp32, as ``flash_dkv`` in JAX.

Each of :func:`flash_fwd`, :func:`flash_dq` and :func:`flash_dkv` runs its
plain PyTorch version for CPU tensors and a hand-written CUDA kernel for
CUDA tensors, and raises on any other device: for bf16/fp16 the wgmma +
TMA kernels of ``csrc/flash_fwd_sm90.cu`` (forward) and
``csrc/flash_bwd_sm90.cu`` (dq, dk/dv), for fp32 the scalar kernels of
``csrc/flash_attention.cu``. The kernels replace the five Pallas kernels:
``_fwd_kernel`` and ``_fwd_kernel_kvgrid`` (flash_fwd), ``_dq_kernel`` and
``_dq_kernel_kvgrid`` (flash_dq), ``_dkv_kernel`` (flash_dkv). On the TPU
the resident/kvgrid split is a VMEM limit; the CUDA forward and dq kernels
always stream K/V, so one kernel fulfils both contracts. ``LAUNCHES``
counts each launch under the contract the call fulfils: ``*_kvgrid`` where
:func:`_use_kvgrid` holds for the call (the call's family from the tuning
table, then :func:`set_kernel_variant`'s pin, then ``seq_k >
MAX_KERNEL_SEQ``), as JAX dispatches.

The 16-bit forward and dq kernels take a key tile of 64 or 128
(``block_k``, a template parameter of each kernel); dk/dv and the fp32
kernels have one tile each. ``TILE_LAUNCHES`` counts the 16-bit forward
and dq launches by contract and key tile, ``MODE_LAUNCHES`` the launches
of the two modes ring attention (``ops/ring_attention.py``) adds to the
training path's: non-causal (every kernel) and dq stored fp32
(``flash_dq(out_dtype=torch.float32)``, JAX's ``out_dtype``).
``HEAD_LAUNCHES`` counts every launch by the query and KV head counts it
ran at ("32/8"; "16/4" for a tensor rank's heads at llama3_8b and tp 2).

:func:`flash_attention` is the differentiable entry: one
``torch.autograd.Function`` covers both of JAX's ``custom_vjp``s (o alone,
and (o, lse) with lse differentiable, the ring-attention building block).
Its tiles, family and quantized wire come from the tuning table
(``tune/lookup.py::resolve_flash``) unless the caller names them; the
plain versions ignore tiles, which change no arithmetic there.
"""

import ctypes
from typing import Optional

import torch
from torch.profiler import record_function

from fms_fsdp_tpu_torch.obs.scopes import scoped
from fms_fsdp_tpu_torch.ops.quant import activation_roundtrip
from fms_fsdp_tpu_torch.tune import candidates as _cand
from fms_fsdp_tpu_torch.tune.lookup import (
    note_block_degradation,
    once_per_build,
    record_final_flash_blocks,
    resolve_flash,
)

LOG2E = 1.4426950408889634  # log2(e)
LN2 = 0.6931471805599453

# The resident TPU kernels stage the whole per-head sequence in VMEM; past
# this cap JAX switches to the kv-streamed kernels. Here it only decides
# which contract a launch is counted under.
MAX_KERNEL_SEQ = _cand.MAX_KERNEL_SEQ
VARIANTS = (None, "auto", "resident", "kvgrid")
# the pinned contract family ("resident" | "kvgrid"), None for the
# sequence-length rule; TrainConfig.flash_kernel_variant, applied by
# make_train_step through set_kernel_variant, as JAX's _VARIANT
_VARIANT = None

# launches of the CUDA kernels, by the Pallas contract each call fulfils;
# counted where a kernel launches and nowhere else
LAUNCHES = {"fwd": 0, "fwd_kvgrid": 0, "dq": 0, "dq_kvgrid": 0, "dkv": 0}
# launches of the 16-bit forward and dq kernels (csrc/flash_*_sm90.cu) by
# contract and key tile; counted where they launch
TILE_LAUNCHES = {c: {64: 0, 128: 0} for c in ("fwd", "fwd_kvgrid", "dq", "dq_kvgrid")}
# launches with causal=False, and of dq stored fp32 from 16-bit inputs;
# counted where the kernels launch
MODE_LAUNCHES = {"fwd_noncausal": 0, "dq_noncausal": 0, "dkv_noncausal": 0, "dq_f32": 0}
# launches by kernel and the head counts they ran at ({"fwd": {"16/4": n}});
# counted where the kernels launch
HEAD_LAUNCHES = {"fwd": {}, "dq": {}, "dkv": {}}

# dtype codes of the csrc/flash_*.cu entry points
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIM = 128  # kHead in the kernels
_TILE = 64  # kBQ / kBK: Sq and Sk must be multiples of it
# scores of at most this many fp32 elements per chunk of the plain versions
_PLAIN_CHUNK_ELEMS = 1 << 27
# bf16: bound on each output's relative error ||kernel - plain|| / ||plain||
# against the plain bf16 version, which rounds at the same points. Set
# between two readings of chip_smoke.py's flash phase on an H100 (four
# shapes, S up to 16384): the kernel's error (o 1.4e-3 to 1.7e-3, lse
# 5e-8, dq 1.1e-3, dk 5.8e-4, dv 9.5e-5 at most) and that of a control,
# the plain version with its scores rounded to bf16 before exp2 (o 4.0e-3,
# lse 1.4e-5, dq 4.5e-3, dk 3.9e-3, dv 3.7e-3 at least), which must fail.
# o differs most: the kernel rounds p against the running row max, the
# plain version against the final one; dq and dk inherit o's error
# through delta = sum(o * do).
BF16_REL_TOL = {"o": 2.5e-3, "lse": 1e-6, "dq": 2e-3, "dk": 1.5e-3, "dv": 5e-4}
# bf16/fp16: bound on the relative error of each 128-row dq block and
# 128-key dk/dv block of the backward kernels against the plain backward on
# the same lse and delta. Set between readings of chip_smoke.py's flash
# phase on an H100 (four shapes, S up to 16384): the kernels' largest (dq
# 8.9e-4, dk 3.8e-4, dv 4.5e-4: small blocks of few terms, group 1) and
# the smallest of the control, the plain backward with one 64-row query
# tile left out of key block 0's walk (dq 6.3e-2, dk 1.58e-3, dv 1.39e-3
# at S=16384, where that tile is one step of 1024), which must fail.
BF16_BLOCK_REL_TOL = {"dq": 2e-3, "dk": 8e-4, "dv": 8e-4}
# rows of a dq block and keys of a dk/dv block of csrc/flash_bwd_sm90.cu,
# and the query rows of one step of a dk/dv block's walk: the units of the
# per-block checks and of the leave-one-tile-out control
BWD_BLOCK = 128
BWD_Q_TILE = 64


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    for tiles in TILE_LAUNCHES.values():
        for key in tiles:
            tiles[key] = 0
    for key in MODE_LAUNCHES:
        MODE_LAUNCHES[key] = 0
    for heads in HEAD_LAUNCHES.values():
        heads.clear()


def _count_heads(op, nq, nkv):
    key = f"{nq}/{nkv}"
    HEAD_LAUNCHES[op][key] = HEAD_LAUNCHES[op].get(key, 0) + 1


def set_kernel_variant(variant) -> None:
    """Pin the contract family every later launch is counted under:
    "resident" or "kvgrid", or "auto" / None for the sequence-length rule
    (JAX's ``set_kernel_variant``, ``flash_attention.py:848``). Each step
    build applies its own config's value, so no build inherits another's."""
    global _VARIANT
    if variant not in VARIANTS:
        raise ValueError(
            f"flash kernel variant {variant!r}: expected one of {VARIANTS}"
        )
    _VARIANT = None if variant == "auto" else variant


def _use_kvgrid(seq_k: int, variant=None) -> bool:
    """JAX's family rule (``flash_attention.py:863``): the call's own
    family (the tuning table's, threaded through the backward) first, then
    the pinned variant, then the sequence-length rule."""
    if variant in ("resident", "kvgrid"):
        return variant == "kvgrid"
    if _VARIANT is not None:
        return _VARIANT == "kvgrid"
    return seq_k > MAX_KERNEL_SEQ


def _kernel_block_k(dtype, block_k):
    """The key tile a CUDA launch runs: ``block_k`` (None: the default,
    128 for 16-bit inputs), one of the 16-bit kernels' tiles; the fp32
    kernels have their one 64-key tile. Anything else raises."""
    if dtype == torch.float32:
        if block_k not in (None, _cand.FLASH_FP32_BLOCK):
            raise ValueError(
                f"the fp32 flash kernels have one {_cand.FLASH_FP32_BLOCK}-key "
                f"tile; got block_k={block_k}"
            )
        return _cand.FLASH_FP32_BLOCK
    if block_k is None:
        return _cand.FLASH_DEFAULT_BLOCK_K
    if block_k not in _cand.FLASH_BLOCK_K_CHOICES:
        raise ValueError(
            f"the 16-bit flash kernels take a key tile of "
            f"{_cand.FLASH_BLOCK_K_CHOICES}; got block_k={block_k}"
        )
    return block_k


def _pick_block(seq: int, target: int, kind: str, dtype) -> int:
    """The tile that runs for a length ``seq``, JAX's ``_pick_block``
    (``flash_attention.py:809``) for the CUDA kernels: they take any
    length that is a multiple of 64 with any of their tiles (a block masks
    the rows or keys past the end), so ``target`` runs as it is, except
    past the length itself, where the largest of the kernel's tiles that
    the length holds runs (the smallest if none does). A tile below half
    the request is counted and warned of, as in JAX."""
    if dtype == torch.float32:
        tiles = (_cand.FLASH_FP32_BLOCK,)
    elif kind == "q":
        tiles = (_cand.FLASH_BLOCK_Q,)
    else:
        tiles = _cand.FLASH_BLOCK_K_CHOICES
    b = target
    if b > seq:
        b = max([t for t in tiles if t <= seq], default=min(tiles))
    if 2 * b < min(seq, target):
        note_block_degradation(kind, seq, target, b)
    return b


def supports(q_shape, k_shape) -> bool:
    """Whether the CUDA kernels take these (B, S, N, H) shapes: what
    :func:`_check_cuda` accepts (head dim 128, both sequence lengths
    multiples of the 64-row tile, Nq a multiple of Nkv), and at most
    ``MAX_KERNEL_SEQ`` keys while the resident contract is pinned, the cap
    JAX keeps there. JAX's rule (``flash_attention.py:903``) follows its
    TPU blocks instead (a 128-multiple head, 256-multiple lengths), so the
    two differ on a head of 256 and on lengths such as 384."""
    _, sq, nq, h = q_shape
    _, sk, nkv, _ = k_shape
    max_seq = MAX_KERNEL_SEQ if _VARIANT == "resident" else float("inf")
    return (
        h == _HEAD_DIM
        and sq % _TILE == 0
        and sk % _TILE == 0
        and 0 < sq <= max_seq
        and 0 < sk <= max_seq
        and nkv > 0
        and nq % nkv == 0
    )


def q_scale_for(scale: float, dtype: torch.dtype) -> float:
    """``scale * log2(e)`` rounded to ``dtype``, as JAX multiplies a bf16
    array by a weakly typed python float."""
    return torch.tensor(scale * LOG2E, dtype=dtype).item()


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the yardstick of the kernels on the card)
# ---------------------------------------------------------------------------


def _plain_chunks(b, nq, sq, sk):
    """Query-row chunks of the plain versions, so (B, Nq, rows, Sk) fp32
    scores stay under ``_PLAIN_CHUNK_ELEMS`` at any sequence length."""
    rows = max(1, min(sq, _PLAIN_CHUNK_ELEMS // max(1, b * nq * sk)))
    return [(i, min(sq, i + rows)) for i in range(0, sq, rows)]


def _scores2(q2c, kf, i0, causal):
    """Base-2 scores of query rows i0.. (B, Nq, rows, Sk) fp32, masked
    above the top-left diagonal. q2c (B, rows, Nq, H) scaled q; kf
    (B, Sk, Nkv, H) fp32."""
    b, rows, nq, h = q2c.shape
    sk, nkv = kf.shape[1], kf.shape[2]
    g = nq // nkv
    s = torch.einsum(
        "bqkgh,bskh->bkgqs", q2c.float().reshape(b, rows, nkv, g, h), kf
    ).reshape(b, nq, rows, sk)
    if causal:
        qpos = torch.arange(i0, i0 + rows, device=q2c.device)[:, None]
        kpos = torch.arange(sk, device=q2c.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    return s


def _pv(p, vf):
    """(B, Nq, rows, Sk) @ v (B, Sk, Nkv, H) -> (B, rows, Nq, H) fp32."""
    b, nq, rows, sk = p.shape
    nkv, h = vf.shape[2], vf.shape[3]
    g = nq // nkv
    out = torch.einsum("bkgqs,bskh->bqkgh", p.reshape(b, nkv, g, rows, sk), vf)
    return out.reshape(b, rows, nq, h)


def flash_fwd_plain(q, k, v, *, causal=True, scale=None):
    """(o (B, Sq, Nq, H) in q's dtype, lse (B, Nq, Sq) fp32)."""
    b, sq, nq, h = q.shape
    sk = k.shape[1]
    scale = float(scale if scale is not None else h**-0.5)
    c = q_scale_for(scale, q.dtype)
    kf, vf = k.float(), v.float()
    o = torch.empty_like(q)
    lse = torch.empty((b, nq, sq), dtype=torch.float32, device=q.device)
    for i0, i1 in _plain_chunks(b, nq, sq, sk):
        q2 = (q[:, i0:i1] * c).to(q.dtype)
        s = _scores2(q2, kf, i0, causal)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = _pv(p.to(v.dtype).float(), vf)
        o[:, i0:i1] = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
        lse[:, :, i0:i1] = (m * LN2 + torch.log(l))[..., 0]
    return o, lse


def _ds(q, k, v, dout, lse, delta, i0, i1, causal, scale, c, kf, vf):
    """Probabilities and ds of query rows i0:i1, both (B, Nq, rows, Sk)
    fp32; ds already rounded to k's dtype."""
    q2 = (q[:, i0:i1] * c).to(q.dtype)
    s = _scores2(q2, kf, i0, causal)
    p = torch.exp2(s - lse[:, :, i0:i1, None] * LOG2E)
    b, rows, nq, h = q2.shape
    nkv = k.shape[2]
    g = nq // nkv
    dp = torch.einsum(
        "bqkgh,bskh->bkgqs",
        dout[:, i0:i1].float().reshape(b, rows, nkv, g, h), vf,
    ).reshape(p.shape)
    ds = (p * (dp - delta[:, :, i0:i1, None]) * scale).to(k.dtype).float()
    return p, ds


def flash_dq_plain(q, k, v, dout, lse, delta, *, causal=True, scale=None,
                   out_dtype=None):
    """dq (B, Sq, Nq, H) in ``out_dtype`` (default q's dtype) from the
    saved lse and delta (B, Nq, Sq) fp32."""
    b, sq, nq, h = q.shape
    sk = k.shape[1]
    scale = float(scale if scale is not None else h**-0.5)
    c = q_scale_for(scale, q.dtype)
    kf, vf = k.float(), v.float()
    out_dtype = _dq_dtype(q.dtype, out_dtype)
    dq = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    for i0, i1 in _plain_chunks(b, nq, sq, sk):
        _, ds = _ds(q, k, v, dout, lse, delta, i0, i1, causal, scale, c, kf, vf)
        dq[:, i0:i1] = _pv(ds, kf).to(out_dtype)
    return dq


def _dq_dtype(q_dtype, out_dtype):
    """The dtype dq is stored in: q's, or fp32 (``out_dtype``)."""
    if out_dtype is None or out_dtype == q_dtype:
        return q_dtype
    if out_dtype != torch.float32:
        raise ValueError(f"dq is stored in q's dtype or fp32; got out_dtype={out_dtype}")
    return out_dtype


def flash_dkv_plain(q, k, v, dout, lse, delta, *, causal=True, scale=None):
    """(dk, dv), each (B, Sk, Nkv, H) fp32, summed over the GQA group."""
    b, sq, nq, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = float(scale if scale is not None else h**-0.5)
    c = q_scale_for(scale, q.dtype)
    kf, vf = k.float(), v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i0, i1 in _plain_chunks(b, nq, sq, sk):
        rows = i1 - i0
        p, ds = _ds(q, k, v, dout, lse, delta, i0, i1, causal, scale, c, kf, vf)
        pt = p.to(dout.dtype).float().reshape(b, nkv, g, rows, sk)
        dof = dout[:, i0:i1].float().reshape(b, rows, nkv, g, h)
        dv += torch.einsum("bkgqs,bqkgh->bskh", pt, dof)
        qf = q[:, i0:i1].float().reshape(b, rows, nkv, g, h)
        dk += torch.einsum("bkgqs,bqkgh->bskh", ds.reshape(pt.shape), qf)
    return dk, dv


def block_rel_err(a, r, block=BWD_BLOCK):
    """Relative error ``||a - r|| / ||r||`` of every block of ``block`` rows
    of one head: a, r (B, S, N, H) -> (B, ceil(S / block), N) fp32. A block
    whose reference is zero reads 0 if ``a`` is zero there too, else inf."""
    b, s, n, h = r.shape
    nb = -(-s // block)
    diff = torch.zeros((b, nb * block, n, h), dtype=torch.float32, device=r.device)
    ref = torch.zeros_like(diff)
    diff[:, :s] = a.float() - r.float()
    ref[:, :s] = r.float()
    d = diff.reshape(b, nb, block, n, h).square().sum((2, 4)).sqrt()
    rn = ref.reshape(b, nb, block, n, h).square().sum((2, 4)).sqrt()
    zero = torch.where(d > 0, float("inf"), 0.0)
    return torch.where(rn > 0, d / rn.clamp_min(torch.finfo(torch.float32).tiny), zero)


def flash_bwd_drop_tile_plain(q, k, v, dout, lse, delta, dq, dk, dv, *, batch, head,
                              q_tile, k_block, causal=True, scale=None):
    """The plain backward with one step of a dk/dv block's walk left out: the
    ``BWD_Q_TILE`` query rows ``q_tile`` of query head ``head`` (batch
    ``batch``) no longer reach the ``BWD_BLOCK`` keys ``k_block`` of its kv
    head. ``dq, dk, dv`` are the plain versions' results on these inputs
    and their ``lse``, ``delta``; returns new (dq, dk, dv) that differ from
    them only in that dq tile and that dk/dv block. A kernel that skipped
    or misread one step of its walk would land about here: the control of
    the per-block checks, which it must fail."""
    nq, hd = q.shape[2], q.shape[3]
    sk, nkv = k.shape[1], k.shape[2]
    kvh = head // (nq // nkv)
    scale = float(scale if scale is not None else hd**-0.5)
    q0, q1 = q_tile * BWD_Q_TILE, (q_tile + 1) * BWD_Q_TILE
    k0, k1 = k_block * BWD_BLOCK, min(sk, (k_block + 1) * BWD_BLOCK)
    qr = q[batch, q0:q1, head]
    dor = dout[batch, q0:q1, head].float()
    kf, vf = k[batch, k0:k1, kvh].float(), v[batch, k0:k1, kvh].float()
    s = (qr * q_scale_for(scale, q.dtype)).to(q.dtype).float() @ kf.T
    if causal:
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.exp2(s - lse[batch, head, q0:q1, None] * LOG2E)
    dp = dor @ vf.T
    ds = (p * (dp - delta[batch, head, q0:q1, None]) * scale).to(k.dtype).float()
    dq, dk, dv = dq.clone(), dk.clone(), dv.clone()
    dq[batch, q0:q1, head] = (dq[batch, q0:q1, head].float() - ds @ kf).to(dq.dtype)
    dk[batch, k0:k1, kvh] -= ds.T @ qr.float()
    dv[batch, k0:k1, kvh] -= p.to(dout.dtype).float().T @ dor
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each kernel's C entry point; pointers and the stream as
# c_void_p: a default int would cut them to 32 bits
_ARGTYPES = {
    "fwd": [_P] * 5 + [_I] * 8 + [_F, _P],
    "dq": [_P] * 7 + [_I] * 8 + [_F, _F, _P],
    "dkv": [_P] * 9 + [_I] * 8 + [_F, _P],
}
# the 16-bit entry points take the key tile before the stream
_ARGTYPES_SM90 = {
    "fwd": [_P] * 5 + [_I] * 8 + [_F, _I, _P],
    "dq": [_P] * 7 + [_I] * 8 + [_F, _F, _I, _I, _P],
    "dkv": _ARGTYPES["dkv"],
}


def _entry(op: str, dtype: torch.dtype):
    """(C entry point, its name) of ``op`` ("fwd", "dq", "dkv") for
    ``dtype``: ``flash_<op>_sm90`` of ``csrc/flash_fwd_sm90.cu`` (fwd) or
    ``csrc/flash_bwd_sm90.cu`` (dq, dkv) for bf16/fp16, ``flash_<op>`` of
    ``csrc/flash_attention.cu`` for fp32."""
    from fms_fsdp_tpu_torch.ops import cuda_build

    if dtype == torch.float32:
        source, name = "flash_attention", f"flash_{op}"
    else:
        source = "flash_fwd_sm90" if op == "fwd" else "flash_bwd_sm90"
        name = f"flash_{op}_sm90"
    fn = getattr(cuda_build.load(source).lib, name)
    if fn.argtypes is None:
        fn.argtypes = (_ARGTYPES if dtype == torch.float32 else _ARGTYPES_SM90)[op]
        fn.restype = ctypes.c_int
    return fn, name


def _check_cuda(q, k, v, **extra):
    tensors = {"q": q, "k": k, "v": v, **extra}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B, Sq, Nq, H) and k/v (B, Sk, Nkv, H); got "
            f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
        )
    b, sq, nq, h = q.shape
    _, sk, nkv, hk = k.shape
    if k.shape[0] != b or hk != h or nq % nkv:
        raise ValueError(
            f"q{tuple(q.shape)} and k{tuple(k.shape)} do not pair (batch, "
            f"head dim, Nq a multiple of Nkv)"
        )
    if h != _HEAD_DIM:
        raise ValueError(f"the kernels take head_dim {_HEAD_DIM}; got {h}")
    if sq % _TILE or sk % _TILE:
        raise ValueError(
            f"the kernels take sequence lengths that are multiples of "
            f"{_TILE}; got Sq={sq}, Sk={sk}"
        )
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q/k/v must share one of bf16, fp16, fp32; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if "dout" in extra and (extra["dout"].shape != q.shape
                            or extra["dout"].dtype != q.dtype):
        raise ValueError("dout must match q's shape and dtype")
    for name in ("lse", "delta"):
        if name in extra and (extra[name].shape != (b, nq, sq)
                              or extra[name].dtype != torch.float32):
            raise ValueError(f"{name} must be fp32 {(b, nq, sq)}")


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return q.device.type


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _tile_args(dtype, block_k):
    """The key-tile argument of a 16-bit entry point (none for fp32)."""
    return () if dtype == torch.float32 else (block_k,)


def _count(op, sk, dtype, block_k, variant, causal, nq, nkv):
    _count_heads(op, nq, nkv)
    contract = op + ("_kvgrid" if _use_kvgrid(sk, variant) else "")
    LAUNCHES[contract] += 1
    if dtype != torch.float32:
        TILE_LAUNCHES[contract][block_k] += 1
    if not causal:
        MODE_LAUNCHES[op + "_noncausal"] += 1


def flash_fwd(q, k, v, *, causal=True, scale=None, block_k=None, variant=None):
    """Forward: (o (B, Sq, Nq, H), lse (B, Nq, Sq) fp32). CPU tensors run
    :func:`flash_fwd_plain`; CUDA tensors launch ``flash_fwd_sm90``
    (``csrc/flash_fwd_sm90.cu``) with the key tile ``block_k`` (64 or 128,
    default 128) for bf16/fp16 and ``flash_fwd`` (``csrc/flash_attention.cu``)
    for fp32. ``variant`` names the contract the launch is counted under
    (:func:`_use_kvgrid`)."""
    if _device_of(q) == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    _check_cuda(q, k, v)
    block_k = _kernel_block_k(q.dtype, block_k)
    b, sq, nq, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else h**-0.5)
    o = torch.empty_like(q)
    lse = torch.empty((b, nq, sq), dtype=torch.float32, device=q.device)
    fn, name = _entry("fwd", q.dtype)
    # the runtime launches on the thread's current device: make it q's
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, sq, sk, nq, nkv, h, int(causal), _CODES[q.dtype],
            q_scale_for(scale, q.dtype), *_tile_args(q.dtype, block_k), stream,
        )
    _raise_on(err, name)
    _count("fwd", sk, q.dtype, block_k, variant, causal, nq, nkv)
    return o, lse


def flash_dq(q, k, v, dout, lse, delta, *, causal=True, scale=None, block_k=None,
             variant=None, out_dtype=None):
    """dq (B, Sq, Nq, H) from the softmax stats lse and delta (B, Nq, Sq)
    fp32, in ``out_dtype``: q's dtype (None) or ``torch.float32``, the
    kernel's fp32 accumulators stored as they are (JAX's ``out_dtype``, for
    partials summed over ring steps). CPU: :func:`flash_dq_plain`; CUDA:
    ``flash_dq_sm90`` (``csrc/flash_bwd_sm90.cu``) with the key tile
    ``block_k`` (64 or 128, default 128) for bf16/fp16, ``flash_dq``
    (``csrc/flash_attention.cu``) for fp32."""
    if _device_of(q) == "cpu":
        return flash_dq_plain(q, k, v, dout, lse, delta, causal=causal, scale=scale,
                              out_dtype=out_dtype)
    _check_cuda(q, k, v, dout=dout, lse=lse, delta=delta)
    block_k = _kernel_block_k(q.dtype, block_k)
    out_dtype = _dq_dtype(q.dtype, out_dtype)
    out_f32 = q.dtype != torch.float32 and out_dtype == torch.float32
    b, sq, nq, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else h**-0.5)
    dq = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    fn, name = _entry("dq", q.dtype)
    mode = () if q.dtype == torch.float32 else (block_k, int(out_f32))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, sq, sk, nq, nkv, h, int(causal), _CODES[q.dtype],
            q_scale_for(scale, q.dtype), scale, *mode, stream,
        )
    _raise_on(err, name)
    _count("dq", sk, q.dtype, block_k, variant, causal, nq, nkv)
    if out_f32:
        MODE_LAUNCHES["dq_f32"] += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, *, causal=True, scale=None, q2=None):
    """(dk, dv), each (B, Sk, Nkv, H) fp32. CPU: :func:`flash_dkv_plain`;
    CUDA: ``flash_dkv_sm90`` for bf16/fp16, ``flash_dkv`` for fp32 (one
    contract: JAX has no kv-streamed dk/dv). ``q2`` is q scaled as
    :func:`scaled_q` makes it, for a caller that runs many calls on one q
    (the ring's steps); None scales it here."""
    if _device_of(q) == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, causal=causal, scale=scale)
    _check_cuda(q, k, v, dout=dout, lse=lse, delta=delta)
    b, sq, nq, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else h**-0.5)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    if q2 is None:
        q2 = scaled_q(q, scale)
    elif q2.shape != q.shape or q2.dtype != q.dtype or not q2.is_contiguous():
        raise ValueError("q2 must be contiguous and match q's shape and dtype")
    fn, name = _entry("dkv", q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), q2.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, sk, nq, nkv, h, int(causal), _CODES[q.dtype], scale, stream,
        )
    _raise_on(err, name)
    LAUNCHES["dkv"] += 1
    _count_heads("dkv", nq, nkv)
    if not causal:
        MODE_LAUNCHES["dkv_noncausal"] += 1
    return dk, dv


def scaled_q(q, scale):
    """q scaled by ``scale * log2(e)`` with the kernels' rounding (the
    fp32 product rounded to q's dtype): the dk/dv kernel's q2, made once
    (every key tile of a head reads each query tile)."""
    return (q * q_scale_for(scale, q.dtype)).to(q.dtype)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Both of JAX's ``custom_vjp``s (``flash_attention.py:754`` and
    ``:781``): outputs (o, lse); a cotangent of lse enters the backward as
    ``delta - dlse`` (``:737``), so ring attention can merge partials."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_k, variant):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale, block_k=block_k,
                           variant=variant)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.block_k, ctx.variant = causal, scale, block_k, variant
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        with record_function("flash_attention_bwd"):
            q, k, v, o, lse = ctx.saved_tensors
            if dout is None:
                dout = torch.zeros_like(o)
            dout = dout.contiguous()
            # delta = sum(o * do) over the head dim, fp32, (B, Nq, Sq)
            delta = torch.einsum("bsnh,bsnh->bns", o.float(), dout.float()).contiguous()
            if dlse is not None:
                delta = delta - dlse.float()
            kw = dict(causal=ctx.causal, scale=ctx.scale)
            dq = flash_dq(q, k, v, dout, lse, delta, block_k=ctx.block_k,
                          variant=ctx.variant, **kw)
            dk, dv = flash_dkv(q, k, v, dout, lse, delta, **kw)
            return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


class _WireSTE(torch.autograd.Function):
    """One attention operand through the quantized family's wire
    (``ops/quant.py::activation_roundtrip``) with a straight-through
    gradient: the round trip is piecewise constant, so the identity
    cotangent keeps the backward exactly the unquantized kernels'."""

    @staticmethod
    def forward(ctx, x, wire):
        return activation_roundtrip(x, wire)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _resolve_tiles(q_shape, k_shape, dtype, block_q, block_k, variant, quant):
    """(block_q, block_k, family, quant) that run for one call's shapes:
    the tuning table's resolution, then ``_pick_block``; recorded as what
    runs (the tiles and the family after dispatch)."""
    bq, bk, fam, qnt, _ = resolve_flash(
        q_shape, k_shape, str(dtype).replace("torch.", ""),
        requested_q=block_q, requested_k=block_k,
        requested_variant=variant, requested_quant=quant,
    )
    block_q = _pick_block(q_shape[1], bq, "q", dtype)
    block_k = _pick_block(k_shape[1], bk, "k", dtype)
    record_final_flash_blocks(block_q, block_k, kvgrid=_use_kvgrid(k_shape[1], fam))
    return block_q, block_k, fam, qnt


@scoped("flash_attention_fwd")
def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                    block_q: Optional[int] = None, block_k: Optional[int] = None,
                    return_lse: bool = False, variant: Optional[str] = None,
                    quant: Optional[str] = None):
    """q (B, Sq, Nq, H); k/v (B, Sk, Nkv, H) -> o (B, Sq, Nq, H).

    ``block_q`` / ``block_k`` / ``variant`` / ``quant`` default to the
    tuning table's resolution (``tune/lookup.py::resolve_flash``: exact
    signature, nearest signature, then the static 128 x 128 tiles; the
    fp32 kernels' one 64 x 64 tile); passing them pins them. ``block_k``
    is the key tile of the 16-bit forward and dq kernels (64 or 128);
    ``block_q`` is recorded (the 16-bit kernels have one 128-row query
    tile); ``variant`` ("resident" / "kvgrid") names the contract the
    launches are counted under. ``quant`` ("int8" / "fp8") selects the
    quantized family: q and k go through the operand wire (per-row absmax
    over the head dim, straight-through gradients) before the kernels, as
    JAX's simulated quantized kernels; None (or "none") leaves every call
    as it was.

    With ``return_lse`` also the per-query logsumexp (B, Sq, Nq, 1) fp32,
    a differentiable output as in JAX.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # a per-call variant pins the family; else set_kernel_variant's pin;
    # else the table may pick it
    requested = (block_q, block_k, variant if variant is not None else _VARIANT, quant)
    block_q, block_k, fam, qnt = once_per_build(
        ("flash", tuple(q.shape), tuple(k.shape), q.dtype, requested),
        lambda: _resolve_tiles(q.shape, k.shape, q.dtype, *requested))
    if qnt not in (None, "none"):
        q = _WireSTE.apply(q, qnt)
        k = _WireSTE.apply(k, qnt)
    o, lse = _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal, float(scale),
        block_k, fam,
    )
    if return_lse:
        return o, lse.transpose(1, 2).unsqueeze(-1)
    return o
