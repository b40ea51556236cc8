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
plain PyTorch version for CPU tensors and the hand-written CUDA kernel of
``csrc/flash_attention.cu`` for CUDA tensors, and raises on any other
device. The kernels replace the five Pallas kernels: ``_fwd_kernel`` and
``_fwd_kernel_kvgrid`` (flash_fwd: wgmma + TMA in ``csrc/flash_fwd_sm90.cu``
for 16-bit inputs, scalar FMA for fp32), ``_dq_kernel`` and
``_dq_kernel_kvgrid`` (flash_dq), ``_dkv_kernel`` (flash_dkv). On the TPU
the resident/kvgrid split is a VMEM limit; the CUDA forward and dq kernels
always stream K/V, so one kernel fulfils both contracts. ``LAUNCHES``
counts each launch under the contract the call fulfils: ``*_kvgrid`` where
:func:`_use_kvgrid` holds for the call (``seq_k > MAX_KERNEL_SEQ``, or
:func:`set_kernel_variant` pins it), as JAX dispatches.

:func:`flash_attention` is the differentiable entry: one
``torch.autograd.Function`` covers both of JAX's ``custom_vjp``s (o alone,
and (o, lse) with lse differentiable, the ring-attention building block).
"""

import ctypes
from typing import Optional

import torch

LOG2E = 1.4426950408889634  # log2(e)
LN2 = 0.6931471805599453

# The resident TPU kernels stage the whole per-head sequence in VMEM; past
# this cap JAX switches to the kv-streamed kernels. Here it only decides
# which contract a launch is counted under.
MAX_KERNEL_SEQ = 8192
VARIANTS = (None, "auto", "resident", "kvgrid")
# the pinned contract family ("resident" | "kvgrid"), None for the
# sequence-length rule; TrainConfig.flash_kernel_variant, applied by
# make_train_step through set_kernel_variant, as JAX's _VARIANT
_VARIANT = None

# launches of the CUDA kernels, by the Pallas contract each call fulfils;
# counted where a kernel launches and nowhere else
LAUNCHES = {"fwd": 0, "fwd_kvgrid": 0, "dq": 0, "dq_kvgrid": 0, "dkv": 0}

# dtype codes of csrc/flash_attention.cu
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


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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


def _use_kvgrid(seq_k: int) -> bool:
    """JAX's family rule (``flash_attention.py:863``): the pinned variant
    first, then the sequence-length rule."""
    if _VARIANT is not None:
        return _VARIANT == "kvgrid"
    return seq_k > MAX_KERNEL_SEQ


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


def flash_dq_plain(q, k, v, dout, lse, delta, *, causal=True, scale=None):
    """dq (B, Sq, Nq, H) in q's dtype from the saved lse and delta
    (B, Nq, Sq) fp32."""
    b, sq, nq, h = q.shape
    sk = k.shape[1]
    scale = float(scale if scale is not None else h**-0.5)
    c = q_scale_for(scale, q.dtype)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(q)
    for i0, i1 in _plain_chunks(b, nq, sq, sk):
        _, ds = _ds(q, k, v, dout, lse, delta, i0, i1, causal, scale, c, kf, vf)
        dq[:, i0:i1] = _pv(ds, kf).to(q.dtype)
    return dq


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


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _library():
    from fms_fsdp_tpu_torch.ops import cuda_build

    lib = cuda_build.load("flash_attention").lib
    if lib.flash_fwd.argtypes is None:
        # pointers and the stream as c_void_p: a default int would cut
        # them to 32 bits
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [p] * 5 + [i] * 8 + [f, p]
        lib.flash_dq.argtypes = [p] * 7 + [i] * 8 + [f, f, p]
        lib.flash_dkv.argtypes = [p] * 9 + [i] * 8 + [f, p]
        for fn in (lib.flash_fwd, lib.flash_dq, lib.flash_dkv):
            fn.restype = ctypes.c_int
    return lib


def _library_sm90():
    """``csrc/flash_fwd_sm90.cu``: the 16-bit forward (wgmma + TMA)."""
    from fms_fsdp_tpu_torch.ops import cuda_build

    lib = cuda_build.load("flash_fwd_sm90").lib
    if lib.flash_fwd_sm90.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd_sm90.argtypes = [p] * 5 + [i] * 8 + [f, p]
        lib.flash_fwd_sm90.restype = ctypes.c_int
    return lib


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


def flash_fwd(q, k, v, *, causal=True, scale=None):
    """Forward: (o (B, Sq, Nq, H), lse (B, Nq, Sq) fp32). CPU tensors run
    :func:`flash_fwd_plain`; CUDA tensors launch ``flash_fwd_sm90``
    (``csrc/flash_fwd_sm90.cu``) for bf16/fp16 and ``flash_fwd``
    (``csrc/flash_attention.cu``) for fp32."""
    if _device_of(q) == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    _check_cuda(q, k, v)
    b, sq, nq, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else h**-0.5)
    o = torch.empty_like(q)
    lse = torch.empty((b, nq, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.float32:
        fn, name = _library().flash_fwd, "flash_fwd"
    else:
        fn, name = _library_sm90().flash_fwd_sm90, "flash_fwd_sm90"
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, sq, sk, nq, nkv, h, int(causal), _CODES[q.dtype],
        q_scale_for(scale, q.dtype), stream,
    )
    _raise_on(err, name)
    LAUNCHES["fwd_kvgrid" if _use_kvgrid(sk) else "fwd"] += 1
    return o, lse


def flash_dq(q, k, v, dout, lse, delta, *, causal=True, scale=None):
    """dq (B, Sq, Nq, H) in q's dtype from the softmax stats lse and delta
    (B, Nq, Sq) fp32. CPU: :func:`flash_dq_plain`; CUDA: ``flash_dq``."""
    if _device_of(q) == "cpu":
        return flash_dq_plain(q, k, v, dout, lse, delta, causal=causal, scale=scale)
    _check_cuda(q, k, v, dout=dout, lse=lse, delta=delta)
    b, sq, nq, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else h**-0.5)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, sq, sk, nq, nkv, h, int(causal), _CODES[q.dtype],
        q_scale_for(scale, q.dtype), scale, stream,
    )
    _raise_on(err, "flash_dq")
    LAUNCHES["dq_kvgrid" if _use_kvgrid(sk) else "dq"] += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, *, causal=True, scale=None):
    """(dk, dv), each (B, Sk, Nkv, H) fp32. CPU: :func:`flash_dkv_plain`;
    CUDA: ``flash_dkv`` (one contract: JAX has no kv-streamed dk/dv)."""
    if _device_of(q) == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, causal=causal, scale=scale)
    _check_cuda(q, k, v, dout=dout, lse=lse, delta=delta)
    b, sq, nq, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else h**-0.5)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    # q scaled once here (every k tile of a head reads each q tile), with
    # the kernels' rounding: the fp32 product rounded to q's dtype
    q2 = (q * q_scale_for(scale, q.dtype)).to(q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_dkv(
        q.data_ptr(), q2.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, nq, nkv, h, int(causal), _CODES[q.dtype], scale, stream,
    )
    _raise_on(err, "flash_dkv")
    LAUNCHES["dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Both of JAX's ``custom_vjp``s (``flash_attention.py:754`` and
    ``:781``): outputs (o, lse); a cotangent of lse enters the backward as
    ``delta - dlse`` (``:737``), so ring attention can merge partials."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(o)
        dout = dout.contiguous()
        # delta = sum(o * do) over the head dim, fp32, (B, Nq, Sq)
        delta = torch.einsum("bsnh,bsnh->bns", o.float(), dout.float()).contiguous()
        if dlse is not None:
            delta = delta - dlse.float()
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_dq(q, k, v, dout, lse, delta, **kw)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, **kw)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False):
    """q (B, Sq, Nq, H); k/v (B, Sk, Nkv, H) -> o (B, Sq, Nq, H).

    With ``return_lse`` also the per-query logsumexp (B, Sq, Nq, 1) fp32,
    a differentiable output as in JAX.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    o, lse = _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal, float(scale),
    )
    if return_lse:
        return o, lse.transpose(1, 2).unsqueeze(-1)
    return o
