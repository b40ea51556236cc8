"""Mamba2 selective scan: chunked SSD (state-space dual) formulation.

Counterpart of ``fms_fsdp_tpu/ops/ssd.py``. The SSD algorithm re-expresses
the per-token recurrence

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T        (state (H, P, N))
    y_t = C_t . h_t + D * x_t

as chunked matrix products: inside a chunk the output is a masked (L, L)
attention-like product, and one (P, N) fp32 state per head crosses chunk
boundaries.

Shapes: x (B, S, H, P), dt (B, S, H) (post-softplus), A (H,) negative,
Bm/Cm (B, S, G, N) with H % G == 0.

:func:`ssd_scan` dispatches on ``kernel``, with the strings of the JAX
package so that one command line drives both:

- ``"reference"``: the per-token recurrence (:func:`ssd_scan_reference`),
  the math the serving decode step replays one token at a time;
- ``"xla"``: the chunked einsums (:func:`_ssd_core_xla`); the backward
  recomputes each chunk body, as JAX's checkpointed scan does, so that it
  holds one chunk's (L, L)-per-head intermediates at a time;
- ``"pallas"``: the fused whole-sequence kernel. For CUDA tensors that is
  a hand-written CUDA kernel (:func:`ssd_fused`): ``csrc/ssd_sm90.cu`` for
  bf16 and fp16, ``csrc/ssd.cu`` for fp32. It replaces the Pallas kernel
  ``fms_fsdp_tpu/ops/ssd.py:51``; for CPU tensors its plain version
  :func:`ssd_core_plain`. Like the Pallas kernel it has no backward
  kernel: the backward differentiates the chunked einsums on the saved
  inputs, as JAX's ``custom_vjp`` does (``ssd.py:224``);
- ``"auto"``: as ``"pallas"``. JAX's "auto" is the einsums; here a CUDA
  tensor launches the kernel or raises, and there is no fallback.

:func:`ssd_scan_cp` is the scan with the sequence split over the context
axis (``ops/ring_attention.py``'s exchange): its local core is the
chunked einsums on every device, as JAX's is XLA.

The mixed precision is JAX's: matmul operands stay in the input dtype and
accumulate in fp32 (the einsums below widen the operands to fp32, which
gives the exact products of the input-dtype values with an fp32 sum); the
decay statistics, the dt scaling and the carried state are fp32; the
weights ``cb * decay * dt``, the carried state and ``exp(total - cum) * dt``
are rounded to the input dtype before their products.
"""

import ctypes

import torch
import torch.nn.functional as F

from fms_fsdp_tpu_torch.obs.scopes import scoped
from fms_fsdp_tpu_torch.tune.lookup import resolve_ssd_chunk

KERNELS = ("auto", "reference", "xla", "pallas")

# launches of the CUDA kernel; counted where it launches and nowhere else
LAUNCHES = {"fused": 0}

# dtype codes of csrc/ssd.cu and csrc/ssd_sm90.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# (source, C entry point) of the kernel for each input dtype
_SOURCES = {
    torch.float32: ("ssd", "ssd_fused"),
    torch.bfloat16: ("ssd_sm90", "ssd_fused_sm90"),
    torch.float16: ("ssd_sm90", "ssd_fused_sm90"),
}
# what the kernels take (kP, kN, kT, kMaxL in both sources)
_HEADDIM = 64
_DSTATE = 128
_TILE = 64
_MAX_CHUNK = 256
# bf16: bound on the relative error ||kernel - plain|| / ||plain|| against
# the plain bf16 version, which rounds at the same points. Set between two
# readings of chip_smoke.py's ssd phase on an H100 (three shapes): the
# kernel's error (5.2e-5 to 6.0e-5: products summed in another order, and
# a weight that falls on the other side of a bf16 rounding step now and
# then) and that of a control, the plain version with dt rounded to bf16
# before the weights (2.8e-3 to 2.9e-3), which must fail.
BF16_REL_TOL = 5e-4
# bf16 and fp16: bound on the relative error of each (batch, chunk, head)
# of y against the plain version on the same inputs (chunk_rel_err). A
# whole-tensor error over thousands of chunks cannot see one tile dropped
# from one chunk; this bound can: the control (ssd_drop_tile_plain, one
# 64-token tile left out of the state one chunk hands on) must exceed it
# on every chunk it changes. Set between the kernel's largest reading and
# the control's smallest in chip_smoke.py's ssd phase on an H100.
BF16_CHUNK_REL_TOL = 2e-3


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _segsum(a):
    """a: (..., L) -> (..., L, L) with out[i, j] = sum(a[j+1 .. i]),
    -inf above the diagonal (i < j)."""
    L = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]  # sum(a[j+1..i]) for i>=j
    mask = torch.ones(L, L, dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _intra_and_states_xla(xc, dtc, ac, Bc, Cc, G):
    """Intra-chunk output and the chunk's state contribution as
    group-factored einsums (heads carried as (G, R): no head-repeated
    (L, H, N) tensor). Returns (y (B, L, H, P) fp32, states (B, H, P, N)
    fp32). The (L, L)-per-head weights are kept head-major, (B, G, R, L,
    L), from the segment sums to the product with x, so that no pass over
    them is a transpose; JAX writes them (B, L, L, G, R) and leaves the
    layout to XLA. The numbers are the same."""
    Bsz, L, H, P = xc.shape
    R = H // G
    od = xc.dtype

    cum = torch.cumsum(ac, dim=1)  # (B, L, H)

    def heads_first(t):  # (B, L, H, ...) -> (B, G, R, L, ...)
        t = t.reshape(Bsz, L, G, R, *t.shape[3:])
        return t.permute(0, 2, 3, 1, *range(4, t.dim()))

    CB = torch.einsum("blgn,bmgn->bglm", Cc.float(), Bc.float())  # (B, G, L, L)
    seg = _segsum(heads_first(ac))  # (B, G, R, L, L)
    w = CB[:, :, None] * torch.exp(seg)
    w = w * heads_first(dtc)[:, :, :, None, :]  # dt of the column's token
    y = torch.einsum("bgrlm,bgrmp->bgrlp", w.to(od).float(), heads_first(xc).float())
    y = y.permute(0, 3, 1, 2, 4).reshape(Bsz, L, H, P)

    return y, _chunk_states(xc, dtc, cum, Bc, G)


def _chunk_states(xc, dtc, cum, Bc, G):
    """What one chunk adds to the carried state: B^T (x * exp(total - cum)
    * dt), (B, H, P, N) fp32; cum (B, L, H) is the chunk's inclusive
    cumsum of a."""
    Bsz, L, H, P = xc.shape
    R = H // G
    N = Bc.shape[-1]
    r = torch.exp(cum[:, -1:, :] - cum) * dtc  # (B, L, H) fp32
    xs = r.reshape(Bsz, L, G, R, 1).to(xc.dtype) * xc.reshape(Bsz, L, G, R, P)
    states = torch.einsum("blgn,blgrp->bgrpn", Bc.float(), xs.float())
    return states.reshape(Bsz, H, P, N)


def _state_contribution(Cc, state, cum, G):
    """exp(cum)-decayed contribution of a carried state to the outputs:
    Cc (B, T, G, N) operand dtype, state (B, H, P, N) fp32, cum (B, T, H)
    fp32 (inclusive cumsum of a) -> (B, T, H, P) fp32."""
    Bsz, T, _, N = Cc.shape
    H = cum.shape[-1]
    R = H // G
    P = state.shape[-2]
    inter = torch.einsum(
        "btgn,bgrpn->btgrp",
        Cc.float(),
        state.reshape(Bsz, G, R, P, N).to(Cc.dtype).float(),
    )
    return (torch.exp(cum).reshape(Bsz, T, G, R, 1) * inter).reshape(Bsz, T, H, P)


def _ssd_chunk(s_prev, xc, dtc, ac, Bc, Cc, G):
    """One chunk of the scan. s_prev (B, H, P, N) fp32; xc (B, L, H, P)
    input dtype; dtc/ac (B, L, H) fp32; Bc/Cc (B, L, G, N) input dtype.
    Returns (y_c (B, L, H, P) fp32, s_new fp32)."""
    cum = torch.cumsum(ac, dim=1)  # (B, L, H)
    total = cum[:, -1, :]  # (B, H)
    y, states = _intra_and_states_xla(xc, dtc, ac, Bc, Cc, G)
    # inter-chunk output: exp(cum_i) * C_i . s_prev
    y = y + _state_contribution(Cc, s_prev, cum, G)
    # state update: s_new = exp(total) * s_prev + chunk state contribution
    s_new = torch.exp(total)[:, :, None, None] * s_prev + states
    return y, s_new


def _ssd_core_xla(x, dtf, a, Bm, Cm, L, return_state: bool = False):
    """Chunk scan over the einsum formulation. x (B, S, H, P) input dtype;
    dtf/a (B, S, H) fp32 (a = dt * A); Bm/Cm (B, S, G, N). Returns y
    (B, S, H, P) fp32 (no D term); with ``return_state`` also the final
    carried state (B, H, P, N) fp32. Differentiated as it stands it keeps
    every chunk's (L, L)-per-head intermediates; :func:`ssd_scan` goes
    through :class:`_SSDCore`, whose backward recomputes them a chunk at
    a time."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    s = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        y_c, s = _ssd_chunk(s, x[:, sl], dtf[:, sl], a[:, sl], Bm[:, sl], Cm[:, sl], G)
        ys.append(y_c)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    if return_state:
        return y, s
    return y


def _ssd_core_xla_backward(inputs, L, cot, needs, d_final=None):
    """Cotangents of :func:`_ssd_core_xla`'s inputs (x, dtf, a, Bm, Cm)
    for the cotangent ``cot`` of y (and ``d_final`` of the final carried
    state, when it is an output); ``needs`` says which are wanted. What
    JAX's checkpointed scan does (``ssd.py:418``): a first sweep keeps only
    the state carried into each chunk, then the chunks are taken last to
    first, each one's body recomputed and differentiated with the
    cotangent of its outgoing state, so one chunk's (L, L)-per-head
    intermediates (67 MB a tensor at the training shape) live at a time."""
    x, dtf, a, Bm, Cm = inputs
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    chunks = [slice(c0, c0 + L) for c0 in range(0, S, L)]
    carried = [torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)]
    with torch.no_grad():
        for sl in chunks[:-1]:
            cum = torch.cumsum(a[:, sl], dim=1)
            carried.append(torch.exp(cum[:, -1, :])[:, :, None, None] * carried[-1]
                           + _chunk_states(x[:, sl], dtf[:, sl], cum, Bm[:, sl], G))
    grads = [torch.empty_like(t) if need else None for t, need in zip(inputs, needs)]
    d_state = d_final  # cotangent of the state a chunk hands on
    for idx in reversed(range(len(chunks))):
        sl = chunks[idx]
        with torch.enable_grad():
            s_prev = carried.pop().requires_grad_(idx > 0)
            leaves = [t[:, sl].detach().requires_grad_(need)
                      for t, need in zip(inputs, needs)]
            y_c, s_new = _ssd_chunk(s_prev, *leaves, G)
            outs, cots = [y_c], [cot[:, sl]]
            if d_state is not None:
                outs.append(s_new)
                cots.append(d_state)
            wanted = [t for t in leaves if t.requires_grad] + ([s_prev] if idx > 0 else [])
            got = list(torch.autograd.grad(outs, wanted, cots))
        d_state = got.pop() if idx > 0 else None
        for g, leaf in zip(grads, leaves):
            if leaf.requires_grad:
                g[:, sl] = got.pop(0)
    return grads


def chunk_rel_err(out, ref, L):
    """||out - ref|| / ||ref|| per (batch, chunk, head) of y (B, S, H, P),
    in fp32: (B, S / L, H)."""
    Bsz, S, H, P = ref.shape
    r = ref.float().reshape(Bsz, S // L, L, H, P)
    d = out.float().reshape(r.shape) - r
    return d.norm(dim=(2, 4)) / r.norm(dim=(2, 4)).clamp_min(1e-30)


def ssd_drop_tile_plain(x, dtf, a, Bm, Cm, L, batch, head, chunk, tile):
    """:func:`ssd_core_plain` with the 64 tokens of tile ``tile`` of chunk
    ``chunk`` left out of the state that chunk hands on, for one (batch,
    head): a fault of the kind the per-chunk check must see. It changes y
    of that head in the chunks after ``chunk`` and nowhere else."""
    Bsz, S, H, P = x.shape
    G = Bm.shape[2]
    grp = head // (H // G)
    s = torch.zeros((Bsz, H, P, Bm.shape[3]), dtype=torch.float32, device=x.device)
    ys = []
    for idx, c0 in enumerate(range(0, S, L)):
        sl = slice(c0, c0 + L)
        y_c, s = _ssd_chunk(s, x[:, sl], dtf[:, sl], a[:, sl], Bm[:, sl], Cm[:, sl], G)
        ys.append(y_c)
        if idx == chunk:
            cum = torch.cumsum(a[batch, sl, head], dim=0)
            r = torch.exp(cum[-1] - cum) * dtf[batch, sl, head]  # (L,)
            tok = slice(tile * _TILE, (tile + 1) * _TILE)
            xs = r[tok, None].to(x.dtype) * x[batch, c0:c0 + L, head][tok]
            s[batch, head] -= torch.einsum(
                "ln,lp->pn", Bm[batch, c0:c0 + L, grp][tok].float(), xs.float())
    return torch.cat(ys, dim=1)


def chunk_check(got, ref, x, dtf, a, Bm, Cm, L, batch=0, head=0):
    """The per-chunk check of a kernel's y ``got`` against the plain
    version's ``ref`` on the same inputs: every (batch, chunk, head) within
    ``BF16_CHUNK_REL_TOL``, and the control (:func:`ssd_drop_tile_plain`,
    the last tile of the next-to-last chunk left out for ``batch``,
    ``head``) above it on every chunk it changes, which must be the last
    chunk of that head alone. With one chunk there is no carried state to
    fault and no control (``control_min`` None)."""
    rel = chunk_rel_err(got, ref, L)
    out = {"kernel_max": rel.max().item(), "chunks": rel.numel(),
           "tol": BF16_CHUNK_REL_TOL, "control_min": None, "control_chunks": 0}
    ok = out["kernel_max"] <= BF16_CHUNK_REL_TOL
    n_chunks = ref.shape[1] // L
    if n_chunks > 1:
        control = ssd_drop_tile_plain(x, dtf, a, Bm, Cm, L, batch, head,
                                      chunk=n_chunks - 2, tile=L // _TILE - 1)
        ctl = chunk_rel_err(control, ref, L)
        changed = ctl > 0
        out["control_chunks"] = int(changed.sum())
        out["control_min"] = ctl[changed].min().item() if changed.any() else None
        ok = (ok and out["control_chunks"] == 1 and bool(changed[batch, -1, head])
              and out["control_min"] > BF16_CHUNK_REL_TOL)
    out["ok"] = ok
    return out


def ssd_core_plain(x, dtf, a, Bm, Cm, L):
    """The plain version of the fused kernel: same signature as
    :func:`ssd_fused`, same rounding points (they are those of the chunked
    einsums, whose body it shares), y (B, S, H, P) fp32."""
    return _ssd_core_xla(x, dtf, a, Bm, Cm, L)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def supports(x_shape, b_shape, L: int) -> bool:
    """Whether the kernels take these shapes: head dim 64, state dim
    128, a chunk that is a multiple of 64 up to 256 and divides S, H a
    multiple of G. The Pallas kernel's own limits (whole or (8, 128)
    divisible trailing dims) are the TPU's and do not carry over."""
    _, S, H, P = x_shape
    G, N = b_shape[2], b_shape[3]
    return (
        P == _HEADDIM
        and N == _DSTATE
        and 0 < L <= _MAX_CHUNK
        and L % _TILE == 0
        and S % L == 0
        and G > 0
        and H % G == 0
    )


def kernel_source(dtype: torch.dtype):
    """(source under ``csrc/``, C entry point) that :func:`ssd_fused`
    launches for inputs of ``dtype``; loads nothing."""
    if dtype not in _SOURCES:
        raise ValueError(f"the SSD kernels take bf16, fp16 or fp32; got {dtype}")
    return _SOURCES[dtype]


def _entry(dtype: torch.dtype):
    from fms_fsdp_tpu_torch.ops import cuda_build

    source, name = kernel_source(dtype)
    fn = getattr(cuda_build.load(source).lib, name)
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: a default int would cut
        # them to 32 bits
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 6 + [i] * 8 + [ll] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn, name


def _strided(t, inner: int):
    """``t`` (B, S, heads, inner) as the kernel reads it: unit inner
    stride, heads ``inner`` apart, batch and token strides and the base
    address multiples of 16 bytes. The model's views into the convolution
    output fit and are read in place; a view that does not fit is copied."""
    unit = 16 // t.element_size()
    fits = (
        t.stride(3) == 1
        and t.stride(2) == inner
        and t.stride(0) % unit == 0
        and t.stride(1) % unit == 0
        and t.data_ptr() % 16 == 0
    )
    return t if fits else t.contiguous()


def ssd_fused(x, dtf, a, Bm, Cm, L: int):
    """The fused whole-sequence SSD forward: x (B, S, H, P) input dtype,
    dtf and a = dt * A (B, S, H) fp32, Bm/Cm (B, S, G, N) input dtype,
    chunk length L -> y (B, S, H, P) fp32, no D term. CPU tensors run
    :func:`ssd_core_plain`; CUDA tensors launch the kernel that
    :func:`kernel_source` names for their dtype or raise."""
    if x.device.type == "cpu":
        return ssd_core_plain(x, dtf, a, Bm, Cm, L)
    if x.device.type != "cuda":
        raise ValueError(f"the SSD scan runs on cuda or cpu, not {x.device}")
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(
            f"expected x (B, S, H, P) and Bm/Cm (B, S, G, N); got "
            f"x{tuple(x.shape)} Bm{tuple(Bm.shape)} Cm{tuple(Cm.shape)}"
        )
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if Bm.shape[:2] != (Bsz, S) or dtf.shape != (Bsz, S, H) or a.shape != dtf.shape:
        raise ValueError(
            f"x{tuple(x.shape)}, dt{tuple(dtf.shape)}, a{tuple(a.shape)} and "
            f"Bm{tuple(Bm.shape)} do not pair"
        )
    if not supports(x.shape, Bm.shape, L):
        raise NotImplementedError(
            f"the SSD kernel takes headdim {_HEADDIM}, d_state {_DSTATE}, a "
            f"chunk that is a multiple of {_TILE} up to {_MAX_CHUNK} and "
            f"divides the sequence, and heads a multiple of groups; got "
            f"x{tuple(x.shape)} Bm{tuple(Bm.shape)} chunk {L}. "
            f"mamba_kernel='xla' runs the chunked einsums"
        )
    if x.dtype not in _CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(
            f"x/Bm/Cm must share one of bf16, fp16, fp32; got {x.dtype}, "
            f"{Bm.dtype}, {Cm.dtype}"
        )
    if dtf.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"dt and a must be fp32; got {dtf.dtype}, {a.dtype}")
    for name, t in (("dt", dtf), ("a", a), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    x, Bm, Cm = _strided(x, P), _strided(Bm, N), _strided(Cm, N)
    dtf, a = dtf.contiguous(), a.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    fn, name = _entry(x.dtype)
    # the runtime launches on the thread's current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), dtf.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), Bsz, S, H, G, P, N, L, _CODES[x.dtype],
            x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES["fused"] += 1
    return y


class _SSDCore(torch.autograd.Function):
    """The scan's core with JAX's gradient rule for both routes: the
    forward is the fused kernel (``fused``; its plain version for CPU
    tensors) or the chunked einsums, and the backward differentiates the
    chunked einsums on the saved inputs a chunk at a time. For the kernel
    that is JAX's ``custom_vjp`` (``ssd.py:214-235``: it has no backward
    kernel), for the einsums its checkpointed scan body."""

    @staticmethod
    def forward(ctx, x, dtf, a, Bm, Cm, L, fused):
        ctx.save_for_backward(x, dtf, a, Bm, Cm)
        ctx.L = L
        core = ssd_fused if fused else _ssd_core_xla
        return core(x, dtf, a, Bm, Cm, L)

    @staticmethod
    def backward(ctx, cot):
        grads = _ssd_core_xla_backward(
            ctx.saved_tensors, ctx.L, cot, ctx.needs_input_grad[:5]
        )
        return (*grads, None, None)


class _SSDCoreState(torch.autograd.Function):
    """:func:`_ssd_core_xla` with ``return_state``: (y, the final carried
    state), both differentiable, the backward a chunk at a time as
    :class:`_SSDCore`'s."""

    @staticmethod
    def forward(ctx, x, dtf, a, Bm, Cm, L):
        ctx.save_for_backward(x, dtf, a, Bm, Cm)
        ctx.L = L
        return _ssd_core_xla(x, dtf, a, Bm, Cm, L, return_state=True)

    @staticmethod
    def backward(ctx, cot, d_final):
        grads = _ssd_core_xla_backward(
            ctx.saved_tensors, ctx.L, cot, ctx.needs_input_grad[:5], d_final=d_final
        )
        return (*grads, None)


@scoped("ssd_scan")
def ssd_scan(x, dt, A, Bm, Cm, D=None, chunk_size: int = 256, kernel: str = "auto"):
    """Chunked selective scan. Returns y with x's shape, computed in fp32,
    cast back to x.dtype. The chunk length is ``min(chunk_size, S)``
    unless the tuning table overrides the default chunk
    (``tune/lookup.py::resolve_ssd_chunk``, ``kernel_tuning="auto"``), and
    must divide S."""
    Bsz, S, H, P = x.shape
    if kernel not in KERNELS:
        raise ValueError(f"unknown ssd kernel {kernel!r}: expected one of {KERNELS}")
    if kernel == "reference":
        return ssd_scan_reference(x, dt, A, Bm, Cm, D)
    dtype = str(x.dtype).replace("torch.", "")
    L = resolve_ssd_chunk(x.shape, Bm.shape[2], Bm.shape[3], dtype, requested=min(chunk_size, S))
    if S % L != 0:
        raise ValueError(f"seq len {S} must be a multiple of chunk {L}")

    dtf = dt.float()
    a = dtf * A.float()[None, None, :]  # (B, S, H), <= 0

    y = _SSDCore.apply(x, dtf, a, Bm, Cm, L, kernel != "xla")

    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)


@scoped("ssd_scan_cp")
def ssd_scan_cp(x, dt, A, Bm, Cm, D=None, *, ring, chunk_size: int = 256,
                kernel: str = "auto"):
    """The scan with the sequence split over the context axis
    (``fms_fsdp_tpu/ops/ssd.py:432``): x, dt, Bm, Cm are this process's
    part of the sequence (all of it under a ``LocalRing``, S / cp under a
    ``GroupRing``, ``ops/ring_attention.py``).

    The recurrence is linear in the carried state: each context rank runs
    its local chunk scan from a zero state (y0 and its final state Z_d),
    the true initial state of rank d is the small recurrence

        IN_0 = 0;  IN_d = T_{d-1} * IN_{d-1} + Z_{d-1}

    over the local decays T_d = exp(sum_local a), unrolled over the
    all-gathered (Z, T) pairs, and its part of the output is the chunk
    body's inter-chunk term, y_t += exp(cumsum_t a) * C_t . IN. The local
    core is the chunked einsums (JAX's is XLA), differentiated a chunk at
    a time; ``kernel="pallas"`` warns that it does not apply. With one
    context rank this is :func:`ssd_scan` with ``kernel`` as asked."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown ssd kernel {kernel!r}: expected one of {KERNELS}")
    cp = 1 if ring is None else ring.cp
    if cp == 1:
        return ssd_scan(x, dt, A, Bm, Cm, D, chunk_size=chunk_size, kernel=kernel)
    if kernel == "pallas":
        import warnings

        warnings.warn(
            "ssd_scan_cp: kernel='pallas' has no cp implementation; running "
            "the XLA core under the context axis",
            stacklevel=2,
        )
    xs, dts, Bs, Cs = ring.split(x), ring.split(dt), ring.split(Bm), ring.split(Cm)
    s_loc = xs[0].shape[1]
    L = min(chunk_size, s_loc)
    if s_loc % L:
        raise ValueError(f"local sequence {s_loc} must be a multiple of chunk {L}")
    Bsz, _, H, P = xs[0].shape
    G, N = Bs[0].shape[2], Bs[0].shape[3]
    Af = A.float()
    parts, packed = [], []
    for xl, dtl, Bl, Cl in zip(xs, dts, Bs, Cs):
        dtf = dtl.float()
        a = dtf * Af[None, None, :]
        y0, z_fin = _SSDCoreState.apply(xl, dtf, a, Bl, Cl, L)
        t_total = torch.exp(a.sum(dim=1))  # (B, H): the local decay product
        parts.append((y0, torch.cumsum(a, dim=1), Cl))
        packed.append(torch.cat([z_fin.reshape(Bsz, -1), t_total], dim=1))
    gathered = ring.gather(packed)  # every rank's (Z, T), in context order
    zs = [g[:, :-H].reshape(Bsz, H, P, N) for g in gathered]
    ts = [g[:, -H:] for g in gathered]
    ys = []
    for idx, (y0, cum, Cl) in zip(ring.slots, parts):
        carry = torch.zeros_like(zs[0])
        for d in range(cp - 1):  # unrolled, as JAX's
            upd = ts[d][..., None, None] * carry + zs[d]
            # a select, not a skip: every rank's output reaches the gathered
            # parts, so every rank runs the gather's backward collective
            carry = torch.where(torch.tensor(d < idx, device=carry.device), upd, carry)
        ys.append(y0 + _state_contribution(Cl, carry, cum, G))
    y = ring.join(ys)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)


def ssd_scan_reference(x, dt, A, Bm, Cm, D=None):
    """Sequential per-token recurrence (ground truth for tests, and the
    math of the serving decode step)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    xf = x.float()
    dtf = dt.float()
    Bf = Bm.float().repeat_interleave(rep, dim=2)
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    Af = A.float()

    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dtf[:, t]
        h = h * torch.exp(dtt * Af)[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtt, Bf[:, t], xf[:, t]
        )
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], h))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype)


def causal_conv1d_cp(x, weight, bias, ring, activation: str = "silu"):
    """:func:`causal_conv1d` over a sequence split over the context axis
    (``ops/ring_attention.py``'s exchange): each rank receives the
    previous rank's last W - 1 rows (rank 0 zeros, the conv's own pad) and
    convolves them ahead of its own, so every output is the whole
    sequence's; the backward sends the halo's gradient back."""
    from fms_fsdp_tpu_torch.ops.ring_attention import shift_from_previous

    halo = weight.shape[-1] - 1
    if ring is None or ring.cp == 1 or halo == 0:
        return causal_conv1d(x, weight, bias, activation)
    parts = ring.split(x)
    if parts[0].shape[1] < halo:
        raise ValueError(f"a context rank's {parts[0].shape[1]} positions are fewer than "
                         f"the conv's halo of {halo}")
    halos = shift_from_previous(ring, [p[:, -halo:] for p in parts])
    outs = [causal_conv1d(torch.cat([h, p], dim=1), weight, bias, activation)[:, halo:]
            for h, p in zip(halos, parts)]
    return ring.join(outs)


@scoped("causal_conv1d")
def causal_conv1d(x, weight, bias=None, activation: str = "silu"):
    """Depthwise causal conv over (B, S, C) with kernel (C, W), the
    mamba_ssm causal_conv1d equivalent, as W shifted fp32 multiply-adds in
    ascending w on a pad kept in the input dtype, as JAX writes it. It is
    not ``F.conv1d``: cuDNN's fp32 convolution runs in TF32 by default,
    and the serving decode step replays exactly this sum."""
    S = x.shape[1]
    W = weight.shape[-1]
    wf = weight.float()
    xt = F.pad(x, (0, 0, W - 1, 0))
    out = xt[:, 0:S].float() * wf[None, None, :, 0]
    for w in range(1, W):
        out = out + xt[:, w : w + S].float() * wf[None, None, :, w]
    if bias is not None:
        out = out + bias.float()[None, None, :]
    if activation == "silu":
        out = F.silu(out)
    return out.to(x.dtype)
