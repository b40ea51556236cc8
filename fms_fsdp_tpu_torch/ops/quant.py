"""Quantized matmuls (int8 and fp8), the gradient wire formats and the
KV-cache page format.

Counterpart of ``fms_fsdp_tpu/ops/quant.py``, step for step:

- activations: per-row (per-token) absmax scale to int8/e4m3;
- weights: per-column (per-output-channel) absmax scale;
- int8 x int8 -> int32 (or e4m3 x e4m3 -> fp32) accumulation, dequantized
  by the outer product of the two scale vectors, multiplied as
  ``(acc.float() * sx * sw).to(x.dtype)``;
- backward: the dgrad is ``g @ w^T`` in the operands' dtype, or, under the
  ``_dgrad`` modes, on the quantized path (int8, or an e5m2 gradient
  against an e4m3 weight, both scaled per row over the contracted dim);
  the wgrad is never quantized, accumulates in fp32 and is cast to the
  weight's dtype.

The shared quantizers follow JAX's arithmetic: the absmax and its
division by 127 (or 448 / 57344) happen in the input's dtype and are
then widened to fp32; int8 values are rounded half to even
(``torch.round``, as ``jnp.round``) and clipped to ±127; fp8 values are
clamped to the format's largest finite value BEFORE the cast (e4m3fn
overflows to NaN, e5m2 to inf); an all-zero row gets scale 0.

On the card the 1-byte GEMMs are cuBLASLt calls: ``torch._int_mm``
(int8 -> int32) and ``torch._scaled_mm`` (fp8, unit scales, fp32 out,
``use_fast_accum=False``); the scales are applied afterwards as above.
Both want the second operand column-major, so the weight is quantized
straight into that layout: ``w.t()`` along its last axis for the forward,
``w`` along its last axis for the dgrad. A shape either call cannot take
raises and names the shape; nothing falls back to a 16-bit product. On
the CPU the plain versions run: an int32 product of the int8 values, an
fp32 product of the fp8 values. :data:`GEMMS` counts the card's calls;
each quantized product (its quantize passes, GEMM and dequant) runs
under the profiler scope ``quant_matmul``.

The gradient wire (``wire_roundtrip``, the quantized reduce of
``parallel/sharding.py``), the attention operand wire
(``activation_roundtrip``, ``flash_attention(quant=)``), delayed scaling
(``leaf_amax``, ``delayed_scale``, ``roll_amax_history``) and the KV page
codec (``kv_quantize``) share the same quantizers.
"""

import torch
from torch.profiler import record_function

FP8_E4M3 = torch.float8_e4m3fn
FP8_E5M2 = torch.float8_e5m2
# largest finite magnitudes; the clamp bound before any fp8 cast
FP8_E4M3_MAX = 448.0
FP8_E5M2_MAX = 57344.0

QUANT_MODES = ("none", "int8", "int8_dgrad", "fp8", "fp8_dgrad")

# the card's 1-byte GEMM calls since the last reset, by pass: "fwd" (the
# forward and a recomputed forward), "dgrad" (the quantized dgrad)
GEMMS = {"fwd": 0, "dgrad": 0}


def reset_gemms() -> None:
    for key in GEMMS:
        GEMMS[key] = 0


# ---------------------------------------------------------------------------
# the shared quantizers
# ---------------------------------------------------------------------------


def absmax(x: torch.Tensor, dim) -> torch.Tensor:
    """|x|'s max along ``dim`` (an int or a tuple, kept as 1), in x's
    dtype."""
    return x.abs().amax(dim=dim, keepdim=True)


def _scales(amax: torch.Tensor, fmax: float):
    scale = (amax / fmax).float()
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    return scale, safe


def _absmax_quant(x: torch.Tensor, dim=-1, amax=None):
    """Symmetric int8 quantization along ``dim``: (q int8, scale fp32
    with ``dim`` kept as 1), x ~= q * scale. ``amax`` replaces x's own
    absmax (a row split across processes takes the whole row's)."""
    scale, safe = _scales(absmax(x, dim) if amax is None else amax, 127.0)
    q = torch.round(x.float() / safe).clamp(-127, 127).to(torch.int8)
    return q, torch.where(scale == 0, torch.zeros_like(scale), scale)


def _absmax_quant_fp8(x: torch.Tensor, dim=-1, dtype=FP8_E4M3, amax=None):
    """Symmetric fp8 quantization along ``dim``: the scale maps the
    absmax to the format's largest finite value."""
    fmax = FP8_E4M3_MAX if dtype == FP8_E4M3 else FP8_E5M2_MAX
    scale, safe = _scales(absmax(x, dim) if amax is None else amax, fmax)
    q = (x.float() / safe).clamp(-fmax, fmax).to(dtype)
    return q, torch.where(scale == 0, torch.zeros_like(scale), scale)


def _quant(x: torch.Tensor, dtype):
    """Along the last axis into ``dtype`` (int8, e4m3 or e5m2)."""
    if dtype == torch.int8:
        return _absmax_quant(x, -1)
    return _absmax_quant_fp8(x, -1, dtype)


# ---------------------------------------------------------------------------
# the 1-byte GEMM
# ---------------------------------------------------------------------------


def _check_gemm(a: torch.Tensor, b_t: torch.Tensor) -> None:
    """The card's layout rules: ``_int_mm`` takes M > 16 and K, N
    multiples of 8; ``_scaled_mm`` K and N multiples of 16."""
    (m, k), (n, _) = a.shape, b_t.shape
    if a.dtype == torch.int8:
        ok, rule = m > 16 and k % 8 == 0 and n % 8 == 0, "M > 16, K and N multiples of 8"
        call = "torch._int_mm"
    else:
        ok, rule = k % 16 == 0 and n % 16 == 0, "K and N multiples of 16"
        call = "torch._scaled_mm"
    if not ok:
        raise ValueError(
            f"{call} cannot take (M, K, N) = ({m}, {k}, {n}): it needs {rule}"
        )


def _gemm(a: torch.Tensor, b_t: torch.Tensor, kind: str) -> torch.Tensor:
    """a (M, K) @ b_t (N, K)^T for 1-byte operands -> (M, N): int32 for
    int8, fp32 for fp8. ``b_t`` is row-major, so ``b_t.t()`` is the
    column-major second operand the library calls want."""
    if a.device.type != "cuda":
        if a.dtype == torch.int8:
            return torch.mm(a.to(torch.int32), b_t.t().to(torch.int32))
        return torch.mm(a.float(), b_t.float().t())
    _check_gemm(a, b_t)
    a, b_t = a.contiguous(), b_t.contiguous()
    if a.dtype == torch.int8:
        out = torch._int_mm(a, b_t.t())
    else:
        one = torch.ones((), dtype=torch.float32, device=a.device)
        out = torch._scaled_mm(a, b_t.t(), scale_a=one, scale_b=one,
                               out_dtype=torch.float32, use_fast_accum=False)
    GEMMS[kind] += 1
    return out


def _expert_gemm(a: torch.Tensor, b_t: torch.Tensor, kind: str) -> torch.Tensor:
    """Per expert: a (E, M, K) @ b_t (E, N, K)^T -> (E, M, N), one 2-D
    library call an expert on the card."""
    if a.device.type != "cuda":
        if a.dtype == torch.int8:
            return torch.bmm(a.to(torch.int32), b_t.to(torch.int32).transpose(1, 2))
        return torch.bmm(a.float(), b_t.float().transpose(1, 2))
    return torch.stack([_gemm(a[e], b_t[e], kind) for e in range(a.shape[0])])


def _fold(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


# ---------------------------------------------------------------------------
# forward, dgrad, wgrad
# ---------------------------------------------------------------------------


@record_function("quant_matmul")
def _matmul_raw(x, w, dtype):
    """x (..., T, D) @ w (D, F) on the 1-byte path: per-row x scales,
    per-column w scales."""
    qx, sx = _quant(_fold(x), dtype)  # (M, D), (M, 1)
    qwt, sw = _quant(w.t(), dtype)  # (F, D), (F, 1): w's column scales
    acc = _gemm(qx, qwt, "fwd")
    out = (acc.float() * sx * sw.t()).to(x.dtype)
    return out.reshape(*x.shape[:-1], w.shape[1])


def int8_matmul_raw(x, w):
    """x (..., T, D) @ w (D, F) through int8 with dynamic dequant."""
    return _matmul_raw(x, w, torch.int8)


def fp8_matmul_raw(x, w):
    """x (..., T, D) @ w (D, F) through e4m3 x e4m3 -> fp32, the same
    per-row / per-column dequant as the int8 path."""
    return _matmul_raw(x, w, FP8_E4M3)


def _wire_dtypes(wire):
    if wire == "int8":
        return torch.int8, torch.int8
    return FP8_E5M2, FP8_E4M3  # e5m2 gradient x e4m3 weight


def _dgrad(g, w, wire):
    """dx = g @ w^T, exact (``wire`` None) in g's dtype, or on the
    quantized path ("int8", "fp8") in fp32: per-row g scale and per-row w
    scale, both over the F dim."""
    if wire is None:
        return g @ w.t()
    with record_function("quant_matmul"):
        g_dtype, w_dtype = _wire_dtypes(wire)
        qg, sg = _quant(_fold(g), g_dtype)  # (M, F), (M, 1)
        qw, sw = _quant(w, w_dtype)  # (D, F), (D, 1)
        acc = _gemm(qg, qw, "dgrad")
        out = acc.float() * sg * sw.squeeze(-1)
        return out.reshape(*g.shape[:-1], w.shape[0])


def _wgrad(x, g):
    """dW = x^T g over every token, unquantized, accumulated in fp32 (the
    caller casts to the weight's dtype: a no-op for fp32, bit-identical
    to the unquantized dW there)."""
    x2, g2 = _fold(x), _fold(g)
    if x2.device.type == "cuda" and x2.dtype != torch.float32:
        return torch.mm(x2.t(), g2, out_dtype=torch.float32)
    return torch.mm(x2.t().float(), g2.float())


def _make_quant_matmul(raw_fn, dgrad_wire, dgrad_fn=None, wgrad_fn=None):
    """An autograd Function over ``raw_fn``: it saves the operands
    themselves, (x, w), and quantizes the weight again in the backward,
    so a gathered weight leaves the forward as a handle
    (``parallel/sharding.py::DataParallel.release_saved``) and no 1-byte
    copy lives until the backward."""
    dgrad_fn = dgrad_fn or _dgrad
    wgrad_fn = wgrad_fn or _wgrad

    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return raw_fn(x, w)

    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dgrad_fn(g, w, dgrad_wire).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = wgrad_fn(x, g).to(w.dtype)
        return dx, dw

    name = f"{raw_fn.__name__}_{dgrad_wire or 'exact'}_dgrad"
    fn = type(name, (torch.autograd.Function,),
              {"forward": staticmethod(forward), "backward": staticmethod(backward)})

    def apply(x, w):
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return fn.apply(x, w)
        return raw_fn(x, w)  # no graph: the forward alone

    return apply


int8_matmul = _make_quant_matmul(int8_matmul_raw, dgrad_wire=None)
int8_matmul_dgrad = _make_quant_matmul(int8_matmul_raw, dgrad_wire="int8")
fp8_matmul = _make_quant_matmul(fp8_matmul_raw, dgrad_wire=None)
fp8_matmul_dgrad = _make_quant_matmul(fp8_matmul_raw, dgrad_wire="fp8")

_MATMULS = {"int8": int8_matmul, "int8_dgrad": int8_matmul_dgrad,
            "fp8": fp8_matmul, "fp8_dgrad": fp8_matmul_dgrad}


def check_quant_mode(quant: str) -> None:
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quantized_matmuls value: {quant!r}")


def matmul(x, w, *, quant: str = "none"):
    """The models' linear layers: "none" (x @ w), "int8" (int8 forward,
    exact backward), "int8_dgrad" (int8 forward and dx), "fp8" (e4m3
    forward), "fp8_dgrad" (e4m3 forward, e5m2 x e4m3 dx); the wgrad is
    never quantized."""
    if quant == "none":
        return x @ w
    check_quant_mode(quant)
    return _MATMULS[quant](x, w)


# ---------------------------------------------------------------------------
# the expert forms: x (E, N, K) E-major (N = B * C capacity rows), w (E, K, F)
# ---------------------------------------------------------------------------


@record_function("quant_matmul")
def _expert_matmul_raw(x, w, dtype):
    qx, sx = _quant(x, dtype)  # (E, N, K), (E, N, 1)
    qwt, sw = _quant(w.transpose(1, 2), dtype)  # (E, F, K), (E, F, 1): over K
    acc = _expert_gemm(qx, qwt, "fwd")
    return (acc.float() * sx * sw.transpose(1, 2)).to(x.dtype)


def int8_expert_matmul_raw(x, w):
    """Per-expert x (E, N, K) @ w (E, K, F) -> (E, N, F) through int8;
    w scaled per (expert, column), over K."""
    return _expert_matmul_raw(x, w, torch.int8)


def fp8_expert_matmul_raw(x, w):
    """The e4m3 form of :func:`int8_expert_matmul_raw`."""
    return _expert_matmul_raw(x, w, FP8_E4M3)


def _expert_dgrad(g, w, wire):
    """dx = g @ w^T per expert: g (E, N, F), w (E, K, F) -> (E, N, K);
    on the quantized path w is scaled per (expert, row), over F."""
    if wire is None:
        return torch.bmm(g, w.transpose(1, 2))
    with record_function("quant_matmul"):
        g_dtype, w_dtype = _wire_dtypes(wire)
        qg, sg = _quant(g, g_dtype)  # (E, N, F), (E, N, 1)
        qw, sw = _quant(w, w_dtype)  # (E, K, F), (E, K, 1)
        acc = _expert_gemm(qg, qw, "dgrad")
        return acc.float() * sg * sw.transpose(1, 2)


def _expert_wgrad(x, g):
    """dW (E, K, F) over each expert's rows, unquantized, fp32."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return torch.bmm(x.transpose(1, 2), g, out_dtype=torch.float32)
    return torch.bmm(x.transpose(1, 2).float(), g.float())


int8_expert_matmul = _make_quant_matmul(
    int8_expert_matmul_raw, None, _expert_dgrad, _expert_wgrad)
int8_expert_matmul_dgrad = _make_quant_matmul(
    int8_expert_matmul_raw, "int8", _expert_dgrad, _expert_wgrad)
fp8_expert_matmul = _make_quant_matmul(
    fp8_expert_matmul_raw, None, _expert_dgrad, _expert_wgrad)
fp8_expert_matmul_dgrad = _make_quant_matmul(
    fp8_expert_matmul_raw, "fp8", _expert_dgrad, _expert_wgrad)

_EXPERT_MATMULS = {"int8": int8_expert_matmul, "int8_dgrad": int8_expert_matmul_dgrad,
                   "fp8": fp8_expert_matmul, "fp8_dgrad": fp8_expert_matmul_dgrad}


def expert_matmul(x, w, *, quant: str = "none"):
    """The MoE expert GEMM x (E, N, K) @ w (E, K, F), the modes of
    :func:`matmul`."""
    if quant == "none":
        return torch.bmm(x, w)
    check_quant_mode(quant)
    return _EXPERT_MATMULS[quant](x, w)


# ---------------------------------------------------------------------------
# gradient wire formats (the quantized reduce)
# ---------------------------------------------------------------------------


def wire_dims(g, ndim=None):
    """The dims of ``g`` that one reduce-wire scale spans: the last (per
    row) for a matrix, all of them (per tensor) for a vector. ``ndim`` is
    the rank that decides (default g's own; a layer of a stacked leaf
    passes the stacked rank: per row of the stacked leaf is per row of
    the layer)."""
    return -1 if (g.dim() if ndim is None else ndim) >= 2 else tuple(range(g.dim()))


def wire_roundtrip(g, wire: str, scale=None, amax=None, ndim=None):
    """One gradient leaf through the reduce wire, back in g's dtype:
    "int8" / "fp8" (e5m2) with dynamic scales over :func:`wire_dims`, or
    "fp8_delayed" with the given per-leaf fp32 ``scale``. ``amax``
    replaces g's own absmax over those dims (a row split across
    processes)."""
    if wire in ("int8", "fp8"):
        dim = wire_dims(g, ndim)
        if amax is None:
            amax = absmax(g, dim)
        if wire == "int8":
            q, s = _absmax_quant(g, dim, amax=amax)
        else:
            q, s = _absmax_quant_fp8(g, dim, FP8_E5M2, amax=amax)
        return (q.float() * s).to(g.dtype)
    if wire == "fp8_delayed":
        safe = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = (g.float() / safe).clamp(-FP8_E5M2_MAX, FP8_E5M2_MAX).to(FP8_E5M2)
        return (q.float() * torch.where(scale == 0, torch.zeros_like(scale), scale)
                ).to(g.dtype)
    raise ValueError(f"unknown reduce wire: {wire!r}")


def activation_roundtrip(x, wire: str):
    """The quantized attention family's operand wire: per-row absmax
    along the head (last) dim, int8 grid or e4m3 (activations want
    e4m3's mantissa; e5m2 is the gradients' wire)."""
    if wire == "int8":
        q, s = _absmax_quant(x, -1)
    elif wire == "fp8":
        q, s = _absmax_quant_fp8(x, -1, FP8_E4M3)
    else:
        raise ValueError(f"unknown activation wire: {wire!r}")
    return (q.float() * s).to(x.dtype)


def leaf_amax(g) -> torch.Tensor:
    """This step's absmax of one gradient leaf (fp32 scalar): the value
    the delayed-scaling history takes."""
    return g.float().abs().max()


def delayed_scale(history, current_amax) -> torch.Tensor:
    """The delayed scale from an (H,) amax history: the window's largest
    amax over e5m2's largest finite value; an all-zero history (step 0, a
    fresh field) takes this step's amax instead."""
    hist = history.max()
    amax = torch.where(hist > 0, hist, current_amax)
    return (amax / FP8_E5M2_MAX).float()


def roll_amax_history(history, current_amax) -> torch.Tensor:
    """The rolling window, newest at index 0."""
    return torch.cat([current_amax.reshape(1).to(history.dtype), history[:-1]])


# ---------------------------------------------------------------------------
# KV-cache page format
# ---------------------------------------------------------------------------


def kv_quantize(x: torch.Tensor, wire: str):
    """Per-row absmax along the head (last) dim, int8 or e4m3 (cache
    entries are activations). Returns (q, scale) with scale keeping the
    reduced dim as 1: 1-byte values and one fp32 scale a row."""
    if wire == "int8":
        return _absmax_quant(x, -1)
    if wire == "fp8":
        return _absmax_quant_fp8(x, -1, FP8_E4M3)
    raise ValueError(f"unknown kv wire: {wire!r}")


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    """Inverse of :func:`kv_quantize`: q * scale in fp32, cast to ``dtype``."""
    return (q.float() * scale).to(dtype)
