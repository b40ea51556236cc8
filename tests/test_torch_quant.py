"""PyTorch port, quantized training ops: held against the JAX package on CPU.

``fms_fsdp_tpu_torch/ops/quant.py`` against ``fms_fsdp_tpu/ops/quant.py``
on the same numpy-seeded inputs. Tolerances:

- int8: bitwise, fp32 and bf16 (int32 accumulation is exact and the
  scales are the same operations in the same order);
- fp8 (e4m3 forward, e5m2 x e4m3 dgrad): the fp8 values are the same
  (bitwise); their products are exact in fp32 but the sums run in
  another order, so 2e-6 of the output's largest magnitude (measured
  < 4e-7);
- exact backward parts (the dgrad without a wire, the wgrad): 1e-5 of the
  largest magnitude in fp32 (the contraction order differs), a bf16 ulp
  (2^-8 relative) in bf16;
- the wires and delayed scaling: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.ops import quant as jq
from fms_fsdp_tpu.parallel.mixed_precision import get_dtype_policy as j_policy
from fms_fsdp_tpu_torch.ops import quant as tq
from fms_fsdp_tpu_torch.ops.flash_attention import flash_attention
from fms_fsdp_tpu_torch.parallel.mixed_precision import (
    REDUCE_QUANT_MODES,
    get_dtype_policy,
)
from fms_fsdp_tpu_torch.parallel.sharding import QuantLeaf, quantized_grad_reduce
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MODES = ("int8", "int8_dgrad", "fp8", "fp8_dgrad")
_DT = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
FP8_REL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    tdt, jdt = _DT[dtype]
    t = torch.from_numpy(a).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bits(x) -> np.ndarray:
    """Raw bytes of a tensor or array, for a bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        if x.dtype in (tq.FP8_E4M3, tq.FP8_E5M2):
            return x.view(torch.uint8).numpy()
        return x.numpy().view(np.uint8)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.uint8)


def _rel(port, ref) -> float:
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30))


def _xwg(seed, lead=(2, 48), d=64, f=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, d)).astype(np.float32)
    w = (0.05 * rng.standard_normal((d, f))).astype(np.float32)
    g = rng.standard_normal((*lead, f)).astype(np.float32)
    return x, w, g


# ---------------------------------------------------------------------------
# the shared quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_quantizers_bitwise_vs_jax(dtype, axis):
    """int8, e4m3 and e5m2 along any axis: the same 1-byte values and fp32
    scales, an all-zero row at scale 0 included."""
    a = np.random.default_rng(0).standard_normal((6, 10, 12)).astype(np.float32) * 3
    a[2, 3] = 0.0
    a[0, :, 0] = 0.0
    t, j = _pair(a, dtype)
    for port, ref in (
        (tq._absmax_quant(t, axis), jq._absmax_quant(j, axis)),
        (tq._absmax_quant_fp8(t, axis, tq.FP8_E4M3),
         jq._absmax_quant_fp8(j, axis, jq.FP8_E4M3)),
        (tq._absmax_quant_fp8(t, axis, tq.FP8_E5M2),
         jq._absmax_quant_fp8(j, axis, jq.FP8_E5M2)),
    ):
        assert np.array_equal(_bits(port[0]), _bits(ref[0]))
        assert np.array_equal(_bits(port[1]), _bits(ref[1]))
    assert float(tq._absmax_quant(t, -1)[1][2, 3]) == 0.0


def test_fp8_clamps_before_the_cast():
    """e4m3fn overflows to NaN and e5m2 to inf: a huge outlier and a zero
    tensor both give finite values."""
    x = torch.full((1, 8, 64), 1e30)
    w = torch.full((64, 32), 1e4)
    assert torch.isfinite(tq.fp8_matmul(x, w)).all()
    assert not torch.isnan(tq.fp8_matmul(torch.zeros(1, 8, 64), torch.zeros(64, 32))).any()
    assert not torch.isnan(tq.int8_matmul(torch.zeros(1, 8, 64), torch.zeros(64, 32))).any()
    big = torch.tensor([[1e38, -3e38, 1.0]])
    assert torch.isfinite(tq.wire_roundtrip(big, "fp8")).all()
    scale = torch.tensor(1e-3)  # a stale delayed scale far below the amax
    out = tq.wire_roundtrip(big, "fp8_delayed", scale=scale)
    assert torch.isfinite(out).all() and float(out.abs().max()) == pytest.approx(57.344)


# ---------------------------------------------------------------------------
# the matmuls
# ---------------------------------------------------------------------------


def _port_vjp(fn, x, w, g):
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    out = fn(x, w)
    dx, dw = torch.autograd.grad(out, (x, w), g)
    return out, dx, dw


def _jax_vjp(fn, x, w, g):
    out, vjp = jax.vjp(fn, x, w)
    return (out, *vjp(g))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_matmul_forward_dgrad_wgrad_vs_jax(mode, dtype):
    x, w, g = _xwg(1)
    tx, jx = _pair(x, dtype)
    tw, jw = _pair(w, dtype)
    tg, jg = _pair(g, dtype)
    out, dx, dw = _port_vjp(lambda a, b: tq.matmul(a, b, quant=mode), tx, tw, tg)
    jout, jdx, jdw = _jax_vjp(lambda a, b: jq.matmul(a, b, quant=mode), jx, jw, jg)
    assert out.dtype == dx.dtype == dw.dtype == tx.dtype
    exact_tol = 1e-5 if dtype == "fp32" else 2.0 ** -8
    if mode.startswith("int8"):
        assert np.array_equal(_bits(out), _bits(jout))
    else:
        assert _rel(out, jout) <= FP8_REL
    if mode == "int8_dgrad":
        assert np.array_equal(_bits(dx), _bits(jdx))
    elif mode == "fp8_dgrad":
        assert _rel(dx, jdx) <= (FP8_REL if dtype == "fp32" else 2.0 ** -8)
    else:
        assert _rel(dx, jdx) <= exact_tol
    assert _rel(dw, jdw) <= exact_tol
    # the quantized forward is close to the exact product
    assert _rel(out, jx @ jw) < (0.02 if mode.startswith("int8") else 0.08)


@pytest.mark.parametrize("mode", MODES)
def test_wgrad_bit_identical_to_unquantized_fp32(mode):
    """The optimizer-bound dW of every mode is the unquantized matmul's,
    bit for bit, on fp32 operands (and the exact modes' dx too)."""
    x, w, g = (torch.from_numpy(a) for a in _xwg(2))
    _, dx_q, dw_q = _port_vjp(lambda a, b: tq.matmul(a, b, quant=mode), x, w, g)
    _, dx_r, dw_r = _port_vjp(lambda a, b: a @ b, x, w, g)
    assert torch.equal(dw_q, dw_r)
    if not mode.endswith("dgrad"):
        assert torch.equal(dx_q, dx_r)


def test_wgrad_bf16_operands_accumulate_fp32():
    """bf16 operands: dW is the fp32 contraction rounded once to bf16."""
    x, w, g = (torch.from_numpy(a).bfloat16() for a in _xwg(3, lead=(2, 128), d=96))
    _, _, dw = _port_vjp(lambda a, b: tq.matmul(a, b, quant="int8"), x, w, g)
    ref = (x.reshape(-1, 96).float().t() @ g.reshape(-1, 32).float()).bfloat16()
    assert dw.dtype == torch.bfloat16 and torch.equal(dw, ref)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_expert_matmul_vs_jax(mode, dtype):
    """The E-major expert forms: the port's (E, B*C, K) buffer against
    JAX's (E, B, C, K); w scaled per (expert, column) in the forward and
    per (expert, row) in the dgrad."""
    rng = np.random.default_rng(4)
    E, B, C, K, F = 4, 2, 12, 64, 48
    x = rng.standard_normal((E, B, C, K)).astype(np.float32)
    w = (0.05 * rng.standard_normal((E, K, F))).astype(np.float32)
    g = rng.standard_normal((E, B, C, F)).astype(np.float32)
    tx, jx = _pair(x.reshape(E, B * C, K), dtype)
    tw, jw = _pair(w, dtype)
    tg, jg = _pair(g.reshape(E, B * C, F), dtype)
    out, dx, dw = _port_vjp(lambda a, b: tq.expert_matmul(a, b, quant=mode), tx, tw, tg)
    jout, jdx, jdw = _jax_vjp(lambda a, b: jq.expert_matmul(a, b, quant=mode),
                              jx.reshape(E, B, C, K), jw, jg.reshape(E, B, C, F))
    jout, jdx = jout.reshape(E, B * C, F), jdx.reshape(E, B * C, K)
    exact_tol = 1e-5 if dtype == "fp32" else 2.0 ** -8
    if mode.startswith("int8"):
        assert np.array_equal(_bits(out), _bits(jout))
    else:
        assert _rel(out, jout) <= FP8_REL
    if mode == "int8_dgrad":
        assert np.array_equal(_bits(dx), _bits(jdx))
    elif mode == "fp8_dgrad":
        assert _rel(dx, jdx) <= (FP8_REL if dtype == "fp32" else 2.0 ** -8)
    else:
        assert _rel(dx, jdx) <= exact_tol
    assert _rel(dw, jdw) <= exact_tol


def test_expert_wgrad_equals_unquantized_fp32():
    """The expert dW against the unquantized batched product's: bitwise
    in the port (both one ``bmm`` over the same operands). JAX's own
    version of this pin fails (its einsum and dot_general contract in
    other orders), so against JAX the bound is 1e-5 of the largest
    magnitude, as every exact backward part here."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 32, 64)).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.standard_normal((4, 64, 48))).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 32, 48)).astype(np.float32))
    _, _, dw_q = _port_vjp(lambda a, b: tq.expert_matmul(a, b, quant="int8_dgrad"), x, w, g)
    _, _, dw_r = _port_vjp(torch.bmm, x, w, g)
    assert torch.equal(dw_q, dw_r)
    _, _, jdw = _jax_vjp(lambda a, b: jnp.einsum("end,edf->enf", a, b),
                         jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                         jnp.asarray(g.numpy()))
    assert _rel(dw_q, jdw) <= 1e-5


def test_unknown_modes_raise():
    x, w = torch.zeros(1, 4, 8), torch.zeros(8, 4)
    with pytest.raises(ValueError, match="quantized_matmuls"):
        tq.matmul(x, w, quant="int4")
    with pytest.raises(ValueError, match="quantized_matmuls"):
        tq.expert_matmul(torch.zeros(2, 4, 8), torch.zeros(2, 8, 4), quant="fp16")
    with pytest.raises(ValueError, match="reduce wire"):
        tq.wire_roundtrip(x, "int4")
    with pytest.raises(ValueError, match="activation wire"):
        tq.activation_roundtrip(x, "e5m2")
    with pytest.raises(ValueError, match="kv wire"):
        tq.kv_quantize(x, "int4")
    with pytest.raises(ValueError, match="quantized_reduce"):
        quantized_grad_reduce([x], "int4", None, [QuantLeaf("g.x", 3, None)])

    class Cfg:
        quantized_reduce = "int4"

    with pytest.raises(ValueError, match="quantized_reduce"):
        get_dtype_policy(Cfg())
    for mode in REDUCE_QUANT_MODES:
        Cfg.quantized_reduce = mode
        assert get_dtype_policy(Cfg()).reduce_quant == j_policy(Cfg()).reduce_quant == mode


def test_card_shape_rules_are_checked():
    """The card's layout rules, raised with the shape (the CPU runs the
    plain products, which take any shape)."""
    i8, e4 = torch.int8, tq.FP8_E4M3
    tq._check_gemm(torch.zeros(32, 64, dtype=i8), torch.zeros(16, 64, dtype=i8))
    with pytest.raises(ValueError, match=r"\(16, 64, 16\)"):
        tq._check_gemm(torch.zeros(16, 64, dtype=i8), torch.zeros(16, 64, dtype=i8))
    with pytest.raises(ValueError, match="multiples of 8"):
        tq._check_gemm(torch.zeros(32, 60, dtype=i8), torch.zeros(16, 60, dtype=i8))
    tq._check_gemm(torch.zeros(8, 64).to(e4), torch.zeros(32, 64).to(e4))
    with pytest.raises(ValueError, match="_scaled_mm"):
        tq._check_gemm(torch.zeros(8, 64).to(e4), torch.zeros(24, 64).to(e4))


# ---------------------------------------------------------------------------
# the wires and delayed scaling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_wire_roundtrip_bitwise_vs_jax(wire, dtype):
    """Per-row scales on a matrix, one scale on a vector, and a stacked
    per-layer slice (a JAX matrix row) equal to the JAX leaf's row."""
    rng = np.random.default_rng(6)
    m = rng.standard_normal((16, 40)).astype(np.float32)
    m[3] = 0.0
    v = (rng.standard_normal(40) * 1e-3).astype(np.float32)
    v[7] = 0.5  # an outlier sets the one scale
    for a in (m, v):
        t, j = _pair(a, dtype)
        out = tq.wire_roundtrip(t, wire)
        assert out.dtype == t.dtype
        assert np.array_equal(_bits(out), _bits(jq.wire_roundtrip(j, wire)))
    t, j = _pair(m, dtype)
    row = tq.wire_roundtrip(t[5], wire, ndim=2)
    assert np.array_equal(_bits(row), _bits(jq.wire_roundtrip(j, wire)[5]))
    # the vector took one per-tensor scale: its small entries round to 0
    tv, _ = _pair(v, dtype)
    assert float(tq.wire_roundtrip(tv, "int8").abs().min()) == 0.0


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fp8_delayed_wire_bitwise_vs_jax(dtype):
    a = np.random.default_rng(7).standard_normal((8, 24)).astype(np.float32) * 50
    t, j = _pair(a, dtype)
    for s in (np.float32(2e-3), np.float32(1e-5), np.float32(0.0)):
        out = tq.wire_roundtrip(t, "fp8_delayed", scale=torch.tensor(s))
        ref = jq.wire_roundtrip(j, "fp8_delayed", scale=jnp.float32(s))
        assert np.array_equal(_bits(out), _bits(ref)), s


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_activation_roundtrip_bitwise_vs_jax(wire, dtype):
    a = np.random.default_rng(8).standard_normal((2, 16, 4, 32)).astype(np.float32)
    t, j = _pair(a, dtype)
    assert np.array_equal(_bits(tq.activation_roundtrip(t, wire)),
                          _bits(jq.activation_roundtrip(j, wire)))


def test_delayed_scale_bootstrap_clamp_and_roll():
    """An all-zero history takes the current amax; a history with values
    takes its max (so a growing amax is clamped by the wire); the roll
    puts the newest at index 0 and drops the oldest. Bitwise JAX's."""
    cur = np.float32(3.7)
    for hist in (np.zeros(4, np.float32), np.array([0.5, 9.0, 0.0, 0.0], np.float32),
                 np.array([np.nan, 1.0, 2.0, 3.0], np.float32)):
        th, jh = torch.from_numpy(hist), jnp.asarray(hist)
        s = tq.delayed_scale(th, torch.tensor(cur))
        js = jq.delayed_scale(jh, jnp.float32(cur))
        assert np.array_equal(_bits(s.reshape(1)), _bits(jnp.reshape(js, (1,))))
        rolled = tq.roll_amax_history(th, torch.tensor(cur))
        assert np.array_equal(_bits(rolled), _bits(jq.roll_amax_history(jh, jnp.float32(cur))))
    assert float(tq.delayed_scale(torch.zeros(4), torch.tensor(cur))) == pytest.approx(
        3.7 / 57344.0)
    g = np.random.default_rng(9).standard_normal((4, 8)).astype(np.float32)
    assert float(tq.leaf_amax(torch.from_numpy(g))) == float(jq.leaf_amax(jnp.asarray(g)))


def test_quantized_grad_reduce_delayed_threads_history():
    """Two steps of the per-leaf delayed wire on one process: a stacked
    leaf's layers share one row (the max over its layers), the rows
    roll, and the grads equal JAX's on the stacked leaf."""
    rng = np.random.default_rng(10)
    stacked = rng.standard_normal((2, 8, 16)).astype(np.float32)
    vec = rng.standard_normal(16).astype(np.float32)
    leaves = [QuantLeaf("g.layers.wq", 3, None), QuantLeaf("g.layers.wq", 3, None),
              QuantLeaf("g.norm", 1, None)]
    state = {"amax_history": {"g.layers.wq": torch.zeros(4), "g.norm": torch.zeros(4)}}
    jstate = {"amax_history": {"g.layers.wq": jnp.zeros(4), "g.norm": jnp.zeros(4)}}
    for step in range(2):
        grads = [torch.from_numpy(stacked[0] * (step + 1)),
                 torch.from_numpy(stacked[1] * (step + 1)), torch.from_numpy(vec)]
        out, state = quantized_grad_reduce(grads, "fp8_delayed", state, leaves)
        jtree = {"layers": {"wq": jnp.asarray(stacked * (step + 1))}, "norm": jnp.asarray(vec)}
        from fms_fsdp_tpu.parallel.sharding import quantized_grad_reduce as j_reduce

        jout, jstate = j_reduce(jtree, "fp8_delayed", jstate)
        assert np.array_equal(_bits(out[0]), _bits(jout["layers"]["wq"][0]))
        assert np.array_equal(_bits(out[1]), _bits(jout["layers"]["wq"][1]))
        assert np.array_equal(_bits(out[2]), _bits(jout["norm"]))
        for key in ("g.layers.wq", "g.norm"):
            assert np.array_equal(_bits(state["amax_history"][key]),
                                  _bits(jstate["amax_history"][key]))
    assert float(state["amax_history"]["g.layers.wq"][1]) == float(np.abs(stacked).max())
    for mode in ("int8", "fp8"):
        out, same = quantized_grad_reduce(grads, mode, state, leaves)
        assert same is state
        jout, _ = j_reduce(jtree, mode, None)
        assert np.array_equal(_bits(out[1]), _bits(jout["layers"]["wq"][1]))
        assert np.array_equal(_bits(out[2]), _bits(jout["norm"]))


# ---------------------------------------------------------------------------
# the attention operand wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_flash_quant_is_the_wire_then_the_kernels_with_straight_through_grads(wire):
    """``flash_attention(quant=)``: the output is the unquantized call's on
    the round-tripped q and k (themselves JAX's round trip bitwise), and
    the gradients pass through the wire unchanged; ``quant=None`` is the
    plain call bit for bit."""
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16), (1, 64, 4, 16)))
    qq, kq = tq.activation_roundtrip(q, wire), tq.activation_roundtrip(k, wire)
    assert np.array_equal(_bits(kq), _bits(jq.activation_roundtrip(jnp.asarray(k.numpy()), wire)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, quant=wire)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (qq, kq, v)]
    ref = flash_attention(*ref_leaves)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do)
    assert torch.equal(out, ref)
    for a, b in zip(grads, ref_grads):
        assert torch.equal(a, b)
    assert torch.equal(flash_attention(q, k, v, quant=None), flash_attention(q, k, v))
    assert not torch.equal(out, flash_attention(q, k, v))


def test_kv_codec_bytes_unchanged_on_the_shared_quantizers():
    """kv_quantize is the shared quantizer along the head dim: the same
    bytes as the quantizers themselves and as JAX's codec."""
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((3, 5, 64)).astype(np.float32))
    for wire, fn in (("int8", lambda t: tq._absmax_quant(t, -1)),
                     ("fp8", lambda t: tq._absmax_quant_fp8(t, -1, tq.FP8_E4M3))):
        q, s = tq.kv_quantize(x.bfloat16(), wire)
        q2, s2 = fn(x.bfloat16())
        assert np.array_equal(_bits(q), _bits(q2)) and torch.equal(s, s2)
        jqv, jsv = jq.kv_quantize(jnp.asarray(x.numpy()).astype(jnp.bfloat16), wire)
        assert np.array_equal(_bits(q), _bits(jqv)) and np.array_equal(_bits(s), _bits(jsv))
