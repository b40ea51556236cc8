"""PyTorch port, long context: ring attention, the context-parallel SSD
scan, the conv halo and the rotary offset, held against JAX.

Inputs come from numpy seeds. JAX runs its context-parallel ops on the
8-device CPU mesh of tests/conftest.py (a context axis of cp devices, its
flash partials through interpret-mode Pallas where its ``supports()``
takes the local shape); the port runs the same ops with all cp chunks in
this process (``LocalRing``), its flash partials through the plain
versions the wrappers take for CPU tensors. The exchange across processes
(``GroupRing`` over gloo) is tests/test_torch_multiprocess.py's. Tolerances
are those of JAX's own tests (tests/test_ring_attention.py,
tests/test_ssd_cp.py): fp32 2e-5 (3e-5 for the flash partials; the SSD
scan's of its largest value), the hybrid model 5e-4 absolute with 1e-4
relative, bf16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.models.mamba import init_mamba_params as j_init_mamba
from fms_fsdp_tpu.models.mamba import mamba_forward as j_mamba_forward
from fms_fsdp_tpu.ops import flash_attention as j_fa
from fms_fsdp_tpu.ops import ring_attention as j_ring
from fms_fsdp_tpu.ops import rope as j_rope
from fms_fsdp_tpu.ops import ssd as j_ssd
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.models.configs import MambaAttnConfig, MambaConfig
from fms_fsdp_tpu_torch.models.mamba import mamba_forward
from fms_fsdp_tpu_torch.ops import flash_attention as t_fa
from fms_fsdp_tpu_torch.ops import rope as t_rope
from fms_fsdp_tpu_torch.ops import ssd as t_ssd
from fms_fsdp_tpu_torch.ops.ring_attention import LocalRing, ring_attention
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _mesh(cp):
    return build_mesh(MeshConfig(sharding_strategy="fsdp", context_parallel_size=cp))


def _qkv(seed, b, s, nq, nkv, h):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, nq, h)).astype(np.float32),
            rng.standard_normal((b, s, nkv, h)).astype(np.float32),
            rng.standard_normal((b, s, nkv, h)).astype(np.float32))


def _t(x, dtype=torch.float32, grad=True):
    t = torch.from_numpy(np.array(x, np.float32)).to(dtype)
    return t.requires_grad_() if grad else t


def _err(port, ref):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max())


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

# (B, S per context rank, Nq, Nkv, H, tolerance): H 16 is refused by the
# kernels' supports() (the einsum partials in both packages); H 128 at 256
# positions a rank is taken by both (the flash partials)
RING_SHAPES = {"einsum": (2, 32, 4, 2, 16, 2e-5), "flash": (1, 256, 2, 1, 128, 3e-5)}


@pytest.mark.parametrize("shape", sorted(RING_SHAPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cp", [2, 4])
def test_ring_attention_matches_jax(cp, causal, shape):
    """o and dq, dk, dv of the port's ring (every chunk in one process)
    against JAX's ring on a context axis of cp devices."""
    b, s_loc, nq, nkv, h, tol = RING_SHAPES[shape]
    q, k, v = _qkv(cp + 10 * causal, b, cp * s_loc, nq, nkv, h)
    local = (b, s_loc, nq, h)
    assert t_fa.supports(local, (b, s_loc, nkv, h)) == (shape == "flash")
    assert j_fa.supports(local, (b, s_loc, nkv, h)) == (shape == "flash")
    mesh = _mesh(cp)

    def j_loss(q, k, v):
        return (j_ring.ring_attention(q, k, v, mesh, causal=causal) ** 2).mean()

    jo = jax.jit(lambda q, k, v: j_ring.ring_attention(q, k, v, mesh, causal=causal))(q, k, v)
    jg = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = _t(q), _t(k), _t(v)
    to = ring_attention(tq, tk, tv, LocalRing(cp), causal=causal)
    (to ** 2).mean().backward()
    assert _err(to, jo) <= tol
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert _err(got, want) <= tol


def test_ring_launches_by_chunk_relation(monkeypatch):
    """Which partials run: under a causal mask each rank's diagonal chunk
    (causal) and the chunks before it (non-causal), none after it; without
    one every chunk, non-causal. Counted on the plain versions' calls."""
    from fms_fsdp_tpu_torch.ops import ring_attention as t_ring

    calls = []
    fwd, dq, dkv = t_fa.flash_fwd, t_fa.flash_dq, t_fa.flash_dkv
    monkeypatch.setattr(t_fa, "flash_fwd",
                        lambda *a, **k: calls.append(("fwd", k["causal"])) or fwd(*a, **k))
    monkeypatch.setattr(t_fa, "flash_dq",
                        lambda *a, **k: calls.append(("dq", k["causal"], k["out_dtype"]))
                        or dq(*a, **k))
    monkeypatch.setattr(t_fa, "flash_dkv",
                        lambda *a, **k: calls.append(("dkv", k["causal"])) or dkv(*a, **k))
    q, k, v = (_t(x) for x in _qkv(3, 1, 4 * 64, 2, 1, 128))
    for causal, n_diag, n_vis in ((True, 4, 6), (False, 0, 16)):
        calls.clear()
        t_ring.ring_attention(q, k, v, LocalRing(4), causal=causal).sum().backward()
        for op in ("fwd", "dkv"):
            assert calls.count((op, True)) == n_diag and calls.count((op, False)) == n_vis
        assert calls.count(("dq", True, torch.float32)) == n_diag
        assert calls.count(("dq", False, torch.float32)) == n_vis


def test_ring_on_the_card_refuses_shapes_the_kernels_do_not_take():
    """A local shape the kernels refuse runs the einsum partials for CPU
    tensors only; ``impl="xla"`` asks for them anywhere."""
    from fms_fsdp_tpu_torch.ops import ring_attention as t_ring

    q, k, v = (torch.zeros(1, 64, 2, 16, device="meta") for _ in range(3))
    with pytest.raises(NotImplementedError, match="attention_kernel='xla'"):
        t_ring._use_flash(q, k, "auto")
    assert not t_ring._use_flash(q, k, "xla")
    q, k = torch.zeros(1, 64, 2, 128), torch.zeros(1, 64, 1, 128)
    assert t_ring._use_flash(q, k, "auto")
    assert not t_ring._use_flash(q[..., :16], k[..., :16], "pallas")


def test_flash_dq_plain_fp32_output_matches_jax():
    """``flash_dq(out_dtype=float32)`` on bf16 inputs: the fp32 dq JAX's
    interpret-mode dq kernel stores, before any rounding to bf16; the
    default output stays bf16, the same values rounded."""
    q, k, v = _qkv(4, 1, 256, 4, 2, 128)
    do = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    bf = [_t(x, torch.bfloat16, grad=False) for x in (q, k, v, do)]
    o, lse = t_fa.flash_fwd_plain(*bf[:3], causal=False)
    delta = torch.einsum("bsnh,bsnh->bns", o.float(), bf[3].float()).contiguous()
    got = t_fa.flash_dq_plain(*bf, lse, delta, causal=False, out_dtype=torch.float32)
    rounded = t_fa.flash_dq_plain(*bf, lse, delta, causal=False)
    assert got.dtype == torch.float32 and rounded.dtype == torch.bfloat16
    # the fp32 output is the default's before its one rounding
    assert torch.equal(got.to(torch.bfloat16), rounded)
    jb = [jnp.asarray(x.float().numpy(), jnp.bfloat16).swapaxes(1, 2) for x in bf]
    want = j_fa.flash_dq(*jb, jnp.asarray(lse.numpy())[..., None],
                         jnp.asarray(delta.numpy())[..., None], scale=128 ** -0.5,
                         causal=False, block_q=128, block_k=128, interpret=True,
                         out_dtype=jnp.float32)
    assert want.dtype == jnp.float32
    want = np.asarray(want).swapaxes(1, 2)
    # the two round ds to bf16 at the same point; a value at a rounding
    # boundary may fall apart (one bf16 ulp of one term), far below the
    # rounding of dq itself, which the check must see
    tol = 1e-3 * float(np.abs(want).max())
    assert _err(got, want) <= tol < _err(rounded, want)
    with pytest.raises(ValueError, match="q's dtype or fp32"):
        t_fa.flash_dq_plain(*bf, lse, delta, out_dtype=torch.float16)


# ---------------------------------------------------------------------------
# ssd_scan_cp
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b=1, s=128, h=4, p=8, g=2, n=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32),
            -np.exp(rng.standard_normal((h,))).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            np.full((h,), 0.5, np.float32))


@pytest.mark.parametrize("cp", [2, 4])
def test_ssd_scan_cp_matches_jax(cp):
    """Forward and the gradients of all six inputs (A and D are
    replicated: their cotangents sum over the ranks) against JAX's
    ssd_scan_cp on a context axis of cp devices, each within 2e-5 of its
    largest value (the loss is JAX's sum of squares: gradients up to ~1e3,
    summed in another order)."""
    inp = _ssd_inputs(cp)
    mesh = _mesh(cp)

    def j_loss(x, dt, Bm, Cm, A, D):
        return jnp.sum(j_ssd.ssd_scan_cp(x, dt, A, Bm, Cm, D, mesh=mesh, chunk_size=16) ** 2)

    x, dt, A, Bm, Cm, D = inp
    jy = jax.jit(lambda *a: j_ssd.ssd_scan_cp(*a, mesh=mesh, chunk_size=16))(x, dt, A, Bm, Cm, D)
    jg = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2, 3, 4, 5)))(x, dt, Bm, Cm, A, D)
    tx, tdt, tA, tB, tC, tD = (_t(a) for a in inp)
    ty = t_ssd.ssd_scan_cp(tx, tdt, tA, tB, tC, tD, ring=LocalRing(cp), chunk_size=16)
    assert _err(ty, jy) <= 2e-5 * max(1.0, float(np.abs(np.asarray(jy)).max()))
    (ty ** 2).sum().backward()
    for got, want in zip((tx.grad, tdt.grad, tB.grad, tC.grad, tA.grad, tD.grad), jg):
        assert _err(got, want) <= 2e-5 * max(1.0, float(np.abs(np.asarray(want)).max()))


def test_ssd_scan_cp_bf16_matches_jax():
    """bf16 operands, fp32 state, cp=2: within JAX's bf16 tolerance of
    JAX's ssd_scan_cp."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(7)
    mesh = _mesh(2)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm)]
    jy = jax.jit(lambda *a: j_ssd.ssd_scan_cp(*a, mesh=mesh, chunk_size=32))(
        jb[0], dt, A, jb[1], jb[2], D)
    tb = [_t(a, torch.bfloat16, grad=False) for a in (x, Bm, Cm)]
    ty = t_ssd.ssd_scan_cp(tb[0], _t(dt, grad=False), _t(A, grad=False), tb[1], tb[2],
                           _t(D, grad=False), ring=LocalRing(2), chunk_size=32)
    assert ty.dtype == torch.bfloat16
    ref = np.asarray(jy.astype(jnp.float32))
    assert _err(ty, ref) <= 2e-2 * max(1.0, float(np.abs(ref).max()))


def test_ssd_scan_cp_one_rank_and_the_kernel_request(recwarn):
    """cp = 1 is ssd_scan with the kernel as asked; an explicit "pallas"
    under a context axis warns, as JAX's does, and runs the einsum core."""
    inp = [_t(a, grad=False) for a in _ssd_inputs(1, s=64)]
    want = t_ssd.ssd_scan(*inp, chunk_size=32, kernel="pallas")
    got = t_ssd.ssd_scan_cp(*inp, ring=LocalRing(1), chunk_size=32, kernel="pallas")
    assert torch.equal(got, want)
    assert torch.equal(t_ssd.ssd_scan_cp(*inp, ring=None, chunk_size=32, kernel="xla"),
                       t_ssd.ssd_scan(*inp, chunk_size=32, kernel="xla"))
    with pytest.warns(UserWarning, match="no cp implementation"):
        t_ssd.ssd_scan_cp(*inp, ring=LocalRing(2), chunk_size=32, kernel="pallas")
    with pytest.raises(ValueError, match="multiple of chunk"):
        t_ssd.ssd_scan_cp(*inp, ring=LocalRing(2), chunk_size=24)


# ---------------------------------------------------------------------------
# the conv halo, the rotary offset, the hybrid model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cp", [2, 4])
def test_conv_halo_matches_jax_full_sequence(cp):
    """The depthwise conv over a context-split sequence, each rank with
    the previous rank's last W - 1 rows: JAX's conv over the whole
    sequence, and its gradients (the halo's sent back)."""
    rng = np.random.default_rng(cp)
    x = rng.standard_normal((2, 32, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32)
    bias = rng.standard_normal((12,)).astype(np.float32)

    def j_loss(x, w, bias):
        return jnp.sum(j_ssd.causal_conv1d(x, w, bias) ** 2)

    jy = j_ssd.causal_conv1d(x, w, bias)
    jg = jax.grad(j_loss, argnums=(0, 1, 2))(x, w, bias)
    tx, tw, tb = _t(x), _t(w), _t(bias)
    ty = t_ssd.causal_conv1d_cp(tx, tw, tb, LocalRing(cp))
    assert _err(ty, jy) <= 2e-5
    (ty ** 2).sum().backward()
    for got, want in zip((tx.grad, tw.grad, tb.grad), jg):
        assert _err(got, want) <= 2e-5 * max(1.0, float(np.abs(want).max()))
    # the halo is what makes the first W - 1 positions of each chunk right
    alone = torch.cat([t_ssd.causal_conv1d(c, tw, tb) for c in tx.detach().chunk(cp, 1)], 1)
    assert _err(alone, jy) > 1e-2


@pytest.mark.parametrize("cp", [2, 4])
def test_rope_offset_rows_are_the_whole_tables(cp):
    """A context rank's rotary table, positions r * S / cp .., is those rows
    of the whole-sequence table (bitwise the port's, within 1e-6 JAX's: the
    two libraries' cos and sin differ in the last bit), and so is the
    rotated chunk."""
    s, hd = 64, 16
    jc, js = j_rope.rope_table(s, hd, 500000.0)
    whole = t_rope.rope_table(s, hd, 500000.0)
    q = np.random.default_rng(cp).standard_normal((1, s, 2, hd)).astype(np.float32)
    jq = np.asarray(j_rope.apply_rotary(jnp.asarray(q), jc, js))
    part = s // cp
    for r in range(cp):
        rows = slice(r * part, (r + 1) * part)
        tc, ts = t_rope.rope_table(part, hd, 500000.0, offset=r * part)
        assert torch.equal(tc, whole[0][rows]) and torch.equal(ts, whole[1][rows])
        assert _err(tc, np.asarray(jc)[rows]) <= 1e-6 and _err(ts, np.asarray(js)[rows]) <= 1e-6
        got = t_rope.apply_rotary(_t(q[:, rows], grad=False), tc, ts)
        assert _err(got, jq[:, rows]) <= 1e-5


def test_mamba_forward_with_a_local_ring_matches_jax():
    """The hybrid (SSD layers and one attention layer with partial rotary)
    with every context chunk in one process: the conv halo, ssd_scan_cp,
    rotary at each chunk's offset and ring attention together give JAX's
    whole-sequence forward, and its gradients flow."""
    kw = dict(d_model=64, d_intermediate=96, n_layer=3, vocab_size=256, attn_layer_idx=(1,),
              d_state=16, headdim=16, chunk_size=16)
    j_cfg = JMambaConfig(**kw, attn_cfg=JMambaAttnConfig(head_dim=16, num_heads=4,
                                                         num_heads_kv=2, rotary_emb_dim=8))
    cfg = MambaConfig(**kw, attn_cfg=MambaAttnConfig(head_dim=16, num_heads=4,
                                                     num_heads_kv=2, rotary_emb_dim=8))
    j_params = j_init_mamba(jax.random.PRNGKey(0), j_cfg)
    tokens = np.random.default_rng(1).integers(0, 256, size=(2, 64))
    ref = np.asarray(jax.jit(lambda p, t: j_mamba_forward(
        p, t, j_cfg, compute_dtype=jnp.float32, attn_impl="xla"))(j_params, jnp.asarray(tokens)))
    params = params_from_numpy(jax.tree.map(np.asarray, j_params))
    for cp in (2, 4):
        out = mamba_forward(params, torch.from_numpy(tokens), cfg,
                            compute_dtype=torch.float32, attn_impl="xla",
                            mamba_kernel="xla", ring=LocalRing(cp))
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=5e-4, rtol=1e-4)
