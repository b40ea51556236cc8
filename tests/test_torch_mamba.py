"""PyTorch port, Mamba2 hybrid training slice: held against the JAX
package on CPU.

Inputs come from numpy seeds and go through both packages; weights are
initialised by JAX and moved into the port with the bridge. Where the JAX
function reaches the Pallas SSD kernel it runs in interpret mode, as
tests/test_mamba.py runs it. Tolerances: fp32 ops at 2e-5 (the JAX tests'
own, tests/test_mamba.py:56), bf16 at 2e-2, the train step as stated on
its test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.models.mamba import init_mamba_params as j_init
from fms_fsdp_tpu.models.mamba import mamba_forward as j_forward
from fms_fsdp_tpu.ops import ssd as j_ssd
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu.utils import flops as j_flops
from fms_fsdp_tpu.utils.config_utils import get_model_config as j_get_model_config
from fms_fsdp_tpu.utils.config_utils import update_config as j_update_config
from fms_fsdp_tpu_torch.bridge import params_from_numpy, params_to_numpy
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.main_training_mamba import main
from fms_fsdp_tpu_torch.models import get_model_api
from fms_fsdp_tpu_torch.models.configs import MambaAttnConfig, MambaConfig
from fms_fsdp_tpu_torch.models.mamba import init_mamba_params, mamba_forward
from fms_fsdp_tpu_torch.ops import ssd
from fms_fsdp_tpu_torch.ops.fused_ce import cross_entropy_loss
from fms_fsdp_tpu_torch.train.step import make_train_step, state_from_params
from fms_fsdp_tpu_torch.utils import flops
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config

# tests/test_mamba.py:25-40: hybrid, 3 layers
_ATTN_KW = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_TINY_KW = dict(d_model=64, d_intermediate=128, n_layer=3, vocab_size=256,
                attn_layer_idx=(1,), d_state=16, d_conv=4, expand=2, headdim=16,
                chunk_size=16, pad_vocab_size_multiple=16)
J_TINY = JMambaConfig(attn_cfg=JMambaAttnConfig(**_ATTN_KW), **_TINY_KW)
TINY = MambaConfig(attn_cfg=MambaAttnConfig(**_ATTN_KW), **_TINY_KW)
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop this module's JAX traces when it ends: a later module in the
    same process that traces the same step on an equal mesh would
    otherwise reuse them, and a compiled program's metadata names the
    stack that traced it."""
    yield
    jax.clear_caches()


def _err(port, ref):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max())


def _scan_inputs(seed, groups, B=2, S=64, H=4, P=8, N=16):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(B, S, H, P)).astype(np.float32),
        dt=(np.abs(rng.normal(size=(B, S, H))) * 0.1 + 0.01).astype(np.float32),
        A=-(np.abs(rng.normal(size=(H,))) + 0.5).astype(np.float32),
        Bm=rng.normal(size=(B, S, groups, N)).astype(np.float32),
        Cm=rng.normal(size=(B, S, groups, N)).astype(np.float32),
        D=rng.normal(size=(H,)).astype(np.float32),
    )


_ORDER = ("x", "dt", "A", "Bm", "Cm", "D")


def _j(inp, dtype=jnp.float32):
    cast = {"x", "Bm", "Cm"}
    return [jnp.asarray(inp[k], dtype if k in cast else jnp.float32) for k in _ORDER]


def _t(inp, dtype=torch.float32):
    cast = {"x", "Bm", "Cm"}
    return [torch.from_numpy(inp[k]).to(dtype if k in cast else torch.float32)
            for k in _ORDER]


# ---------------------------------------------------------------------------
# ops/ssd.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activation", ["silu", None])
def test_causal_conv1d_matches_jax(activation):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    ref = j_ssd.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              activation=activation)
    out = ssd.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), activation=activation)
    assert _err(out, ref) <= 2e-5
    # causal: a change at position 10 leaves the outputs before it alone
    x2 = x.copy()
    x2[0, 10] = 99.0
    out2 = ssd.causal_conv1d(torch.from_numpy(x2), torch.from_numpy(w),
                             torch.from_numpy(b), activation=activation)
    assert torch.equal(out[0, :10], out2[0, :10])
    assert not torch.allclose(out[0, 10:14], out2[0, 10:14])


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_scan_reference_matches_jax(groups):
    inp = _scan_inputs(0, groups)
    ref = j_ssd.ssd_scan_reference(*_j(inp))
    out = ssd.ssd_scan_reference(*_t(inp))
    assert _err(out, ref) <= 2e-5
    via = ssd.ssd_scan(*_t(inp), kernel="reference")
    assert torch.equal(via, out)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_scan_xla_matches_jax(groups, chunk):
    inp = _scan_inputs(0, groups)
    ref = j_ssd.ssd_scan(*_j(inp), chunk_size=chunk, kernel="xla")
    out = ssd.ssd_scan(*_t(inp), chunk_size=chunk, kernel="xla")
    assert _err(out, ref) <= 2e-5
    # and the chunked form against the recurrence, as tests/test_mamba.py
    assert _err(out, j_ssd.ssd_scan_reference(*_j(inp))) <= 2e-5


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("kernel", ["pallas", "auto"])
def test_ssd_scan_kernel_route_matches_jax_pallas(groups, kernel):
    """On CPU tensors "pallas" and "auto" run the kernel's plain version;
    JAX's "pallas" runs the Pallas kernel in interpret mode."""
    inp = _scan_inputs(3, groups)
    ref = j_ssd.ssd_scan(*_j(inp), chunk_size=16, kernel="pallas")
    ssd.reset_launches()
    out = ssd.ssd_scan(*_t(inp), chunk_size=16, kernel=kernel)
    assert _err(out, ref) <= 2e-5
    assert ssd.LAUNCHES == {"fused": 0}  # no kernel launches on the CPU


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_core_plain_matches_jax_pallas_core(groups):
    inp = _scan_inputs(4, groups)
    jx, jdt, jA, jB, jC, _ = _j(inp)
    ja = jdt * jA[None, None, :]
    ref = j_ssd._ssd_core_pallas(jx, jdt, ja, jB, jC, 16, True)
    x, dt, A, Bm, Cm, _ = _t(inp)
    out = ssd.ssd_core_plain(x, dt, dt * A[None, None, :], Bm, Cm, 16)
    assert out.dtype == torch.float32
    assert _err(out, ref) <= 2e-5
    y, state = ssd._ssd_core_xla(x, dt, dt * A[None, None, :], Bm, Cm, 16,
                                 return_state=True)
    jy, jstate = j_ssd._ssd_core_xla(jx, jdt, ja, jB, jC, 16, return_state=True)
    assert _err(y, jy) <= 2e-5 and _err(state, jstate) <= 2e-5


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_ssd_scan_gradients_match_jax(groups, kernel):
    """x, dt, B, C gradients of mean(y^2) against JAX's through the same
    route (the Pallas route's backward is the chunked einsums in both)."""
    inp = _scan_inputs(3, groups)
    jx, jdt, jA, jB, jC, jD = _j(inp)

    def j_loss(x, dt, Bm, Cm):
        return (j_ssd.ssd_scan(x, dt, jA, Bm, Cm, jD, chunk_size=16,
                               kernel=kernel) ** 2).mean()

    refs = jax.grad(j_loss, argnums=(0, 1, 2, 3))(jx, jdt, jB, jC)
    x, dt, A, Bm, Cm, D = _t(inp)
    leaves = [x, dt, Bm, Cm]
    for t in leaves:
        t.requires_grad_()
    (ssd.ssd_scan(x, dt, A, Bm, Cm, D, chunk_size=16, kernel=kernel) ** 2).mean().backward()
    for t, ref in zip(leaves, refs):
        assert _err(t.grad, ref) <= 2e-5


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_backward_equals_autograd(groups):
    """The scan's own backward (a chunk at a time, the state's cotangent
    carried backwards) against autograd through the whole chunk loop, for
    a cotangent that reaches only some inputs too."""
    inp = _scan_inputs(6, groups)
    x, dt, A, Bm, Cm, _ = _t(inp)
    a = dt * A[None, None, :]
    cot = torch.from_numpy(np.random.default_rng(7).normal(size=x.shape).astype(np.float32))
    for needs in ([True] * 5, [True, False, False, True, False]):
        leaves = [t.clone().requires_grad_(n) for t, n in zip((x, dt, a, Bm, Cm), needs)]
        y = ssd._ssd_core_xla(*leaves, 16)
        want = torch.autograd.grad(y, [t for t in leaves if t.requires_grad], cot)
        got = ssd._ssd_core_xla_backward((x, dt, a, Bm, Cm), 16, cot, needs)
        assert [g is not None for g in got] == needs
        for g, w in zip([g for g in got if g is not None], want):
            assert torch.allclose(g, w, atol=1e-5, rtol=1e-5)


def test_ssd_scan_bf16_matches_jax_pallas():
    inp = _scan_inputs(5, 1)
    ref = j_ssd.ssd_scan(*_j(inp, jnp.bfloat16), chunk_size=16, kernel="pallas")
    out = ssd.ssd_scan(*_t(inp, torch.bfloat16), chunk_size=16, kernel="pallas")
    assert out.dtype == torch.bfloat16
    # the outputs reach |y| ~ 8, where one bf16 step is 0.03: 2e-2 of the
    # largest value, under one step there
    ref = np.asarray(ref.astype(jnp.float32))
    assert _err(out, ref) <= 2e-2 * max(1.0, float(np.abs(ref).max()))


def test_ssd_scan_refusals():
    inp = _scan_inputs(0, 1)
    with pytest.raises(ValueError, match="unknown ssd kernel"):
        ssd.ssd_scan(*_t(inp), kernel="triton")
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd.ssd_scan(*_t(inp), chunk_size=48)
    # the context-parallel scan runs: one rank is ssd_scan, two ranks (every
    # chunk in this process) its einsum core from a zero state per rank
    # plus the carried-state correction
    from fms_fsdp_tpu_torch.ops.ring_attention import LocalRing

    whole = ssd.ssd_scan(*_t(inp), chunk_size=16, kernel="xla")
    assert torch.equal(ssd.ssd_scan_cp(*_t(inp), ring=LocalRing(1), chunk_size=16,
                                       kernel="xla"), whole)
    assert _err(ssd.ssd_scan_cp(*_t(inp), ring=LocalRing(2), chunk_size=16),
                whole.numpy()) <= 2e-5
    # the kernel's own shape rule
    assert ssd.supports((2, 4096, 128, 64), (2, 4096, 1, 128), 256)
    assert ssd.supports((2, 512, 16, 64), (2, 512, 8, 128), 64)
    assert not ssd.supports((2, 64, 4, 8), (2, 64, 1, 16), 16)
    assert not ssd.supports((2, 4096, 128, 64), (2, 4096, 1, 128), 512)
    assert not ssd.supports((2, 4096, 128, 64), (2, 4096, 3, 128), 256)


# ---------------------------------------------------------------------------
# models/mamba.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), J_TINY))


def _tokens(seed, rows, seq=SEQ, vocab=256):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(rows, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_init_mamba_params_matches_jax_tree(np_params):
    params = init_mamba_params(torch.Generator().manual_seed(0), TINY)
    assert _shapes(params) == _shapes(np_params)
    assert isinstance(params["layers"], list)
    n = sum(t.numel() for t in _leaves(params))
    assert n == TINY.n_params() == J_TINY.n_params()
    mixer = params["layers"][0]["mixer"]
    # the recipes: A in [1, 16], dt = softplus(dt_bias) in [1e-3, 1e-1]
    assert (mixer["A_log"].exp() >= 1).all() and (mixer["A_log"].exp() <= 16).all()
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert (dt >= 1e-3 * 0.999).all() and (dt <= 1e-1 * 1.001).all()
    assert mixer["conv_w"].std() > 5 * params["layers"][0]["mlp"]["w1"].std()
    assert torch.equal(mixer["D"], torch.ones(TINY.nheads))
    # the bridge round trip keeps the list nesting
    back = params_from_numpy(params_to_numpy(params))
    assert _shapes(back) == _shapes(params)
    assert torch.equal(back["layers"][2]["mixer"]["in_proj"],
                       params["layers"][2]["mixer"]["in_proj"])


@pytest.mark.parametrize("kernel", ["xla", "pallas", "reference"])
def test_mamba_forward_matches_jax(np_params, kernel):
    inputs, _ = _tokens(2, 2)
    ref = j_forward(np_params, jnp.asarray(inputs), J_TINY, compute_dtype=jnp.float32,
                    attn_impl="xla", mamba_kernel=kernel)
    out = mamba_forward(params_from_numpy(np_params), torch.from_numpy(inputs).long(),
                        TINY, compute_dtype=torch.float32, attn_impl="xla",
                        mamba_kernel=kernel)
    assert out.shape == (2, SEQ, TINY.padded_vocab_size)
    scale = float(np.abs(np.asarray(ref)).max())
    assert _err(out, ref) <= 2e-5 * max(1.0, scale)


def test_mamba_forward_hidden_and_bf16(np_params):
    inputs, _ = _tokens(2, 2)
    params = params_from_numpy(np_params)
    hidden = mamba_forward(params, torch.from_numpy(inputs).long(), TINY,
                           compute_dtype=torch.float32, attn_impl="xla",
                           return_hidden=True)
    jh = j_forward(np_params, jnp.asarray(inputs), J_TINY, compute_dtype=jnp.float32,
                   attn_impl="xla", return_hidden=True)
    assert _err(hidden, jh) <= 2e-5
    # bf16: the whole tree is cast first in both packages
    ref = j_forward(np_params, jnp.asarray(inputs), J_TINY, compute_dtype=jnp.bfloat16,
                    attn_impl="xla")
    out = mamba_forward(params, torch.from_numpy(inputs).long(), TINY,
                        compute_dtype=torch.bfloat16, attn_impl="xla")
    assert out.dtype == torch.bfloat16
    assert _err(out, np.asarray(ref.astype(jnp.float32))) <= 2e-2
    # int8 GEMMs (tests/test_torch_quant_training.py holds them against
    # JAX's): logits near the exact ones; an unknown mode raises
    q8 = mamba_forward(params, torch.from_numpy(inputs).long(), TINY, quant="int8",
                       compute_dtype=torch.float32, attn_impl="xla")
    exact = mamba_forward(params, torch.from_numpy(inputs).long(), TINY,
                          compute_dtype=torch.float32, attn_impl="xla")
    assert 0 < float((q8 - exact).abs().max()) <= 0.05 * float(exact.abs().max())
    with pytest.raises(ValueError, match="quantized_matmuls"):
        mamba_forward(params, torch.from_numpy(inputs).long(), TINY, quant="int4")


def test_mamba_forward_is_causal(np_params):
    inputs, _ = _tokens(3, 1)
    params = params_from_numpy(np_params)
    kw = dict(compute_dtype=torch.float32, attn_impl="xla")
    a = mamba_forward(params, torch.from_numpy(inputs).long(), TINY, **kw)
    inputs[0, 20] = (inputs[0, 20] + 1) % 256
    b = mamba_forward(params, torch.from_numpy(inputs).long(), TINY, **kw)
    assert torch.allclose(a[0, :20], b[0, :20], atol=1e-4)
    assert not torch.allclose(a[0, 20:], b[0, 20:])


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_mamba_forward_ac_mask_changes_nothing(np_params, kernel):
    """A mixed remat mask gives the same loss and gradients as none."""
    inputs, labels = _tokens(3, 2)
    outs = []
    for mask in (None, [True, False, True]):
        params = params_from_numpy(np_params)
        leaves = [params["lm_head"], params["layers"][0]["mixer"]["in_proj"],
                  params["layers"][0]["mixer"]["A_log"],
                  params["layers"][1]["mixer"]["wq"], params["layers"][2]["mlp"]["w2"]]
        for t in leaves:
            t.requires_grad_()
        logits = mamba_forward(params, torch.from_numpy(inputs).long(), TINY,
                               compute_dtype=torch.float32, attn_impl="xla",
                               ac_mask=mask, mamba_kernel=kernel)
        loss = cross_entropy_loss(logits, torch.from_numpy(labels))
        loss.backward()
        outs.append([loss.detach()] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        assert torch.allclose(a, b, atol=1e-6, rtol=0)


def test_get_model_api_dispatches_mamba():
    init_fn, forward_fn, n_layers = get_model_api(TINY)
    assert init_fn is init_mamba_params and forward_fn is mamba_forward
    assert n_layers == 3


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

_STEP_KW = dict(seq_length=SEQ, batch_size=8, num_steps=20, vocab_size=256,
                attention_kernel="xla", sharding_strategy="fsdp", learning_rate=1e-3)


def _run_both(cfg_kw, n_steps):
    jcfg = JTrainConfig(**cfg_kw)
    mesh = build_mesh(MeshConfig.from_train_config(jcfg))
    opt = j_step.make_optimizer(jcfg)
    jstate, _ = j_step.init_train_state(jax.random.PRNGKey(0), J_TINY, jcfg, mesh, opt)
    jfn = j_step.make_train_step(J_TINY, jcfg, mesh, opt)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]))
    tstate = state_from_params(params, TrainConfig(**cfg_kw))
    tfn = make_train_step(TINY, TrainConfig(**cfg_kw))
    rows = []
    for i in range(n_steps):
        inputs, labels = _tokens(10 + i, 8)
        jstate, jm = jfn(jstate, (jnp.asarray(inputs), jnp.asarray(labels)))
        tm = tfn(tstate, (torch.from_numpy(inputs).long(), torch.from_numpy(labels).long()))
        rows.append(({k: float(jm[k]) for k in ("loss", "gnorm", "lr")},
                     {k: float(tm[k]) for k in ("loss", "gnorm", "lr")}))
    return rows


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_mamba_train_step_matches_jax_fp32(kernel):
    """Three fp32 steps of the hybrid TINY model from the same weights and
    tokens, with selective AC 1/2. JAX's step runs over the 8-device CPU
    mesh of tests/conftest.py (batch 8), so its sums go in another order;
    loss and gnorm within 1e-5 relative."""
    rows = _run_both(dict(_STEP_KW, mixed_precision=False, mamba_kernel=kernel,
                          fsdp_activation_checkpointing=True,
                          selective_checkpointing=0.5), 3)
    for i, (j, t) in enumerate(rows):
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6, abs=1e-12), i
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5), (i, j, t)
        assert t["gnorm"] == pytest.approx(j["gnorm"], rel=1e-5), (i, j, t)
    # the weights moved: each step sees new random tokens, so the loss
    # need not fall, but it is not the first step's
    assert rows[-1][1]["loss"] != rows[0][1]["loss"]


def test_mamba_train_step_matches_jax_bf16_policy():
    """One bfSixteen step (fp32 params, bf16 forward and grads; A_log,
    dt_bias, D and the norms rounded to bf16 first in both packages). bf16
    rounds at other places in the two frameworks: 1e-3 relative on the
    loss; the gradient norm, a sum over bf16 gradients, at 1e-2."""
    (j, t), = _run_both(dict(_STEP_KW, mixed_precision=True), 1)
    assert t["loss"] == pytest.approx(j["loss"], rel=1e-3)
    assert t["gnorm"] == pytest.approx(j["gnorm"], rel=1e-2)


def test_mamba_optimizer_walks_every_leaf_once(np_params):
    params = params_from_numpy(np_params)
    state = state_from_params(params, TrainConfig(**_STEP_KW))
    held = state["optimizer"].param_groups[0]["params"]
    assert len(held) == len(_leaves(params))
    assert {t.data_ptr() for t in held} == {t.data_ptr() for t in _leaves(params)}
    assert sum(t.numel() for t in held) == TINY.n_params()


# ---------------------------------------------------------------------------
# the entry point, the variant table, the FLOPs model
# ---------------------------------------------------------------------------

_ENTRY_OVERRIDES = {
    "MambaConfig.d_model": 64, "MambaConfig.d_intermediate": 128,
    "MambaConfig.n_layer": 3, "MambaConfig.attn_layer_idx": (1,),
    "MambaConfig.vocab_size": 256, "MambaConfig.d_state": 16,
    "MambaConfig.headdim": 16, "MambaConfig.chunk_size": 16,
    "MambaConfig.attn_cfg": MambaAttnConfig(**_ATTN_KW),
}


def test_mamba_entry_trains_on_cpu(capsys, tmp_path):
    out = main(device="cpu", use_dummy_dataset=True, num_steps=4, report_interval=2,
               ckpt_save_path=str(tmp_path), ckpt_load_path=str(tmp_path),
               batch_size=2, seq_length=SEQ, vocab_size=256, learning_rate=1e-3,
               attention_kernel="xla", fsdp_activation_checkpointing=True,
               selective_checkpointing=0.5, **_ENTRY_OVERRIDES)
    assert isinstance(out["model_cfg"], MambaConfig)
    assert out["model_cfg"].n_layer == 3 and out["model_cfg"].attn_layer_idx == (1,)
    assert out["cfg"].model_variant == "mamba_9.8b"
    losses = [r["loss"] for r in out["reports"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert out["skipped_batches"] == 0
    assert "step: 4" in capsys.readouterr().out


def test_mamba_entry_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would train on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(use_dummy_dataset=True, num_steps=1, **_ENTRY_OVERRIDES)


def test_mamba_variant_and_overrides_match_jax():
    argv = ["--model_variant=mamba_9.8b", "--MambaConfig.n_layer=6",
            "--MambaConfig.attn_layer_idx=(3,)", "--mamba_kernel=pallas"]
    kw = parse_cli_args(argv)
    assert kw["MambaConfig.attn_layer_idx"] == (3,)
    m, jm = get_model_config("mamba_9.8b"), j_get_model_config("mamba_9.8b")
    assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    assert m.n_params() == jm.n_params() and m.nheads == jm.nheads == 128
    assert m.padded_vocab_size == jm.padded_vocab_size == 128256
    assert m.d_inner == jm.d_inner == 8192
    update_config(m, **kw)
    j_update_config(jm, **kw)
    assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    assert m.n_layer == 6 and m.attn_layer_idx == (3,)
    assert m.n_params() == jm.n_params()
    cfg = TrainConfig()
    update_config(cfg, **kw)
    assert cfg.mamba_kernel == "pallas"


@pytest.mark.parametrize("seq", [256, 4096])
def test_mamba_flops_match_jax(seq):
    m, jm = get_model_config("mamba_9.8b"), j_get_model_config("mamba_9.8b")
    assert flops.mamba_matmul_params(m) == j_flops.mamba_matmul_params(jm)
    assert flops.mamba_fwd_flops_per_token(m, seq) == j_flops.mamba_fwd_flops_per_token(jm, seq)
    for ac in (0.0, 0.5):
        assert (flops.mamba_train_flops_per_token(m, seq, ac)
                == j_flops.mamba_train_flops_per_token(jm, seq, ac))
        assert (flops.train_flops_per_token(m, seq, ac)
                == j_flops.train_flops_per_token(jm, seq, ac))
    llama = get_model_config("llama3_8b_4k")
    assert (flops.train_flops_per_token(llama, seq)
            == flops.llama_train_flops_per_token(llama, seq))
