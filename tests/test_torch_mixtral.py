"""PyTorch port, Mixtral slice (training): held against the JAX package
on the CPU.

Inputs come from numpy seeds and go through both packages; weights are
initialised by JAX (the TINY sizes of tests/test_mixtral_train.py) and
moved into the port with the bridge. Tolerances: fp32 logits 1e-5
absolute, the routing stats as JAX's, the train step as
tests/test_torch_training.py holds Llama's (1e-5 relative in fp32, 1e-3
under the bf16 policy).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models import mixtral as jm
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu.utils import flops as j_flops
from fms_fsdp_tpu.utils.config_utils import get_model_config as j_get_model_config
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.main_training_mixtral import main
from fms_fsdp_tpu_torch.models import get_model_api
from fms_fsdp_tpu_torch.models import mixtral as tm
from fms_fsdp_tpu_torch.models.configs import MixtralConfig
from fms_fsdp_tpu_torch.ops.fused_ce import cross_entropy_loss
from fms_fsdp_tpu_torch.train.step import make_train_step, state_from_params
from fms_fsdp_tpu_torch.utils import flops
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config

TINY = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
            hidden_dim=96, num_experts=4, top_k=2, max_expected_seq_len=64)
SEQ = 32
# the entry's overrides: the TINY model through the CLI's dotted keys
ENTRY_OVERRIDES = {f"MixtralConfig.{k}": v for k, v in TINY.items()}


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _cfgs(**kw):
    return JMixtralConfig(**TINY, **kw), MixtralConfig(**TINY, **kw)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jm.init_mixtral_params(jax.random.PRNGKey(0),
                                                           JMixtralConfig(**TINY)))


def _tokens(seed, rows, seq=SEQ, vocab=128):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(rows, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _err(port, ref):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max())


def _layer(seed, cfg, d, scale_gate=0.5):
    rng = np.random.default_rng(seed)
    E, h = cfg.num_experts, cfg.hidden_dim
    return {
        "gate": (scale_gate * rng.standard_normal((d, E))).astype(np.float32),
        "w1": (0.1 * rng.standard_normal((E, d, h))).astype(np.float32),
        "w3": (0.1 * rng.standard_normal((E, d, h))).astype(np.float32),
        "w2": (0.1 * rng.standard_normal((E, h, d))).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
@pytest.mark.parametrize("impl", ["dense", "dispatch", "dispatch_einsum"])
def test_forward_matches_jax(np_params, impl, capacity_factor):
    """fp32 logits within 1e-5; balance and drop_frac as JAX's. At
    capacity factor 8 nothing drops; at 0.5 about half the choices do."""
    jcfg, cfg = _cfgs(capacity_factor=capacity_factor)
    inputs, _ = _tokens(1, 2)
    ref, j_aux = jm.mixtral_forward(np_params, jnp.asarray(inputs), jcfg,
                                    compute_dtype=jnp.float32, moe_impl=impl,
                                    return_aux=True)
    out, aux = tm.mixtral_forward(params_from_numpy(np_params),
                                  torch.from_numpy(inputs).long(), cfg,
                                  compute_dtype=torch.float32, attn_impl="xla",
                                  moe_impl=impl, return_aux=True)
    assert _err(out, ref) <= 1e-5
    assert float(aux["balance"]) == pytest.approx(float(j_aux["balance"]), rel=1e-6)
    assert float(aux["drop_frac"]) == float(j_aux["drop_frac"])
    dropping = impl != "dense" and capacity_factor < 1
    assert (float(aux["drop_frac"]) > 0) == dropping
    hidden = tm.mixtral_forward(params_from_numpy(np_params),
                                torch.from_numpy(inputs).long(), cfg,
                                compute_dtype=torch.float32, attn_impl="xla",
                                moe_impl=impl, return_hidden=True)
    jh = jm.mixtral_forward(np_params, jnp.asarray(inputs), jcfg,
                            compute_dtype=jnp.float32, moe_impl=impl, return_hidden=True)
    assert _err(hidden, jh) <= 1e-5


def test_scatter_dispatch_matches_einsum_oracle_with_drops():
    """The scatter/gather dispatch against the one-hot einsum oracle
    (the port's and JAX's) at a capacity that drops, outputs and the
    gradients of h and every weight."""
    jcfg, cfg = _cfgs(capacity_factor=0.5)
    D = cfg.emb_dim
    h = np.random.default_rng(3).standard_normal((2, 16, D)).astype(np.float32)
    lp = _layer(4, cfg, D)
    j_ref, j_stats = jm._moe_ffn_dispatch_einsum(jnp.asarray(h), lp, jcfg, mesh=None)
    assert float(j_stats["drop_frac"]) > 0

    def run(fn):
        th = torch.from_numpy(h).requires_grad_()
        tl = {k: torch.from_numpy(v).requires_grad_() for k, v in lp.items()}
        y, route = fn(th, tl, cfg)
        (y.square().sum() + route["probs"].square().sum()).backward()
        return y.detach(), route, [th.grad] + [tl[k].grad for k in sorted(tl)]

    y_s, route_s, g_s = run(tm._moe_ffn_dispatch)
    y_e, route_e, g_e = run(tm._moe_ffn_dispatch_einsum)
    assert _err(y_s, j_ref) <= 1e-5 and _err(y_e, j_ref) <= 1e-5
    for a, b in zip(g_s, g_e):
        assert torch.allclose(a, b, atol=1e-5, rtol=0)
    for key in ("counts", "kept"):
        assert torch.equal(route_s[key], route_e[key])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_router_ties_take_the_lower_index(dtype):
    """Experts 1, 2 and 3 get identical gate columns, so every token's
    router ties them; ``lax.top_k`` puts the lower index first and the
    port must too, in both compute dtypes. Then the whole dispatch, whose
    slot claims follow the choice order, against JAX's at a capacity that
    drops."""
    jcfg, cfg = _cfgs(capacity_factor=0.5)
    D = cfg.emb_dim
    rng = np.random.default_rng(5)
    gate = np.zeros((D, 4), np.float32)
    col = (np.abs(rng.standard_normal(D)) + 0.1).astype(np.float32)
    gate[:, 1] = gate[:, 2] = gate[:, 3] = col
    gate[:, 0] = -col
    h = np.abs(rng.standard_normal((2, 16, D))).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j_idx, j_w, _ = jm._router(jnp.asarray(h, jdt), jnp.asarray(gate, jdt), jcfg)
    t_idx, t_w, _ = tm._router(torch.from_numpy(h).to(dtype),
                               torch.from_numpy(gate).to(dtype), cfg)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert (t_idx.numpy() == [1, 2]).all()
    assert _err(t_w, j_w) <= 1e-6
    # ties among random bf16-rounded values: equal picks, lower index first
    probs = torch.from_numpy(rng.integers(0, 3, size=(64, 8)).astype(np.float32) / 4)
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1])
    np.testing.assert_array_equal(tm.top_k_lower_first(probs, 3).numpy(), want)
    lp = dict(_layer(6, cfg, D), gate=gate)
    j_y, j_stats = jm._moe_ffn_dispatch(jnp.asarray(h), lp, jcfg, mesh=None)
    t_y, route = tm._moe_ffn_dispatch(torch.from_numpy(h),
                                      {k: torch.from_numpy(v) for k, v in lp.items()}, cfg)
    assert _err(t_y, j_y) <= 1e-5
    stats = tm.moe_stats({k: v[None] if k != "tokens" else v for k, v in route.items()},
                         cfg)
    assert float(stats["drop_frac"]) == float(j_stats["drop_frac"]) > 0


def test_aux_loss_at_uniform_routing():
    """A uniform router (zero gate) gives f.p = 1/E per expert: the
    balance term is aux_loss_weight (JAX's tests/test_mixtral_train.py)."""
    _, cfg = _cfgs(aux_loss_weight=0.02)
    D, E, H = cfg.emb_dim, cfg.num_experts, cfg.hidden_dim
    h = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 8, D)).astype(np.float32))
    lp = {"gate": torch.zeros(D, E), "w1": torch.zeros(E, D, H),
          "w3": torch.zeros(E, D, H), "w2": torch.zeros(E, H, D)}
    _, route = tm._moe_ffn_dense(h, lp, cfg)
    stats = tm.moe_stats({k: v[None] if k != "tokens" else v for k, v in route.items()},
                         cfg)
    assert float(stats["balance"]) == pytest.approx(cfg.aux_loss_weight, abs=1e-6)
    assert float(stats["drop_frac"]) == 0.0


def test_forward_ac_mask_changes_nothing(np_params):
    """A mixed remat mask gives the same logits, balance and gradients as
    none, through the dispatch path."""
    _, cfg = _cfgs()
    inputs, labels = _tokens(8, 2)
    outs = []
    for mask in (None, [True, False]):
        params = params_from_numpy(np_params)
        leaves = [params["lm_head"], params["layers"]["gate"], params["layers"]["w1"],
                  params["layers"]["wq"]]
        for t in leaves:
            t.requires_grad_()
        logits, aux = tm.mixtral_forward(params, torch.from_numpy(inputs).long(), cfg,
                                         compute_dtype=torch.float32, attn_impl="xla",
                                         ac_mask=mask, moe_impl="dispatch",
                                         return_aux=True)
        (cross_entropy_loss(logits, torch.from_numpy(labels)) + aux["balance"]).backward()
        outs.append([logits.detach(), aux["balance"].detach()] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        assert torch.allclose(a, b, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the registry and the FLOPs
# ---------------------------------------------------------------------------


def test_registry_and_flops_match_jax():
    port, ref = get_model_config("mixtral_8x7b"), j_get_model_config("mixtral_8x7b")
    assert isinstance(port, MixtralConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_params() == ref.n_params() and 46e9 < port.n_params() < 47.5e9
    assert port.n_params(include_embeddings=False) == ref.n_params(include_embeddings=False)
    init, fwd, n = get_model_api(port)
    assert (init, fwd, n) == (tm.init_mixtral_params, tm.mixtral_forward, 32)
    for cfg, jcfg in ((port, ref), _cfgs()[::-1]):
        assert flops.mixtral_matmul_params_active(cfg) == \
            j_flops.mixtral_matmul_params_active(jcfg)
        for seq, ac in ((32, 0.0), (4096, 0.5), (4096, 1.0)):
            assert flops.train_flops_per_token(cfg, seq, ac) == \
                j_flops.train_flops_per_token(jcfg, seq, ac)


def test_init_draws_one_layer_at_a_time_in_the_dtype():
    """The port's init: JAX's shapes and names, the dtype asked for."""
    _, cfg = _cfgs()
    params = tm.init_mixtral_params(torch.Generator().manual_seed(0), cfg,
                                    dtype=torch.bfloat16)
    ref = jm.init_mixtral_params(jax.random.PRNGKey(0), JMixtralConfig(**TINY))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        t = params[keys[0]] if len(keys) == 1 else params[keys[0]][keys[1]]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16, keys
    w1 = params["layers"]["w1"].float()
    assert 0.015 < float(w1.std()) < 0.025 and float(w1.abs().max()) <= 0.0601  # 3 std, bf16-rounded


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

_STEP_KW = dict(seq_length=SEQ, batch_size=8, num_steps=20, vocab_size=128,
                attention_kernel="xla", sharding_strategy="fsdp", learning_rate=1e-2)


def _run_both(cfg_kw, n_steps):
    jcfg, mcfg = _cfgs()
    cfg = JTrainConfig(**cfg_kw)
    mesh = build_mesh(MeshConfig.from_train_config(cfg))
    opt = j_step.make_optimizer(cfg)
    jstate, _ = j_step.init_train_state(jax.random.PRNGKey(0), jcfg, cfg, mesh, opt)
    jfn = j_step.make_train_step(jcfg, cfg, mesh, opt)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]))
    tstate = state_from_params(params, TrainConfig(**cfg_kw))
    tfn = make_train_step(mcfg, TrainConfig(**cfg_kw))
    rows = []
    keys = ("loss", "gnorm", "lr", "moe_drop_frac")
    for i in range(n_steps):
        inputs, labels = _tokens(10 + i, 8)
        jstate, jm_ = jfn(jstate, (jnp.asarray(inputs), jnp.asarray(labels)))
        tm_ = tfn(tstate, (torch.from_numpy(inputs).long(), torch.from_numpy(labels).long()))
        rows.append(({k: float(jm_[k]) for k in keys}, {k: float(tm_[k]) for k in keys}))
    return rows


def test_train_step_matches_jax_fp32():
    """Three fp32 steps from the same weights and tokens, the balance term
    in the loss, at the dispatch's default capacity (factor 2)."""
    rows = _run_both(dict(_STEP_KW, mixed_precision=False), 3)
    for i, (j, t) in enumerate(rows):
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6, abs=1e-12), i
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5), (i, j, t)
        assert t["gnorm"] == pytest.approx(j["gnorm"], rel=1e-5), (i, j, t)
        assert t["moe_drop_frac"] == pytest.approx(j["moe_drop_frac"], abs=1e-7), (i, j, t)


def test_train_step_matches_jax_bf16_policy():
    """One bfSixteen step (fp32 params, bf16 forward and grads), as
    tests/test_torch_training.py holds Llama's: 1e-3 relative."""
    (j, t), = _run_both(dict(_STEP_KW, mixed_precision=True), 1)
    assert t["loss"] == pytest.approx(j["loss"], rel=1e-3)
    assert t["gnorm"] == pytest.approx(j["gnorm"], rel=1e-3)


def test_train_step_ac_mask_changes_nothing(np_params):
    """Two fp32 steps with AC on every other layer equal two without."""
    _, mcfg = _cfgs()
    outs = []
    for ac in (False, True):
        cfg = TrainConfig(**dict(_STEP_KW, mixed_precision=False,
                                 fsdp_activation_checkpointing=ac,
                                 selective_checkpointing=0.5))
        state = state_from_params(params_from_numpy(np_params), cfg)
        step = make_train_step(mcfg, cfg)
        ms = []
        for i in range(2):
            inputs, labels = _tokens(30 + i, 4)
            ms.append(step(state, (torch.from_numpy(inputs).long(),
                                   torch.from_numpy(labels).long())))
        outs.append(([float(m["loss"]) for m in ms], state["params"]["layers"]["w1"].clone()))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    assert torch.allclose(outs[0][1], outs[1][1], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

# JAX's report lines in its order (tests/test_obs.py:737-741), then the
# family's metric
_LABELS = [
    "step:", "loss:", "LR:", "tokens seen:", "gradient norm:",
    "reserved memory:", "allocated memory:", "current step time:",
    "overall step time:", "current token per chip per sec:",
    "overall token per chip per sec:", "overall token per day:", "moe_drop_frac:",
]


def test_entry_trains_on_cpu(capsys, tmp_path):
    """The Mixtral entry: 4 steps with AC 1/2 at report interval 2; finite
    falling loss, JAX's report lines with ``moe_drop_frac`` last, and the
    drop fraction in each report and record."""
    out = main(device="cpu", use_dummy_dataset=True, ckpt_save_path=str(tmp_path),
               ckpt_load_path=str(tmp_path), num_steps=4, report_interval=2,
               batch_size=2, seq_length=SEQ, vocab_size=128, learning_rate=1e-2,
               fsdp_activation_checkpointing=True, selective_checkpointing=0.5,
               **ENTRY_OVERRIDES)
    assert isinstance(out["model_cfg"], MixtralConfig)
    assert out["model_cfg"].emb_dim == 64 and out["model_cfg"].num_experts == 4
    losses = [r["loss"] for r in out["reports"]]
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(0.0 <= r["moe_drop_frac"] < 1.0 for r in out["reports"])
    printed = capsys.readouterr().out
    labels = [lbl for ln in printed.splitlines() for lbl in _LABELS if ln.startswith(lbl)]
    assert labels == 2 * _LABELS, printed
    # the params the entry trained are JAX's layout: a Mixtral train state
    assert set(out["state"]["params"]["layers"]) >= {"gate", "w1", "w2", "w3"}


def test_entry_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would train on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(use_dummy_dataset=True, num_steps=1, **ENTRY_OVERRIDES)


@pytest.mark.parametrize("overrides,item", [
    ({"expert_parallel_size": 2}, "A.4b"),
    ({"quantized_matmuls": "int8"}, "A.7"),
    ({"context_parallel_size": 2}, "A.8"),
])
def test_unported_options_raise(overrides, item):
    with pytest.raises(NotImplementedError, match=item):
        main(device="cpu", use_dummy_dataset=True, num_steps=4, **overrides,
             **ENTRY_OVERRIDES)
