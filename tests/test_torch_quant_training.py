"""PyTorch port, quantized training: the train steps held against JAX's.

The TINY Llama, Mamba2-hybrid and Mixtral configs of
tests/test_quant_parity.py (Mixtral at ``expert_parallel_size=1`` on both
sides), JAX's weights carried into the port by ``bridge.py``, the same
numpy-seeded batches of 8 rows, fp32 policy. JAX's step runs on one CPU
device. Tolerances, stated per test:
a GEMM mode quantizes operands that themselves differ by fp32 rounding
between the packages, so now and then a value on a rounding boundary of
the int8 grid or an e4m3 binade lands one step apart; the losses and the
gradients (Adam's first moment after step 1, where the learning rate is
0: 0.1 x the clipped gradient) are held to bounds that cover that.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.parallel.sharding import init_amax_state as j_init_amax_state
from fms_fsdp_tpu.resilience.faults import configure_faults as j_configure_faults
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu_torch.bridge import (
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.models.configs import (
    LlamaConfig,
    MambaAttnConfig,
    MambaConfig,
    MixtralConfig,
)
from fms_fsdp_tpu_torch.resilience.faults import configure_faults
from fms_fsdp_tpu_torch.train.step import make_train_step, state_from_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_LLAMA_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                 multiple_of=16, max_expected_seq_len=64)
_MAMBA_KW = dict(d_model=64, d_intermediate=128, n_layer=2, vocab_size=128,
                 attn_layer_idx=(1,), d_state=16, headdim=16, chunk_size=16,
                 pad_vocab_size_multiple=16)
_ATTN_KW = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_MIXTRAL_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                   hidden_dim=96, num_experts=4, top_k=2, max_expected_seq_len=64)
FAMILIES = {
    "llama": (JLlamaConfig(**_LLAMA_KW), LlamaConfig(**_LLAMA_KW)),
    "mamba": (JMambaConfig(**_MAMBA_KW, attn_cfg=JMambaAttnConfig(**_ATTN_KW)),
              MambaConfig(**_MAMBA_KW, attn_cfg=MambaAttnConfig(**_ATTN_KW))),
    "mixtral": (JMixtralConfig(**_MIXTRAL_KW), MixtralConfig(**_MIXTRAL_KW)),
}
SEQ, ROWS = 32, 8
MODES = ("int8", "int8_dgrad", "fp8", "fp8_dgrad")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _cfg_kw(**kw):
    return dict(dict(sharding_strategy="fsdp", expert_parallel_size=1, batch_size=ROWS,
                     seq_length=SEQ, num_steps=10, learning_rate=3e-3, mixed_precision=False,
                     attention_kernel="xla", mamba_kernel="xla", kernel_tuning="off",
                     vocab_size=128), **kw)


def _batch(i):
    toks = np.random.default_rng(100 + i).integers(0, 128, size=(ROWS, SEQ + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _flat(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.array(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(state):
    """The port's state keyed as JAX's, copied (a CPU tensor's numpy view
    would follow the later steps' in-place updates)."""
    return {k: np.array(v) for k, v in train_state_to_numpy(state).items()}


_RUNS = {}
_INIT = {}


def _jax_setup(family, jcfg):
    """JAX's mesh (one CPU device: the batch is 8 rows either way) and a
    fresh copy of the family's initial state (params and optimizer state
    do not depend on the modes; the step donates its input), with the
    zero amax rows under fp8_delayed."""
    if family not in _INIT:
        mesh = build_mesh(MeshConfig.from_train_config(jcfg), devices=jax.devices()[:1])
        opt = j_step.make_optimizer(jcfg)
        state, _ = j_step.init_train_state(jax.random.PRNGKey(0), FAMILIES[family][0],
                                           jcfg, mesh, opt)
        state.pop("quant", None)
        _INIT[family] = (mesh, state)
    mesh, state = _INIT[family]
    state = jax.tree.map(jnp.copy, state)
    if jcfg.quantized_reduce == "fp8_delayed":
        state["quant"] = j_init_amax_state(state["params"], jcfg.fp8_amax_history_len)
    return mesh, state


def _run_both(family, quant="none", reduce="none", steps=3, **extra):
    """JAX's and the port's steps on the same weights and batches: per
    step (JAX's metrics, the port's), and the two states after step 1
    and at the end, as flat numpy dicts keyed by JAX's tree paths."""
    key = (family, quant, reduce, steps, tuple(sorted(extra.items())))
    if key in _RUNS:
        return _RUNS[key]
    jmodel, model = FAMILIES[family]
    kw = _cfg_kw(quantized_matmuls=quant, quantized_reduce=reduce, **extra)
    jcfg = JTrainConfig(**kw)
    mesh, jstate = _jax_setup(family, jcfg)
    opt = j_step.make_optimizer(jcfg)
    jfn = j_step.make_train_step(jmodel, jcfg, mesh, opt)
    cfg = TrainConfig(**kw)
    tstate = state_from_params(params_from_numpy(jax.tree.map(np.asarray, jstate["params"])),
                               cfg)
    tfn = make_train_step(model, cfg)
    rows, after = [], {}
    for i in range(steps):
        inputs, labels = _batch(i)
        jstate, jm = jfn(jstate, (jnp.asarray(inputs), jnp.asarray(labels)))
        tm = tfn(tstate, (torch.from_numpy(inputs).long(), torch.from_numpy(labels).long()))
        rows.append(({k: float(jm[k]) for k in ("loss", "gnorm", "nonfinite")},
                     {k: float(tm[k]) for k in ("loss", "gnorm", "nonfinite")}))
        if i == 0:
            after = (_flat(jstate), _port_flat(tstate))
    out = {"rows": rows, "first": after, "last": (_flat(jstate), _port_flat(tstate)),
           "tstate": tstate, "jstate": jstate}
    _RUNS[key] = out
    return out


def _leaf_rel(port, ref):
    """The largest |port - ref| over the leaf's largest |ref|."""
    return float(np.abs(port - ref).max() / max(float(np.abs(ref).max()), 1e-30))


# Measured worst cases over the twelve runs (this sandbox's CPU): the
# first loss 2.0e-7 relative, the gradient norm 2.0e-5, three steps'
# losses 2.9e-5; a gradient leaf's relative L2 distance 3.0e-3 (int8,
# int8_dgrad, fp8: one int8 step or e4m3 binade apart somewhere upstream)
# and 1.5e-2 under fp8_dgrad, whose e5m2 gradient carries 2 mantissa bits
# (one value a rounding step apart moves by 12.5-25%).
_LOSS_TOL, _GNORM_TOL, _STEPS_TOL = 1e-6, 1e-4, 2e-4
_GRAD_TOL = {"int8": 1e-2, "int8_dgrad": 1e-2, "fp8": 1e-2, "fp8_dgrad": 5e-2}


def _leaf_l2(port, ref):
    return float(np.linalg.norm(port - ref) / max(float(np.linalg.norm(ref)), 1e-30))


def _grads_within(res, tol):
    """Every gradient leaf of step 1 (Adam's mu) within ``tol`` of JAX's
    (relative L2); returns the worst (distance, key)."""
    jflat, tflat = res["first"]
    mu = [k for k in jflat if k.startswith("opt_state.inner_state.0.mu.")]
    assert mu and sorted(mu) == sorted(k for k in tflat if k.startswith("opt_state.inner_state.0.mu."))
    worst = max((_leaf_l2(tflat[k], jflat[k]), k) for k in mu)
    assert worst[0] <= tol, worst
    return worst


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_gemm_modes_match_jax(family, mode):
    """Each family in each GEMM mode: the first step's loss and gradient
    norm, every gradient leaf (Adam's mu after step 1), and three steps'
    losses against JAX's."""
    res = _run_both(family, quant=mode)
    (j0, t0) = res["rows"][0]
    assert t0["loss"] == pytest.approx(j0["loss"], rel=_LOSS_TOL)
    assert t0["gnorm"] == pytest.approx(j0["gnorm"], rel=_GNORM_TOL)
    _grads_within(res, _GRAD_TOL[mode])
    for i, (j, t) in enumerate(res["rows"]):
        assert np.isfinite(t["loss"]) and t["nonfinite"] == 0.0
        assert t["loss"] == pytest.approx(j["loss"], rel=_STEPS_TOL), i
    # the mode changed the step: not the unquantized port loss
    assert t0["loss"] != _plain_loss(family)


@functools.lru_cache(maxsize=None)
def _plain_loss(family):
    """The port's unquantized first-step loss on the same weights."""
    _, state = _jax_setup(family, JTrainConfig(**_cfg_kw()))
    cfg = TrainConfig(**_cfg_kw())
    tstate = state_from_params(params_from_numpy(jax.tree.map(np.asarray, state["params"])),
                               cfg)
    inputs, labels = _batch(0)
    m = make_train_step(FAMILIES[family][1], cfg)(
        tstate, (torch.from_numpy(inputs).long(), torch.from_numpy(labels).long()))
    return float(m["loss"])


# ---------------------------------------------------------------------------
# the quantized reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "fp8", "fp8_delayed"])
def test_reduce_modes_match_jax(mode):
    """Three Llama steps through each reduce wire: losses and gradient
    norms (taken before the wire, as JAX's) within the GEMM modes'
    bounds, the wired gradients of step 1 within 1e-2 (an e5m2 step is
    a quarter of a value), and under fp8_delayed the amax rows equal to
    JAX's after three steps (1e-4 relative, measured 1.1e-5: the amax of
    gradients that differ by fp32 rounding and, from step 2 on, by
    weights updated through e5m2 values a rounding step apart)."""
    res = _run_both("llama", reduce=mode)
    for i, (j, t) in enumerate(res["rows"]):
        assert t["loss"] == pytest.approx(j["loss"], rel=_STEPS_TOL), i
        assert t["gnorm"] == pytest.approx(j["gnorm"], rel=_GNORM_TOL), i
    _grads_within(res, 1e-2)
    jflat, tflat = res["last"]
    rows = sorted(k for k in tflat if k.startswith("quant."))
    if mode != "fp8_delayed":
        assert not rows and "quant" not in res["tstate"]
        return
    assert rows == sorted(k for k in jflat if k.startswith("quant."))
    assert "quant.amax_history.g.layers.wq" in rows
    assert "quant.amax_history.g.embedding" in rows
    for k in rows:
        np.testing.assert_allclose(tflat[k], jflat[k], rtol=1e-4, atol=0)
        assert tflat[k].dtype == np.float32 and tflat[k].shape == (16,)
        assert (tflat[k][:3] > 0).all() and (tflat[k][3:] == 0).all(), k
    # a stacked leaf's row is the max over its layers' gradients
    assert len(rows) == 12


def _port_run(batches, faults="", **kw):
    """The port's fp8_delayed Llama steps from JAX's initial weights."""
    _, jstate = _jax_setup("llama", JTrainConfig(**_cfg_kw()))
    cfg = TrainConfig(**_cfg_kw(quantized_reduce="fp8_delayed", **kw))
    state = state_from_params(params_from_numpy(jax.tree.map(np.asarray, jstate["params"])),
                              cfg)
    configure_faults(faults)
    try:
        step = make_train_step(FAMILIES["llama"][1], cfg)
    finally:
        configure_faults("")
    metrics = []
    for i in range(batches):
        inputs, labels = _batch(i)
        metrics.append(step(state, (torch.from_numpy(inputs).long(),
                                    torch.from_numpy(labels).long())))
    rows = {k: v.clone() for k, v in state["quant"]["amax_history"].items()}
    return state, metrics, rows


def test_poisoned_step_keeps_the_amax_rows():
    """A non-finite batch that the guard skips leaves every amax row as
    it was (NaN in the window would poison every later scale); without
    the guard the rows roll, NaN at the head, as JAX's do."""
    _, _, clean = _port_run(2)
    _, metrics, poisoned = _port_run(3, faults="nan_loss:step=2:count=1")
    assert metrics[2]["nonfinite"] == 1.0 and not np.isfinite(float(metrics[2]["loss"]))
    for k, row in clean.items():
        assert torch.equal(poisoned[k], row) and torch.isfinite(row).all(), k
    _, metrics, rolled = _port_run(3, faults="nan_loss:step=2:count=1",
                                   anomaly_skip_updates=False)
    assert metrics[2]["nonfinite"] == 1.0
    for k, row in clean.items():
        assert torch.isnan(rolled[k][0]) and torch.equal(rolled[k][1:], row[:-1]), k


def test_amax_rows_survive_every_checkpoint_tier(tmp_path):
    """The rows save under ``quant.amax_history.<key>`` and load back,
    bitwise, from the local tier's checkpoint (step 2) and from the
    durable tier's (step 3), each into a fresh state whose rows are
    zero."""
    from fms_fsdp_tpu_torch.ckpt import build_checkpoint_manager
    from fms_fsdp_tpu_torch.ckpt.state import checkpoint_state

    state, _, rows = _port_run(3)
    kw = _cfg_kw(quantized_reduce="fp8_delayed", ckpt_local_dir=str(tmp_path / "local"),
                 ckpt_local_interval=1, checkpoint_interval=3,
                 ckpt_save_path=str(tmp_path / "durable"))
    manager = build_checkpoint_manager(TrainConfig(**kw), rank=0)
    manager.save(2, state, None)  # the local tier's cadence
    manager.save(3, state, None)  # the durable tier's
    manager.finalize()
    assert [(r["step"], r["tier"]) for r in manager.save_log] == [(2, "local"), (3, "durable")]
    saved = {k[len("quant.amax_history."):] for k in checkpoint_state(state)
             if k.startswith("quant.amax_history.")}
    assert saved == set(rows) and "g.layers.wq" in saved
    for root, saved in (("local", 2), ("durable", 3)):
        cfg = TrainConfig(**dict(kw, ckpt_local_dir="", ckpt_save_path=str(tmp_path / root)))
        fresh, _, _ = _port_run(0)
        assert all(float(r.abs().sum()) == 0.0 for r in fresh["quant"]["amax_history"].values())
        loaded, _, step, _, resumed = build_checkpoint_manager(cfg, rank=0).load(
            fresh, None, path=str(tmp_path / root / "checkpoints"), strict=False)
        assert resumed and step == saved, root
        for k, row in rows.items():
            assert torch.equal(loaded["quant"]["amax_history"][k], row), (root, k)


def test_jax_state_with_amax_rows_crosses_the_bridge():
    """JAX's fp8_delayed state (rows included) becomes a port state and
    comes back with the same keys and values."""
    res = _run_both("llama", reduce="fp8_delayed")
    jflat = _flat(res["jstate"])
    state = train_state_from_numpy(jflat, TrainConfig(**_cfg_kw(quantized_reduce="fp8_delayed")))
    back = _port_flat(state)
    assert set(back) == set(jflat)
    for k in jflat:
        if k.startswith("quant."):
            assert np.array_equal(back[k], jflat[k]), k


# ---------------------------------------------------------------------------
# across processes (gloo ranks on the CPU, tests/torch_mp_child.py)
# ---------------------------------------------------------------------------


def _mp():
    import test_torch_multiprocess as mp

    return mp


def test_two_rank_wire_equals_one_rank(tmp_path):
    """Two fsdp ranks round-trip their parts of the same seeded gradients:
    gathered whole, each mode's result equals one process's on the whole
    gradients, bitwise, for every leaf, the leaves split on their last
    dim included (wo, w2, embedding: their rows' amax all-reduced).
    Control: with each rank's amax kept local, those leaves differ."""
    import torch_mp_child
    from fms_fsdp_tpu_torch.ckpt.state import unflatten
    from fms_fsdp_tpu_torch.parallel.sharding import init_amax_state, quantized_grad_reduce
    from fms_fsdp_tpu_torch.train.step import _per_layer, quant_leaves

    modes = ["int8", "fp8", "fp8_delayed"]
    spec = {"out": str(tmp_path), "wire": modes, "model": _LLAMA_KW}
    _mp()._run(2, spec, tmp_path)
    got = np.load(tmp_path / "wire.npz")
    params, grads = torch_mp_child.wire_inputs(LlamaConfig(**_LLAMA_KW))
    whole = _per_layer(unflatten(grads, "params"), lambda w, *_: w)[1]
    leaves = quant_leaves(params)
    keys = _per_layer(params, lambda w, key, stacked: key)[1]
    split_last = [i for i, k in enumerate(keys)
                  if k.endswith((".wo", ".w2")) or k == "params.embedding"]
    assert len(split_last) == 2 * 2 + 1
    for mode in modes:
        ref, _ = quantized_grad_reduce(whole, mode, init_amax_state(params, 4), leaves)
        for i, r in enumerate(ref):
            assert np.array_equal(got[f"{mode}.{i}"], r.numpy()), (mode, keys[i])
        local_differs = [i for i in range(len(ref))
                         if not np.array_equal(got[f"{mode}.local.{i}"], ref[i].numpy())]
        assert set(split_last) <= set(local_differs), (mode, local_differs)


def test_two_rank_fsdp_quantized_resumes_on_one(tmp_path):
    """Two fsdp ranks train 2 steps under int8 GEMMs and the fp8_delayed
    reduce: 2 x L layer gathers a step (the quantized matmul saves the
    gathered weight itself, a handle), the same amax rows on both ranks;
    one process resumes their save: its state, the rows included, hashes
    as theirs did (DCP reads the replicated rows into the new world)."""
    mp = _mp()
    base = dict(_LLAMA_ENTRY, seq_length=SEQ, vocab_size=128, attention_kernel="xla",
                mixed_precision=False, learning_rate=1e-3, report_interval=1,
                use_dummy_dataset=True, feed_prefetch=0, checkpoint_interval=1000,
                sharding_strategy="fsdp", quantized_matmuls="int8",
                quantized_reduce="fp8_delayed", ckpt_save_path=str(tmp_path / "ck"),
                ckpt_load_path=str(tmp_path / "ck"))
    first, _ = mp._run(2, {"out": str(tmp_path / "a"), "count_gathers": True,
                           "main": dict(base, num_steps=2, batch_size=2)}, tmp_path)
    assert [g["layer"] for g in first[0]["gathers"]] == [2 * 2] * 2
    assert all(r["sharded"] for r in first)
    assert first[0]["quant_rows"] == first[1]["quant_rows"]
    assert first[0]["quant_rows"]["g.layers.wo"][1] > 0
    second, outs = mp._run(1, {"out": str(tmp_path / "b"), "record_rows": True,
                               "main": dict(base, num_steps=3, batch_size=4)}, tmp_path)
    assert second[0]["start_step"] == 2
    assert second[0]["first_step_hash"] == first[0]["final_hash"] == first[1]["final_hash"]
    assert second[0]["quant_rows"]["g.layers.wo"][1:3] == first[0]["quant_rows"]["g.layers.wo"][:2]


_LLAMA_ENTRY = dict({f"LlamaConfig.{k}": v for k, v in _LLAMA_KW.items()},
                    model_variant="llama3_194m_4k")


# ---------------------------------------------------------------------------
# the speculator's frozen base
# ---------------------------------------------------------------------------


def test_speculator_int8_base_stage1_matches_jax():
    """Two stage-1 steps on the TINY Llama base, its GEMMs int8 in both
    packages (the base in bf16, as both entries run it): per-head losses
    and the gradient norm within 2e-2, as the unquantized base's
    (tests/test_torch_speculator.py); the int8 base's hidden states are
    not the unquantized ones."""
    from fms_fsdp_tpu.models import speculator as js
    from fms_fsdp_tpu.models.llama import init_llama_params as j_init
    from fms_fsdp_tpu.train import speculator as jts
    from fms_fsdp_tpu_torch.models import get_base_api
    from fms_fsdp_tpu_torch.models import speculator as ts
    from fms_fsdp_tpu_torch.train import speculator as tts

    kw = dict(seq_length=32, batch_size=4, num_steps=100, stage2_start_step=50,
              n_speculator_heads=3, speculator_width=32, learning_rate=5e-3,
              attention_kernel="xla", quantized_matmuls="int8")
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    skw = dict(emb_dim=64, inner_dim=32, vocab_size=128, n_predict=3)
    jscfg, scfg = js.SpeculatorConfig(**skw), ts.SpeculatorConfig(**skw)
    np_base = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), FAMILIES["llama"][0]))
    jp = js.init_speculator_params(jax.random.PRNGKey(5), jscfg)
    jopt = jts.make_speculator_optimizer(jcfg)
    jstate = {"params": jp, "opt_state": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jts.make_stage1_step(jax.tree.map(jnp.asarray, np_base), FAMILIES["llama"][0],
                                 jscfg, jcfg, jopt)
    state = tts.speculator_state(params_from_numpy(jax.tree.map(np.asarray, jp)), cfg)
    base = params_from_numpy(np_base)
    step = tts.make_stage1_step(base, FAMILIES["llama"][1], scfg, cfg)
    rng = np.random.default_rng(7)
    for _ in range(2):
        inputs = rng.integers(0, 128, size=(4, 32)).astype(np.int32)
        jstate, jm = jstep(jstate, jnp.asarray(inputs))
        state, m = step(state, torch.from_numpy(inputs).long())
        np.testing.assert_allclose(m["per_head"].float().numpy(), np.asarray(jm["per_head"]),
                                   rtol=2e-2)
        assert float(m["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=2e-2)
    api = get_base_api("embedllama")
    toks = torch.from_numpy(inputs).long()
    with torch.no_grad():
        q8 = api.forward_hidden(base, toks, FAMILIES["llama"][1], attn_impl="xla", quant="int8")
        plain = api.forward_hidden(base, toks, FAMILIES["llama"][1], attn_impl="xla")
    assert not torch.equal(q8, plain)
