"""PyTorch port, expert parallelism: gloo worlds on the CPU held against
JAX's programs on the same meshes.

One module-scoped fixture starts a world of 2 and a world of 4, each rank
a fresh interpreter (tests/torch_ep_child.py) that runs all of its
world's cases one after another and imports no JAX, and while they run
computes JAX's references here, on the 8-device CPU mesh of
tests/conftest.py at the same expert, tensor, context and slice sizes
(fsdp takes the rest of JAX's devices). Then one process without an
expert axis resumes the world of 2's save, and a world of 2 at ep 2
resumes that process's save. Inputs come from numpy seeds (and JAX's
initial params, pickled), fp32 policy.

- The dispatch alone (JAX's tests/test_mixtral_train.py:156): the
  all-to-all path over an expert group of 2 and of 4 equals the plain
  scatter dispatch on the whole batch in one process, and JAX's
  ``_moe_ffn_dispatch_a2a`` on its mesh, at capacity factor 0.5 (drops):
  outputs 1e-5, the balance term and the dropped share 1e-6, gradients
  1e-4 (JAX's bounds). JAX's two fallbacks warn in JAX's words.
- The trainer (the TINY Mixtral of tests/test_torch_multiprocess.py, 3
  steps on 8 global rows; ``:268``, ``:281``): ep 2 on 2 ranks, fsdp 2 x
  ep 2, context 2 x ep 2, tensor 2 x ep 2 and 2 slices x ep 2 (the DCN
  overlap on and off) on 4, each rank's loss and gradient norm within
  1e-5 relative of JAX's at the same mesh; ep 2 within 1e-5 of the
  port's ep 1; 3 experts at ep 2 (JAX's fallback: whole experts) too;
  the int8 GEMMs with the int8 wire and fp8 with the delayed fp8 wire at
  ep 2 (tests/test_quant_parity.py:390's ``expert_parallel_size=2``)
  within tests/test_torch_quant_training.py's GEMM-mode bounds.
- The controls fail that parity: the leaves not split over expert
  summed without the expert axis, and the all-to-all broken.
- A save at ep 2 resumes at ep 1 on one process and back at ep 2, the
  global batch kept, DCP's chunks of the expert leaves and their Adam
  moments cut along E.
- ``eval_ppl.main`` at ep 2: JAX's eval step at ep 2.
"""

import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval_ppl as j_eval
from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models import mixtral as jm
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.parallel.sharding import init_amax_state
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu_torch.data.synth import build_arrow_corpus
from fms_fsdp_tpu_torch.models import mixtral as tm
from fms_fsdp_tpu_torch.models.configs import MixtralConfig
from fms_fsdp_tpu_torch.parallel.expert import ExpertParallel
from test_torch_multiprocess import (
    _MIXTRAL,
    _RUN,
    REPO,
    ROWS,
    SEQ,
    STEPS,
    _env,
    _finish,
    _free_port,
    _global_batches,
    _j_model_cfg,
)
from test_torch_tp_worlds import FP8, INT8, MODELS, QUANT_TOL, _j_steps
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

EP_CHILD = os.path.join(REPO, "tests", "torch_ep_child.py")
EP_MODELS = dict(MODELS, **{"mixtral_e3": dict(_MIXTRAL, **{
    "MixtralConfig.num_experts": 3, "MixtralConfig.capacity_factor": 0.5})})
EP2 = (("expert_parallel_size", 2),)
OFF = (("dcn_overlap", "off"),)
# (case, world, model, TrainConfig overrides, case flags)
TRAIN_CASES = (
    ("ep2", 2, "mixtral_cf0.5", EP2, {}),
    ("ep1", 2, "mixtral_cf0.5", (), {}),
    ("ep2_e3", 2, "mixtral_e3", EP2, {}),
    ("ep2_int8", 2, "mixtral_cf2.0", EP2 + INT8, {}),
    ("ep2_fp8", 2, "mixtral_cf2.0", EP2 + FP8, {}),
    ("control_expert_sum", 2, "mixtral_cf0.5", EP2, {"drop_expert_sum": True}),
    ("control_exchange", 2, "mixtral_cf0.5", EP2, {"break_exchange": True}),
    ("fsdp2_ep2", 4, "mixtral_cf0.5", EP2, {}),
    ("cp2_ep2", 4, "mixtral_cf0.5", EP2 + (("context_parallel_size", 2),), {}),
    ("tp2_ep2", 4, "mixtral_cf0.5", EP2 + (("tensor_parallel_size", 2),), {}),
    ("slices_ep2", 4, "mixtral_cf0.5", EP2 + (("num_slices", 2),), {}),
    ("slices_ep2_off", 4, "mixtral_cf0.5", EP2 + (("num_slices", 2),) + OFF, {}),
)
PARITY = [c for c in TRAIN_CASES if c[0] not in ("ep1",) and not c[0].startswith("control")]
# JAX's reference of a case: its model and every override but the
# overlap (JAX's own program at the same mesh)
_KEYS = ("expert_parallel_size", "tensor_parallel_size", "context_parallel_size",
         "num_slices", "quantized_matmuls", "quantized_reduce")


def _ref_key(model, over):
    return (model,) + tuple(kv for kv in over if kv[0] in _KEYS)


REFS = sorted({_ref_key(model, over) for _, _, model, over, _ in TRAIN_CASES
               if over})
# the dispatch alone: JAX's TINY (tests/test_mixtral_train.py), drops at
# capacity factor 0.5, the balance term weighted as the trainers' cases
MOE = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2, hidden_dim=96,
           num_experts=4, top_k=2, max_expected_seq_len=64, capacity_factor=0.5,
           aux_loss_weight=0.5)
A2A_B, A2A_S = 8, 16
FALLBACK = "not divisible by the expert axis"


def _params(tmp, model):
    """JAX's initial params of ``model`` (``PRNGKey(0)``, fp32), pickled
    for the port's cases."""
    model_cfg = _j_model_cfg(EP_MODELS[model])
    params = jm.init_mixtral_params(jax.random.PRNGKey(0), model_cfg, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, params)
    with open(tmp / f"{model}.pkl", "wb") as f:
        pickle.dump(params, f)
    return params


def _moe_inputs(tmp):
    rng = np.random.default_rng(24)
    E, D, H = MOE["num_experts"], MOE["emb_dim"], MOE["hidden_dim"]
    data = {"h": rng.standard_normal((A2A_B, A2A_S, D)),
            "gate": rng.standard_normal((D, E)) * 0.5,
            "w1": rng.standard_normal((E, D, H)) * 0.1,
            "w3": rng.standard_normal((E, D, H)) * 0.1,
            "w2": rng.standard_normal((E, H, D)) * 0.1}
    data = {k: v.astype(np.float32) for k, v in data.items()}
    np.savez(tmp / "moe.npz", **data)
    return data


def _train_case(tmp, name, world, model, over, flags):
    kw = dict(over)
    data_world = world // kw.get("tensor_parallel_size", 1) // kw.get("context_parallel_size", 1)
    main = dict(_RUN, **EP_MODELS[model], **kw, sharding_strategy="fsdp",
                batch_size=ROWS // data_world, ckpt_load_path=str(tmp / f"{model}.pkl"),
                ckpt_save_path=str(tmp / f"ck_{name}"), checkpoint_interval=1000)
    return dict({"name": name, "kind": "train", "main": main,
                 "batches": str(tmp / "batches.npz")}, **flags)


def _eval_case(tmp):
    main = dict(_MIXTRAL, use_dummy_dataset=True, seq_length=SEQ, vocab_size=128,
                batch_size=ROWS // 2, attention_kernel="xla", mixed_precision=False,
                sharding_strategy="fsdp", expert_parallel_size=2, eval_batches=1,
                ckpt_load_path=str(tmp / "mixtral_cf0.5.pkl"))
    return {"name": "eval_ep2", "kind": "eval", "main": main,
            "batches": str(tmp / "batches.npz")}


def _resume_base(tmp):
    return dict(_MIXTRAL, seq_length=SEQ, vocab_size=128, attention_kernel="xla",
                mixed_precision=False, learning_rate=1e-3, report_interval=1,
                use_dummy_dataset=False, data_path=str(tmp / "corpus"),
                datasets="dataset_1", weights="1", file_type="arrow", logical_shards=8,
                loader_shuffle_window=16, num_workers=1, feed_prefetch=0,
                checkpoint_interval=1000, sharding_strategy="fsdp", batch_size=2,
                ckpt_save_path=str(tmp / "resume_ck"), ckpt_load_path=str(tmp / "resume_ck"))


def _j_init(params, model, *over):
    """JAX's train state and step at the mesh of ``over`` (expert, tensor,
    context, slices; fsdp the rest of the 8 devices) with its quantized
    modes, from ``params``: the state's structure and shardings from an
    abstract evaluation of ``init_train_state``, whose random init never
    compiles."""
    model_cfg = _j_model_cfg(EP_MODELS[model])
    jcfg = JTrainConfig(**_RUN, **dict(over), batch_size=ROWS, sharding_strategy="fsdp")
    mesh = build_mesh(MeshConfig.from_train_config(jcfg))
    opt = j_step.make_optimizer(jcfg)
    shardings = {}

    def init(key):
        state, shardings["state"] = j_step.init_train_state(key, model_cfg, jcfg, mesh, opt)
        return state

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    params = jax.tree.map(jnp.asarray, params)
    state = {"params": params, "opt_state": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    if "quant" in shapes:
        state["quant"] = init_amax_state(params, jcfg.fp8_amax_history_len)
    return (jax.device_put(state, shardings["state"]),
            j_step.make_train_step(model_cfg, jcfg, mesh, opt))


def _ep_mesh(ep):
    return build_mesh(MeshConfig.from_train_config(
        JTrainConfig(sharding_strategy="fsdp", expert_parallel_size=ep)))


def _j_a2a(data, ep):
    """JAX's ``_moe_ffn_dispatch_a2a`` over an expert axis of ``ep`` (its
    test's jitted value and gradients): (y, balance, drop_frac, grads)."""
    cfg = JMixtralConfig(**MOE)
    mesh = _ep_mesh(ep)
    assert jm._use_expert_a2a(cfg, mesh, A2A_B)

    def f(h, lp):
        y, stats = jm._moe_ffn_dispatch_a2a(h, lp, cfg, mesh)
        return jnp.sum(y ** 2) + stats["balance"], (y, stats)

    lp = {k: jnp.asarray(data[k]) for k in ("gate", "w1", "w3", "w2")}
    (_, (y, stats)), (gh, glp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(data["h"]), lp)
    grads = {"h": gh, **glp}
    return (np.asarray(y), float(stats["balance"]), float(stats["drop_frac"]),
            {k: np.asarray(v) for k, v in grads.items()})


def _j_eval(tmp, inputs, labels):
    """JAX's eval step at ep 2 over the first global batch: (NLL a token,
    tokens)."""
    jcfg = JTrainConfig(**_RUN, batch_size=ROWS, sharding_strategy="fsdp",
                        expert_parallel_size=2)
    mesh = build_mesh(MeshConfig.from_train_config(jcfg))
    with open(tmp / "mixtral_cf0.5.pkl", "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    nll, count = j_eval.make_eval_step(_j_model_cfg(EP_MODELS["mixtral_cf0.5"]), jcfg, mesh)(
        params, (jnp.asarray(inputs[0], jnp.int32), jnp.asarray(labels[0], jnp.int32)))
    return {"nll": float(nll) / int(count), "tokens": int(count)}


def _spawn(world, spec):
    os.makedirs(spec["out"], exist_ok=True)
    port = _free_port()
    return [subprocess.Popen([sys.executable, "-u", EP_CHILD, json.dumps(spec)],
                             cwd=REPO, env=_env(r, world, port), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs, world, out, timeout=600):
    outs = _finish(procs, timeout=timeout)
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{text[-4000:]}"
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_worlds")
    inputs, labels = _global_batches()
    np.savez(tmp / "batches.npz", inputs=inputs, labels=labels)
    moe = _moe_inputs(tmp)
    build_arrow_corpus(tmp / "corpus", vocab=128)
    params = {m: _params(tmp, m) for m in sorted({c[2] for c in TRAIN_CASES})}
    spec = {w: {"out": str(tmp / f"w{w}"), "cases": [
        {"name": f"a2a_ep{w}", "kind": "a2a", "ep": w, "model": MOE,
         "inputs": str(tmp / "moe.npz")}]
        + [_train_case(tmp, *c) for c in TRAIN_CASES if c[1] == w]}
        for w in (2, 4)}
    spec[2]["cases"] += [
        _eval_case(tmp),
        {"name": "resume_save", "kind": "train", "record_rows": True,
         "main": dict(_resume_base(tmp), num_steps=3, expert_parallel_size=2)}]
    procs = {w: _spawn(w, s) for w, s in spec.items()}
    jobs = {key: lambda key=key: _j_steps(*_j_init(params[key[0]], *key), inputs, labels)
            for key in REFS}
    jobs.update({("a2a", ep): lambda ep=ep: _j_a2a(moe, ep) for ep in (2, 4)})
    try:
        with ThreadPoolExecutor(3) as pool:
            refs = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
        refs["eval"] = _j_eval(tmp, inputs, labels)
    except BaseException:
        for group in procs.values():
            for p in group:
                p.kill()
        raise
    finally:
        jax.clear_caches()
    res = {w: _wait(procs[w], w, spec[w]["out"]) for w in (2, 4)}
    # one process without an expert axis resumes the ep 2 save, and a
    # world of 2 at ep 2 resumes that process's save
    one = {"out": str(tmp / "w1"), "cases": [
        {"name": "resume", "kind": "train", "record_rows": True,
         "main": dict(_resume_base(tmp), num_steps=5)}]}
    res[1] = _wait(_spawn(1, one), 1, one["out"])
    back = {"out": str(tmp / "w2_back"), "cases": [
        {"name": "resume_back", "kind": "train", "record_rows": True,
         "main": dict(_resume_base(tmp), num_steps=7, expert_parallel_size=2)}]}
    res["back"] = _wait(_spawn(2, back), 2, back["out"])
    yield {"refs": refs, "res": res, "tmp": tmp, "moe": moe}


def _results(worlds, name, world):
    return [r[name] for r in worlds["res"][world][0]]


def _port_plain(data):
    """The plain scatter dispatch on the whole batch in one process, the
    balance term from its own route sums: (y, balance, drop_frac,
    grads)."""
    cfg = MixtralConfig(**MOE)
    h = torch.from_numpy(data["h"]).requires_grad_(True)
    lp = {k: torch.from_numpy(data[k]).requires_grad_(True) for k in ("gate", "w1", "w3", "w2")}
    y, route = tm._moe_ffn_dispatch(h, lp, cfg)
    stats = tm.moe_stats(route, cfg)
    grads = torch.autograd.grad((y ** 2).sum() + stats["balance"], [h, *lp.values()])
    return (y.detach().numpy(), float(stats["balance"].detach()), float(stats["drop_frac"]),
            {k: g.numpy() for k, g in zip(("h", *lp), grads)})


def _port_a2a(worlds, ep):
    """The ranks' a2a results joined: rows and experts concatenated in
    rank order, the router's partial gradients summed."""
    out = os.path.join(worlds["tmp"], f"w{ep}")
    ranks = [np.load(os.path.join(out, f"a2a_ep{ep}_rank{r}.npz")) for r in range(ep)]
    for r in ranks[1:]:
        assert float(r["balance"]) == float(ranks[0]["balance"])
        assert float(r["drop_frac"]) == float(ranks[0]["drop_frac"])
    grads = {"h": np.concatenate([r["g_h"] for r in ranks]),
             "gate": sum(r["g_gate"] for r in ranks)}
    grads.update({k: np.concatenate([r[f"g_{k}"] for r in ranks]) for k in ("w1", "w3", "w2")})
    return (np.concatenate([r["y"] for r in ranks]), float(ranks[0]["balance"]),
            float(ranks[0]["drop_frac"]), grads)


@pytest.mark.parametrize("ep", [2, 4])
def test_a2a_dispatch_matches_plain_dispatch_and_jax(worlds, ep):
    """JAX's tests/test_mixtral_train.py:156 at an expert group of 2 and
    of 4 ranks, each holding its rows and E / ep experts, drops included
    (capacity factor 0.5): the outputs, the balance term, the dropped
    share and every gradient (h, the router's summed over the ranks, the
    experts') equal to the plain dispatch on the whole batch and to JAX's
    ``_moe_ffn_dispatch_a2a`` on its mesh, within JAX's bounds."""
    got = _port_a2a(worlds, ep)
    assert got[2] > 0.0
    for ref in (_port_plain(worlds["moe"]), worlds["refs"][("a2a", ep)]):
        assert float(np.max(np.abs(got[0] - ref[0]))) < 1e-5
        assert abs(got[1] - ref[1]) < 1e-6 and abs(got[2] - ref[2]) < 1e-6
        for k, g in ref[3].items():
            assert float(np.max(np.abs(got[3][k] - g))) < 1e-4, (ep, k)
    # two exchanges forward, two backward
    assert all(r[f"a2a_ep{ep}"]["exchanges"] == 4 for r in worlds["res"][ep][0])


@pytest.mark.parametrize("num_experts,batch", [(3, A2A_B), (4, A2A_B - 1)],
                         ids=["experts", "batch"])
def test_fallbacks_warn_in_jax_words(num_experts, batch):
    """``_use_expert_a2a`` falls back, warning as JAX's does, when the
    expert extent does not divide the expert count or the batch; it
    applies at 4 experts and 8 rows, and never without an expert axis."""
    ep, mesh = ExpertParallel(None, 2, 0), _ep_mesh(2)
    kw = dict(MOE, num_experts=num_experts)
    with pytest.warns(UserWarning) as port:
        assert not tm._use_expert_a2a(MixtralConfig(**kw), ep, batch)
    with pytest.warns(UserWarning) as ref:
        assert not jm._use_expert_a2a(JMixtralConfig(**kw), mesh, batch)
    assert [str(w.message) for w in port] == [str(w.message) for w in ref]
    assert tm._use_expert_a2a(MixtralConfig(**MOE), ep, A2A_B)
    assert jm._use_expert_a2a(JMixtralConfig(**MOE), mesh, A2A_B)
    assert not tm._use_expert_a2a(MixtralConfig(**MOE), None, A2A_B)


@pytest.mark.parametrize("case", PARITY, ids=[c[0] for c in PARITY])
def test_expert_parallel_steps_match_jax(worlds, case):
    """Three fp32 steps (JAX's tests/test_mixtral_train.py:268 and :281):
    every rank's loss and gradient norm within 1e-5 relative of JAX's at
    the same mesh, each step (a quantized case within ``QUANT_TOL`` of
    JAX's in the same modes, its gradient norm at the first step); the
    dropped share above 0 at capacity factor 0.5."""
    name, world, model, over, _ = case
    ref = worlds["refs"][_ref_key(model, over)]
    quant = any(k.startswith("quantized") for k, _ in over)
    tol = QUANT_TOL if quant else {"loss": 1e-5, "gnorm": 1e-5}
    for r, got in enumerate(_results(worlds, name, world)):
        for s, (jl, jg) in enumerate(ref):
            assert got["losses"][s] == pytest.approx(jl, rel=tol["loss"]), (name, r, s)
            if not quant or s == 0:
                assert got["gnorms"][s] == pytest.approx(jg, rel=tol["gnorm"]), (name, r, s)
        assert got["steps"] == [1, 2, 3]
        assert got["tokens_seen"] == [s * ROWS * SEQ for s in (1, 2, 3)]
        if model.endswith("cf0.5") or model == "mixtral_e3":
            assert all(d is not None and d > 0 for d in got["drop_frac"])


def test_ep2_equals_ep1(worlds):
    """The same global batch at ep 2 and at ep 1 (fsdp 2) on the same two
    ranks: losses and gradient norms within 1e-5 relative, the dropped
    shares equal."""
    for a, b in zip(_results(worlds, "ep2", 2), _results(worlds, "ep1", 2)):
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
        np.testing.assert_allclose(a["gnorms"], b["gnorms"], rtol=1e-5)
        assert a["drop_frac"] == b["drop_frac"]


def test_drops_are_counted_once(worlds):
    """Each rank routes its own rows before the exchange and the route
    sums are summed over the data group, the expert axis among it: the
    dropped share of the global batch's choices, the same on every rank
    and at fsdp 2 x ep 2, context 2 x ep 2 and tensor 2 x ep 2."""
    want = _results(worlds, "ep1", 2)[0]["drop_frac"]
    for name, world in (("ep2", 2), ("fsdp2_ep2", 4), ("cp2_ep2", 4), ("tp2_ep2", 4)):
        for got in _results(worlds, name, world):
            assert got["drop_frac"] == pytest.approx(want, rel=1e-6), name


@pytest.mark.parametrize("name,world,shape", [
    ("ep2", 2, (2, 2, 64, 96)), ("fsdp2_ep2", 4, (2, 2, 32, 96)),
    ("tp2_ep2", 4, (2, 2, 64, 48)), ("ep2_e3", 2, (2, 3, 64, 96)),
])
def test_each_rank_holds_its_experts(worlds, name, world, shape):
    """Each rank's ``w1`` is its (L, E / ep, d / fsdp, h / tp) part (E
    whole where ep does not divide it: 3 experts, the fallback, which
    warns in JAX's words); the exchanges a run made, two a layer forward
    and two backward (0 on the fallback)."""
    per_run = STEPS * 2 * 2 * 2  # steps x layers x (forward, backward) x 2
    for got in _results(worlds, name, world):
        assert tuple(got["w1_shape"]) == shape
        assert got["exchanges"] == (0 if name == "ep2_e3" else per_run)
        assert got["fallback_warned"] == (name == "ep2_e3")
    assert all(got["exchanges"] == 0 for got in _results(worlds, "ep1", 2))


@pytest.mark.parametrize("world,line", [
    (2, "'fsdp': 1, 'expert': 2, 'context': 1, 'tensor': 1}"),
    (4, "'fsdp': 2, 'expert': 2, 'context': 1, 'tensor': 1}"),
])
def test_mesh_line_names_the_expert_axis(worlds, world, line):
    """Rank 0's mesh line prints the expert axis."""
    assert f"mesh = {{'dcn': 1, 'replica': 1, {line}" in worlds["res"][world][1][0]


def test_slices_overlap_on_and_off_are_bit_equal(worlds):
    """2 slices x ep 2: the bucketed cross-slice reduce sums each kind of
    leaf as the pass after the backward does: the same losses, gradient
    norms and final state bit for bit, one state on every rank."""
    on, off = _results(worlds, "slices_ep2", 4), _results(worlds, "slices_ep2_off", 4)
    for a, b in zip(on, off):
        assert (a["losses"], a["gnorms"], a["final_hash"]) == (
            b["losses"], b["gnorms"], b["final_hash"])
    assert len({r["final_hash"] for r in on}) == 1


@pytest.mark.parametrize("control", ["control_expert_sum", "control_exchange"])
def test_controls_fail_the_parity(worlds, control):
    """Without the expert axis in the sum of the leaves not split over it
    (each expert rank keeps its rows' gradients of the attention, the
    router and the embeddings), or with the all-to-all broken (each rank
    keeps its own chunks), the first step's gradient norm leaves 1e-5 of
    JAX's at ep 2."""
    (jl, jg) = worlds["refs"][_ref_key("mixtral_cf0.5", EP2)][0]
    for got in _results(worlds, control, 2):
        assert got["gnorms"][0] != pytest.approx(jg, rel=1e-5)


def _chunks(step_dir, key):
    from torch.distributed.checkpoint import FileSystemReader

    meta = FileSystemReader(str(step_dir / "state")).read_metadata()
    return sorted(tuple(c.offsets) for c in meta.state_dict_metadata[key].chunks)


def test_dcp_places_the_experts_on_the_expert_dim(worlds):
    """DCP's views put ``Shard(1)`` (E) on the expert mesh dim, beside
    fsdp's ``Shard(2)`` at fsdp 2 x ep 2, and none on a leaf it does not
    split (wq at fsdp 1); the ep 2 save holds each expert leaf and its
    Adam moments as two chunks cut along E."""
    (ep2,) = {json.dumps(r["placements"]) for r in _results(worlds, "ep2", 2)}
    ep2 = json.loads(ep2)
    assert ep2["params.layers.w1"] == ["R", "R", "R", "S(1)", "R", "R"]
    assert ep2["params.layers.wq"] is None
    four = _results(worlds, "fsdp2_ep2", 4)[0]["placements"]["params.layers.w1"]
    assert four == ["R", "R", "S(2)", "S(1)", "R", "R"]
    step = worlds["tmp"] / "resume_ck" / "checkpoints" / "step_3_ckp"
    for key in ("params.layers.w1", "opt_state.inner_state.0.mu.layers.w2"):
        assert _chunks(step, key) == [(0, 0, 0, 0), (0, 2, 0, 0)], key
    assert _chunks(step, "params.layers.wq") == [(0, 0, 0)]


def test_ep2_save_resumes_at_ep1_and_back(worlds):
    """An ep 2 world of 2 trains 3 steps on arrow shards (each rank its own
    rows) and saves; one process resumes it at ep 1 with the global batch
    (4 rows) and the same state, and its save resumes at ep 2 (2 rows a
    rank), each continuing the step and the stream with no row trained
    again."""
    tmp = worlds["tmp"]
    first = _results(worlds, "resume_save", 2)
    with open(tmp / "resume_ck" / "checkpoints" / "step_3_ckp" / "metadata.json") as f:
        topo = json.load(f)["topology"]
    assert topo["global_batch_rows"] == 4
    assert first[0]["final_hash"] == first[1]["final_hash"]
    assert not {tuple(r) for b in first[0]["rows"] for r in b} & {
        tuple(r) for b in first[1]["rows"] for r in b}
    resumed = _results(worlds, "resume", 1)[0]
    assert resumed["start_step"] == 3 and resumed["batch_size"] == 4
    assert resumed["first_step_hash"] == first[0]["final_hash"]
    assert resumed["steps"] == [4, 5]
    back = _results(worlds, "resume_back", "back")
    for r in back:
        assert r["start_step"] == 5 and r["batch_size"] == 2
        assert r["first_step_hash"] == resumed["final_hash"]
        assert r["steps"] == [6, 7]
    trained = {tuple(row) for rank in first for batch in rank["rows"][:3] for row in batch}
    trained |= {tuple(row) for batch in resumed["rows"][:2] for row in batch}
    again = {tuple(row) for rank in back for batch in rank["rows"][:2] for row in batch}
    assert len(trained) == 3 * 4 + 2 * 4 and len(again) == 2 * 4 and not trained & again


def test_eval_ppl_at_ep2_matches_jax(worlds):
    """``eval_ppl.main`` at ep 2 (each expert rank reads its own rows; the
    params whole, the dense mix): the NLL and the token count of JAX's
    eval step at ep 2 over the whole batch."""
    ref = worlds["refs"]["eval"]
    for got in _results(worlds, "eval_ep2", 2):
        got = got["eval"]
        assert got["tokens"] == ref["tokens"] == int((_global_batches()[1][0] != -100).sum())
        assert got["nll"] == pytest.approx(ref["nll"], rel=1e-5, abs=1e-6)
