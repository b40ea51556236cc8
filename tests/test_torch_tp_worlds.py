"""PyTorch port, tensor parallelism in training: gloo worlds on the CPU
held against JAX's programs on the same mesh.

Each gloo world runs once: one module-scoped fixture starts a world of 2
(tp 2) and a world of 4, each rank a fresh interpreter
(tests/torch_tp_child.py) that runs all of that world's cases one after
another and imports no JAX, and while they run computes JAX's references
here, on the 8-device CPU mesh of tests/conftest.py at the same
``MeshConfig`` (tensor and context sizes and strategy; fsdp takes the
rest of JAX's 8 devices). Then one process without a tensor axis runs
the single-rank cases: a resume of the world of 2's save, and the
speculator's reference. The tests assert on those results.

- The trainers (the TINY models of tests/test_torch_multiprocess.py,
  fp32, 3 steps on 8 global rows): Llama at tp 2, at ``"tp"`` (tp 2 x
  fsdp 2), at tp 4 with nkv 2 (JAX's GQA guard: every rank runs every
  head, the split q/k/v projections gathered), at cp 2 x tp 2 with the
  fused loss (the vocabulary-split lm_head chunk by chunk); Mixtral
  at tp 2 with drops (capacity factor 0.5; and tp 2 x fsdp 2, and tp 4
  under the GQA guard); the Mamba hybrid at tp 2 with one group (the SSD
  guard: every head on every rank) and with two (local heads and
  groups), at cp 2 x tp 2, and at tp 4. Loss
  and gradient norm within 1e-5 relative of JAX's every step.
- Quantized training beside the tensor axis: int8 matmuls and dgrad with
  the int8 wire (Llama at fsdp 2 x tp 2), fp8 with the delayed fp8 wire
  (Mixtral's experts at tp 2, no drop), within the GEMM modes' bounds of
  tests/test_torch_quant_training.py of JAX's in the same modes.
- The controls fail that parity: the tensor sums over the whole world
  (tensor peers' rows counted twice), and the forward's row-parallel
  reduces dropped.
- The speculator under ``"tp"`` (``tp_size`` 2 and 4, the base in fp32
  through the entry's ``mixed_precision=False``): the per-head losses
  and gradient norms of JAX's stage-1 steps on the same mesh, and of the
  port's one-process run, within 1e-5; the report's per-chip world
  JAX's.
- A tp 2 save resumes on one process with the global batch, and that
  process's save on a tensor group of two.
- ``eval_ppl.main`` at tp 2: the NLL and the token count of JAX's eval
  step at tp 2, each token counted once.
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
from fms_fsdp_tpu.models import BaseModelAPI as JBaseModelAPI
from fms_fsdp_tpu.models import get_base_api as j_get_base_api
from fms_fsdp_tpu.models import get_model_api as j_model_api
from fms_fsdp_tpu.models import speculator as js
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.parallel.sharding import init_amax_state, shard_params
from fms_fsdp_tpu.train import speculator as jts
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu.utils.config_utils import get_model_config as j_get_model_config
from fms_fsdp_tpu.utils.config_utils import update_config as j_update_config
from fms_fsdp_tpu_torch.bridge import params_to_numpy
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.data.synth import build_arrow_corpus
from fms_fsdp_tpu_torch.models import speculator as ts
from fms_fsdp_tpu_torch.models.llama import init_llama_params
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config
from test_torch_multiprocess import (
    _MAMBA,
    _MIXTRAL,
    _MODEL,
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
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TP_CHILD = os.path.join(REPO, "tests", "torch_tp_child.py")
MODELS = {
    "llama": _MODEL,
    "mixtral_cf2.0": dict(_MIXTRAL, **{"MixtralConfig.capacity_factor": 2.0}),
    "mixtral_cf0.5": dict(_MIXTRAL, **{"MixtralConfig.capacity_factor": 0.5}),
    "mamba_g1": _MAMBA,
    "mamba_g2": dict(_MAMBA, **{"MambaConfig.ngroups": 2}),
}
# TrainConfig overrides of some cases: the quantized modes, the fused loss
INT8 = (("quantized_matmuls", "int8_dgrad"), ("quantized_reduce", "int8"))
FP8 = (("quantized_matmuls", "fp8_dgrad"), ("quantized_reduce", "fp8_delayed"))
FUSED = (("fused_loss", True), ("loss_chunk_size", 64))
# (case, model, world, strategy, tp, cp, extra case flags, overrides)
TRAIN_CASES = (
    ("llama_tp2", "llama", 2, "fsdp", 2, 1, {}, ()),
    ("mixtral_cf0.5_tp2", "mixtral_cf0.5", 2, "fsdp", 2, 1, {}, ()),
    ("mamba_g1_tp2", "mamba_g1", 2, "fsdp", 2, 1, {}, ()),
    ("mamba_g2_tp2", "mamba_g2", 2, "fsdp", 2, 1, {}, ()),
    ("mixtral_cf2.0_tp2_fp8", "mixtral_cf2.0", 2, "fsdp", 2, 1, {}, FP8),
    ("control_world_sums", "llama", 2, "fsdp", 2, 1, {"world_sums": True}, ()),
    ("control_drop_reduce", "llama", 2, "fsdp", 2, 1, {"drop_reduce": True}, ()),
    ("llama_tp_strategy", "llama", 4, "tp", 2, 1, {}, ()),
    ("llama_tp4_guard", "llama", 4, "fsdp", 4, 1, {}, ()),
    ("mixtral_cf0.5_tp4_guard", "mixtral_cf0.5", 4, "fsdp", 4, 1, {}, ()),
    ("mamba_g1_tp4", "mamba_g1", 4, "fsdp", 4, 1, {}, ()),
    ("llama_cp2_tp2_fused", "llama", 4, "fsdp", 2, 2, {}, FUSED),
    ("llama_tp2_fsdp2_int8", "llama", 4, "fsdp", 2, 1, {}, INT8),
    ("mixtral_cf0.5_tp2_fsdp2", "mixtral_cf0.5", 4, "fsdp", 2, 1, {}, ()),
    ("mamba_g2_cp2_tp2", "mamba_g2", 4, "fsdp", 2, 2, {}, ()),
)
PARITY = [c for c in TRAIN_CASES if not c[0].startswith("control")]
# JAX's "tp" mesh is the fsdp mesh with the tensor axis (tests/
# test_torch_tensor_parallel.py): one reference serves both strategies
REFS = sorted({(model, tp, cp, over) for _, model, _, _, tp, cp, _, over in TRAIN_CASES})
# a quantized mode quantizes operands that differ by fp32 rounding between
# the packages, so a value on a rounding boundary of the int8 grid or an
# e4m3 binade now and then lands one step apart: the GEMM modes' bounds of
# tests/test_torch_quant_training.py, every step's loss within 2e-4 and
# the first step's gradient norm within 1e-4 (the later steps' weights
# were updated through values a rounding step apart)
QUANT_TOL = {"loss": 2e-4, "gnorm": 1e-4}
SPEC_SEQ, SPEC_STEPS = 32, 3


def _train_case(tmp, name, model, world, strategy, tp, cp, flags, over):
    data_world = world // tp // cp
    main = dict(_RUN, **MODELS[model], **dict(over), sharding_strategy=strategy,
                tensor_parallel_size=tp, context_parallel_size=cp,
                batch_size=ROWS // data_world,
                ckpt_load_path=str(tmp / f"{model}.pkl"),
                ckpt_save_path=str(tmp / f"ck_{name}"), checkpoint_interval=1000)
    return dict({"name": name, "kind": "train", "main": main,
                 "batches": str(tmp / "batches.npz")}, **flags)


def _spec_main(tmp, name, strategy, tp_size):
    """The speculator entry's settings: the TINY Llama base in fp32."""
    return dict(_MODEL, vocab_size=128, speculator_width=32, use_dummy_dataset=True,
                seq_length=SPEC_SEQ, num_steps=SPEC_STEPS, stage2_start_step=100,
                report_interval=1, attention_kernel="xla", learning_rate=1e-3,
                checkpoint_interval=1000, feed_prefetch=0, batch_size=4,
                mixed_precision=False, sharding_strategy=strategy, tp_size=tp_size,
                ckpt_save_path=str(tmp / f"ck_{name}"), ckpt_load_path=str(tmp / f"ck_{name}"))


def _spec_case(tmp, name, strategy, tp_size):
    return {"name": name, "kind": "speculator",
            "main": _spec_main(tmp, name, strategy, tp_size),
            "batches": str(tmp / "spec_batches.npz")}


def _j_spec(tmp, tp):
    """JAX's stage-1 steps under ``"tp"`` at ``tp_size`` ``tp`` on the
    8-device mesh (fsdp the rest), from the port entry's initial base and
    speculator (the same seeds, fp32) over the global batches: (per-head
    losses, gradient norm) each step. JAX's entry runs its base in bf16
    whatever the settings; here its forward runs in fp32, as the port's
    does under ``mixed_precision=False``."""
    main = _spec_main(tmp, "ref", "tp", tp)
    cfg = TrainConfig()
    update_config(cfg, **main)
    model_cfg = get_model_config(cfg.model_variant)
    update_config(model_cfg, **main)
    base = init_llama_params(torch.Generator().manual_seed(cfg.seed), model_cfg,
                             dtype=torch.float32)
    scfg = ts.SpeculatorConfig.from_train_config(
        cfg, emb_dim=model_cfg.emb_dim, vocab_size=model_cfg.src_vocab_size)
    spec = ts.init_speculator_params(torch.Generator().manual_seed(cfg.seed + 1), scfg)
    jcfg = JTrainConfig()
    j_update_config(jcfg, **main)
    jcfg.seq_length += jcfg.n_speculator_heads + 1
    j_model_cfg = j_get_model_config(jcfg.model_variant)
    j_update_config(j_model_cfg, **main)
    mesh = build_mesh(MeshConfig(sharding_strategy="tp", tensor_parallel_size=tp,
                                 sharding_group_size=jcfg.sharding_group_size))
    api = j_get_base_api(jcfg.model_arch)
    fp32 = JBaseModelAPI(api.arch, api.init, lambda *a, **k: api.forward_embeds(
        *a, compute_dtype=jnp.float32, **k), api.generate, api.param_specs)
    j_base = shard_params(jax.tree.map(jnp.asarray, params_to_numpy(base)),
                          api.param_specs(), mesh)
    jscfg = js.SpeculatorConfig.from_train_config(
        jcfg, emb_dim=j_model_cfg.emb_dim, vocab_size=j_model_cfg.src_vocab_size)
    jp = jax.tree.map(jnp.asarray, params_to_numpy(spec))
    opt = jts.make_speculator_optimizer(jcfg)
    state = {"params": jp, "opt_state": opt.init(jp), "step": jnp.zeros((), jnp.int32)}
    step = jts.make_stage1_step(j_base, j_model_cfg, jscfg, jcfg, opt, base_api=fp32,
                                mesh=mesh)
    rows = []
    for toks in np.load(tmp / "spec_batches.npz")["inputs"]:
        state, m = step(state, jnp.asarray(toks, jnp.int32))
        rows.append((np.asarray(m["per_head"]).tolist(), float(m["gnorm"])))
    return rows


def _eval_case(tmp):
    main = dict(_MODEL, use_dummy_dataset=True, seq_length=SEQ, vocab_size=128,
                batch_size=ROWS, attention_kernel="xla", mixed_precision=False,
                sharding_strategy="fsdp", tensor_parallel_size=2, eval_batches=1,
                ckpt_load_path=str(tmp / "llama.pkl"))
    return {"name": "eval_llama", "kind": "eval", "main": main,
            "batches": str(tmp / "batches.npz")}


def _j_eval(tmp, inputs, labels):
    """JAX's eval step at tp 2 over the first global batch: (NLL a token,
    tokens)."""
    jcfg = JTrainConfig(**_RUN, batch_size=ROWS, sharding_strategy="fsdp",
                        tensor_parallel_size=2)
    mesh = build_mesh(MeshConfig.from_train_config(jcfg))
    with open(tmp / "llama.pkl", "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    nll, count = j_eval.make_eval_step(_j_model_cfg(_MODEL), jcfg, mesh)(
        params, (jnp.asarray(inputs[0], jnp.int32), jnp.asarray(labels[0], jnp.int32)))
    return {"nll": float(nll) / int(count), "tokens": int(count)}


def _resume_base(tmp):
    return dict(_MODEL, seq_length=SEQ, vocab_size=128, attention_kernel="xla",
                mixed_precision=False, learning_rate=1e-3, report_interval=1,
                use_dummy_dataset=False, data_path=str(tmp / "corpus"),
                datasets="dataset_1", weights="1", file_type="arrow", logical_shards=8,
                loader_shuffle_window=16, num_workers=1, feed_prefetch=0,
                checkpoint_interval=1000, sharding_strategy="fsdp", batch_size=2,
                ckpt_save_path=str(tmp / "resume_ck"), ckpt_load_path=str(tmp / "resume_ck"))


def _j_params(tmp, model):
    """JAX's initial params of ``model`` (``PRNGKey(0)``, fp32), pickled
    for the port's cases."""
    model_cfg = _j_model_cfg(MODELS[model])
    params = j_model_api(model_cfg)[0](jax.random.PRNGKey(0), model_cfg, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, params)
    with open(tmp / f"{model}.pkl", "wb") as f:
        pickle.dump(params, f)
    return params


def _j_init(params, model, tp, cp, over):
    """JAX's train state at (tp, cp) on the 8-device mesh with the
    overrides ``over``, from ``params`` (the pickled ones); (state, step
    fn). The state is ``init_train_state``'s, its structure and shardings
    read from an abstract evaluation of it, with ``params`` in place of
    its random init (so its jitted init is never compiled): the
    optimizer's init and the fp8 amax history, placed on the mesh."""
    model_cfg = _j_model_cfg(MODELS[model])
    jcfg = JTrainConfig(**_RUN, **dict(over), batch_size=ROWS, sharding_strategy="fsdp",
                        tensor_parallel_size=tp, context_parallel_size=cp,
                        mamba_kernel="xla")
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
    assert jax.tree.structure(state) == jax.tree.structure(shapes)
    assert all(jax.tree.leaves(jax.tree.map(
        lambda a, s: (a.shape, a.dtype) == (s.shape, s.dtype), state, shapes)))
    return (jax.device_put(state, shardings["state"]),
            j_step.make_train_step(model_cfg, jcfg, mesh, opt))


def _j_steps(state, fn, inputs, labels):
    """JAX's three steps: (loss, gradient norm) each. The state goes back
    to its first shardings after each step (the Mamba hybrid's optimizer
    moments come out of the step laid out otherwise, which would compile
    the step a second time for the same values)."""
    rows = []
    shardings = jax.tree.map(lambda a: a.sharding, state)
    for s in range(STEPS):
        state, m = fn(state, (jnp.asarray(inputs[s], jnp.int32),
                              jnp.asarray(labels[s], jnp.int32)))
        state = jax.device_put(state, shardings)
        rows.append((float(m["loss"]), float(m["gnorm"])))
    return rows


def _spawn(world, spec):
    """The ranks of one world of tests/torch_tp_child.py, started."""
    os.makedirs(spec["out"], exist_ok=True)
    port = _free_port()
    return [subprocess.Popen([sys.executable, "-u", TP_CHILD, json.dumps(spec)],
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
    tmp = tmp_path_factory.mktemp("tp_worlds")
    inputs, labels = _global_batches()
    np.savez(tmp / "batches.npz", inputs=inputs, labels=labels)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 128, size=(SPEC_STEPS, 4, SPEC_SEQ + 4)).astype(np.int64)
    np.savez(tmp / "spec_batches.npz", inputs=toks, labels=toks)
    build_arrow_corpus(tmp / "corpus", vocab=128)
    # the params first (every case loads its model's), then the worlds,
    # and JAX's inits and steps while they run
    params = {model: _j_params(tmp, model) for model in sorted({key[0] for key in REFS})}
    worlds_spec = {w: {"out": str(tmp / f"w{w}"), "cases": [
        _train_case(tmp, *c) for c in TRAIN_CASES if c[2] == w]} for w in (2, 4)}
    worlds_spec[2]["cases"] += [
        _spec_case(tmp, "spec_tp2", "tp", 2), _eval_case(tmp),
        {"name": "resume_save", "kind": "train", "record_rows": True,
         "main": dict(_resume_base(tmp), num_steps=3, tensor_parallel_size=2)}]
    worlds_spec[4]["cases"].append(_spec_case(tmp, "spec_tp4", "tp", 4))
    procs = {w: _spawn(w, spec) for w, spec in worlds_spec.items()}
    jobs = {key: lambda key=key: _j_steps(*_j_init(params[key[0]], *key), inputs, labels)
            for key in REFS}
    jobs.update({("spec", tp): lambda tp=tp: _j_spec(tmp, tp) for tp in (2, 4)})

    try:
        # a few at a time: one compiles while another runs
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
    res = {w: _wait(procs[w], w, worlds_spec[w]["out"]) for w in (2, 4)}
    # one process without a tensor axis: the resume of the world of 2's
    # save, and the speculator's reference
    one = {"out": str(tmp / "w1"), "cases": [
        {"name": "resume", "kind": "train", "record_rows": True,
         "main": dict(_resume_base(tmp), num_steps=5)},
        _spec_case(tmp, "spec_tp1", "fsdp", 1)]}
    res[1] = _wait(_spawn(1, one), 1, one["out"])
    # and back: a tensor group of two resumes the one process's save
    back = {"out": str(tmp / "w2_back"), "cases": [
        {"name": "resume_back", "kind": "train", "record_rows": True,
         "main": dict(_resume_base(tmp), num_steps=7, tensor_parallel_size=2)}]}
    res["back"] = _wait(_spawn(2, back), 2, back["out"])
    yield {"refs": refs, "res": res, "tmp": tmp}


def _results(worlds, name, world):
    return [r[name] for r in worlds["res"][world][0]]


@pytest.mark.parametrize("case", PARITY, ids=[c[0] for c in PARITY])
def test_tensor_parallel_steps_match_jax(worlds, case):
    """Three fp32 steps: every rank's loss and gradient norm within 1e-5
    relative of JAX's on the same MeshConfig, each step (a quantized case
    within ``QUANT_TOL`` of JAX's in the same modes, its gradient norm at
    the first step: the quantized
    products' scales over a split dim and the reduce wire's amaxes over
    a tensor-split row are the whole row's)."""
    name, model, world, _, tp, cp, _, over = case
    ref = worlds["refs"][(model, tp, cp, over)]
    quant = any(k.startswith("quantized") for k, _ in over)
    tol = QUANT_TOL if quant else {"loss": 1e-5, "gnorm": 1e-5}
    for r, got in enumerate(_results(worlds, name, world)):
        for s, (jl, jg) in enumerate(ref):
            assert got["losses"][s] == pytest.approx(jl, rel=tol["loss"]), (name, r, s)
            if not quant or s == 0:
                assert got["gnorms"][s] == pytest.approx(jg, rel=tol["gnorm"]), (name, r, s)
        assert got["steps"] == [1, 2, 3]
        # the global tokens: the data ranks' rows, whole sequences
        assert got["tokens_seen"] == [s * ROWS * SEQ for s in (1, 2, 3)]
        if model.startswith("mixtral"):
            assert all(d is not None for d in got["drop_frac"])


@pytest.mark.parametrize("world,tp", [(2, 2), (4, 2), (4, 4)])
def test_mesh_line_names_the_tensor_axis(worlds, world, tp):
    """Rank 0's mesh line prints the tensor axis."""
    _, outs = worlds["res"][world]
    assert f"'tensor': {tp}}}" in outs[0]


def test_mixtral_drops_are_counted_once(worlds):
    """With drops (capacity factor 0.5) the dropped share is a share of
    the global batch's choices, not of tp copies of them: the same on
    every rank and at tp 2 x fsdp 2, and above 0."""
    two = [d for got in _results(worlds, "mixtral_cf0.5_tp2", 2) for d in got["drop_frac"]]
    four = [d for got in _results(worlds, "mixtral_cf0.5_tp2_fsdp2", 4)
            for d in got["drop_frac"]]
    assert min(two) > 0 and len(set(two)) <= STEPS
    assert sorted(set(two)) == pytest.approx(sorted(set(four)), rel=1e-6)


@pytest.mark.parametrize("control", ["control_world_sums", "control_drop_reduce"])
def test_controls_fail_the_parity(worlds, control):
    """The controls break the parity of the first step: the tensor sums
    over the world count each row twice (each rank's loss is its rows'
    over twice their label count, so the gradients halve; the reported
    loss, summed over the world too, hides it), and a forward without
    its row-parallel reduces keeps each rank's partial sums (the
    embedding of the other half of the vocabulary reads zero: the loss
    moves past 1e-3)."""
    (jl, jg) = worlds["refs"][("llama", 2, 1, ())][0]
    for got in _results(worlds, control, 2):
        loss, gnorm = got["losses"][0], got["gnorms"][0]
        assert not (loss == pytest.approx(jl, rel=1e-5) and gnorm == pytest.approx(jg, rel=1e-5))
        if control == "control_world_sums":
            assert gnorm == pytest.approx(jg / 2, rel=1e-4)
        else:
            assert loss != pytest.approx(jl, rel=1e-3)


@pytest.mark.parametrize("tp", [2, 4])
def test_speculator_tp_matches_jax(worlds, tp):
    """The speculator under ``"tp"`` at ``tp_size`` 2 and 4 (a world of
    that many ranks, one data index; at 4 the TINY base's two KV heads
    put JAX's GQA guard on): every rank's per-head losses and gradient
    norms of JAX's stage-1 steps on the same mesh within 1e-5, each step,
    and the report's per-chip world JAX's."""
    ref = worlds["refs"][("spec", tp)]
    for got in _results(worlds, f"spec_tp{tp}", tp):
        assert len(got["per_head"]) == len(ref) == SPEC_STEPS
        for s, (heads, gnorm) in enumerate(ref):
            np.testing.assert_allclose(got["per_head"][s], heads, rtol=1e-5)
            assert got["gnorms"][s] == pytest.approx(gnorm, rel=1e-5), (tp, s)
        assert got["chips"] == [tp] * SPEC_STEPS


def test_speculator_tp_base_matches_one_process(worlds):
    """The speculator under ``"tp"`` (``tp_size`` 2): the two ranks are a
    tensor group over one data index (both read its rows) and the base
    runs on their blocks; the per-head losses and the gradient norms of
    the one-process run (the port's, held to JAX by
    tests/test_torch_speculator.py) within 1e-5, the tokens seen equal,
    and the report's per-chip world JAX's ``world // tp // cp`` (which
    reads ``tensor_parallel_size``, not ``tp_size``)."""
    one = _results(worlds, "spec_tp1", 1)[0]
    for got in _results(worlds, "spec_tp2", 2):
        np.testing.assert_allclose(got["per_head"], one["per_head"], rtol=1e-5)
        np.testing.assert_allclose(got["gnorms"], one["gnorms"], rtol=1e-5)
        assert got["tokens_seen"] == one["tokens_seen"]
        assert got["chips"] == [2] * SPEC_STEPS and one["chips"] == [1] * SPEC_STEPS
    _, outs = worlds["res"][2]
    assert "Sharding strategy = tp, mesh = {'dcn': 1, 'replica': 1, 'fsdp': 1" in outs[0]


def test_tp2_save_resumes_on_one_process_with_the_global_batch(worlds):
    """A tensor group of two trains 3 steps on arrow shards and saves: one
    loader state file (tensor peers read the same rows, tensor index 0
    writes it), each rank its blocks of the state. One process without a
    tensor axis resumes: the same state, the same global batch (2 rows),
    the step and the stream continued with no row trained again."""
    tmp = worlds["tmp"]
    first = _results(worlds, "resume_save", 2)
    ckpt = tmp / "resume_ck" / "checkpoints" / "step_3_ckp"
    assert sorted(f for f in os.listdir(ckpt) if f.startswith("loader_state")) == [
        "loader_state_0.pkl"]
    with open(ckpt / "metadata.json") as f:
        topo = json.load(f)["topology"]
    assert (topo["tensor_parallel_size"], topo["global_batch_rows"]) == (2, 2)
    assert first[0]["rows"] == first[1]["rows"]
    assert first[0]["final_hash"] == first[1]["final_hash"]
    resumed = _results(worlds, "resume", 1)[0]
    assert resumed["start_step"] == 3 and resumed["batch_size"] == 2
    assert resumed["first_step_hash"] == first[0]["final_hash"]
    assert resumed["steps"] == [4, 5]
    assert resumed["tokens_seen"] == [4 * 2 * SEQ, 5 * 2 * SEQ]
    trained = {tuple(row) for batch in first[0]["rows"][:3] for row in batch}
    served = {tuple(row) for batch in resumed["rows"][:2] for row in batch}
    assert len(trained) == 3 * 2 and len(served) == 2 * 2 and not trained & served


def test_eval_ppl_tensor_axis_counts_each_token_once(worlds):
    """``eval_ppl.main`` on a tensor group of two (one data index, both
    ranks reading its rows): the NLL and the token count of JAX's eval
    step at tp 2 over the whole batch, each token counted once, not tp
    times."""
    ref = worlds["refs"]["eval"]
    for got in _results(worlds, "eval_llama", 2):
        got = got["eval"]
        assert got["tokens"] == ref["tokens"] == int((_global_batches()[1][0] != -100).sum())
        assert got["nll"] == pytest.approx(ref["nll"], rel=1e-5, abs=1e-6)


def test_one_process_save_resumes_on_a_tensor_group(worlds):
    """The one process's save (step 5) resumes on a tensor group of two:
    each rank loads its blocks of the whole tensors (DCP reshards into
    the DTensor views), the state gathered hashes as the one process's,
    both ranks read the saved global batch (2 rows), and no row is
    trained again."""
    resumed = _results(worlds, "resume", 1)[0]
    back = [r["resume_back"] for r in worlds["res"]["back"][0]]
    for r in back:
        assert r["start_step"] == 5 and r["batch_size"] == 2
        assert r["first_step_hash"] == resumed["final_hash"]
        assert r["steps"] == [6, 7]
    assert back[0]["rows"] == back[1]["rows"]
    first = _results(worlds, "resume_save", 2)[0]
    trained = {tuple(row) for batch in first["rows"][:3] + resumed["rows"][:2]
               for row in batch}
    again = {tuple(row) for batch in back[0]["rows"][:2] for row in batch}
    assert len(again) == 2 * 2 and not trained & again
