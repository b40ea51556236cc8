"""PyTorch port, long context for Mixtral, eval_ppl and the speculator:
gloo worlds on the CPU held against JAX's context-parallel programs.

Each gloo world runs once: one module-scoped fixture starts a world of 2
(cp 2) and a world of 4 (fsdp 2 x cp 2), each rank a fresh interpreter
(tests/torch_context_child.py) that runs all of that world's cases one
after another and imports no JAX, and while they run computes JAX's
references here, on the 8-device CPU mesh of tests/conftest.py at
``context_parallel_size=2``. Then one process without a context axis
resumes the world of 2's Mixtral save. The tests assert on those
results.

- Mixtral (the TINY of tests/test_mixtral_train.py, fp32, the balance
  term weighted 0.5 as tests/test_torch_multiprocess.py's): one step at
  capacity factors 2.0 (no drop) and 0.5 (drops): loss and gradient norm
  within 1e-5 relative of JAX's cp 2 step, ``moe_drop_frac`` equal, the
  balance term within 1e-5 of JAX's forward. A chunk-local routing (each
  chunk its own counts and the capacity of its own length) fails it.
- ``eval_ppl.main`` at cp 2 for Llama, the Mamba hybrid and Mixtral: the
  NLL and token count of JAX's ``make_eval_step`` at cp 2.
- The speculator entry at ``context_parallel_size=2``: the per-head
  losses of cp 1, the report's per-chip world JAX's ``world // tp // cp``.
- A Mixtral state saved by two context ranks resumes on one process with
  the global batch, the state and the stream continued.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import eval_ppl as j_eval
from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models import mixtral as jm
from fms_fsdp_tpu.models.llama import init_llama_params as j_init_llama
from fms_fsdp_tpu.models.mamba import init_mamba_params as j_init_mamba
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu_torch.data.synth import build_arrow_corpus
from test_torch_multiprocess import (
    _MAMBA,
    _MIXTRAL,
    _MODEL,
    _RUN,
    REPO,
    ROWS,
    SEQ,
    _env,
    _finish,
    _free_port,
    _global_batches,
    _j_model_cfg,
    _run,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CONTEXT_CHILD = os.path.join(REPO, "tests", "torch_context_child.py")
CFS = (2.0, 0.5)
FAMILIES = {"llama": _MODEL, "mamba": _MAMBA, "mixtral": _MIXTRAL}
SPEC_SEQ, SPEC_STEPS = 32, 2


def _mixtral(cf):
    return dict(_MIXTRAL, **{"MixtralConfig.capacity_factor": cf})


def _train_case(tmp, name, model, world, **extra):
    data_world = world // 2
    main = dict(_RUN, **model, num_steps=1, sharding_strategy="fsdp",
                context_parallel_size=2, batch_size=ROWS // data_world,
                ckpt_load_path=str(tmp / "mixtral.pkl"),
                ckpt_save_path=str(tmp / f"ck_{name}_w{world}"), checkpoint_interval=1000)
    return dict({"name": name, "kind": "train", "main": main,
                 "batches": str(tmp / "batches.npz")}, **extra)


def _eval_case(tmp, family):
    model = FAMILIES[family]
    main = dict(model, use_dummy_dataset=True, seq_length=SEQ, vocab_size=128,
                batch_size=ROWS, attention_kernel="xla", mixed_precision=False,
                sharding_strategy="fsdp", context_parallel_size=2, eval_batches=1,
                ckpt_load_path=str(tmp / f"{family}.pkl"))
    return {"name": f"eval_{family}", "kind": "eval", "main": main,
            "batches": str(tmp / "batches.npz")}


def _spec_case(tmp, cp):
    main = dict(_MODEL, vocab_size=128, speculator_width=32, use_dummy_dataset=True,
                seq_length=SPEC_SEQ, num_steps=SPEC_STEPS, stage2_start_step=100,
                report_interval=1, attention_kernel="xla", learning_rate=1e-3,
                checkpoint_interval=1000, feed_prefetch=0, batch_size=2,
                context_parallel_size=cp, ckpt_save_path=str(tmp / f"spec_ck{cp}"),
                ckpt_load_path=str(tmp / f"spec_ck{cp}"))
    return {"name": f"spec_cp{cp}", "kind": "speculator", "main": main,
            "batches": str(tmp / "spec_batches.npz")}


def _resume_base(tmp):
    return dict(_MIXTRAL, seq_length=SEQ, vocab_size=128, attention_kernel="xla",
                mixed_precision=False, learning_rate=1e-3, report_interval=1,
                use_dummy_dataset=False, data_path=str(tmp / "corpus"),
                datasets="dataset_1", weights="1", file_type="arrow", logical_shards=8,
                loader_shuffle_window=16, num_workers=1, feed_prefetch=0,
                checkpoint_interval=1000, sharding_strategy="fsdp", batch_size=2,
                ckpt_save_path=str(tmp / "resume_ck"), ckpt_load_path=str(tmp / "resume_ck"))


def _inputs(tmp):
    """The params pickles (JAX's init), the batches, the arrow corpus."""
    inputs, labels = _global_batches()
    np.savez(tmp / "batches.npz", inputs=inputs, labels=labels)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 128, size=(SPEC_STEPS, 4, SPEC_SEQ + 4)).astype(np.int64)
    np.savez(tmp / "spec_batches.npz", inputs=toks, labels=toks)
    build_arrow_corpus(tmp / "corpus", vocab=128)
    # JAX's Mixtral train state at cp 2 on the 8-device mesh (fsdp 4 x
    # context 2); the capacity factor does not enter the init
    jcfg = JTrainConfig(**dict(_RUN, num_steps=1, batch_size=ROWS, sharding_strategy="fsdp",
                               context_parallel_size=2))
    mesh = build_mesh(MeshConfig.from_train_config(jcfg))
    opt = j_step.make_optimizer(jcfg)
    state, _ = j_step.init_train_state(jax.random.PRNGKey(0), _j_model_cfg(_mixtral(CFS[0])),
                                       jcfg, mesh, opt)
    params = {"mixtral": state["params"],
              "llama": j_init_llama(jax.random.PRNGKey(0), _j_model_cfg(_MODEL)),
              "mamba": j_init_mamba(jax.random.PRNGKey(0), _j_model_cfg(_MAMBA))}
    for family, tree in params.items():
        with open(tmp / f"{family}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, tree), f)
    return (state, jcfg, mesh, opt), params, inputs, labels


def _j_references(j_train, params, inputs, labels):
    """JAX's cp 2 Mixtral step per capacity factor (loss, gnorm,
    moe_drop_frac, and the balance term of the step's forward) and its cp 2
    eval per family."""
    state, jcfg, mesh, opt = j_train
    refs = {}
    batch = (jnp.asarray(inputs[0], jnp.int32), jnp.asarray(labels[0], jnp.int32))
    for family, model in FAMILIES.items():
        step = j_eval.make_eval_step(_j_model_cfg(model), jcfg, mesh)
        nll, count = step(params[family], batch)
        refs[f"eval_{family}"] = {"nll": float(nll) / int(count), "tokens": int(count)}
    for cf in CFS:
        model_cfg = _j_model_cfg(_mixtral(cf))
        _, aux = jax.jit(lambda p, t: jm.mixtral_forward(
            p, t, model_cfg, compute_dtype=jnp.float32, attn_impl="xla", mesh=mesh,
            moe_impl="dispatch", return_aux=True))(state["params"], batch[0])
        # the step donates its state: each capacity factor steps a copy
        fresh = jax.tree.map(lambda a: a.copy(), state)
        _, m = j_step.make_train_step(model_cfg, jcfg, mesh, opt)(fresh, batch)
        refs[cf] = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                    "drop_frac": float(m["moe_drop_frac"]),
                    "balance": float(aux["balance"])}
    return refs


def _wait(procs, world, out, timeout=600):
    outs = _finish(procs, timeout=timeout)
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{text[-4000:]}"
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, outs


def _spawn(world, spec):
    """The ranks of one world of tests/torch_context_child.py, started."""
    os.makedirs(spec["out"], exist_ok=True)
    port = _free_port()
    return [subprocess.Popen([sys.executable, "-u", CONTEXT_CHILD, json.dumps(spec)],
                             cwd=REPO, env=_env(r, world, port), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("context_worlds")
    j_train, params, inputs, labels = _inputs(tmp)
    two = {"out": str(tmp / "w2"), "cases": [
        *[_train_case(tmp, f"mixtral_cf{cf}", _mixtral(cf), 2) for cf in CFS],
        _train_case(tmp, "mixtral_chunk_local", _mixtral(0.5), 2, chunk_local=True),
        *[_eval_case(tmp, family) for family in FAMILIES],
        _spec_case(tmp, 1), _spec_case(tmp, 2),
        {"name": "resume_save", "kind": "train", "record_rows": True,
         "main": dict(_resume_base(tmp), num_steps=3, context_parallel_size=2)},
    ]}
    four = {"out": str(tmp / "w4"), "cases": [
        _train_case(tmp, f"mixtral_cf{cf}", _mixtral(cf), 4) for cf in CFS]}
    procs = {2: _spawn(2, two), 4: _spawn(4, four)}
    try:
        refs = _j_references(j_train, params, inputs, labels)
    except BaseException:
        for group in procs.values():
            for p in group:
                p.kill()
        raise
    finally:
        jax.clear_caches()
    res = {2: _wait(procs[2], 2, two["out"]), 4: _wait(procs[4], 4, four["out"])}
    # one process without a context axis resumes the world of 2's save
    resumed, resume_outs = _run(1, {"out": str(tmp / "w1"), "record_rows": True,
                                    "main": dict(_resume_base(tmp), num_steps=5)}, tmp)
    yield {"refs": refs, "res": res, "resumed": resumed[0], "resume_out": resume_outs[0],
           "tmp": tmp}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cf", CFS)
def test_mixtral_context_step_matches_jax(worlds, world, cf):
    """One step at cp 2, JAX's capacity routing of the whole sequence:
    the loss, the gradient norm, the dropped share and the balance term of
    JAX's cp 2 step; at world 4 the context pairs are also split 2-way
    over fsdp (4 of the 8 rows a data index)."""
    ref = worlds["refs"][cf]
    results, outs = worlds["res"][world]
    assert (f"'fsdp': {world // 2}, 'expert': 1, 'context': 2, 'tensor': 1}}") in outs[0]
    for r in results:
        got = r[f"mixtral_cf{cf}"]
        assert got["losses"][0] == pytest.approx(ref["loss"], rel=1e-5), r["rank"]
        assert got["gnorms"][0] == pytest.approx(ref["gnorm"], rel=1e-5), r["rank"]
        assert got["drop_frac"][0] == ref["drop_frac"], r["rank"]
        assert got["balance"][0] == pytest.approx(ref["balance"], abs=1e-5), r["rank"]
    assert (ref["drop_frac"] > 0) == (cf < 1)


def test_mixtral_chunk_local_routing_fails_the_parity(worlds):
    """The control: each chunk routed with its own counts and the capacity
    of its own length drops other choices than JAX's whole-sequence
    routing, and the step's loss moves past the tolerance."""
    ref = worlds["refs"][0.5]
    results, _ = worlds["res"][2]
    for r in results:
        got = r["mixtral_chunk_local"]
        assert got["drop_frac"][0] != ref["drop_frac"]
        assert got["losses"][0] != pytest.approx(ref["loss"], rel=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_eval_ppl_context_matches_jax(worlds, family):
    """``eval_ppl.main`` on two context ranks (one data index, each its
    half of every row): the NLL and the token count of JAX's eval step at
    cp 2 over the whole batch; each token counted once."""
    ref = worlds["refs"][f"eval_{family}"]
    results, _ = worlds["res"][2]
    for r in results:
        got = r[f"eval_{family}"]["eval"]
        assert got["tokens"] == ref["tokens"] == int((_global_batches()[1][0] != -100).sum())
        assert got["nll"] == pytest.approx(ref["nll"], rel=1e-5, abs=1e-6)


def test_speculator_context_setting_changes_only_the_report(worlds):
    """The speculator has no context axis (JAX's mesh has none): at
    ``context_parallel_size=2`` every rank trains its own rows with the
    losses of cp 1, and only the report's per-chip world is divided, as
    JAX's ``world // tp // cp`` (``train/speculator.py:297-302``)."""
    results, _ = worlds["res"][2]
    for r in results:
        one, two = r["spec_cp1"], r["spec_cp2"]
        assert two["per_head"] == one["per_head"] and two["gnorms"] == one["gnorms"]
        assert two["tokens_seen"] == one["tokens_seen"]
        world = r["world"]
        assert one["chips"] == [max(1, world // 1 // 1)] * SPEC_STEPS
        assert two["chips"] == [max(1, world // 1 // 2)] * SPEC_STEPS


def test_mixtral_context_resume_to_one_rank_keeps_the_global_batch(worlds):
    """Two context ranks (one data index) train Mixtral 3 steps on arrow
    shards and save: one loader state file, the state once. One process
    without a context axis resumes: the same state, the same global batch
    (2 rows), the step and the stream continued with no row trained
    again."""
    tmp = worlds["tmp"]
    first = [r["resume_save"] for r in worlds["res"][2][0]]
    ckpt = tmp / "resume_ck" / "checkpoints" / "step_3_ckp"
    assert sorted(f for f in os.listdir(ckpt) if f.startswith("loader_state")) == [
        "loader_state_0.pkl"]
    with open(ckpt / "metadata.json") as f:
        topo = json.load(f)["topology"]
    assert (topo["context_parallel_size"], topo["global_batch_rows"]) == (2, 2)
    halves = [[len(row) for b in r["rows"] for row in b] for r in first]
    assert halves == [[SEQ // 2] * len(halves[0])] * 2
    assert first[0]["final_hash"] == first[1]["final_hash"]
    whole = [[a + b for a, b in zip(b0, b1)] for b0, b1 in zip(first[0]["rows"],
                                                                first[1]["rows"])]
    resumed = worlds["resumed"]
    assert resumed["start_step"] == 3 and resumed["batch_size"] == 2
    assert resumed["first_step_hash"] == first[0]["final_hash"]
    assert resumed["steps"] == [4, 5]
    assert resumed["tokens_seen"] == [4 * 2 * SEQ, 5 * 2 * SEQ]
    assert "moe_drop_frac:" in worlds["resume_out"]
    trained = {tuple(row) for batch in whole[:3] for row in batch}
    served = {tuple(row) for batch in resumed["rows"][:2] for row in batch}
    assert len(trained) == 3 * 2 and len(served) == 2 * 2 and not trained & served

