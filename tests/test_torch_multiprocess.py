"""PyTorch port, data-parallel slice: the entry point across processes
on the CPU (gloo), held against JAX's one-process step.

Each rank is a fresh interpreter (tests/torch_mp_child.py) that imports
no JAX, launched with torchrun's environment; a hung world is killed
whole at its timeout. The JAX reference runs here, on the 8-device CPU
mesh of tests/conftest.py, over the same global batch and the same
weights (carried into the port as a params pickle). Tolerances: loss and
gradient norm 1e-5 relative, as tests/test_torch_training.py's fp32
steps.
"""

import dataclasses
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.parallel.sharding import llama_param_specs, resolve_spec
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu.utils.config_utils import get_model_config as j_get_model_config
from fms_fsdp_tpu.utils.config_utils import update_config as j_update_config
from fms_fsdp_tpu_torch.data.synth import build_arrow_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_mp_child.py")

# the TINY model of tests/test_serving.py:47, through the entry's overrides
_MODEL = {"model_variant": "llama2_7b", "LlamaConfig.nlayers": 2, "LlamaConfig.emb_dim": 64,
          "LlamaConfig.nheads": 4, "LlamaConfig.kvheads": 2,
          "LlamaConfig.src_vocab_size": 128, "LlamaConfig.max_expected_seq_len": 256}
# tests/test_torch_mamba.py's hybrid TINY (3 layers, attention at 1)
_MAMBA = {"model_variant": "mamba_9.8b", "MambaConfig.d_model": 64,
          "MambaConfig.d_intermediate": 128, "MambaConfig.n_layer": 3,
          "MambaConfig.vocab_size": 128, "MambaConfig.attn_layer_idx": [1],
          "MambaConfig.d_state": 16, "MambaConfig.headdim": 16,
          "MambaConfig.chunk_size": 16}
# tests/test_torch_mixtral.py's TINY; the balance term weighted 0.5 (JAX's
# default 0.02) so that a rank-local load-balancing loss, which differs
# from the global batch's by the covariance of the ranks' routing, moves
# the loss and the gradient norm far past 1e-5
_MIXTRAL = {"model_variant": "mixtral_8x7b", "MixtralConfig.nlayers": 2,
            "MixtralConfig.emb_dim": 64, "MixtralConfig.nheads": 4,
            "MixtralConfig.kvheads": 2, "MixtralConfig.hidden_dim": 96,
            "MixtralConfig.num_experts": 4, "MixtralConfig.src_vocab_size": 128,
            "MixtralConfig.max_expected_seq_len": 64,
            "MixtralConfig.aux_loss_weight": 0.5}
N_LAYERS = 2
SEQ, ROWS, STEPS = 32, 8, 3
_RUN = dict(seq_length=SEQ, vocab_size=128, num_steps=STEPS, report_interval=1,
            attention_kernel="xla", mixed_precision=False, learning_rate=1e-3,
            checkpoint_interval=1000, feed_prefetch=0, use_dummy_dataset=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank, world, port):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "FMS_FAULTS")}
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    return env


def _start(world, spec, faults=""):
    port = _free_port()
    procs = []
    for r in range(world):
        env = _env(r, world, port)
        if faults:
            env["FMS_FAULTS"] = faults
        procs.append(subprocess.Popen([sys.executable, "-u", CHILD, json.dumps(spec)],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs, timeout=120):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    return outs


def _run(world, spec, tmp, faults="", expect=0):
    os.makedirs(spec["out"], exist_ok=True)
    procs = _start(world, spec, faults)
    outs = _finish(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == expect, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    if expect != 0:
        return None, outs
    results = []
    for r in range(world):
        with open(os.path.join(spec["out"], f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, outs


# ---------------------------------------------------------------------------
# the JAX reference: one process, the whole global batch
# ---------------------------------------------------------------------------


def _j_model_cfg(model):
    cfg = j_get_model_config(model["model_variant"])
    j_update_config(cfg, **model)
    if hasattr(cfg, "attn_layer_idx"):  # a JSON list in the child's spec
        cfg = dataclasses.replace(cfg, attn_layer_idx=tuple(cfg.attn_layer_idx))
    return cfg


def _global_batches():
    """STEPS global batches of ROWS rows, the ranks' shares of ignored
    labels unlike: rows 0-3 (rank 0 of two) lose most of their labels,
    rows 4-7 a few."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 128, size=(STEPS, ROWS, SEQ + 1))
    inputs, labels = toks[..., :-1].astype(np.int64), toks[..., 1:].astype(np.int64)
    for s in range(STEPS):
        labels[s, 0, : SEQ - 2] = -100
        labels[s, 1, 3 + s:] = -100
        labels[s, 2, :20] = -100
        labels[s, 5, :1 + s] = -100
    return inputs, labels


def _reference(tmp, model):
    """JAX's three steps, the params pickle and the batches file."""
    model_cfg = _j_model_cfg(model)
    jcfg = JTrainConfig(**_RUN, batch_size=ROWS, sharding_strategy="fsdp",
                        mamba_kernel="xla")
    mesh = build_mesh(MeshConfig.from_train_config(jcfg))
    opt = j_step.make_optimizer(jcfg)
    state, _ = j_step.init_train_state(jax.random.PRNGKey(0), model_cfg, jcfg, mesh, opt)
    params = jax.tree.map(np.asarray, state["params"])
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    inputs, labels = _global_batches()
    np.savez(tmp / "batches.npz", inputs=inputs, labels=labels)
    fn = j_step.make_train_step(model_cfg, jcfg, mesh, opt)
    rows = []
    for s in range(STEPS):
        state, m = fn(state, (jnp.asarray(inputs[s], jnp.int32), jnp.asarray(labels[s], jnp.int32)))
        rows.append((float(m["loss"]), float(m["gnorm"])))
    return {"tmp": tmp, "rows": rows, "params": params, "model": model}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    yield _reference(tmp_path_factory.mktemp("ref"), _MODEL)
    jax.clear_caches()


def _parity_spec(ref, tmp, strategy, world, **extra):
    main = dict(_RUN, **ref["model"], sharding_strategy=strategy, batch_size=ROWS // world,
                ckpt_load_path=str(ref["tmp"] / "params.pkl"),
                ckpt_save_path=str(tmp / "ck"), checkpoint_interval=1, **extra)
    return {"out": str(tmp / "out"), "main": main, "count_gathers": True,
            "batches": str(ref["tmp"] / "batches.npz")}


_RUNS = {}


def _parity_run(reference, tmp_path, strategy, world=2, **extra):
    key = (reference["model"]["model_variant"], strategy, world, tuple(sorted(extra.items())))
    if key not in _RUNS:
        spec = _parity_spec(reference, tmp_path, strategy, world=world, **extra)
        _RUNS[key] = _run(world, spec, tmp_path)
    return _RUNS[key]


def _assert_matches_jax(res, reference):
    for s, (jl, jg) in enumerate(reference["rows"]):
        for r in res:
            assert r["losses"][s] == pytest.approx(jl, rel=1e-5), (s, r["rank"])
            assert r["gnorms"][s] == pytest.approx(jg, rel=1e-5), (s, r["rank"])


@pytest.mark.parametrize("strategy", ["ddp", "fsdp"])
def test_two_ranks_match_jax_one_process(strategy, reference, tmp_path):
    """Two gloo ranks through ``main``, each with half of every global
    batch (4 of 8 rows) whose ignored labels fall mostly on rank 0: the
    loss is the mean over the global count of labels, so it and the
    gradient norm equal JAX's one-process step on the whole batch."""
    res, outs = _parity_run(reference, tmp_path, strategy)
    _assert_matches_jax(res, reference)
    assert [r["steps"] for r in res] == [[1, 2, 3]] * 2
    # the whole world's tokens: 2 ranks x 4 rows x SEQ a step
    assert res[0]["tokens_seen"] == [s * ROWS * SEQ for s in (1, 2, 3)]
    # only rank 0 prints the report lines
    assert "step: 3" in outs[0] and "step:" not in outs[1]
    expect_mesh = ("{'dcn': 1, 'replica': 2, 'fsdp': 1" if strategy == "ddp"
                   else "{'dcn': 1, 'replica': 1, 'fsdp': 2")
    assert f"mesh = {expect_mesh}" in outs[0]


@pytest.mark.parametrize("strategy", ["ddp", "fsdp"])
def test_gathers_and_local_bytes(strategy, reference, tmp_path):
    """fsdp gathers each layer twice a step (forward, and again for the
    backward) and ddp never; under fsdp each rank holds half of every
    leaf JAX's specs split on a 2-way fsdp mesh, params and moments
    alike."""
    res, _ = _parity_run(reference, tmp_path, strategy)
    whole = sum(np.asarray(a).nbytes for a in jax.tree.leaves(reference["params"]))
    mesh_shape = {"dcn": 1, "replica": 1, "fsdp": 2, "expert": 1, "context": 1, "tensor": 1}
    specs = llama_param_specs(scan=True)
    split_bytes = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(reference["params"])[0]:
        spec = specs
        for k in path:
            spec = spec[k.key]
        if any(e == "fsdp" for e in resolve_spec(spec, leaf.shape, _FakeMesh(mesh_shape))):
            split_bytes += np.asarray(leaf).nbytes
    for r in res:
        if strategy == "fsdp":
            assert r["sharded"]
            assert [g["layer"] for g in r["gathers"]] == [2 * N_LAYERS] * STEPS
            assert r["param_bytes"] == whole - split_bytes // 2
        else:
            assert not r["sharded"]
            assert [g["layer"] for g in r["gathers"]] == [0] * STEPS
            assert r["param_bytes"] == whole
        assert r["moment_bytes"] == 2 * r["param_bytes"]
    assert split_bytes > 0.9 * whole


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def test_hsdp_four_ranks_equal_fsdp(reference, tmp_path):
    """hsdp over four ranks in groups of two (two replicas of a 2-way
    fsdp split, 2 rows each): the same losses as the two-rank fsdp run,
    and JAX's."""
    res, outs = _parity_run(reference, tmp_path, "hsdp", world=4, sharding_group_size=2)
    assert "mesh = {'dcn': 1, 'replica': 2, 'fsdp': 2" in outs[0]
    fsdp, _ = _parity_run(reference, tmp_path, "fsdp")
    for s in range(STEPS):
        assert res[0]["losses"][s] == pytest.approx(fsdp[0]["losses"][s], rel=1e-5)
        assert res[0]["gnorms"][s] == pytest.approx(fsdp[0]["gnorms"][s], rel=1e-5)
    _assert_matches_jax(res, reference)
    assert [g["layer"] for g in res[0]["gathers"]] == [2 * N_LAYERS] * STEPS


def test_two_ranks_mamba_fsdp_match_jax(tmp_path_factory, tmp_path):
    """The hybrid's unlike layers under fsdp: the leaves JAX's specs split
    (in_proj, conv_w and conv_b, out_proj, the attention and MLP weights)
    gathered a layer at a time, the rest (dt_bias, A_log, D, the norms)
    replicated; JAX's one-process losses and gradient norms, each layer
    gathered twice a step (the middle layer under activation
    checkpointing gathers again in its recomputed forward)."""
    ref = _reference(tmp_path_factory.mktemp("mamba_ref"), _MAMBA)
    jax.clear_caches()
    res, _ = _parity_run(ref, tmp_path, "fsdp", mamba_kernel="xla",
                         fsdp_activation_checkpointing=True, selective_checkpointing=0.5)
    _assert_matches_jax(res, ref)
    assert [g["layer"] for g in res[0]["gathers"]] == [2 * 3] * STEPS
    assert all(r["sharded"] for r in res)


def test_two_ranks_mixtral_fsdp_match_jax(tmp_path_factory, tmp_path):
    """Mixtral under fsdp on two ranks whose rows route unlike: the
    load-balancing term is JAX's over the global batch (the routing sums
    all-reduced before the product, the term counted once), so the losses
    and gradient norms equal JAX's one-process step; the expert weights
    split on their d dim, the router replicated, each layer gathered
    twice a step."""
    ref = _reference(tmp_path_factory.mktemp("mixtral_ref"), _MIXTRAL)
    jax.clear_caches()
    res, outs = _parity_run(ref, tmp_path, "fsdp")
    _assert_matches_jax(res, ref)
    assert [g["layer"] for g in res[0]["gathers"]] == [2 * N_LAYERS] * STEPS
    assert all(r["sharded"] for r in res)
    assert "moe_drop_frac:" in outs[0]


# ---------------------------------------------------------------------------
# elastic resume, divergence, preemption
# ---------------------------------------------------------------------------


def test_resume_world2_to_world1_keeps_the_global_batch(tmp_path):
    """Two fsdp ranks train 4 steps on arrow shards and save; one process
    resumes: the state it starts from hashes as the two ranks' did (their
    parts gathered), its batch is the saved global batch (2 x 2 rows), and
    it serves no row the two ranks trained on. Then two ranks resume the
    one process's save the same way."""
    corpus = build_arrow_corpus(tmp_path / "corpus", vocab=128)
    base = dict(_MODEL, seq_length=SEQ, vocab_size=128, attention_kernel="xla",
                mixed_precision=False, learning_rate=1e-3, report_interval=1,
                use_dummy_dataset=False, data_path=corpus, datasets="dataset_1",
                weights="1", file_type="arrow", logical_shards=8,
                loader_shuffle_window=16, num_workers=1, feed_prefetch=0,
                checkpoint_interval=1000, sharding_strategy="fsdp", batch_size=2,
                ckpt_save_path=str(tmp_path / "ck"), ckpt_load_path=str(tmp_path / "ck"))
    first, _ = _run(2, {"out": str(tmp_path / "a"), "record_rows": True,
                        "main": dict(base, num_steps=4)}, tmp_path)
    second, outs = _run(1, {"out": str(tmp_path / "b"), "record_rows": True,
                            "main": dict(base, num_steps=6)}, tmp_path)
    resumed = second[0]
    assert resumed["start_step"] == 4
    assert resumed["first_step_hash"] == first[0]["final_hash"] == first[1]["final_hash"]
    assert resumed["batch_size"] == 4
    assert "preserving the global batch of 4 rows" in outs[0]
    assert "Elastic resume" in outs[0]
    # each run fetched one batch past its last step, untrained
    trained = {tuple(row) for r in first for batch in r["rows"][:4] for row in batch}
    assert len(trained) == 2 * 4 * 2
    served = [tuple(row) for batch in resumed["rows"][:2] for row in batch]
    assert len(served) == 2 * 4 and not trained & set(served)
    assert resumed["steps"] == [5, 6]
    assert resumed["tokens_seen"] == [4 * 4 * SEQ + 4 * SEQ, 4 * 4 * SEQ + 8 * SEQ]
    # and back onto two ranks: each loads its parts of the one process's
    # whole tensors (DCP reshards into the DTensor views)
    third, outs = _run(2, {"out": str(tmp_path / "c"), "record_rows": True,
                           "main": dict(base, num_steps=7, batch_size=4)}, tmp_path)
    assert [r["start_step"] for r in third] == [6, 6]
    assert third[0]["first_step_hash"] == third[1]["first_step_hash"] == resumed["final_hash"]
    assert [r["batch_size"] for r in third] == [2, 2]
    assert "preserving the global batch of 4 rows" in outs[0]
    again = {tuple(row) for r in third for batch in r["rows"][:1] for row in batch}
    assert len(again) == 4 and not again & (trained | set(served))


def test_sdc_flip_on_one_ddp_rank_exits_state_divergence(tmp_path):
    """``sdc_grad_flip`` scales rank 1's copy of the largest leaf at step
    3; the compare at the next report boundary (step 4) sees the
    replicas' checksums differ, and both ranks exit 9 (state_divergence)."""
    spec = {"out": str(tmp_path / "out"),
            "main": dict(_RUN, **_MODEL, sharding_strategy="ddp", batch_size=2,
                         num_steps=8, report_interval=2, divergence_check_interval=2,
                         ckpt_save_path=str(tmp_path / "ck"),
                         ckpt_load_path=str(tmp_path / "ck"))}
    _, outs = _run(2, spec, tmp_path, faults="sdc_grad_flip:step=3:proc=1", expect=9)
    assert "sdc_grad_flip fault: scaled local shards of params." in outs[1]
    for out in outs:
        assert "cross-replica state divergence detected at step 4" in out
        assert "whole-state checksums disagree" in out
    assert "step: 2" in outs[0] and "step: 6" not in outs[0]


def test_sigterm_to_one_rank_saves_every_rank_at_one_step(tmp_path):
    """SIGTERM to rank 1 alone: the ranks agree on it at the next step
    boundary, save one checkpoint at the same step and exit 0."""
    spec = {"out": str(tmp_path / "out"),
            "main": dict(_RUN, **_MODEL, sharding_strategy="fsdp", batch_size=2,
                         num_steps=100000, ckpt_save_path=str(tmp_path / "ck"),
                         ckpt_load_path=str(tmp_path / "ck"))}
    os.makedirs(spec["out"])
    procs = _start(2, spec)
    lines = []

    def read():
        for line in procs[0].stdout:
            lines.append(line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.time() + 90
    while not any(ln.startswith("step: 3") for ln in lines):
        assert time.time() < deadline and procs[0].poll() is None, "".join(lines[-50:])
        time.sleep(0.05)
    procs[1].send_signal(signal.SIGTERM)
    try:
        procs[0].wait(timeout=90)
        out1, _ = procs[1].communicate(timeout=90)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise
    reader.join(timeout=10)
    out0 = "".join(lines)
    assert procs[0].returncode == 0 and procs[1].returncode == 0, out0[-3000:] + out1[-3000:]
    res = [json.load(open(os.path.join(spec["out"], f"rank{r}.json"))) for r in range(2)]
    last = res[0]["steps"][-1]
    assert res[1]["steps"][-1] == last and last < 100000
    assert f"preemption signal received: checkpoint saved at step {last}" in out0
    ckpts = os.listdir(tmp_path / "ck" / "checkpoints")
    assert ckpts == [f"step_{last}_ckp"]
    payload = os.listdir(tmp_path / "ck" / "checkpoints" / ckpts[0] / "state")
    assert any(f.startswith("__0_") for f in payload) and any(f.startswith("__1_") for f in payload)
    with open(tmp_path / "ck" / "checkpoints" / ckpts[0] / "metadata.json") as f:
        meta = json.load(f)
    assert meta["step"] == last and meta["topology"]["process_count"] == 2


def test_speculator_two_ranks_match_one_process(tmp_path):
    """2-rank gloo stage-1 speculator steps (2 of 4 rows a rank) against
    the port's one-process steps on the same global batches: the per-head
    losses, the gradient norm and the params after 3 steps within 1e-6.
    A rank-local gradient (no all-reduce) moves the norm far past it.
    The frozen base runs in fp32 here (bf16 in the entry), and with it
    the speculator: in bf16 the ranks' 2-row sums round apart from the
    4-row sums by ~1e-5 of the norm."""
    seq, steps = 32, 3
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 128, size=(steps, 4, seq + 4)).astype(np.int64)
    np.savez(tmp_path / "spec_batches.npz", inputs=toks, labels=toks)
    main = dict(_MODEL, vocab_size=128, speculator_width=32, use_dummy_dataset=True,
                seq_length=seq, num_steps=steps, stage2_start_step=100, report_interval=1,
                attention_kernel="xla", learning_rate=1e-3, checkpoint_interval=1000,
                feed_prefetch=0)
    results = {}
    for world in (1, 2):
        spec = {"out": str(tmp_path / f"out{world}"), "speculator": True, "fp32_base": True,
                "batches": str(tmp_path / "spec_batches.npz"),
                "main": dict(main, batch_size=4 // world,
                             ckpt_save_path=str(tmp_path / f"ck{world}"),
                             ckpt_load_path=str(tmp_path / f"ck{world}"))}
        results[world], _ = _run(world, spec, tmp_path)
    one = results[1][0]
    assert one["steps"] == [1, 2, 3]
    for r in results[2]:
        assert r["steps"] == one["steps"] and r["tokens_seen"] == one["tokens_seen"]
        np.testing.assert_allclose(r["per_head"], one["per_head"], rtol=1e-6)
        np.testing.assert_allclose(r["gnorms"], one["gnorms"], rtol=1e-6)
        assert sorted(r["param_sums"]) == sorted(one["param_sums"])
        for key, want in one["param_sums"].items():
            assert r["param_sums"][key] == pytest.approx(want, rel=1e-6, abs=1e-6), key
