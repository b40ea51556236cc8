"""PyTorch port, resume: a resumed run continues a straight one, in the
port bitwise and against the JAX package within the fp32 tolerance of
tests/test_torch_training.py; and the entry points save and resume.

TINY Llama of tests/test_serving.py, fp32 on the CPU, tokens from numpy
seeds. A loader the test positions at the resumed step stands in for the
stateful loader (ROADMAP.md A.15): the dummy stream restarts on a resume,
in JAX as in the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu.utils.checkpointing import Checkpointer as JCheckpointer
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.ckpt.state import checkpoint_state
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.main_training_llama import main
from fms_fsdp_tpu_torch.main_training_mamba import main as mamba_main
from fms_fsdp_tpu_torch.main_training_mixtral import main as mixtral_main
from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MambaAttnConfig, MixtralConfig
from fms_fsdp_tpu_torch.train.step import get_lr_schedule, make_train_step, state_from_params
from fms_fsdp_tpu_torch.utils.checkpointing import Checkpointer
from fms_fsdp_tpu_torch.utils.train_utils import train
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_TINY_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                max_expected_seq_len=256)
J_TINY = JLlamaConfig(**_TINY_KW)
TINY = LlamaConfig(**_TINY_KW)
SEQ, ROWS = 16, 8  # JAX's step needs rows divisible by the 8-device CPU mesh
_KW = dict(seq_length=SEQ, batch_size=ROWS, vocab_size=128, attention_kernel="xla",
           sharding_strategy="fsdp", mixed_precision=False, learning_rate=1e-3,
           num_steps=20, report_interval=1, checkpoint_interval=1000)


def _batches(n):
    out = []
    for i in range(n):
        toks = np.random.default_rng(100 + i).integers(0, 128, size=(ROWS, SEQ + 1))
        out.append((toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)))
    return out


def _t(batch):
    return tuple(torch.from_numpy(b).long() for b in batch)


def _j_state(cfg, mesh, opt, seed=0):
    return j_step.init_train_state(jax.random.PRNGKey(seed), J_TINY, cfg, mesh, opt)[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop this module's JAX traces when it ends: a later module in the
    same process that traces the same step on an equal mesh would
    otherwise reuse them, and a compiled program's metadata names the
    stack that traced it."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def j_setup():
    """JAX's config, mesh, optimizer and the numpy of its initial params
    (JAX's step donates its state, so no test shares a JAX state)."""
    cfg = JTrainConfig(**_KW)
    mesh = build_mesh(MeshConfig.from_train_config(cfg))
    opt = j_step.make_optimizer(cfg)
    return cfg, mesh, opt, jax.tree.map(np.asarray, _j_state(cfg, mesh, opt)["params"])


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def test_resumed_run_is_bitwise_the_straight_run(j_setup, tmp_path):
    """6 steps straight against 3 + save + a fresh state + load + 3: the
    first run is the same 6-step run (its schedule spans 6 steps), cut
    after its interval save at step 3 when its loader runs dry."""
    np_params = j_setup[3]
    batches = [_t(b) for b in _batches(6)]
    cfg = TrainConfig(**dict(_KW, num_steps=6))
    straight = state_from_params(params_from_numpy(np_params), cfg)
    ref = train(cfg, straight, make_train_step(TINY, cfg), 0, iter(batches))

    first = state_from_params(params_from_numpy(np_params), cfg)
    ck = Checkpointer(str(tmp_path), 2, "fsdp")
    cfg3 = TrainConfig(**dict(_KW, num_steps=6, checkpoint_interval=3))
    head = train(cfg3, first, make_train_step(TINY, cfg3), 0, iter(batches[:3]), ck)
    assert head["steps"] == 3 and os.listdir(tmp_path / "checkpoints") == ["step_3_ckp"]
    fresh = state_from_params(params_from_numpy(jax.tree.map(lambda a: a * 0.5, np_params)),
                              cfg)
    _, _, start, ntok, resuming = Checkpointer(str(tmp_path), 2, "fsdp").load(fresh, None)
    assert (start, ntok, resuming) == (3, 3 * ROWS * SEQ, True)
    tail = train(cfg, fresh, make_train_step(TINY, cfg), 0, iter(batches[start:]),
                 start_step=start, tokens_seen=ntok)

    losses = [r["loss"] for r in head["reports"] + tail["reports"]]
    assert losses == [r["loss"] for r in ref["reports"]]
    assert [r["lr"] for r in tail["reports"]] == [r["lr"] for r in ref["reports"][3:]]
    assert tail["reports"][-1]["tokens_seen"] == ref["reports"][-1]["tokens_seen"]
    want, got = checkpoint_state(straight), checkpoint_state(fresh)
    for key in want:
        assert torch.equal(_bits(want[key]), _bits(got[key])), key


def test_resume_matches_jax(j_setup, tmp_path):
    """Each package trains 2 steps, saves, loads into a fresh state and
    trains 2 more. The loaded step, tokens and LR are equal; the losses
    hold to 1e-5 relative and the params to 2e-5 absolute, the fp32
    tolerances of tests/test_torch_training.py."""
    jcfg, mesh, opt, np_params = j_setup
    jstate = _j_state(jcfg, mesh, opt)
    batches = _batches(4)
    jfn = j_step.make_train_step(J_TINY, jcfg, mesh, opt)
    cfg = TrainConfig(**_KW)
    tfn = make_train_step(TINY, cfg)
    tstate = state_from_params(params_from_numpy(np_params), cfg)
    rows = {"jax": [], "port": []}
    for b in batches[:2]:
        jstate, jm = jfn(jstate, tuple(jnp.asarray(x) for x in b))
        tm = tfn(tstate, _t(b))
        rows["jax"].append(jm)
        rows["port"].append(tm)

    tokens = 2 * ROWS * SEQ
    JCheckpointer(str(tmp_path / "jax"), 2, "fsdp", rank=0).save(2, jstate, None,
                                                                 tokens_seen=tokens)
    Checkpointer(str(tmp_path / "port"), 2, "fsdp").save(2, tstate, None, tokens_seen=tokens)
    jfresh = _j_state(jcfg, mesh, opt, seed=5)
    jfresh, _, jstart, jtok, jres = JCheckpointer(str(tmp_path / "jax"), 2, "fsdp",
                                                  rank=0).load(jfresh, None)
    tfresh = state_from_params(params_from_numpy(jax.tree.map(np.zeros_like, np_params)), cfg)
    _, _, tstart, ttok, tres = Checkpointer(str(tmp_path / "port"), 2, "fsdp").load(tfresh, None)
    assert (tstart, ttok, tres) == (jstart, jtok, jres) == (2, tokens, True)
    assert tfresh["step"] == int(jfresh["step"]) == 2
    # the schedule continues from the restored step in both (start_step 0)
    jfn = j_step.make_train_step(J_TINY, jcfg, mesh, opt)
    tfn = make_train_step(TINY, cfg)
    for b in batches[2:]:
        jfresh, jm = jfn(jfresh, tuple(jnp.asarray(x) for x in b))
        rows["jax"].append(jm)
        rows["port"].append(tfn(tfresh, _t(b)))
    schedule = get_lr_schedule(cfg)
    for i, (j, t) in enumerate(zip(rows["jax"], rows["port"])):
        assert t["lr"] == pytest.approx(float(j["lr"]), rel=1e-6, abs=1e-12), i
        assert t["lr"] == schedule(i)
        assert float(t["loss"]) == pytest.approx(float(j["loss"]), rel=1e-5), i
    for name, leaf in tfresh["params"]["layers"].items():
        ref = np.asarray(jfresh["params"]["layers"][name])
        assert np.abs(leaf.numpy() - ref).max() <= 2e-5, name
    assert np.abs(tfresh["params"]["embedding"].numpy()
                  - np.asarray(jfresh["params"]["embedding"])).max() <= 2e-5


_MIXTRAL_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                   hidden_dim=96, num_experts=4, top_k=2, max_expected_seq_len=64,
                   capacity_factor=1.0)


def test_mixtral_state_resumes_bitwise_in_jax_layout(tmp_path):
    """A TINY Mixtral train state (capacity factor 1, so choices drop):
    its checkpoint keys are JAX's train-state tree paths (the router and
    the (L, E, d, h) experts among them); 4 steps straight against 2 +
    a DCP save + a load into a fresh state + 2, bitwise, the drop
    fractions equal."""
    jcfg_model, cfg_model = JMixtralConfig(**_MIXTRAL_KW), MixtralConfig(**_MIXTRAL_KW)
    jcfg = JTrainConfig(**_KW)
    mesh = build_mesh(MeshConfig.from_train_config(jcfg))
    opt = j_step.make_optimizer(jcfg)
    jstate = j_step.init_train_state(jax.random.PRNGKey(0), jcfg_model, jcfg, mesh, opt)[0]
    j_keys = {jax.tree_util.keystr(path, simple=True, separator=".")
              for path, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    np_params = jax.tree.map(np.asarray, jstate["params"])
    cfg = TrainConfig(**dict(_KW, num_steps=4))
    batches = [_t(b) for b in _batches(4)]

    straight = state_from_params(params_from_numpy(np_params), cfg)
    assert set(checkpoint_state(straight)) == j_keys
    assert "params.layers.gate" in j_keys and "opt_state.inner_state.0.mu.layers.w2" in j_keys
    ref = train(cfg, straight, make_train_step(cfg_model, cfg), 0, iter(batches))

    first = state_from_params(params_from_numpy(np_params), cfg)
    cfg2 = TrainConfig(**dict(_KW, num_steps=4, checkpoint_interval=2))
    head = train(cfg2, first, make_train_step(cfg_model, cfg2), 0, iter(batches[:2]),
                 Checkpointer(str(tmp_path), 2, "fsdp"))
    fresh = state_from_params(params_from_numpy(jax.tree.map(np.zeros_like, np_params)),
                              cfg)
    _, _, start, ntok, resuming = Checkpointer(str(tmp_path), 2, "fsdp").load(fresh, None)
    assert (start, ntok, resuming) == (2, 2 * ROWS * SEQ, True)
    tail = train(cfg, fresh, make_train_step(cfg_model, cfg), 0, iter(batches[2:]),
                 start_step=start, tokens_seen=ntok)
    reports = head["reports"] + tail["reports"]
    for key in ("loss", "gnorm", "lr", "moe_drop_frac"):
        assert [r[key] for r in reports] == [r[key] for r in ref["reports"]], key
    assert any(r["moe_drop_frac"] > 0 for r in reports)
    want, got = checkpoint_state(straight), checkpoint_state(fresh)
    for key in want:
        assert torch.equal(_bits(want[key]), _bits(got[key])), key


_LLAMA_ENTRY = {
    "model_variant": "llama3_194m_4k", "LlamaConfig.nlayers": 2, "LlamaConfig.emb_dim": 64,
    "LlamaConfig.nheads": 4, "LlamaConfig.kvheads": 2, "LlamaConfig.src_vocab_size": 128,
    "vocab_size": 128,
}
_MIXTRAL_ENTRY = dict({f"MixtralConfig.{k}": v for k, v in _MIXTRAL_KW.items()},
                      vocab_size=128)
_MAMBA_ENTRY = {
    "MambaConfig.d_model": 64, "MambaConfig.d_intermediate": 128, "MambaConfig.n_layer": 3,
    "MambaConfig.vocab_size": 256, "MambaConfig.attn_layer_idx": (1,),
    "MambaConfig.d_state": 16, "MambaConfig.headdim": 16, "MambaConfig.chunk_size": 16,
    "MambaConfig.attn_cfg": MambaAttnConfig(head_dim=16, num_heads=4, num_heads_kv=2,
                                            rotary_emb_dim=8),
    "vocab_size": 256,
}


@pytest.mark.parametrize("family", ["llama", "mamba", "mixtral"])
def test_entry_saves_and_resumes(family, tmp_path, capsys):
    entry, over = {"llama": (main, _LLAMA_ENTRY), "mamba": (mamba_main, _MAMBA_ENTRY),
                   "mixtral": (mixtral_main, _MIXTRAL_ENTRY)}[family]
    run = str(tmp_path / "run")
    kw = dict(device="cpu", use_dummy_dataset=True, batch_size=2, seq_length=32,
              attention_kernel="xla", report_interval=2, checkpoint_interval=2,
              ckpt_save_path=run, ckpt_load_path=str(tmp_path / "none"), **over)
    out = entry(num_steps=4, **kw)
    assert out["start_step"] == 0 and out["steps"] == 4
    ckpts = os.path.join(run, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["step_2_ckp", "step_4_ckp"]
    assert [r["step"] for r in out["checkpointer"].save_log] == [2, 4]
    assert [r["reason"] for r in out["checkpointer"].save_log] == ["interval", "final"]
    out2 = entry(num_steps=6, **kw)
    printed = capsys.readouterr().out
    assert f"Prior checkpoint {ckpts}/step_4_ckp detected." in printed
    assert out2["start_step"] == 4 and out2["steps"] == 2
    assert out2["reports"][-1]["tokens_seen"] == 6 * 2 * 32
    assert all(np.isfinite(r["loss"]) for r in out2["reports"])
    assert out2["state"]["step"] == 6
    assert sorted(os.listdir(ckpts)) == ["step_2_ckp", "step_4_ckp", "step_6_ckp"]
    # the LR continues the schedule of a 6-step run from the restored step
    sched = get_lr_schedule(out2["cfg"])
    assert out2["reports"][-1]["lr"] == sched(5)
    # continued pretraining from that run's root: its newest checkpoint,
    # with the step and tokens restarted
    out3 = entry(num_steps=2, **dict(kw, ckpt_save_path=str(tmp_path / "next"),
                                     ckpt_load_path=run))
    assert out3["start_step"] == 0 and out3["state"]["step"] == 2
    assert out3["reports"][-1]["tokens_seen"] == 2 * 2 * 32
    assert f"Prior checkpoint {ckpts}/step_6_ckp detected." in capsys.readouterr().out


def test_anomaly_abort_saves_then_raises(j_setup, tmp_path):
    """A streak of non-finite steps reaching ``anomaly_max_consecutive``
    saves the last good state (reason "abort", durable tier) with the
    skipped steps and tokens in its metadata, then aborts; the writer is
    joined on the way out."""
    import json

    from fms_fsdp_tpu_torch.ckpt import build_checkpoint_manager
    from fms_fsdp_tpu_torch.utils.train_utils import AnomalyAbort

    np_params = j_setup[3]
    cfg = TrainConfig(**dict(_KW, num_steps=8, report_interval=2, anomaly_max_consecutive=2,
                             ckpt_save_path=str(tmp_path), checkpoint_interval=100))
    state = state_from_params(params_from_numpy(np_params), cfg)

    def poisoned(st, batch):
        st["step"] += 1
        nan = torch.tensor(float("nan"))
        return {"loss": nan, "gnorm": nan, "lr": 0.0, "nonfinite": 1.0}

    mgr = build_checkpoint_manager(cfg)
    with pytest.raises(AnomalyAbort, match="at step 2"):
        train(cfg, state, poisoned, 0, iter(_batches(8)), mgr, start_step=0, tokens_seen=0)
    assert [(r["step"], r["reason"], r["tier"]) for r in mgr.save_log] == [(2, "abort",
                                                                            "durable")]
    with open(tmp_path / "checkpoints" / "step_2_ckp" / "metadata.json") as f:
        meta = json.load(f)
    assert meta["skipped_steps"] == 2 and meta["tokens_seen"] == 2 * ROWS * SEQ
    assert meta["step"] == 2 and "topology" in meta
