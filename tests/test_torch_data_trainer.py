"""PyTorch port, both trainers on streamed arrow shards against the JAX
package's entry points.

Each package's ``main`` trains a TINY model, fp32 on the CPU, on the same
corpus (tests/test_e2e_realdata.py's, written here with the port's
``build_arrow_corpus``) from the same initial params: JAX's, made numpy
and handed to both entries as a params pickle (``ckpt_load_path``).
Losses per step hold to 1e-5 relative, the fp32 tolerance of
tests/test_torch_training.py, and the batches each step consumed are
bitwise equal. The Llama run mirrors test_e2e_realdata.py: 8 steps at 2
loader workers, a resume to 11 at 2, a resume to 14 at 4 (the loader
state reshards). The feed is synchronous (``feed_prefetch=0``), so a
saved loader state differs from the consumed position only by the
workers' own prefetch, which is the same in both packages.
"""

import os
import pickle

import jax
import numpy as np
import pytest

import fms_fsdp_tpu.ckpt.elastic as j_elastic
import fms_fsdp_tpu.data.device_feed as j_feed
import main_training_llama as j_llama
import main_training_mamba as j_mamba
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.utils.config_utils import get_model_config as j_get_model_config
from fms_fsdp_tpu.utils.config_utils import update_config as j_update_config
from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
from fms_fsdp_tpu_torch.data.synth import build_arrow_corpus
from fms_fsdp_tpu_torch.main_training_llama import main as llama_main
from fms_fsdp_tpu_torch.main_training_mamba import main as mamba_main
from fms_fsdp_tpu_torch.models.configs import MambaAttnConfig

_LLAMA = {"model_variant": "llama2_7b", "LlamaConfig.nlayers": 2, "LlamaConfig.emb_dim": 64,
          "LlamaConfig.nheads": 4, "LlamaConfig.kvheads": 2, "LlamaConfig.src_vocab_size": 256,
          "LlamaConfig.multiple_of": 16, "LlamaConfig.max_expected_seq_len": 64}
_ATTN_KW = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_MAMBA = {"model_variant": "mamba_9.8b", "MambaConfig.d_model": 64,
          "MambaConfig.d_intermediate": 128, "MambaConfig.n_layer": 3,
          "MambaConfig.vocab_size": 256, "MambaConfig.attn_layer_idx": (1,),
          "MambaConfig.d_state": 16, "MambaConfig.headdim": 16, "MambaConfig.chunk_size": 16}
_RUN = dict(use_dummy_dataset=False, datasets="dataset_1", weights="1", file_type="arrow",
            seq_length=32, vocab_size=256, batch_size=8, logical_shards=8,
            loader_shuffle_window=16, report_interval=1, checkpoint_interval=1000,
            sharding_strategy="fsdp", attention_kernel="xla", mamba_kernel="xla",
            mixed_precision=False, feed_prefetch=0, learning_rate=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_arrow_corpus(tmp_path_factory.mktemp("corpus"))


def _init_pickle(path, model_kw, attn=None):
    """JAX's initial params for the model, numpy, in a params pickle."""
    from fms_fsdp_tpu.models import get_model_api

    cfg = j_get_model_config(model_kw["model_variant"])
    j_update_config(cfg, **model_kw, **({"MambaConfig.attn_cfg": attn} if attn else {}))
    params = get_model_api(cfg)[0](jax.random.PRNGKey(0), cfg)
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return str(path)


@pytest.fixture(autouse=True)
def _one_device_mesh(monkeypatch):
    """JAX's entry trains on one device of the 8-device CPU mesh of
    tests/conftest.py, as the port trains on one card: its batch_size is
    per data-parallel device, so on 8 devices each step would pull 8
    loader batches, and its loader would not be the port's."""
    build, fingerprint = j_llama.build_mesh, j_elastic.current_fingerprint
    monkeypatch.setattr(j_llama, "build_mesh",
                        lambda cfg: build(cfg, devices=jax.devices()[:1]))
    # the topology its checkpoints stamp and its resumes check: 1 device
    monkeypatch.setattr(j_elastic, "current_fingerprint",
                        lambda cfg, process_count=None, device_count=None:
                        fingerprint(cfg, process_count, 1))


class _Recorder:
    """The input rows of every batch each package's feed staged."""

    def __init__(self, monkeypatch):
        self.rows = {"jax": [], "port": []}
        j_stage, p_stage = j_feed.to_global_batch, DeviceFeed._stage

        def j_record(batch, mesh):
            self.rows["jax"].append(np.array(batch[0]))
            return j_stage(batch, mesh)

        def p_record(feed, batch):
            self.rows["port"].append(np.array(batch[0]))
            return p_stage(feed, batch)

        monkeypatch.setattr(j_feed, "to_global_batch", j_record)
        monkeypatch.setattr(DeviceFeed, "_stage", p_record)

    def take(self):
        out = {k: np.stack(v) for k, v in self.rows.items()}
        self.rows = {"jax": [], "port": []}
        return out


def _jax_losses(out):
    return [float(line.split(":")[1]) for line in out.splitlines() if line.startswith("loss:")]


def _check(jl, pl, rows, steps):
    assert len(pl) == len(jl) == steps, (jl, pl)
    assert pl == pytest.approx(jl, rel=1e-5), (jl, pl)
    # the pipeline pulls one batch past num_steps before the loop ends
    assert rows["port"].shape[0] == rows["jax"].shape[0] == steps + 1
    assert np.array_equal(rows["port"], rows["jax"])


def test_llama_streams_like_jax_across_resumes(corpus, tmp_path, capsys, monkeypatch):
    recorder = _Recorder(monkeypatch)
    kw = dict(_RUN, **_LLAMA, data_path=corpus, num_workers=2,
              ckpt_load_path=_init_pickle(tmp_path / "init.pkl", _LLAMA))
    per_pkg = {}

    def run(num_steps, steps, **over):
        outs = {}
        for name, j_main, p_main in (("jax", j_llama.main, None), ("port", None, llama_main)):
            ck = str(tmp_path / name)
            run_kw = dict(kw, num_steps=num_steps, ckpt_save_path=ck, **over)
            if j_main:
                j_main(**run_kw)
                out = capsys.readouterr().out
                outs[name] = (_jax_losses(out), out)
            else:
                res = p_main(device="cpu", **run_kw)
                out = capsys.readouterr().out
                outs[name] = ([r["loss"] for r in res["reports"]], out)
                per_pkg[num_steps] = res
        rows = recorder.take()
        _check(outs["jax"][0], outs["port"][0], rows, steps)
        return rows["port"], outs["port"][1]

    first, _ = run(8, 8)
    assert per_pkg[8]["start_step"] == 0
    second, out = run(11, 3, resuming_dataset=True)
    assert "start_step = 8" in out and "Dataset checkpoint loaded" in out, out[-3000:]
    third, out = run(14, 3, resuming_dataset=True, num_workers=4)
    assert "start_step = 11" in out and "Dataset checkpoint loaded" in out, out[-3000:]
    # no row of an earlier run comes again after a resume
    seen = {r.tobytes() for r in first[:8].reshape(-1, first.shape[-1])}
    for later in (second[:3], third[:3]):
        for row in later.reshape(-1, later.shape[-1]):
            assert row.tobytes() not in seen
        seen |= {r.tobytes() for r in later.reshape(-1, later.shape[-1])}
    assert per_pkg[14]["loader"] is not None and per_pkg[14]["feed"].served == 4


def test_mamba_streams_like_jax(corpus, tmp_path, capsys, monkeypatch):
    recorder = _Recorder(monkeypatch)
    init = _init_pickle(tmp_path / "init.pkl", _MAMBA, JMambaAttnConfig(**_ATTN_KW))
    base = dict(_RUN, **_MAMBA, data_path=corpus, num_workers=1, num_steps=4,
                ckpt_load_path=init)
    j_mamba.main(**base, ckpt_save_path=str(tmp_path / "jax"),
                 **{"MambaConfig.attn_cfg": JMambaAttnConfig(**_ATTN_KW)})
    jl = _jax_losses(capsys.readouterr().out)
    res = mamba_main(device="cpu", **base, ckpt_save_path=str(tmp_path / "port"),
                     **{"MambaConfig.attn_cfg": MambaAttnConfig(**_ATTN_KW)})
    _check(jl, [r["loss"] for r in res["reports"]], recorder.take(), 4)


def _port_kw(corpus, tmp_path, **over):
    return dict(_RUN, **_LLAMA, data_path=corpus, ckpt_save_path=str(tmp_path / "ck"),
                ckpt_load_path=str(tmp_path / "ck"), **over)


def test_entry_process_workers_are_reaped(corpus, tmp_path):
    """Forked loader workers feed the port's trainer (through a
    prefetching feed) and write their loader state into the final
    checkpoint; when main returns, every worker has been reaped."""
    res = llama_main(device="cpu", **_port_kw(corpus, tmp_path, num_workers=2,
                                              worker_mode="process", feed_prefetch=2,
                                              num_steps=4))
    assert [r["step"] for r in res["reports"]] == [1, 2, 3, 4]
    step_dir = tmp_path / "ck" / "checkpoints" / "step_4_ckp"
    assert sorted(f for f in os.listdir(step_dir) if f.startswith("loader")) == \
        ["loader_state_0.pkl", "loader_state_1.pkl"]
    loader = res["loader"]
    assert loader._procs == [] and loader._threads == []
    import multiprocessing

    assert multiprocessing.active_children() == []


def test_fallback_restores_the_loader_state_of_the_step_it_loads(corpus, tmp_path, capsys,
                                                                 monkeypatch):
    """A truncated payload at step 4 makes the resume fall back to step 2:
    the loader restores step 2's state from step 2's dir (the step the
    trainer resolved), and the rows it serves are the rows a straight
    run consumed after step 2."""
    kw = _port_kw(corpus, tmp_path, num_workers=1, num_steps=4, checkpoint_interval=2)
    recorder_rows = []
    stage = DeviceFeed._stage

    def record(feed, batch):
        recorder_rows.append(np.array(batch[0]))
        return stage(feed, batch)

    monkeypatch.setattr(DeviceFeed, "_stage", record)
    llama_main(device="cpu", **kw)
    straight = list(recorder_rows)
    payload = tmp_path / "ck" / "checkpoints" / "step_4_ckp" / "state"
    victim = max(payload.iterdir(), key=lambda p: p.stat().st_size)
    victim.write_bytes(victim.read_bytes()[: victim.stat().st_size // 2])
    capsys.readouterr()
    recorder_rows.clear()
    res = llama_main(device="cpu", **dict(kw, num_steps=6))
    out = capsys.readouterr().out
    assert res["start_step"] == 2, out[-3000:]
    assert "Dataset checkpoint loaded (trainer-resolved" in out and "step_2_ckp" in out
    # zero skew (one worker, synchronous feed): steps 3-4 come again, exactly
    assert np.array_equal(np.stack(recorder_rows[:2]), np.stack(straight[2:4]))


class _SaveLog:
    """A checkpointer that records the loop's saves."""

    def __init__(self):
        self.saves, self.finalized = [], 0

    def save(self, step, state, dataloader=None, reason="interval", **metadata):
        self.saves.append((step, reason, metadata["tokens_seen"]))

    def finalize(self):
        self.finalized += 1


def test_finite_stream_ends_the_loop_as_in_jax(capsys):
    """A stream that ends before num_steps: both loops train every batch,
    drain the last window into a report, save only at their interval (no
    final save: num_steps was not reached) and finalize the checkpointer."""
    import torch

    from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
    from fms_fsdp_tpu.utils.train_utils import train as j_train
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.utils.train_utils import train

    kw = dict(num_steps=10, report_interval=2, checkpoint_interval=4, batch_size=2,
              seq_length=8)
    losses = [3.0, 2.5, 2.25, 2.0, 1.5]

    def j_step(state, batch):
        return state, {k: np.float32(v) for k, v in
                       dict(loss=losses[batch], gnorm=1.0, lr=1e-3, nonfinite=0.0).items()}

    def p_step(state, batch):
        return {k: torch.tensor(v) for k, v in
                dict(loss=losses[batch], gnorm=1.0, lr=1e-3, nonfinite=0.0).items()}

    j_ck, p_ck = _SaveLog(), _SaveLog()
    j_loss = j_train(JTrainConfig(**kw), {}, j_step, 0, iter(range(5)), None, j_ck, 0, 0)
    j_out = capsys.readouterr().out
    res = train(TrainConfig(**kw), {}, p_step, 0, iter(range(5)), p_ck, device="cpu")
    p_out = capsys.readouterr().out

    def steps(out):
        return [int(ln.split(":")[1]) for ln in out.splitlines() if ln.startswith("step:")]

    assert steps(p_out) == steps(j_out) == [2, 4, 5]
    assert _jax_losses(p_out) == _jax_losses(j_out)
    assert res["final_loss"] == j_loss == 1.5 and res["steps"] == 5
    # JAX counts tokens over its data-parallel devices (the 8 of the CPU
    # mesh); the port's one card waits for ROADMAP.md A.6
    assert p_ck.saves == [(4, "interval", 4 * 2 * 8)]
    assert j_ck.saves == [(4, "interval", 4 * 2 * 8 * jax.device_count())]
    assert p_ck.finalized == j_ck.finalized == 1
