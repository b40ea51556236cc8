"""PyTorch port, the trainer's observability and resilience end to end on
the CPU, at the TINY Llama size of tests/test_serving.py.

- One run, both packages: JAX's ``train`` and the port's from the same
  params (carried by ``bridge.py``), with ``obs_dir`` and one ``nan_loss``
  fault: the same skipped step, the same metrics.jsonl keys, records
  equal on step, tokens_seen, the skip counts and data_mix, and on loss
  and grad_norm to 1e-5.
- The port's entry as a subprocess (``--device=cpu``): a wedged step the
  watchdog turns into exit 2 with its stall report; SIGTERM, a
  preemption save and exit 0; a ``ckpt_precommit_kill`` (exit 7) whose
  torn dir the resume skips; the supervisor CLI taking a ``nan_loss``
  burst through an ``anomaly_abort`` restart to completion; the Mamba
  entry under ``classified_exit``. Every subprocess has its own timeout.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.resilience import faults as j_faults
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu.utils import train_utils as j_train_utils
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.obs.schema import validate_record
from fms_fsdp_tpu_torch.resilience import faults as t_faults
from fms_fsdp_tpu_torch.train.step import make_train_step, state_from_params
from fms_fsdp_tpu_torch.utils.train_utils import train
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                max_expected_seq_len=256)
SEQ, ROWS = 16, 8  # JAX's step needs rows divisible by the 8-device CPU mesh


@pytest.fixture(autouse=True)
def _clean_registries():
    j_faults.configure_faults("")
    t_faults.configure_faults("")
    yield
    j_faults.configure_faults("")
    t_faults.configure_faults("")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop this module's JAX traces when it ends (a later module tracing
    the same step would reuse them, and their metadata names this one)."""
    yield
    jax.clear_caches()


class _SaveLog:
    def __init__(self):
        self.saves = []

    def save(self, step, state, dataloader=None, reason="interval", **metadata):
        self.saves.append((step, reason, metadata["tokens_seen"],
                           metadata["skipped_steps"]))

    def finalize(self):
        pass


def _batches(n):
    out = []
    for i in range(n):
        toks = np.random.default_rng(300 + i).integers(0, 128, size=(ROWS, SEQ + 1))
        out.append((toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)))
    return out


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_same_run_both_packages(tmp_path, monkeypatch, capsys):
    """JAX's loop and the port's over the same params and batches, with
    obs_dir set and step 4 (state step 3) poisoned by the fault spec."""
    spec = "nan_loss:step=3:count=1"
    kw = dict(seq_length=SEQ, batch_size=ROWS, vocab_size=128, attention_kernel="xla",
              sharding_strategy="fsdp", mixed_precision=False, learning_rate=1e-3,
              num_steps=6, report_interval=2, checkpoint_interval=1000,
              obs_sinks="jsonl,csv", obs_strict_schema=True,
              divergence_check_interval=2)  # inert on one process, in both
    jcfg = JTrainConfig(**kw, obs_dir=str(tmp_path / "jax"))
    mesh = build_mesh(MeshConfig.from_train_config(jcfg))
    opt = j_step.make_optimizer(jcfg)
    jstate = j_step.init_train_state(jax.random.PRNGKey(0), JLlamaConfig(**_TINY_KW), jcfg,
                                     mesh, opt)[0]
    np_params = jax.tree.map(np.asarray, jstate["params"])
    batches = _batches(6)

    j_faults.configure_faults(spec)
    jfn = j_step.make_train_step(JLlamaConfig(**_TINY_KW), jcfg, mesh, opt)
    j_ck = _SaveLog()
    # JAX counts tokens over its data-parallel devices (the 8 of the CPU
    # mesh); the port's one card: the loop is held to one device here
    monkeypatch.setattr(j_train_utils.jax, "device_count", lambda: 1)
    j_train_utils.train(jcfg, jstate, jfn, 0,
                        iter([tuple(jnp.asarray(x) for x in b) for b in batches]), None,
                        j_ck, 0, 0)
    monkeypatch.undo()

    t_faults.configure_faults(spec)
    cfg = TrainConfig(**kw, obs_dir=str(tmp_path / "port"))
    tstate = state_from_params(params_from_numpy(np_params), cfg)
    t_ck = _SaveLog()
    out = train(cfg, tstate, make_train_step(LlamaConfig(**_TINY_KW), cfg), 0,
                iter([tuple(torch.from_numpy(x).long() for x in b) for b in batches]), t_ck)
    capsys.readouterr()

    jrec = _records(tmp_path / "jax" / "metrics.jsonl")
    trec = _records(tmp_path / "port" / "metrics.jsonl")
    assert [r["step"] for r in trec] == [r["step"] for r in jrec] == [2, 4, 6]
    assert [set(r) for r in trec] == [set(r) for r in jrec]
    for j, t in zip(jrec, trec):
        assert validate_record(t) == []
        for key in ("step", "tokens_seen", "skipped_steps", "skipped_steps_window",
                    "data_mix", "restarts", "dcn_overlap_frac", "divergence_checks"):
            assert t[key] == j[key], key
        for key in ("loss", "grad_norm"):
            assert t[key] == pytest.approx(j[key], rel=1e-5), key
    assert [r["skipped_steps_window"] for r in trec] == [0, 1, 0]
    assert out["skipped_batches"] == 1
    assert t_ck.saves == j_ck.saves == [(6, "final", 6 * ROWS * SEQ, 1)]
    with open(tmp_path / "port" / "metrics.csv") as f, \
            open(tmp_path / "jax" / "metrics.csv") as g:
        assert f.readline() == g.readline()
    hb = [json.load(open(tmp_path / p / "heartbeat.json")) for p in ("jax", "port")]
    assert set(hb[0]) == set(hb[1]) and hb[0]["step"] == hb[1]["step"] == 6


# ---------------------------------------------------------------------------
# the entry points as subprocesses
# ---------------------------------------------------------------------------

_ENTRY_ARGS = [
    "--device=cpu", "--model_variant=llama3_194m_4k", "--use_dummy_dataset=True",
    "--batch_size=2", "--seq_length=32", "--vocab_size=128", "--attention_kernel=xla",
    "--LlamaConfig.nlayers=2", "--LlamaConfig.emb_dim=64", "--LlamaConfig.nheads=4",
    "--LlamaConfig.kvheads=2", "--LlamaConfig.src_vocab_size=128", "--report_interval=2",
]
_ENV = dict(os.environ, PYTHONPATH=REPO)
_ENV.pop("FMS_FAULTS", None)


def _entry(tmp_path, *args, module="main_training_llama"):
    ck = str(tmp_path / "ck")
    return [sys.executable, "-u", "-m", f"fms_fsdp_tpu_torch.{module}",
            f"--ckpt_save_path={ck}", f"--ckpt_load_path={ck}", *args]


def _committed(tmp_path):
    steps = tmp_path / "ck" / "checkpoints"
    return sorted(int(d.split("_")[1]) for d in os.listdir(steps)
                  if (steps / d / "metadata.json").exists())


def test_watchdog_turns_a_parked_step_into_exit_2(tmp_path):
    obs = str(tmp_path / "obs")
    proc = subprocess.run(
        _entry(tmp_path, *_ENTRY_ARGS, "--num_steps=6", "--step_timeout_s=3",
               f"--obs_dir={obs}", "--faults=dcn_reduce_stall:step=3:seconds=120"),
        cwd=tmp_path, env=_ENV, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr[-3000:]
    assert "step watchdog [proc 0]: no training progress for" in proc.stderr
    assert f"last heartbeat ({obs}/heartbeat.json): {{'step': 2," in proc.stderr
    assert "Thread" in proc.stderr  # the stacks it dumped
    assert "step: 4" not in proc.stdout


def test_sigterm_saves_and_exits_clean(tmp_path):
    """SIGTERM after the step-2 report (step 3 is parked 3 s): the loop
    saves at the next boundary with reason preempt and exits 0."""
    obs = tmp_path / "obs"
    proc = subprocess.Popen(
        _entry(tmp_path, *_ENTRY_ARGS, "--num_steps=20", "--checkpoint_interval=100",
               f"--obs_dir={obs}", "--faults=dcn_reduce_stall:step=3:seconds=3"),
        cwd=tmp_path, env=_ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step: 2"):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines) + rest
    assert proc.returncode == 0, out[-3000:]
    saved = _committed(tmp_path)
    assert len(saved) == 1 and saved[0] in (2, 3), saved
    assert (f"preemption signal received: checkpoint saved at step {saved[0]}, "
            f"exiting clean") in out
    assert json.load(open(obs / "heartbeat.json"))["step"] == saved[0]
    meta = json.load(open(tmp_path / "ck" / "checkpoints" / f"step_{saved[0]}_ckp"
                          / "metadata.json"))
    assert meta["step"] == saved[0] and meta["tokens_seen"] == saved[0] * 2 * 32


def test_precommit_kill_leaves_a_torn_dir_the_resume_skips(tmp_path):
    args = [*_ENTRY_ARGS, "--num_steps=6", "--checkpoint_interval=2"]
    first = subprocess.run(_entry(tmp_path, *args, "--faults=ckpt_precommit_kill:step=4"),
                           cwd=tmp_path, env=_ENV, capture_output=True, text=True,
                           timeout=120)
    assert first.returncode == 7, first.stderr[-3000:]
    torn = tmp_path / "ck" / "checkpoints" / "step_4_ckp"
    assert (torn / "manifest.json").exists() and not (torn / "metadata.json").exists()
    assert _committed(tmp_path) == [2]
    second = subprocess.run(_entry(tmp_path, *args), cwd=tmp_path, env=_ENV,
                            capture_output=True, text=True, timeout=120)
    assert second.returncode == 0, second.stderr[-3000:]
    step2 = os.path.join(str(tmp_path / "ck"), "checkpoints", "step_2_ckp")
    assert f"Prior checkpoint {step2} detected." in second.stdout
    assert "step: 6" in second.stdout and 6 in _committed(tmp_path)


def test_supervisor_cli_restarts_a_nan_burst_to_completion(tmp_path):
    """The verify recipe at a tiny size: states 4-5 (loop steps 5-6) are
    poisoned, the first incarnation aborts classified at its step-6
    report after its abort save, the relaunch resumes at 6 and completes
    step 10; the records carry the restart."""
    obs, ledger = tmp_path / "obs", tmp_path / "ledger.json"
    child = _entry(tmp_path, *_ENTRY_ARGS, "--num_steps=10", "--checkpoint_interval=4",
                   "--anomaly_max_consecutive=2", f"--obs_dir={obs}")
    env = dict(_ENV, FMS_FAULTS="nan_loss:step=4:count=2")
    proc = subprocess.run(
        [sys.executable, "-u", "-m", "fms_fsdp_tpu_torch.resilience.supervisor",
         "--ledger", str(ledger), "--heartbeat", str(obs / "heartbeat.json"),
         "--target-step", "10", "--restart-backoff-s", "0.1", "--anomaly-cooldown-s", "0.1",
         "--log-dir", str(tmp_path / "logs"), "--", *child],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "[supervisor] completed: 1 restart(s), final step 10" in proc.stdout
    led = json.load(open(ledger))
    assert [e["classification"] for e in led["entries"]] == ["anomaly_abort", "ok"]
    assert [e["exit_codes"] for e in led["entries"]] == [[4], [0]]
    assert led["entries"][1]["resumed_step"] == 6 and led["restarts"] == 1
    log1 = open(tmp_path / "logs" / "attempt1_child0.log").read()
    assert "exit classified: anomaly_abort (exit 4)" in open(
        tmp_path / "logs" / "attempt0_child0.log").read()
    step6 = os.path.join(str(tmp_path / "ck"), "checkpoints", "step_6_ckp")
    assert f"Prior checkpoint {step6} detected." in log1
    records = [json.loads(line) for line in open(obs / "metrics.jsonl")]
    assert [r["step"] for r in records] == [2, 4, 6, 8, 10]
    assert records[2]["skipped_steps"] == 2 and records[-1]["skipped_steps"] == 0
    assert records[-1]["restarts"] == 1 and records[-1]["restart_downtime_s"] > 0
    assert all(validate_record(r) == [] for r in records)
    hb = json.load(open(obs / "heartbeat.json"))
    assert hb["step"] == 10 and hb["run_id"] == "ledger-i1"


def test_mamba_entry_exits_classified(tmp_path):
    args = ["--device=cpu", "--use_dummy_dataset=True", "--batch_size=2", "--seq_length=32",
            "--vocab_size=256", "--MambaConfig.d_model=64", "--MambaConfig.d_intermediate=128",
            "--MambaConfig.n_layer=2", "--MambaConfig.vocab_size=256",
            "--MambaConfig.attn_layer_idx=()", "--MambaConfig.d_state=16",
            "--MambaConfig.headdim=16", "--MambaConfig.chunk_size=16", "--report_interval=2",
            "--num_steps=8", "--anomaly_max_consecutive=2", "--faults=nan_loss:step=0:count=4"]
    proc = subprocess.run(_entry(tmp_path, *args, module="main_training_mamba"),
                          cwd=tmp_path, env=_ENV, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 4, proc.stderr[-3000:]
    assert "AnomalyAbort: anomaly guard: 2 consecutive non-finite steps" in proc.stderr
    assert "exit classified: anomaly_abort (exit 4)" in proc.stderr
    assert _committed(tmp_path) == [2]  # the abort save
