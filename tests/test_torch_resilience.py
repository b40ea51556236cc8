"""PyTorch port, resilience (``fms_fsdp_tpu_torch/resilience/``) against
the JAX package's: the exit-code registry and its classifiers, the fault
spec grammar and firing sequences, the run supervisor's ledgers on the
scripted worlds of tests/test_supervisor.py, the watchdog's stall report,
the scrubber's verdicts on the same checkpoints, and every fault site of
the checkpoint manager and the loader run in both packages from one
spec. Inputs come from numpy seeds.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

import fms_fsdp_tpu_torch.ckpt  # noqa: F401 — before utils.checkpointing, which it imports
from fms_fsdp_tpu.resilience import exits as j_exits
from fms_fsdp_tpu.resilience import faults as j_faults
from fms_fsdp_tpu.resilience import guards as j_guards
from fms_fsdp_tpu.resilience import scrub as j_scrub
from fms_fsdp_tpu.resilience import supervisor as j_sup
from fms_fsdp_tpu_torch.resilience import exits as t_exits
from fms_fsdp_tpu_torch.resilience import faults as t_faults
from fms_fsdp_tpu_torch.resilience import guards as t_guards
from fms_fsdp_tpu_torch.resilience import scrub as t_scrub
from fms_fsdp_tpu_torch.resilience import supervisor as t_sup
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_registries():
    """Both fault registries are process-global: reset around every test."""
    j_faults.configure_faults("")
    t_faults.configure_faults("")
    yield
    j_faults.configure_faults("")
    t_faults.configure_faults("")


# ---------------------------------------------------------------------------
# exit codes
# ---------------------------------------------------------------------------


def test_exit_codes_and_priority_equal():
    assert t_exits.EXIT_CODES == j_exits.EXIT_CODES
    assert t_exits.CLASSIFY_PRIORITY == j_exits.CLASSIFY_PRIORITY
    assert (t_exits.ENV_RUN_ID, t_exits.ENV_LEDGER) == (j_exits.ENV_RUN_ID, j_exits.ENV_LEDGER)
    assert len(set(t_exits.EXIT_CODES.values())) == len(t_exits.EXIT_CODES)


@pytest.mark.parametrize("code", [None] + list(range(-1, 13)))
def test_classify_exit_equal(code):
    assert t_exits.classify_exit(code) == j_exits.classify_exit(code)


@pytest.mark.parametrize("seed", range(4))
def test_classify_world_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        codes = [None if c < 0 else int(c)
                 for c in rng.integers(-2, 13, size=int(rng.integers(1, 5)))]
        assert t_exits.classify_world(codes) == j_exits.classify_world(codes), codes


def test_classify_exception_maps_the_ports_types():
    from fms_fsdp_tpu_torch.data.loader import LoaderWorkerError
    from fms_fsdp_tpu_torch.data.streaming import CorpusLossError
    from fms_fsdp_tpu_torch.utils.train_utils import AnomalyAbort

    assert t_exits.classify_exception(AnomalyAbort("x")) == "anomaly_abort"
    assert t_exits.classify_exception(LoaderWorkerError("x")) == "loader_death"
    assert t_exits.classify_exception(CorpusLossError("x")) == "corpus_loss"
    assert t_exits.classify_exception(RuntimeError("x")) is None


@pytest.mark.parametrize("exc,code", [
    ("fms_fsdp_tpu_torch.utils.train_utils:AnomalyAbort", 4),
    ("fms_fsdp_tpu_torch.data.loader:LoaderWorkerError", 5),
    ("fms_fsdp_tpu_torch.data.streaming:CorpusLossError", 8),
    ("builtins:ValueError", 1),
])
def test_classified_exit_codes(exc, code):
    mod, name = exc.split(":")
    script = (
        "import importlib\n"
        "from fms_fsdp_tpu_torch.resilience.exits import classified_exit\n"
        f"exc = getattr(importlib.import_module({mod!r}), {name!r})\n"
        "with classified_exit():\n"
        "    raise exc('boom')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == code, proc.stderr[-2000:]
    assert "boom" in proc.stderr


def test_run_id_and_ledger_readers(tmp_path, monkeypatch):
    monkeypatch.setenv("FMS_RUN_ID", "ledger-i2")
    ledger = tmp_path / "l.json"
    ledger.write_text('{"restarts": 3}')
    assert t_exits.current_run_id() == j_exits.current_run_id() == "ledger-i2"
    assert t_exits.read_restart_ledger(str(ledger)) == {"restarts": 3}
    ledger.write_text("{torn")
    assert t_exits.read_restart_ledger(str(ledger)) is None


# ---------------------------------------------------------------------------
# fault specs
# ---------------------------------------------------------------------------

_SPECS = [
    "shard_read:path=q1:times=2;nan_loss:step=5:count=3",
    "",
    "loader_worker:worker=1:batch=3:times=2",
    "ckpt_shard_corrupt:step=4:bytes=8:file=state",
    " nan_loss : step=2 ; ; dcn_reduce_stall:slice=0:seconds=7.5 ",
    "corpus_kill:corpus=dataset_2:times=1;slice_kill:step=6:code=3",
]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_spec_equal(spec):
    assert t_faults.parse_spec(spec) == j_faults.parse_spec(spec)


def test_parse_spec_rejects_alike():
    for pkg in (j_faults, t_faults):
        with pytest.raises(ValueError, match="expected key=value"):
            pkg.parse_spec("site:notakv")


_FIRES = [
    ("loader_worker:worker=1:batch=3:times=2",
     [("loader_worker", dict(worker=0, batch=3)), ("loader_worker", dict(worker=1, batch=2)),
      ("loader_worker", dict(worker=1, batch=3)), ("loader_worker", dict(worker=1, batch=3)),
      ("loader_worker", dict(worker=1, batch=3)), ("nope", {})]),
    ("shard_read:path=quarter:times=3",
     [("shard_read", dict(path="/d/quartershard_1.arrow", op="open"))] * 4
     + [("shard_read", dict(path="/d/full.arrow", op="open"))]),
    ("slice_kill:slice=1:step=6",
     [("slice_kill", dict(step=6, slice=0)), ("slice_kill", dict(step=5, slice=1)),
      ("slice_kill", dict(step=6)), ("slice_kill", dict(step=6, slice=1))]),
    ("ckpt_precommit_kill:step=4:tier=durable",
     [("ckpt_precommit_kill", dict(step=4, tier="local")),
      ("ckpt_precommit_kill", dict(step=4, tier="durable")),
      ("ckpt_precommit_kill", dict(step=8, tier="durable"))]),
]


@pytest.mark.parametrize("spec,calls", _FIRES)
def test_firing_sequence_equal(spec, calls):
    j_faults.configure_faults(spec)
    t_faults.configure_faults(spec)
    for site, ctx in calls:
        assert t_faults.fire_fault(site, **ctx) == j_faults.fire_fault(site, **ctx), (site, ctx)
    for site in t_faults.parse_spec(spec):
        assert t_faults.fault_params(site) == j_faults.fault_params(site)


def test_env_spec_read_lazily(monkeypatch):
    monkeypatch.setenv("FMS_FAULTS", "nan_loss:step=2:count=4")
    t_faults._SPECS = None
    assert t_faults.fault_params("nan_loss") == {"step": 2, "count": 4}


@pytest.mark.parametrize("spec,item", [
    ("handoff_chunk_corrupt:every=3", "A.10"),
    ("replica_kill", "A.10"),
    ("replica_stall:seconds=3", "A.10"),
    ("nan_loss:step=1;handoff_chunk_drop:every=5", "A.10"),
    ("transport_stall", "A.10"),
])
def test_unported_sites_refused(spec, item, monkeypatch):
    """The serving sites (ROADMAP.md A.10) have their call sites now: each
    spec configures, from the argument and from the environment, and reads
    as JAX's does. The refusal stays for any site listed as unported."""
    assert t_faults.UNPORTED_SITES == {}
    t_faults.configure_faults(spec)
    j_faults.configure_faults(spec)
    for site in t_faults.parse_spec(spec):
        assert t_faults.fault_params(site) == j_faults.fault_params(site)
    j_faults.configure_faults("")
    monkeypatch.setenv("FMS_FAULTS", spec)
    t_faults._SPECS = None
    t_faults.fire_fault("nan_loss", step=1)
    assert set(t_faults._SPECS) == set(t_faults.parse_spec(spec))
    site = next(iter(t_faults.parse_spec(spec)))
    monkeypatch.setitem(t_faults.UNPORTED_SITES, site, item)
    with pytest.raises(NotImplementedError, match=item):
        t_faults.configure_faults(spec)


# ---------------------------------------------------------------------------
# the run supervisor on scripted worlds (tests/test_supervisor.py)
# ---------------------------------------------------------------------------


class _FakeWorld:
    """Scripted incarnations: each launch pops (exit_codes, hb_step) and
    writes the heartbeat the way a real child would (run-id stamped)."""

    def __init__(self, script, hb_path):
        self.script = list(script)
        self.hb_path = hb_path
        self.launches = []

    def __call__(self, specs, attempt, run_id):
        codes, step = self.script.pop(0)
        self.launches.append((attempt, run_id, specs))
        if step is not None:
            os.makedirs(os.path.dirname(self.hb_path), exist_ok=True)
            with open(self.hb_path, "w") as f:
                json.dump({"step": step, "run_id": run_id}, f)
        return codes


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _run(pkg, tmp, script, stale_hb=None, **kw):
    hb = str(tmp / "obs" / "heartbeat.json")
    if stale_hb is not None:
        os.makedirs(os.path.dirname(hb), exist_ok=True)
        with open(hb, "w") as f:
            json.dump(stale_hb, f)
    world = _FakeWorld(script, hb)
    slept, ctxs = [], []

    def build(ctx):
        ctxs.append({k: ctx[k] for k in ("attempt", "run_id", "num_slices", "restarts",
                                         "verified_resume")})
        return [["cmd", f"--num_slices={ctx['num_slices']}"]]

    sup = pkg.RunSupervisor(build, ledger_path=str(tmp / "ledger.json"), heartbeat_path=hb,
                            launch=world, clock=_Clock(), sleep=slept.append,
                            log=lambda m: None, **kw)
    res = sup.run()
    return {"status": res.status, "restarts": res.restarts, "final_step": res.final_step,
            "ledger": res.ledger, "post_mortem": res.post_mortem.replace(str(tmp), "<tmp>"),
            "slept": slept, "ctxs": ctxs, "launches": world.launches}


_WORLDS = {
    "completion": ([([0, 0], 100)], dict(target_step=100)),
    "preemption": ([([0], 40), ([0], 100)], dict(target_step=100)),
    "slice_loss_shrink": ([([7, 7, 3, 3], 6), ([0], 100)],
                          dict(target_step=100, num_slices=2, restart_backoff_s=0.0)),
    "slice_loss_same": ([([3, 7], 6), ([0], 100)],
                        dict(target_step=100, num_slices=2, on_slice_loss="same",
                             restart_backoff_s=0.0)),
    "backoff_and_cooldown": ([([1], 10), ([1], 20), ([4], 30), ([0], 100)],
                             dict(target_step=100, restart_backoff_s=2.0,
                                  anomaly_cooldown_s=60.0)),
    "backoff_doubles": ([([1], 10)] * 3 + [([0], 100)],
                        dict(target_step=100, restart_backoff_s=1.0, crash_loop_threshold=10)),
    "crash_loop": ([([1], 8)] * 5,
                   dict(target_step=100, restart_backoff_s=0.0, crash_loop_threshold=3)),
    "max_restarts": ([([2], 10 * (i + 1)) for i in range(10)],
                     dict(target_step=10_000, restart_backoff_s=0.0, max_restarts=4,
                          crash_loop_threshold=100)),
    "anomaly_aborts": ([([4], 14), ([4], 18), ([0], 24)],
                       dict(target_step=24, restart_backoff_s=0.5, anomaly_cooldown_s=1.0)),
    "divergence_verified_resume": ([([9, 9], 10), ([0], 100)], dict(target_step=100)),
    "loader_and_corpus": ([([5], 4), ([8], 6), ([0, 7], 9), ([0], 12)],
                          dict(target_step=12, restart_backoff_s=0.25)),
}


@pytest.mark.parametrize("world", sorted(_WORLDS))
def test_supervisor_ledgers_equal(world, tmp_path):
    script, kw = _WORLDS[world]
    j = _run(j_sup, tmp_path / "jax", script, **kw)
    t = _run(t_sup, tmp_path / "port", script, **kw)
    assert t == j


def test_supervisor_ignores_stale_heartbeat_alike(tmp_path):
    stale = {"step": 500, "run_id": "someone-else"}
    kw = dict(target_step=1000, restart_backoff_s=0.0, crash_loop_threshold=3)
    script = [([1], None)] * 3
    j = _run(j_sup, tmp_path / "jax", script, stale_hb=stale, **kw)
    t = _run(t_sup, tmp_path / "port", script, stale_hb=stale, **kw)
    assert t == j and t["status"] == "crash_loop"


def test_supervisor_resumes_prior_ledger_alike(tmp_path):
    out = {}
    for name, pkg in (("jax", j_sup), ("port", t_sup)):
        tmp = tmp_path / name
        first = _run(pkg, tmp, [([1], 10), ([1], 20), ([1], 30)], target_step=100,
                     restart_backoff_s=0.0, max_restarts=2, crash_loop_threshold=10)
        second = _run(pkg, tmp, [([0], 100)], target_step=100, max_restarts=5)
        out[name] = (first, second)
    assert out["port"] == out["jax"]
    assert out["port"][1]["launches"][0][0] == 3


def test_supervisor_refuses_target_without_heartbeat(tmp_path):
    with pytest.raises(ValueError, match="heartbeat_path"):
        t_sup.RunSupervisor(lambda ctx: [["cmd"]], ledger_path=str(tmp_path / "l.json"),
                            target_step=100)


def test_supervise_from_config_reads_knobs(tmp_path):
    from fms_fsdp_tpu_torch.config import TrainConfig

    sup = t_sup.supervise_from_config(
        TrainConfig(max_restarts=2, restart_backoff_s=7.5, crash_loop_threshold=5),
        lambda ctx: [["cmd"]], ledger_path=str(tmp_path / "l.json"))
    assert (sup.max_restarts, sup.restart_backoff_s, sup.crash_loop_threshold) == (2, 7.5, 5)


def test_default_policies_equal():
    for kw in ({}, {"anomaly_cooldown_s": 3.0, "on_slice_loss": "same"}):
        assert {k: vars(v) for k, v in t_sup.default_policies(**kw).items()} == \
            {k: vars(v) for k, v in j_sup.default_policies(**kw).items()}


# ---------------------------------------------------------------------------
# the step watchdog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hb,run_id", [
    (None, None),
    ({"step": 12, "time_unix": 5.0, "goodput": 0.5, "schema_version": 15}, None),
    ({"step": 12, "run_id": "ledger-i0"}, "ledger-i1"),
    ({"step": 12, "run_id": "ledger-i1"}, "ledger-i1"),
])
def test_watchdog_stall_report_equal(tmp_path, hb, run_id):
    path = None
    if hb is not None:
        path = str(tmp_path / "heartbeat.json")
        with open(path, "w") as f:
            json.dump(hb, f)
    j = j_guards.StepWatchdog(30.0, heartbeat_path=path, process_index=0, run_id=run_id)
    t = t_guards.StepWatchdog(30.0, heartbeat_path=path, process_index=0, run_id=run_id)
    assert t._stall_report(42.5) == j._stall_report(42.5)
    assert t_guards.StepWatchdog.EXIT_CODE == j_guards.StepWatchdog.EXIT_CODE == 2


def test_watchdog_exits_2_with_stacks_and_is_quiet_when_fed():
    script = (
        "import time\n"
        "from fms_fsdp_tpu_torch.resilience.guards import StepWatchdog\n"
        "w = StepWatchdog(2.0).start()\n"
        "for _ in range(5):\n"
        "    w.beat(); time.sleep(0.3)\n"
        "with w.paused():\n"
        "    time.sleep(3.0)\n"
        "print('fed through', flush=True)\n"
        "time.sleep(60)\n"
        "print('unreachable')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 2, proc.stderr[-1000:]
    assert "fed through" in proc.stdout and "unreachable" not in proc.stdout
    assert "step watchdog: no training progress" in proc.stderr
    assert "File" in proc.stderr  # the stack dump
    with pytest.raises(ValueError):
        t_guards.StepWatchdog(0.0)


# ---------------------------------------------------------------------------
# the scrubber: the same verdicts on the same checkpoints
# ---------------------------------------------------------------------------


def _committed_dirs(root, steps, seed=0):
    """Committed step dirs the port's save path writes: payload files,
    the manifest, the metadata.json marker, then the corruption sites."""
    from fms_fsdp_tpu_torch.utils.checkpointing import Checkpointer

    ck = Checkpointer(str(root), 100, "fsdp")
    rng = np.random.default_rng(seed)
    for step in steps:
        d = os.path.join(ck.ckp_path, f"step_{step}_ckp")
        os.makedirs(os.path.join(d, "state"))
        for i, n in enumerate((3 << 20, 4096)):
            with open(os.path.join(d, "state", f"__0_{i}.distcp"), "wb") as f:
                f.write(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        ck.commit(d, {"step": step}, step)
    return ck.ckp_path


@pytest.mark.parametrize("spec,want", [
    ("", {"verified": 3, "quarantined": 0, "legacy": 0}),
    ("ckpt_shard_corrupt:step=4", {"verified": 2, "quarantined": 1, "legacy": 0}),
    ("ckpt_shard_corrupt:step=4:file=__0_1:bytes=1", {"verified": 2, "quarantined": 1,
                                                       "legacy": 0}),
    ("ckpt_corrupt:step=6", {"verified": 2, "quarantined": 1, "legacy": 0}),
])
def test_scrub_pass_equal_on_the_same_checkpoints(tmp_path, spec, want, capsys):
    t_faults.configure_faults(spec)
    src = _committed_dirs(tmp_path / "src", (2, 4, 6))
    counts = {}
    for name, pkg in (("jax", j_scrub), ("port", t_scrub)):
        root = str(tmp_path / name)
        shutil.copytree(src, root)
        pkg.reset_cache()
        counts[name] = pkg.scrub_pass([root])
        quarantined = sorted(d for d in os.listdir(root)
                             if pkg.is_quarantined(os.path.join(root, d)))
        counts[name + "_quarantined"] = quarantined
        assert pkg.total_verified() == want["verified"]
        # a second sweep reads the cached verdicts: the same counts
        assert pkg.scrub_pass([root]) == counts[name]
    assert counts["port"] == counts["jax"] == want
    assert counts["port_quarantined"] == counts["jax_quarantined"]
    assert capsys.readouterr().out.count("INTEGRITY: checkpoint") == 2 * want["quarantined"]
    t_scrub.reset_cache()
    j_scrub.reset_cache()


def test_scrubber_thread_cadence_and_release(tmp_path):
    t_faults.configure_faults("ckpt_shard_corrupt:step=2")
    root = _committed_dirs(tmp_path, (2, 4))
    t_scrub.reset_cache()
    lines = []
    scrubber = t_scrub.CheckpointScrubber([root], 4, report=lines.append)
    fired = []
    for step in (2, 4, 6, 8):
        fired.append(scrubber.maybe_scrub(step))
        scrubber.stop(timeout_s=30)
    assert fired == [True, False, True, False]
    assert scrubber.last_counts == {"verified": 1, "quarantined": 1, "legacy": 0}
    bad = os.path.join(root, "step_2_ckp")
    assert t_scrub.is_quarantined(bad) and "quarantined" in lines[0]
    assert t_scrub.total_verified() == 1
    assert t_scrub.release_quarantine(bad) and not t_scrub.is_quarantined(bad)
    assert not t_scrub.release_quarantine(bad)
    assert t_scrub.scrub_roots(type("C", (), {"ckp_path": root})()) == [root]
    t_scrub.reset_cache()


# ---------------------------------------------------------------------------
# the checkpoint manager's fault sites
# ---------------------------------------------------------------------------


def _mgr_state(tmp_path, **kw):
    from fms_fsdp_tpu_torch.ckpt import build_checkpoint_manager
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.models.configs import LlamaConfig
    from fms_fsdp_tpu_torch.train.step import init_train_state

    cfg = TrainConfig(ckpt_save_path=str(tmp_path), mixed_precision=False,
                      ckpt_durable_backoff_s=0.01, **kw)
    model = LlamaConfig(src_vocab_size=64, emb_dim=32, nheads=2, kvheads=1, nlayers=1,
                        max_expected_seq_len=32)
    state = init_train_state(torch.Generator().manual_seed(0), model, cfg)
    return build_checkpoint_manager(cfg, 0), state


def test_writer_crash_surfaces_in_the_next_save(tmp_path):
    t_faults.configure_faults("ckpt_writer_crash:step=2")
    mgr, state = _mgr_state(tmp_path)
    mgr.save(2, state)
    with pytest.raises(RuntimeError, match="background checkpoint writer failed") as err:
        mgr.save(4, state)
    assert "injected fault at site 'ckpt_writer_crash'" in str(err.value.__cause__)
    mgr.finalize()
    steps = os.path.join(str(tmp_path), "checkpoints")
    assert not os.path.exists(os.path.join(steps, "step_2_ckp", "metadata.json"))


@pytest.mark.parametrize("spec,committed", [
    ("ckpt_durable_write:step=2:times=2", True),   # absorbed by the bounded retry
    ("ckpt_durable_write:step=2", False),          # exhausts it: the writer fails
])
def test_durable_write_retry(tmp_path, spec, committed):
    t_faults.configure_faults(spec)
    mgr, state = _mgr_state(tmp_path, ckpt_durable_retries=2)
    mgr.save(2, state, reason="final")
    if committed:
        mgr.finalize()
    else:
        with pytest.raises(RuntimeError, match="writer failed"):
            mgr.finalize()
    marker = os.path.join(str(tmp_path), "checkpoints", "step_2_ckp", "metadata.json")
    assert os.path.exists(marker) == committed


def test_observer_attached_to_the_manager_gets_its_window(tmp_path):
    from fms_fsdp_tpu_torch.obs.observer import Observer

    mgr, state = _mgr_state(tmp_path)
    obs = Observer(strict_schema=True)
    mgr.observer = obs
    mgr.save(2, state)
    mgr.finalize()
    rec = obs.report(2, 2, loss=1.0, tokens_per_sec_per_chip=1.0)
    assert rec["checkpoint_bg_s"] > 0 and rec["checkpoint_in_flight"] == 0
    assert rec["checkpoint_s"] > 0
    assert rec["extra"]["checkpoint.saves.durable"] == 1
    assert rec["extra"]["checkpoint.bytes"] > 0


# ---------------------------------------------------------------------------
# the loader's fault sites, one spec in both packages
# ---------------------------------------------------------------------------


class _CounterPipeline:
    """Minimal stateful pipeline: yields [rank, n] (tests/test_resilience.py)."""

    def __init__(self, rank=0, worldsize=1):
        self.rank, self.worldsize = rank, worldsize
        self.local_worldsize = -1
        self.load_worldsize = worldsize
        self.datapath = None
        self.n = 0

    def setup(self):
        pass

    def __iter__(self):
        while True:
            yield np.array([self.rank, self.n], dtype=np.int64)
            self.n += 1

    def state_dict(self):
        return {"n": self.n, "rank": self.rank}

    def load_state_dict(self, sds, sharded_input=False):
        self.n = sds[0]["n"]


def _loader_walk(loader_mod, spec, n, faults, **kw):
    faults.configure_faults(spec)
    loader = loader_mod.StatefulDataLoader(_CounterPipeline(), batch_size=2,
                                           restart_backoff_s=0.01, **kw)
    out = []
    try:
        it = iter(loader)
        for _ in range(n):
            out.append(next(it))
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        out.append(f"{type(e).__name__}: {e}")
    finally:
        loader.shutdown()
    return out


@pytest.mark.parametrize("spec,kw", [
    ("loader_worker:worker=1:batch=2:times=1", dict(num_workers=2, max_worker_restarts=2)),
    ("loader_worker:worker=0", dict(num_workers=2, max_worker_restarts=1)),
    ("loader_worker:batch=3", dict(num_workers=0)),
])
def test_loader_worker_site_equal(spec, kw, capsys):
    from fms_fsdp_tpu.data import loader as j_loader
    from fms_fsdp_tpu_torch.data import loader as t_loader

    j = _loader_walk(j_loader, spec, 8, j_faults, **kw)
    t = _loader_walk(t_loader, spec, 8, t_faults, **kw)
    assert len(t) == len(j)
    for a, b in zip(j, t):
        if isinstance(a, str):
            assert a == b
        else:
            assert np.array_equal(a, b)
    out = capsys.readouterr().out
    if kw.get("num_workers"):
        assert out.count("restart 1/") == 2
    else:
        assert "injected loader worker crash (worker 0, batch 3)" in j[-1]


def test_process_worker_exit_site_restarts(capsys):
    from fms_fsdp_tpu_torch.data import loader as t_loader

    out = _loader_walk(t_loader, "loader_worker:worker=1:batch=2:action=exit:code=5", 8,
                       t_faults, num_workers=2, worker_mode="process", max_worker_restarts=2)
    printed = capsys.readouterr().out
    assert len(out) == 8 and all(not isinstance(b, str) for b in out)
    assert "restart 1/2" in printed and "will repeat" in printed


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    """dataset_1: one 100-doc shard; dataset_2: two 50-doc shards; meta."""
    root = tmp_path_factory.mktemp("data")
    schema = pa.schema([pa.field("tokens", pa.uint32())])
    for corpus, shards in (("dataset_1", {"full.arrow": (100, 100, 0)}),
                           ("dataset_2", {"q1.arrow": (50, 50, 0), "q2.arrow": (50, 50, 2500)})):
        os.makedirs(root / corpus)
        for name, (docs, size, base) in shards.items():
            with pa.ipc.new_file(str(root / corpus / name), schema) as w:
                for i in range(docs):
                    w.write(pa.record_batch(
                        [list(range(base + i * size, base + (i + 1) * size))], schema))
    os.makedirs(root / "meta")
    with open(root / "meta" / "combined_counts.csv", "w") as f:
        f.write("dataset/filename,documents,tokens\n/dataset_1/full.arrow,100,10000\n"
                "/dataset_2/q1.arrow,50,2500\n/dataset_2/q2.arrow,50,2500\n")
    return str(root)


def _sampler(streaming, handlers, datadir, **kw):
    reader = streaming.StreamingDocDataset(os.path.join(datadir, "dataset_1"), 0, 1,
                                           handlers.ArrowHandler(), -1, max_chunksize=1000)
    return streaming.SamplingDataset(datadir, reader, -1, datasets=["dataset_1", "dataset_2"],
                                     weights=[1, 1], **kw)


@pytest.mark.parametrize("spec,pulls", [
    ("corpus_kill:corpus=dataset_2", 40),
    ("corpus_kill:corpus=dataset_2:times=2", 120),
])
def test_corpus_kill_site_equal(datadir, spec, pulls):
    from fms_fsdp_tpu.data import handlers as j_handlers
    from fms_fsdp_tpu.data import streaming as j_streaming
    from fms_fsdp_tpu_torch.data import handlers as t_handlers
    from fms_fsdp_tpu_torch.data import streaming as t_streaming

    seen = {}
    for name, streaming, handlers, faults in (
            ("jax", j_streaming, j_handlers, j_faults),
            ("port", t_streaming, t_handlers, t_faults)):
        faults.configure_faults(spec)
        streaming.drain_mix_events()
        d = _sampler(streaming, handlers, datadir)
        it = iter(d)
        outs = [np.asarray(next(it)) for _ in range(pulls)]
        seen[name] = (outs, d.quarantined_corpora, list(d.tokens_seen),
                      streaming.drain_mix_events())
    assert seen["port"][1:] == seen["jax"][1:]
    assert all(np.array_equal(a, b) for a, b in zip(seen["port"][0], seen["jax"][0]))
    assert seen["port"][3]["corpus_quarantined"] == 1


def test_corpus_kill_below_the_floor_is_corpus_loss(datadir):
    from fms_fsdp_tpu_torch.data import handlers as t_handlers
    from fms_fsdp_tpu_torch.data import streaming as t_streaming

    t_faults.configure_faults("corpus_kill:corpus=dataset_2")
    d = _sampler(t_streaming, t_handlers, datadir, min_live_corpora=2)
    with pytest.raises(t_streaming.CorpusLossError, match="min_live_corpora"):
        next(iter(d))
    assert t_exits.classify_exception(t_streaming.CorpusLossError("x")) == "corpus_loss"


@pytest.mark.parametrize("spec,retries,ok", [
    ("shard_read:path=q1:times=2", 3, True),   # transient: absorbed by the retry
    ("shard_read:path=q1", 1, False),          # permanent: exhausts it
    ("shard_read:path=q1:op=length", 0, True),  # another op's filter: opens pass
])
def test_shard_read_site_equal(datadir, spec, retries, ok):
    from fms_fsdp_tpu.data import handlers as j_handlers
    from fms_fsdp_tpu.resilience import retry as j_retry
    from fms_fsdp_tpu_torch.data import handlers as t_handlers
    from fms_fsdp_tpu_torch.resilience import retry as t_retry

    path = os.path.join(datadir, "dataset_2", "q1.arrow")
    got = {}
    for name, retry, handlers, faults in (("jax", j_retry, j_handlers, j_faults),
                                          ("port", t_retry, t_handlers, t_faults)):
        faults.configure_faults(spec)
        h = retry.RetryingShardHandler(handlers.ArrowHandler(), retries=retries,
                                       backoff_s=0.001)
        try:
            got[name] = list(h.get(h.open(path), 3, set()))
        except OSError as e:
            got[name] = str(e)
    assert got["port"] == got["jax"]
    assert isinstance(got["port"], list) == ok
