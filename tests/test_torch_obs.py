"""PyTorch port, observability (``fms_fsdp_tpu_torch/obs/``) against the
JAX package's ``fms_fsdp_tpu/obs/``: the same schema (version, fields,
digest, the same problems on the same malformed records), the same
records from ``Observer.report`` under the fixed clocks of
tests/test_obs.py (field by field, except MFU/HFU, whose peak is the
card's in the port), the same CSV columns, tracker keys and heartbeat,
and the same phase windows and goodput. Inputs come from numpy seeds.
"""

import csv
import json
import os

import numpy as np
import pytest

from fms_fsdp_tpu.obs import observer as j_observer
from fms_fsdp_tpu.obs import schema as j_schema
from fms_fsdp_tpu.obs import sinks as j_sinks
from fms_fsdp_tpu.obs import timing as j_timing
from fms_fsdp_tpu_torch.obs import observer as t_observer
from fms_fsdp_tpu_torch.obs import schema as t_schema
from fms_fsdp_tpu_torch.obs import sinks as t_sinks
from fms_fsdp_tpu_torch.obs import timing as t_timing
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PACKAGES = {
    "jax": (j_observer, j_schema, j_sinks, j_timing),
    "port": (t_observer, t_schema, t_sinks, t_timing),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def test_schema_version_fields_and_digest_equal():
    assert t_schema.SCHEMA_VERSION == j_schema.SCHEMA_VERSION == 15
    assert t_schema.SCHEMA_FIELDS == j_schema.SCHEMA_FIELDS
    assert list(t_schema.SCHEMA_FIELDS) == list(j_schema.SCHEMA_FIELDS)
    assert t_schema.schema_digest() == j_schema.schema_digest()
    assert t_schema.SCHEMA_DIGESTS == j_schema.SCHEMA_DIGESTS
    assert t_schema.schema_digest() == t_schema.SCHEMA_DIGESTS[t_schema.SCHEMA_VERSION]


def _record(pkg, clock=None, **kw):
    observer = PACKAGES[pkg][0]
    obs = observer.Observer(clock=clock or FakeClock(), strict_schema=True)
    args = dict(loss=2.5, tokens_per_sec_per_chip=1000.0, skipped_steps_total=0,
                skipped_steps_window=0)
    args.update(kw)
    return obs.report(10, 4, **args)


_MALFORMED = {
    "missing_required": lambda r: {k: v for k, v in r.items() if k != "goodput"},
    "wrong_type": lambda r: dict(r, loss="high"),
    "unknown_field": lambda r: dict(r, surprise=1),
    "version": lambda r: dict(r, schema_version=r["schema_version"] + 1),
    "bool_as_int": lambda r: dict(r, step=True),
    "bad_map": lambda r: dict(r, extra={"a": "x"}),
    "null_required": lambda r: dict(r, wall_s=None),
    "several": lambda r: dict({k: v for k, v in r.items() if k != "step"}, mfu="x", z=0),
}


@pytest.mark.parametrize("case", sorted(_MALFORMED))
def test_validate_record_same_problems(case):
    rec = _record("jax")
    assert t_schema.validate_record(rec) == j_schema.validate_record(rec) == []
    bad = _MALFORMED[case](rec)
    problems = j_schema.validate_record(bad)
    assert problems and t_schema.validate_record(bad) == problems


def _drive(pkg, script, seed):
    """One observer per package under one fake clock, driven by the same
    numpy-seeded script; returns the records."""
    observer = PACKAGES[pkg][0]
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    obs = observer.Observer(clock=clk, strict_schema=True, flops_per_token=100.0,
                            hfu_flops_per_token=120.0, peak_flops=1e6,
                            restarts=2, restart_downtime_s=7.5)
    obs.attach_checkpoint_stats(lambda: {"bg_s": 1.25, "in_flight": 1})
    records = []
    for step in range(1, 4):
        for phase, dt in zip(("data_wait", "compute", "checkpoint"), rng.uniform(0.1, 3, 3)):
            with obs.phase(phase):
                clk.tick(float(dt))
        clk.tick(float(rng.uniform(0, 1)))
        obs.registry.counter("feed.batches").add(int(rng.integers(1, 9)))
        obs.registry.hist("checkpoint.snapshot_s").record(float(rng.uniform(0, 1)))
        kw = dict(script)
        kw["tokens_per_sec_per_chip"] = float(rng.uniform(100, 5000))
        records.append(obs.report(step * 4, 4, **kw))
    return records


_SCRIPTS = {
    "clean": dict(loss=2.0, grad_norm=1.5, learning_rate=3e-4, tokens_seen=4096,
                  skipped_steps_total=0, skipped_steps_window=0, step_time_s=0.5,
                  memory_reserved_bytes=1 << 30, memory_allocated_bytes=1 << 29),
    "skipped": dict(loss=2.0, skipped_steps_total=3, skipped_steps_window=1,
                    tokens_per_sec_per_chip_overall=900.0, extra={"x": 1.0}),
    "poisoned": dict(loss=float("nan"), grad_norm=float("nan"), skipped_steps_total=4,
                     skipped_steps_window=4, extra={"window_poisoned": 1}),
    "data_mix": dict(loss=1.0, data_mix={"a.tokens_seen": 10.0, "a.target_share": 0.75,
                                         "a.realized_share": 0.7, "a.quarantined": 0}),
}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_observer_report_equal_under_fixed_clocks(script):
    """The records of tests/test_obs.py's fixed-clock reports, field by
    field; MFU/HFU too when both observers are handed the same peak (the
    port's own peak is the card's, tests/test_torch_card.py)."""
    j_recs = _drive("jax", _SCRIPTS[script], seed=7)
    t_recs = _drive("port", _SCRIPTS[script], seed=7)
    for j, t in zip(j_recs, t_recs):
        assert set(t) == set(j)
        for key in j:
            if key in ("time_unix",):
                continue
            assert t[key] == j[key], key
        assert t_schema.validate_record(t) == []


def test_observer_mfu_goodput_as_jax_test():
    """tests/test_obs.py::test_observer_report_derives_mfu_and_goodput."""
    clk = FakeClock()
    obs = t_observer.Observer(clock=clk, flops_per_token=100.0, hfu_flops_per_token=120.0,
                              peak_flops=1e6, strict_schema=True)
    with obs.phase("compute"):
        clk.tick(8.0)
    clk.tick(2.0)
    rec = obs.report(5, 4, loss=2.0, tokens_per_sec_per_chip=5000.0,
                     skipped_steps_total=1, skipped_steps_window=1)
    assert rec["mfu"] == pytest.approx(0.5) and rec["hfu"] == pytest.approx(0.6)
    assert rec["goodput"] == pytest.approx(8.0 * 0.75 / 10.0)


def test_build_observer_card_peak_and_refused_chip_hint(tmp_path):
    """On the CPU the port's MFU is null (no card peak); obs_chip_hint,
    a TPU generation in JAX, is refused; the file sinks and heartbeat
    attach on rank 0 only."""
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config

    cfg = TrainConfig(obs_dir=str(tmp_path / "obs"), obs_sinks="jsonl,csv", seq_length=128,
                      fsdp_activation_checkpointing=True, selective_checkpointing=0.5)
    obs = t_observer.build_observer(cfg, 0, model_cfg=get_model_config("llama3_194m_4k"),
                                    device="cpu")
    assert obs.peak_flops is None and obs.hfu_flops_per_token > obs.flops_per_token
    assert len(obs.sinks) == 2 and obs.heartbeat is not None
    assert t_observer.build_observer(cfg, 1).sinks == []
    rec = obs.report(1, 1, loss=1.0, tokens_per_sec_per_chip=10.0)
    assert rec["mfu"] is None and rec["hfu"] is None
    with pytest.raises(ValueError, match="obs_chip_hint"):
        t_observer.build_observer(TrainConfig(obs_chip_hint="v5e"), 0)


def test_restart_ledger_folds_into_records(tmp_path, monkeypatch):
    ledger = tmp_path / "ledger.json"
    ledger.write_text(json.dumps({"restarts": 2, "restart_downtime_s": 12.5}))
    monkeypatch.setenv("FMS_RESTART_LEDGER", str(ledger))
    from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
    from fms_fsdp_tpu_torch.config import TrainConfig

    recs = [pkg.build_observer(c, 0, clock=FakeClock()).report(
                1, 1, loss=1.0, tokens_per_sec_per_chip=1.0)
            for pkg, c in ((j_observer, JTrainConfig()), (t_observer, TrainConfig()))]
    assert [(r["restarts"], r["restart_downtime_s"]) for r in recs] == [(2, 12.5)] * 2


def test_csv_columns_equal(tmp_path):
    assert t_sinks.CSVSink.COLUMNS == j_sinks.CSVSink.COLUMNS
    rec = _record("jax")
    for pkg in ("jax", "port"):
        sink = PACKAGES[pkg][2].CSVSink(str(tmp_path / f"{pkg}.csv"))
        sink.emit(rec)
        sink.emit(rec)
        sink.close()
    rows = [list(csv.reader(open(tmp_path / f"{p}.csv"))) for p in ("jax", "port")]
    assert rows[0] == rows[1] and len(rows[1]) == 3


def test_tracker_sink_payload_equal():
    rec = _record("jax", extra={"moe": 0.5})
    logged = {}
    for pkg in ("jax", "port"):
        PACKAGES[pkg][2].TrackerSink(
            lambda d, step, pkg=pkg: logged.setdefault(pkg, (d, step))).emit(rec)
    assert logged["port"] == logged["jax"] and "current throughput (token per chip per sec)" \
        in logged["port"][0]


def test_tracker_sink_driven_by_a_callable_in_the_loop(tmp_path):
    """The tracker path with a plain callable standing in for wandb/aim:
    every report reaches it under the legacy keys."""
    import torch

    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.utils.train_utils import train

    calls = []
    obs = t_observer.build_observer(TrainConfig(), 0, tracker_fn=lambda d, step: calls.append(
        (step, d["loss"], d["skipped batches"])))

    def step_fn(state, batch):
        return {"loss": torch.tensor(float(batch)), "gnorm": torch.tensor(1.0), "lr": 1e-3,
                "nonfinite": 0.0}

    cfg = TrainConfig(num_steps=4, report_interval=2, batch_size=1, seq_length=4)
    train(cfg, {}, step_fn, 0, iter([1, 3, 5, 7]), device="cpu", observer=obs)
    assert calls == [(2, 2.0, 0), (4, 6.0, 0)]


@pytest.mark.parametrize("run_id", [None, "ledger-i3"])
def test_heartbeat_payload_equal(tmp_path, run_id):
    beats = {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / pkg / "heartbeat.json")
        PACKAGES[pkg][2].Heartbeat(path, run_id=run_id).beat(42, 1234.5, 0.875)
        beats[pkg] = PACKAGES[pkg][2].read_heartbeat(path)
    assert beats["port"] == beats["jax"]
    assert ("run_id" in beats["port"]) == (run_id is not None)


def test_build_sinks_same_errors(tmp_path):
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match="unknown obs sink"):
            PACKAGES[pkg][2].build_sinks(str(tmp_path), ["jsonl", "speedometer"])
        assert PACKAGES[pkg][2].build_sinks("", ["jsonl", "csv", "tracker"]) == []


def _timer_windows(timing, seed):
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    t = timing.PhaseTimer(clock=clk)
    windows = []
    for _ in range(4):
        with t.phase("compute"):
            clk.tick(float(rng.uniform(0, 2)))
            with t.phase("checkpoint"):
                clk.tick(float(rng.uniform(0, 5)))
            clk.tick(float(rng.uniform(0, 1)))
        with t.phase("data_wait"):
            clk.tick(float(rng.uniform(0, 1)))
        t.record("data_wait", float(rng.uniform(0, 0.5)))
        clk.tick(float(rng.uniform(0, 1)))
        windows.append(t.window())
    return windows


def _goodput(timing, windows, downtime):
    g = timing.GoodputTracker(restart_downtime_s=downtime)
    return [g.update(w, steps=4, skipped_steps=i % 3) for i, w in enumerate(windows)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phase_timer_and_goodput_windows_equal(seed):
    jw, tw = _timer_windows(j_timing, seed), _timer_windows(t_timing, seed)
    assert tw == jw
    assert t_timing.PHASES == j_timing.PHASES
    assert _goodput(t_timing, tw, 3.0) == _goodput(j_timing, jw, 3.0)
    assert _goodput(t_timing, [{"wall": 0.0, "compute": 0.0}], 0.0) == [(0.0, 0.0)]


@pytest.mark.parametrize("tracker", ["wandb", "aim"])
def test_tracker_without_its_package_raises_like_jax(tracker):
    """Neither package has wandb/aim here: a set tracker raises JAX's
    ImportError naming the package; an unknown one JAX's ValueError."""
    from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
    from fms_fsdp_tpu.utils.train_utils import get_tracker as j_get_tracker
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.utils.train_utils import get_tracker

    errors = []
    for fn, cfg in ((j_get_tracker, JTrainConfig(tracker=tracker)),
                    (get_tracker, TrainConfig(tracker=tracker))):
        with pytest.raises(ImportError) as err:
            fn(cfg, 0)
        errors.append(str(err.value))
        assert fn(cfg, 1) is None  # rank 0 only
    assert errors[0] == errors[1] == f"tracker is set to {tracker} but {tracker} is not installed."
    with pytest.raises(ValueError, match="not supported"):
        get_tracker(TrainConfig(tracker="tensorboard"), 0)


@pytest.mark.parametrize("steps,written", [(6, True), (4, True), (2, False)])
def test_windowed_profiler_window_and_early_close(tmp_path, steps, written):
    """wait 1, warmup 2, active 3: a trace is written after step 6, or by
    close() when the loop ends inside the active window; a loop that ends
    before it records nothing."""
    import torch

    from fms_fsdp_tpu_torch.utils.train_utils import WindowedProfiler

    prof = WindowedProfiler(logdir=str(tmp_path / "traces"), device="cpu")
    for _ in range(steps):
        torch.ones(8).sum()
        prof.step()
    prof.close()
    prof.close()  # idempotent
    files = os.listdir(tmp_path / "traces") if (tmp_path / "traces").exists() else []
    assert (len(files) == 1 and files[0].endswith(".pt.trace.json")) == written
