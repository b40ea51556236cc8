"""PyTorch port, the serving fleet: held against the JAX package.

- Every case of JAX's tests/test_fleet.py (journal, keep-N replica
  supervision, the router on fake replicas, typed admission, and the
  engine satellites on the TINY Llama) and the router cases of
  tests/test_disagg.py (prefill/decode roles on fake replicas) run
  unchanged on the port's classes (``tests/torch_jax_cases.py``).
- One scripted schedule on fake replicas and a fake clock (a death, a
  stall, a prefill death, a decode death after a handoff) writes the same
  journal event log and the same ``ReplicaSetSupervisor`` ledger through
  both packages.
- A subprocess fleet on the CPU: a prefill replica and two decode
  replicas (``python -m fms_fsdp_tpu_torch.serve.replica --device cpu``)
  over the chunked transport, decode replica 1 killed by ``replica_kill``
  after it took a handoff: every request completes once, with the tokens
  of an in-process engine on the same seed's weights.
"""

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.models.llama import init_llama_params
from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
from fms_fsdp_tpu_torch.serve.fleet import FleetConfig, FleetRouter, make_subprocess_spawn
from torch_jax_cases import export_tests, port_cases

_FLEET = port_cases("test_fleet.py", start="import json")
_DISAGG = port_cases(
    "test_disagg.py", start="class FakeClock:",
    prelude="import base64\nimport json\nimport pytest\n"
            "from fms_fsdp_tpu.serve.fleet import FleetConfig, FleetRouter",
)
JAX_CASES = export_tests(_FLEET, globals()) + export_tests(_DISAGG, globals())

_TINY_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                max_expected_seq_len=256)
TINY = LlamaConfig(**_TINY_KW)


@pytest.fixture(scope="module")
def tiny_setup():
    """JAX's TINY Llama weights (PRNGKey 0) on the CPU, through the bridge."""
    from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
    from fms_fsdp_tpu.models.llama import init_llama_params as j_init

    np_params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), JLlamaConfig(**_TINY_KW)))
    yield TINY, params_from_numpy(np_params, "cpu")
    jax.clear_caches()


def _engine(tiny_setup, clk=None, **kw):
    cfg, params = tiny_setup
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("attn_impl", "reference")
    kw.setdefault("page_size", 16)
    extra = {} if clk is None else {"clock": clk}
    return ServingEngine(params, cfg, ServeConfig(**kw), device="cpu", **extra)


# the engine satellites of test_fleet.py build their engines here
_FLEET["_engine"] = _engine


def test_jax_cases_replayed():
    assert len(JAX_CASES) >= 25
    for name in ("test_router_death_requeues_and_completes_exactly_once",
                 "test_supervisor_availability_folds_downtime",
                 "test_engine_drain_refuses_admission_and_drains",
                 "test_router_decode_death_post_handoff_replays_bytes"):
        assert name in JAX_CASES


# ---------------------------------------------------------------------------
# one scripted schedule through both packages: the same journal and ledger
# ---------------------------------------------------------------------------


def _schedule(ns, disagg, tmp, tag):
    """Drive ns's router on fake replicas through a death and a stall
    (unified fleet) or a prefill death and a decode death after a handoff
    (disaggregated fleet); returns (journal events, ledger, stats)."""
    clk = ns["FakeClock"]()
    paths = {"journal_path": str(tmp / f"{tag}.jsonl"), "ledger_path": str(tmp / f"{tag}.json")}
    if disagg:
        router, replicas = ns["_disagg_fleet"](clk, n=3, prefill=1, **paths)
    else:
        router, replicas = ns["_fleet"](clk, n=2, stall_timeout_s=3.0, **paths)
    router.start()
    rids = [router.submit([1, 2, i], 4) for i in range(8)]

    def chaos(i):
        if disagg:
            if i == 1:
                replicas[0].dead = 10  # the prefill worker, mid-handoff
            if replicas[1].work and replicas[1].dead is None and i > 3:
                replicas[1].dead = 10  # a decode replica that took handoffs
        else:
            if i == 1:
                replicas[0].dead = 10
            if i == 4:
                replicas[1].wedged = True

    done = ns["_drive"](router, replicas, clk, 120, on_tick=chaos)
    assert sorted(r.rid for r in done) == rids
    stats = router.stats()
    router.shutdown()
    events = [json.loads(line) for line in open(paths["journal_path"])]
    return events, json.load(open(paths["ledger_path"])), stats


@pytest.mark.parametrize("disagg", [False, True])
def test_scripted_schedule_journal_and_ledger_equal_jax(tmp_path, disagg):
    if disagg:
        j_ns = port_cases("test_disagg.py", start="class FakeClock:", port=False,
                          prelude="import base64\nimport json\nimport pytest\n"
                                  "from fms_fsdp_tpu.serve.fleet import FleetConfig, FleetRouter")
        t_ns = _DISAGG
    else:
        j_ns = port_cases("test_fleet.py", start="import json", port=False)
        t_ns = _FLEET
    t_events, t_ledger, t_stats = _schedule(t_ns, disagg, tmp_path, "port")
    j_events, j_ledger, j_stats = _schedule(j_ns, disagg, tmp_path, "jax")
    assert t_events == j_events
    assert t_ledger == j_ledger
    assert t_stats == j_stats
    assert t_ledger["restarts"] >= 1 and t_stats["availability"] < 1.0
    kinds = {e["event"] for e in t_events}
    assert "requeue" in kinds and "complete" in kinds
    if disagg:
        assert "handoff" in kinds


# ---------------------------------------------------------------------------
# a subprocess fleet on the CPU: real replica children, one kill
# ---------------------------------------------------------------------------


def test_subprocess_fleet_kill_token_identity(tmp_path):
    """One prefill and two decode ``--device cpu`` children over the
    chunked transport; decode replica 1 dies (``replica_kill``) after it
    has imported a handoff. Every request completes exactly once with the
    tokens of an in-process unified engine on the same seed's weights; the
    ledger shows the loss; each child that drained reports decode-step and
    launch counts (no kernel on the CPU)."""
    cfg = LlamaConfig(**dict(_TINY_KW, src_vocab_size=256))
    scfg = dict(max_batch=4, max_seq_len=64, compute_dtype="float32", page_size=16)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, size=int(n)).tolist() for n in rng.randint(4, 30, size=8)]
    ref = ServingEngine(init_llama_params(torch.Generator().manual_seed(3), cfg), cfg,
                        ServeConfig(**scfg), device="cpu")
    ref_reqs = [ref.submit(p, 6) for p in prompts]
    ref.run()

    spawn = make_subprocess_spawn(
        str(tmp_path), dataclasses.asdict(cfg), scfg, init_seed=3, device="cpu",
        prefill_replicas=1, faults="replica_kill:replica=1:step=3",
        python=sys.executable, env_extra={"OMP_NUM_THREADS": "1"},
    )
    router = FleetRouter(spawn, FleetConfig(
        n_replicas=3, prefill_replicas=1, max_seq_len=64, max_inflight_per_replica=4,
        startup_timeout_s=120.0, stall_timeout_s=60.0, restart_backoff_s=0.1,
        # a loaded CPU host: a chunk waits out a slow receiver for ~8 s
        transport_retries=10, transport_backoff_s=0.2,
        journal_path=str(tmp_path / "journal.jsonl"),
        ledger_path=str(tmp_path / "ledger.json"),
    ), log=lambda m: None)
    router.start()
    try:
        # the wave only once every replica is up: a decode replica still
        # starting when the handoffs arrive would take none, and the kill
        # on replica 1 would never fire
        router.wait_ready(tick_s=0.002)
        rids = [router.submit(p, 6) for p in prompts]
        router.run_until_idle(timeout_s=240.0, tick_s=0.002)
        router.drain(timeout_s=30.0)
    finally:
        router.shutdown()
    recs = router.journal.records
    assert [recs[r].tokens for r in rids] == [r.generated for r in ref_reqs]
    assert sorted(r.rid for r in router.completed) == rids  # each exactly once
    stats = router.stats()
    assert stats["requests_handed_off"] >= len(rids)
    assert stats["duplicates_dropped"] == 0 and stats["availability"] < 1.0
    ledger = json.load(open(tmp_path / "ledger.json"))
    lost = [e for e in ledger["entries"] if e["replica"] == 1 and e["incarnation"] == 0]
    assert lost and lost[0]["classification"] == "replica_loss"
    reports = {p.name: json.load(open(p)) for p in tmp_path.glob("*.stats.json")}
    assert "replica0-i0.stats.json" in reports
    for name, rep in reports.items():
        assert rep["launches"] == {"v1": 0, "v2": 0}  # the reference attention on the CPU
        if rep["role"] == "prefill":
            assert rep["decode_steps"] == 0
    assert sum(r["decode_steps"] for r in reports.values() if r["role"] == "decode") > 0


def test_subprocess_fleet_returns_a_rid_whose_handoff_failed(tmp_path):
    """The prefill child's first handoff loses its chunk
    (``handoff_chunk_drop``, no resend allowed): its sender gives up and
    the child hands the rid back (``returned``); the router re-prefills it
    and every request still completes once with the reference tokens."""
    cfg = LlamaConfig(**dict(_TINY_KW, src_vocab_size=256))
    scfg = dict(max_batch=4, max_seq_len=64, compute_dtype="float32", page_size=16)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8], [1, 4, 1, 4, 2, 1, 3]]
    ref = ServingEngine(init_llama_params(torch.Generator().manual_seed(4), cfg), cfg,
                        ServeConfig(**scfg), device="cpu")
    ref_reqs = [ref.submit(p, 5) for p in prompts]
    ref.run()
    spawn = make_subprocess_spawn(
        str(tmp_path), dataclasses.asdict(cfg), scfg, init_seed=4, device="cpu",
        prefill_replicas=1, faults="handoff_chunk_drop:transport=rep0.tx:times=1",
        retries=0, backoff_s=0.5, python=sys.executable,
        env_extra={"OMP_NUM_THREADS": "1"},
    )
    router = FleetRouter(spawn, FleetConfig(
        n_replicas=2, prefill_replicas=1, max_seq_len=64, startup_timeout_s=120.0,
        journal_path=str(tmp_path / "journal.jsonl"),
    ), log=lambda m: None)
    router.start()
    try:
        rids = [router.submit(p, 5) for p in prompts]
        router.run_until_idle(timeout_s=120.0, tick_s=0.002)
    finally:
        router.shutdown()
    assert [router.journal.records[r].tokens for r in rids] == [r.generated for r in ref_reqs]
    events = [json.loads(line) for line in open(tmp_path / "journal.jsonl")]
    returned = [e["rid"] for e in events if e["event"] == "returned"]
    assert returned == [rids[0]]
    assert sum(e["event"] == "complete" for e in events) == len(rids)
    assert "transfer 1 failed" in (tmp_path / "replica0-i0.stderr").read_text()
