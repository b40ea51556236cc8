"""PyTorch port, the fleet replica over a group of ranks: fleets whose
replicas are ``serve_layout`` groups of ``--device cpu`` processes, held
against JAX's sharded engine on the same weights.

JAX's sharded replica is one process over its devices; the port's is a
leader child (``python -m fms_fsdp_tpu_torch.serve.replica``) that
starts, watches and releases T x F - 1 followers (``serve/replica.py``).
One module fixture runs every fleet at once, each driven by its own
router in a thread, beside two gloo worlds of the idle case, while
JAX's references run on the 8-device CPU mesh of tests/conftest.py. TINY
of tests/test_disagg.py, fp32, weights from ``--params`` (a pickle of
JAX's numpy params):

- one unified layout replica (Llama tp 2, Llama tp 2 x fsdp 2, Mixtral
  tp 2 dense) serves JAX's ``ServingEngine(serve_layout=...)`` tokens;
- a tp 2 prefill replica hands off to a tp 2 decode replica over the
  chunked transport: ``_disagg_tokens(..., {"serve_layout": "tp=2"})``
  of tests/test_disagg.py;
- one faulted fleet (a tp 2 prefill replica, two tp 2 decode replicas):
  a follower SIGKILLed while its replica holds streams, a leader killed
  by ``replica_kill``, then a decode replica preempted while it holds
  streams. Each death is one ``replica_loss`` relaunch of its replica,
  no process of a dead incarnation outlives it by more than a few
  seconds, the preempted replica's followers exit 0 after their release
  with their stats files written, and every request completes once with
  JAX's tokens;
- the idle case (ROADMAP.md C.4): a world of 2 whose message group times
  out after 3 s serves again after 9 s of idle, and with the leader's
  keep-alive off the same check fails;
- a Mamba replica child refuses a layout with JAX's "single-chip"
  message.
"""

import dataclasses
import json
import os
import pickle
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fms_fsdp_tpu.models import mixtral as j_mixtral
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init
from fms_fsdp_tpu.serve import ServeConfig as JServeConfig
from fms_fsdp_tpu.serve import ServingEngine as JServingEngine
from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MambaConfig, MixtralConfig
from fms_fsdp_tpu_torch.resilience.exits import EXIT_CODES
from fms_fsdp_tpu_torch.serve.fleet import FleetConfig, FleetRouter, make_subprocess_spawn
from test_disagg import _disagg_tokens
from test_torch_multiprocess import REPO, _env, _finish, _free_port
from torch_layout_child import LLAMA_KW, MAX_NEW, MIXTRAL_KW, PROMPTS, SCFG
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LAYOUT_CHILD = os.path.join(REPO, "tests", "torch_layout_child.py")
J_CFG = {"llama": JLlamaConfig(**LLAMA_KW), "mixtral": JMixtralConfig(**MIXTRAL_KW)}
CFG = {"llama": LlamaConfig(**LLAMA_KW), "mixtral": MixtralConfig(**MIXTRAL_KW)}
# tests/test_disagg.py's keys: Llama PRNGKey(0), Mixtral PRNGKey(2)
_J_INIT = {"llama": (j_init, 0), "mixtral": (j_mixtral.init_mixtral_params, 2)}
# the clean fleets: (family, serve_layout, ServeConfig overrides, prefill replicas)
CLEAN = {
    "llama-tp2": ("llama", "tp=2", {}, 0),
    "llama-tp2-fsdp2": ("llama", "tp=2,fsdp=2", {}, 0),
    "mixtral-tp2": ("mixtral", "tp=2", {"moe_impl": "dense"}, 0),
    "disagg-tp2": ("llama", "tp=2", {}, 1),
}
# the faulted fleet's waves: two prompt lengths (two prefill compiles on
# JAX's side), long enough streams that a replica holds some while the
# router watches it
_RNG = np.random.RandomState(22)
CHAOS_PROMPTS = [_RNG.randint(0, 128, size=int(n)).tolist() for n in (5, 9) * 8]
CHAOS_NEW = 24
# the faulted fleet's incarnation-0 faults: decode replica 2's leader dies
# at its 4th engine iteration (after its warmup, once it holds handoffs)
CHAOS_FAULTS = "replica_kill:replica=2:step=4"
# a dead incarnation's processes must be gone within this
GONE_S = 5.0
# the idle case: the message group's timeout, the keep-alive, the idle spell
IDLE = {"timeout_s": 3.0, "keepalive_s": 0.5, "idle_s": 9.0}


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _children(pid):
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(p) for p in f.read().split()]
    except OSError:
        return []


def _alive(pid) -> bool:
    """Whether ``pid`` runs (a zombie waiting for its reaper does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except OSError:
        return False


class _Fleet:
    """One subprocess fleet of layout replicas and its router, driven by
    :meth:`run` (in a thread of the fixture)."""

    def __init__(self, tmp, name, family, layout, over, prefill, params, n_replicas,
                 faults=""):
        self.dir = str(tmp / name)
        self.family = family
        scfg = dict(SCFG, serve_layout=layout, **over)
        spawn = make_subprocess_spawn(
            self.dir, dict(dataclasses.asdict(CFG[family]), family=family), scfg,
            params=params, device="cpu", prefill_replicas=prefill, faults=faults,
            python=sys.executable, env_extra={"OMP_NUM_THREADS": "1"},
            # a loaded CPU host: a chunk waits out a slow receiver for ~8 s
            retries=10, backoff_s=0.2,
        )
        self.router = FleetRouter(spawn, FleetConfig(
            n_replicas=n_replicas, prefill_replicas=prefill, max_seq_len=SCFG["max_seq_len"],
            max_inflight_per_replica=4, startup_timeout_s=120.0, stall_timeout_s=60.0,
            restart_backoff_s=0.1, transport_retries=10, transport_backoff_s=0.2,
            journal_path=os.path.join(self.dir, "journal.jsonl"),
            ledger_path=os.path.join(self.dir, "ledger.json"),
        ), log=lambda m: None)
        self.pids = {}  # run id -> [leader, followers...], read at readiness
        self.events = {}
        self.rids = []
        self._t0 = time.monotonic()

    def tick(self, deadline_s=240.0):
        router, sup = self.router, self.router.supervisor
        router.poll()
        for idx in sup.live_indices():
            run = sup.run_id(idx)
            if router._ready.get(idx) and run not in self.pids:
                leader = sup.handle(idx).proc.pid
                self.pids[run] = [leader] + _children(leader)
        if time.monotonic() - self._t0 > deadline_s:
            raise TimeoutError(f"{self.dir}: {router.journal.counts()} {self.events}")
        time.sleep(0.002)

    def holds_streams(self, idx) -> bool:
        router = self.router
        run = router.supervisor.run_id(idx)
        return (router._ready.get(idx, False) and router.journal.inflight(run) > 0
                and router._hb_stats.get(idx, {}).get("slots_busy", 0) > 0)

    def wait_gone(self, pids, key):
        t0 = time.monotonic()
        while any(_alive(p) for p in pids) and time.monotonic() - t0 < 3 * GONE_S:
            self.tick()
        self.events[key] = time.monotonic() - t0

    def run(self, prompts, max_new, script=None):
        router = self.router
        router.start()
        try:
            router.wait_ready(tick_s=0.002)
            self.tick()  # the ranks' pids
            if script is None:
                self.rids = [router.submit(p, max_new) for p in prompts]
                router.run_until_idle(timeout_s=120.0, tick_s=0.002)
            else:
                script(self, prompts, max_new)
            router.drain(timeout_s=30.0)
        finally:
            router.shutdown()
        recs = router.journal.records
        reports = {}
        for name in sorted(os.listdir(self.dir)):
            if name.endswith(".stats.json"):
                with open(os.path.join(self.dir, name)) as f:
                    reports[name[:-len(".stats.json")]] = json.load(f)
        with open(os.path.join(self.dir, "ledger.json")) as f:
            ledger = json.load(f)
        with open(os.path.join(self.dir, "journal.jsonl")) as f:
            journal = [json.loads(line) for line in f]
        # every process this fleet started is gone once it is shut down
        t0 = time.monotonic()
        while time.monotonic() - t0 < GONE_S:
            leftover = [p for run in self.pids.values() for p in run if _alive(p)]
            if not leftover:
                break
            time.sleep(0.05)
        return {"tokens": [recs[r].tokens for r in self.rids],
                "completed": sorted(r.rid for r in router.completed), "rids": self.rids,
                "stats": router.stats(), "ledger": ledger, "journal": journal,
                "reports": reports, "pids": self.pids, "events": self.events,
                "leftover": leftover}


def _chaos(fleet, prompts, max_new):
    """The faulted fleet's schedule (module docstring)."""
    router, sup = fleet.router, fleet.router.supervisor
    half = len(prompts) // 2
    fleet.rids += [router.submit(p, max_new) for p in prompts[:half]]
    # decode replica 1 holds streams: SIGKILL its follower
    while not fleet.holds_streams(1):
        fleet.tick()
    dead = fleet.pids["replica1-i0"]
    fleet.events["follower_killed_with_streams"] = router.journal.inflight("replica1-i0")
    os.kill(dead[1], signal.SIGKILL)
    fleet.wait_gone(dead, "follower_kill_gone_s")
    # decode replica 2's leader dies at its fault's iteration
    while "replica2-i0" not in fleet.pids or sup.slots[2].incarnation < 1:
        fleet.tick()
    fleet.wait_gone(fleet.pids["replica2-i0"], "leader_kill_gone_s")
    # both relaunches ready: the second half of the wave
    while not all(r in fleet.pids for r in ("replica1-i1", "replica2-i1")):
        fleet.tick()
    fleet.rids += [router.submit(p, max_new) for p in prompts[half:]]
    while True:
        fleet.tick()
        busy = [i for i in (1, 2) if fleet.holds_streams(i)]
        if busy:
            break
        if router.journal.outstanding() == 0:
            raise AssertionError("the wave finished before a decode replica held a stream")
    fleet.events["preempted"] = busy[0]
    fleet.events["preempted_run"] = sup.run_id(busy[0])
    router.preempt(busy[0])
    while router.journal.outstanding():
        fleet.tick()
    # the preempted replica's relaunch up, so that the drain reaches it
    while f"replica{busy[0]}-i2" not in fleet.pids:
        fleet.tick()


def _idle_world(tmp, paths, keepalive_s):
    """The idle case's world of 2 (``tests/torch_layout_child.py``):
    (exit codes, rank 0's result or None)."""
    out = tmp / f"idle_{keepalive_s}"
    os.makedirs(out)
    spec = {"out": str(out), "params": {"llama": paths["llama"]}, "speculator": "",
            "world": 2, "idle": dict(IDLE, keepalive_s=keepalive_s)}
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-u", LAYOUT_CHILD, json.dumps(spec)], cwd=REPO,
                              env=_env(r, 2, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = _finish(procs, timeout=120)
    result = None
    if os.path.exists(out / "rank0.json"):
        with open(out / "rank0.json") as f:
            result = json.load(f)["idle"]
    return [p.returncode for p in procs], result, logs


def _j_engine_tokens(np_params, family, layout, over, prompts, max_new):
    eng = JServingEngine(jax.tree.map(jnp.asarray, np_params), J_CFG[family],
                         JServeConfig(**SCFG, serve_layout=layout, **over))
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    return [list(map(int, r.generated)) for r in reqs]


def _served_after_idle(result) -> bool:
    """The idle case's check: the wave after the idle spell served every
    request with the first wave's tokens."""
    return (result is not None and result.get("after") == result["before"]
            and all(len(t) == MAX_NEW for t in result["before"]))


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_layout")
    np_params, paths = {}, {}
    for family, (init, key) in _J_INIT.items():
        np_params[family] = jax.tree.map(np.asarray, init(jax.random.PRNGKey(key), J_CFG[family]))
        paths[family] = str(tmp / f"{family}.pkl")
        with open(paths[family], "wb") as f:
            pickle.dump(np_params[family], f)
    runs = {}
    with ThreadPoolExecutor(len(CLEAN) + 3) as pool:
        chaos = _Fleet(tmp, "chaos", "llama", "tp=2", {}, 1, paths["llama"], 3,
                       faults=CHAOS_FAULTS)
        runs["chaos"] = pool.submit(chaos.run, CHAOS_PROMPTS, CHAOS_NEW, _chaos)
        for name, (family, layout, over, prefill) in CLEAN.items():
            fleet = _Fleet(tmp, name, family, layout, over, prefill, paths[family],
                           1 + prefill)
            runs[name] = pool.submit(fleet.run, PROMPTS, MAX_NEW)
        for keepalive in (IDLE["keepalive_s"], 0.0):
            runs[f"idle_{keepalive}"] = pool.submit(_idle_world, tmp, paths, keepalive)
        # JAX's references while the fleets run
        refs = {name: _j_engine_tokens(np_params[family], family, layout, over, PROMPTS,
                                       MAX_NEW)
                for name, (family, layout, over, prefill) in CLEAN.items() if not prefill}
        j_llama = jax.tree.map(jnp.asarray, np_params["llama"])
        refs["disagg-tp2"] = _disagg_tokens(j_llama, J_CFG["llama"], {"serve_layout": "tp=2"},
                                            PROMPTS)[0]
        refs["chaos"] = _disagg_tokens(j_llama, J_CFG["llama"], {"serve_layout": "tp=2"},
                                       CHAOS_PROMPTS, CHAOS_NEW)[0]
        results = {name: fut.result() for name, fut in runs.items()}
    return {"refs": refs, **results}


@pytest.mark.parametrize("name", ["llama-tp2", "llama-tp2-fsdp2", "mixtral-tp2"])
def test_layout_fleet_matches_jax(fleets, name):
    """One unified layout replica: JAX's sharded engine's tokens, each
    request once; every rank ran the leader's decode steps (the warmup's
    included) and the group exited with its leader, 0."""
    got = fleets[name]
    assert got["tokens"] == fleets["refs"][name]
    assert got["completed"] == sorted(got["rids"])
    ranks = len(got["pids"]["replica0-i0"])
    assert ranks == {"llama-tp2": 2, "llama-tp2-fsdp2": 4, "mixtral-tp2": 2}[name]
    lead = got["reports"]["replica0-i0"]
    assert lead["follower_exits"] == [0] * (ranks - 1)
    for r in range(1, ranks):
        rank = got["reports"][f"replica0-i0.rank{r}"]
        assert rank["decode_steps"] == lead["decode_steps"] + lead["warmup_decode_steps"]
        assert rank["launches"] == {"v1": 0, "v2": 0}  # the reference attention on the CPU
    assert [e["classification"] for e in got["ledger"]["entries"]] == ["ok"]
    assert got["leftover"] == []


def test_layout_fleet_disagg_matches_jax(fleets):
    """A tp 2 prefill replica hands off to a tp 2 decode replica over the
    chunked transport: JAX's sharded prefill -> decode tokens. The
    prefill ranks decode nothing; both of the decode replica's ranks ran
    its imports and decode steps."""
    got = fleets["disagg-tp2"]
    assert got["tokens"] == fleets["refs"]["disagg-tp2"]
    assert got["completed"] == sorted(got["rids"])
    assert got["stats"]["requests_handed_off"] >= len(PROMPTS)
    reports = got["reports"]
    for run in ("replica0-i0", "replica0-i0.rank1"):
        assert reports[run]["role"] == "prefill" and reports[run]["decode_steps"] == 0
    assert reports["replica0-i0.rank1"]["calls"]["export_handoff"] >= len(PROMPTS)
    lead, rank = reports["replica1-i0"], reports["replica1-i0.rank1"]
    assert rank["calls"]["import_handoff"] == len(PROMPTS)
    assert rank["decode_steps"] == lead["decode_steps"] + lead["warmup_decode_steps"]
    assert got["leftover"] == []


def _entries(got, replica):
    return [e for e in got["ledger"]["entries"] if e["replica"] == replica]


def test_layout_fleet_follower_killed_mid_wave(fleets):
    """A follower SIGKILLed while its replica holds streams: the leader
    exits ``replica_loss`` at once, the whole incarnation is gone within
    a few seconds, the replica is relaunched once as a new group, and
    every request completes once with JAX's tokens."""
    got = fleets["chaos"]
    assert got["tokens"] == fleets["refs"]["chaos"]
    assert got["completed"] == sorted(got["rids"])
    assert got["stats"]["duplicates_dropped"] == 0
    assert got["events"]["follower_killed_with_streams"] > 0
    assert got["events"]["follower_kill_gone_s"] < GONE_S
    first = _entries(got, 1)[0]
    assert (first["incarnation"], first["classification"], first["exit_code"]) == (
        0, "replica_loss", EXIT_CODES["replica_loss"])
    assert [e["classification"] for e in _entries(got, 1)].count("replica_loss") == 1
    assert len(got["pids"]["replica1-i1"]) == 2  # the relaunch is a group again
    requeued = [e for e in got["journal"] if e["event"] == "requeue"]
    assert requeued


def test_layout_fleet_leader_killed(fleets):
    """The leader killed (``replica_kill``): its follower is gone within
    a few seconds (it dies with its leader), the replica is relaunched
    as a group, and the tokens are JAX's."""
    got = fleets["chaos"]
    first = _entries(got, 2)[0]
    assert (first["incarnation"], first["classification"]) == (0, "replica_loss")
    assert got["events"]["leader_kill_gone_s"] < GONE_S
    assert len(got["pids"]["replica2-i0"]) == 2 and len(got["pids"]["replica2-i1"]) == 2
    assert got["tokens"] == fleets["refs"]["chaos"]
    assert got["leftover"] == []


def test_layout_fleet_preempted_decode_replica(fleets):
    """A tp 2 decode replica preempted while it holds streams: its live
    streams migrate (the followers take part in the head gather), the
    leader releases and joins its follower before it exits
    ``preempted``, and the follower exits 0 with its stats written."""
    got = fleets["chaos"]
    run = got["events"]["preempted_run"]
    assert got["stats"]["drain_migrations"] >= 1
    assert got["tokens"] == fleets["refs"]["chaos"]
    ended = [e for e in got["ledger"]["entries"] if e["run_id"] == run]
    assert ended[0]["classification"] == "preempted"
    assert got["reports"][run]["follower_exits"] == [0]
    follower = got["reports"][f"{run}.rank1"]
    assert follower["calls"]["export_handoff"] >= 1
    assert follower["decode_steps"] > 0


def test_layout_outlives_an_idle_spell(fleets):
    """ROADMAP.md C.4: with the message group's timeout at 3 s, 9 s of
    idle between two waves; the leader's keep-alive keeps the followers
    in step and the second wave serves the first's tokens."""
    codes, result, logs = fleets[f"idle_{IDLE['keepalive_s']}"]
    assert codes == [0, 0], logs[1][-3000:]
    assert _served_after_idle(result), result
    assert result["keepalives"] >= IDLE["idle_s"] / IDLE["timeout_s"]


def test_idle_control_without_keepalive_fails(fleets):
    """The control: the keep-alive off, the same idle spell. The
    follower's receive times out, and the second wave fails the check."""
    codes, result, logs = fleets["idle_0.0"]
    assert codes[1] != 0 and "lost its leader" in logs[1]
    assert not _served_after_idle(result)


def test_replica_child_refuses_a_mamba_layout(tmp_path):
    """A Mamba replica child given a layout exits ``replica_loss`` with
    JAX's "single-chip" message before its group forms."""
    cfg = MambaConfig(d_model=64, n_layer=2, vocab_size=128, d_state=16, headdim=16,
                      chunk_size=8, attn_layer_idx=(), d_intermediate=128)
    (tmp_path / "model.json").write_text(json.dumps(dict(dataclasses.asdict(cfg),
                                                         family="mamba")))
    (tmp_path / "serve.json").write_text(json.dumps(dict(SCFG, serve_layout="tp=2")))
    proc = subprocess.run(
        [sys.executable, "-m", "fms_fsdp_tpu_torch.serve.replica", "--model-cfg",
         str(tmp_path / "model.json"), "--serve-cfg", str(tmp_path / "serve.json"),
         "--replica", "0", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120, stdin=subprocess.DEVNULL)
    assert proc.returncode == EXIT_CODES["replica_loss"]
    assert "single-chip" in proc.stderr
