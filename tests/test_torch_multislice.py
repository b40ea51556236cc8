"""PyTorch port, multi-slice training: gloo worlds on the CPU held against
JAX's programs on the same slices.

One module-scoped fixture starts the worlds once, each rank a fresh
interpreter (tests/torch_slice_child.py) that runs all of its world's
cases one after another and imports no JAX, and while they run computes
JAX's references here, on the 8-device CPU mesh of tests/conftest.py at
``num_slices=2`` (fsdp takes the rest). The worlds:

- 2 slices of 2 ranks (a world of 4): the TINY models of
  tests/test_torch_multiprocess.py, fp32, 3 steps on 8 global rows —
  Llama at dcn 2 x fsdp 2 and at dcn 2 x replica 2 (hsdp, group 1), each
  with the DCN overlap on (``"auto"``) and off; Mixtral with drops
  (capacity factor 0.5) and the Mamba hybrid at dcn 2 x fsdp 2; the int8
  and the delayed fp8 reduce wires with their GEMM modes; the control
  (the cross-slice sum dropped); and a wider Llama (emb 256, vocab 512)
  whose gradients fill several 1 MB buckets, on and off, with
  ``obs_dir`` set;
- the same world with ``slice_kill:slice=1:step=3`` and a slice timeout
  of 3 s, and beside it two slices of one rank whose losses are NaN from
  step 2 (the anomaly guard's abort after two); once they are done,
- one slice of 2 ranks: Llama at fsdp 2 under ``"auto"`` with every
  collective of each step recorded, and the resume of the killed
  world's last commit.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.parallel.sharding import init_amax_state
from fms_fsdp_tpu.train import step as j_step
from test_torch_multiprocess import (
    _MODEL,
    _RUN,
    REPO,
    ROWS,
    SEQ,
    STEPS,
    _env,
    _free_port,
    _global_batches,
    _j_model_cfg,
)
from test_torch_tp_worlds import FP8, INT8, MODELS, QUANT_TOL, _j_params, _j_steps
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SLICE_CHILD = os.path.join(REPO, "tests", "torch_slice_child.py")
SLICES = 2
OFF = (("dcn_overlap", "off"),)
HSDP = (("sharding_strategy", "hsdp"), ("sharding_group_size", 1))
# a Llama wide enough (~1.7M params, ~3.4 MB of bf16 wire bytes) to fill
# several 1 MB buckets; TINY's gradients fit in one
BIG = {**_MODEL, "LlamaConfig.emb_dim": 256, "LlamaConfig.src_vocab_size": 512}
BIG_RUN = (("vocab_size", 512), ("dcn_bucket_mb", 1))
# (case, model, overrides, case flags); the JAX reference is keyed by the
# model and the quantized modes
CASES = (
    ("llama_fsdp", "llama", (), {}),
    ("llama_fsdp_off", "llama", OFF, {}),
    ("llama_hsdp", "llama", HSDP, {}),
    ("llama_hsdp_off", "llama", HSDP + OFF, {}),
    ("mixtral_cf0.5", "mixtral_cf0.5", (), {}),
    ("mamba", "mamba_g1", (), {}),
    ("llama_int8", "llama", INT8, {}),
    ("llama_fp8", "llama", FP8, {}),
    ("control_drop_dcn", "llama", (), {"drop_dcn": True}),
    ("big", "big", BIG_RUN, {}),
    ("big_off", "big", BIG_RUN + OFF, {}),
)
PARITY = [c for c in CASES if not c[0].startswith(("control", "big"))]
QUANT = dict(INT8 + FP8)
REFS = sorted({(model, tuple(kv for kv in over if kv[0] in QUANT))
               for _, model, over, _ in PARITY})
# every collective a Llama step at fsdp 2 runs on one slice, as the tree
# before the dcn axis ran it: the layers' and the top leaves' gathers,
# the label count, the reduce-scatters, the whole leaves' sum, the loss
# and the gradient norm (a group of 2 each)
ONE_SLICE_STEP = (
    [["all_gather_into_tensor", 2], ["all_reduce", 2]]
    + [["all_gather_into_tensor", 2]] * 4
    + [["reduce_scatter_tensor", 2], ["all_gather_into_tensor", 2]]
    + [["reduce_scatter_tensor", 2]] * 2
    + [["all_reduce", 2]] * 3
)
KILL = "slice_kill:slice=1:step=3"
NAN = "nan_loss:step=2:count=100"


def _main(tmp, name, model, over, **extra):
    kw = dict(_RUN, **(BIG if model == "big" else MODELS[model]), num_slices=SLICES,
              sharding_strategy="fsdp", batch_size=ROWS // 4,
              ckpt_save_path=str(tmp / f"ck_{name}"), checkpoint_interval=1000)
    if model != "big":
        kw["ckpt_load_path"] = str(tmp / f"{model}.pkl")
    kw.update(dict(over), **extra)
    return kw


def _case(tmp, name, model, over, flags):
    extra = {"obs_dir": str(tmp / "obs_big")} if name == "big" else {}
    return dict({"name": name, "kind": "train", "main": _main(tmp, name, model, over, **extra),
                 "batches": None if model == "big" else str(tmp / "batches.npz")}, **flags)


def _kill_main(tmp, **extra):
    """The faulted run's settings: saves at step 2, committed before step 3
    starts (a synchronous save: a background commit would race the
    kill)."""
    kw = dict(_RUN, **_MODEL, sharding_strategy="fsdp", batch_size=2, num_steps=6,
              checkpoint_interval=2, ckpt_async=False, ckpt_save_path=str(tmp / "ck_kill"),
              ckpt_load_path=str(tmp / "ck_kill"))
    kw.update(extra)
    return kw


def _j_init(params, model, over):
    """JAX's train state and step at ``num_slices=2`` on the 8-device mesh
    (dcn 2 x fsdp 4) with the quantized modes ``over``, from ``params``
    (the pickled ones): the state's structure and shardings from an
    abstract evaluation of ``init_train_state``, whose random init never
    compiles."""
    model_cfg = _j_model_cfg(MODELS[model])
    jcfg = JTrainConfig(**_RUN, **dict(over), batch_size=ROWS, sharding_strategy="fsdp",
                        num_slices=SLICES, mamba_kernel="xla")
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
    return (jax.device_put(state, shardings["state"]),
            j_step.make_train_step(model_cfg, jcfg, mesh, opt))


def _spawn(world, spec, faults=""):
    os.makedirs(spec["out"], exist_ok=True)
    port = _free_port()
    procs = []
    for r in range(world):
        env = _env(r, world, port)
        if faults:
            env["FMS_FAULTS"] = faults
        procs.append(subprocess.Popen([sys.executable, "-u", SLICE_CHILD, json.dumps(spec)],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _join(procs, timeout=300):
    """(exit codes, outputs); a world still running at ``timeout`` is
    killed whole and fails the test: the no-hang assertion."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    return [p.returncode for p in procs], outs


def _results(spec, world, rcs, outs):
    """Each rank's results, rank 0's output beside them."""
    for r, (rc, text) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} of {world} exited {rc}:\n{text[-4000:]}"
    res = []
    for r in range(world):
        with open(os.path.join(spec["out"], f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res, outs[0]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice_worlds")
    inputs, labels = _global_batches()
    np.savez(tmp / "batches.npz", inputs=inputs, labels=labels)
    params = {model: _j_params(tmp, model) for model in sorted({key[0] for key in REFS})}
    two = {"out": str(tmp / "w4"), "cases": [_case(tmp, *c) for c in CASES]}
    kill = {"out": str(tmp / "kill"), "cases": [{"name": "kill", "kind": "train", "main":
            _kill_main(tmp, num_slices=SLICES, slice_heartbeat_dir=str(tmp / "hb"),
                       slice_timeout_s=3.0)}]}
    abort = {"out": str(tmp / "abort"), "cases": [{"name": "abort", "kind": "train", "main":
             dict(_main(tmp, "abort", "llama", ()), batch_size=ROWS // 2, num_steps=6,
                  anomaly_max_consecutive=2, slice_heartbeat_dir=str(tmp / "hb_abort"),
                  slice_timeout_s=3.0)}]}
    procs = {"two": _spawn(4, two), "kill": _spawn(4, kill, faults=KILL),
             "abort": _spawn(2, abort, faults=NAN)}
    jobs = {key: lambda key=key: _j_steps(*_j_init(params[key[0]], *key), inputs, labels)
            for key in REFS}
    try:
        with ThreadPoolExecutor(3) as pool:
            refs = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    except BaseException:
        for group in procs.values():
            for p in group:
                p.kill()
        raise
    finally:
        jax.clear_caches()
    killed, aborted = _join(procs["kill"]), _join(procs["abort"])
    # one slice: the step's collectives, and the resume of the killed
    # world's last commit (num_steps 4: steps 3 and 4)
    one = {"out": str(tmp / "w2"), "cases": [
        {"name": "one_slice", "kind": "train", "count_collectives": True,
         "main": dict(_main(tmp, "one_slice", "llama", ()), num_slices=0, batch_size=ROWS // 2)},
        {"name": "resume", "kind": "train", "main": _kill_main(tmp, num_steps=4)}]}
    one_procs = _spawn(2, one)
    res = {"two": _results(two, 4, *_join(procs["two"]))}
    res["one"] = _results(one, 2, *_join(one_procs))
    yield {"refs": refs, "res": res, "killed": killed, "aborted": aborted, "tmp": tmp}


def _cases(worlds, name, world="two"):
    return [r[name] for r in worlds["res"][world][0]]


@pytest.mark.parametrize("world,dcn", [("two", 2), ("one", 1)])
def test_mesh_line_names_the_slices(worlds, world, dcn):
    """Rank 0's mesh line prints the dcn axis at the slice count."""
    assert f"mesh = {{'dcn': {dcn}," in worlds["res"][world][1]


@pytest.mark.parametrize("case", PARITY, ids=[c[0] for c in PARITY])
def test_two_slice_steps_match_jax(worlds, case):
    """Three fp32 steps at 2 slices: every rank's loss and gradient norm
    within 1e-5 relative of JAX's at ``num_slices=2``, each step (a
    quantized case within the GEMM modes' bounds of
    tests/test_torch_quant_training.py of JAX's in the same modes, its
    gradient norm at the first step)."""
    name, model, over, _ = case
    quant = tuple(kv for kv in over if kv[0] in QUANT)
    ref = worlds["refs"][(model, quant)]
    tol = QUANT_TOL if quant else {"loss": 1e-5, "gnorm": 1e-5}
    for r, got in enumerate(_cases(worlds, name)):
        for s, (jl, jg) in enumerate(ref):
            assert got["losses"][s] == pytest.approx(jl, rel=tol["loss"]), (name, r, s)
            if not quant or s == 0:
                assert got["gnorms"][s] == pytest.approx(jg, rel=tol["gnorm"]), (name, r, s)
        assert got["steps"] == [1, 2, 3]
        assert got["tokens_seen"] == [s * ROWS * SEQ for s in (1, 2, 3)]
        assert got["dcn_group"]
        if model.startswith("mixtral"):
            assert all(d is not None and d > 0 for d in got["drop_frac"])
        # a plan under "auto" at 2 slices, one cross-slice reduce a bucket
        # a step with it
        plan = got["plan"]
        if ("dcn_overlap", "off") in over:
            assert plan is None and got["dcn_reduces"] == 0
        else:
            assert plan["buckets"] >= 1 and got["dcn_reduces"] == STEPS * plan["buckets"]
            if quant:
                assert plan["wire_bytes"] == 1


@pytest.mark.parametrize("on,off", [("llama_fsdp", "llama_fsdp_off"),
                                    ("llama_hsdp", "llama_hsdp_off"), ("big", "big_off")])
def test_overlap_on_and_off_are_bit_equal(worlds, on, off):
    """The bucketed reduce started in the backward sums each element as
    the pass after it does (inside the slice, then across): the same
    losses and gradient norms bit for bit, and the same final state on
    every rank. The wider Llama's plan has several buckets, each reduced
    once a step."""
    ons, offs = _cases(worlds, on), _cases(worlds, off)
    for a, b in zip(ons, offs):
        assert a["losses"] == b["losses"] and a["gnorms"] == b["gnorms"]
        assert a["final_hash"] == b["final_hash"]
    assert len({r["final_hash"] for r in ons}) == 1
    if on == "big":
        plan = ons[0]["plan"]
        assert plan["buckets"] >= 3 and plan["target_mb"] == 1
        assert all(r["dcn_reduces"] == STEPS * plan["buckets"] for r in ons)


def test_hsdp_group_one_is_replicas_inside_each_slice(worlds):
    """dcn 2 x replica 2: no fsdp part, every leaf whole, summed over the
    slice's replicas and then across: the within-slice group exists."""
    for got in _cases(worlds, "llama_hsdp"):
        assert got["slice_group"] and got["dcn_group"]


def test_control_without_the_cross_slice_sum_fails(worlds):
    """With ``DataParallel.dcn_reduce`` doing nothing each slice keeps its
    own gradients: the first gradient norm leaves 1e-5 of JAX's."""
    (jl, jg) = worlds["refs"][("llama", ())][0]
    for got in _cases(worlds, "control_drop_dcn"):
        assert got["gnorms"][0] != pytest.approx(jg, rel=1e-5)


def test_one_slice_adds_nothing(worlds):
    """One slice under ``"auto"``: no plan, no cross-slice reduce, no dcn
    or within-slice group, and each step runs exactly the collectives
    the step ran before the dcn axis existed."""
    for got in _cases(worlds, "one_slice", "one"):
        assert got["plan"] is None and got["dcn_reduces"] == 0
        assert not got["dcn_group"] and not got["slice_group"]
        assert got["collectives"] == [ONE_SLICE_STEP] * STEPS


def test_lost_slice_exits_slice_loss_and_resumes_on_one_slice(worlds):
    """``slice_kill`` at slice 1, step 3: its ranks exit
    ``injected_kill``, the survivors ``slice_loss`` (3) with JAX's
    message, without hanging (the join's timeout). A world of 2 on one
    slice resumes the last commit (step 2) with the global batch of 8
    rows (4 a rank)."""
    rcs, outs = worlds["killed"]
    assert rcs == [3, 3, 7, 7], rcs
    for text in outs[:2]:
        assert "slice 1 lost" in text and "2 -> 1 slice(s)" in text, text[-3000:]
    for got in _cases(worlds, "resume", "one"):
        assert got["start_step"] == 2 and got["batch_size"] == 4
        assert got["steps"] == [3, 4]


def test_abort_line_names_the_fault_domain(worlds):
    """On two slices the anomaly guard's abort names each rank's process
    and slice, ``[proc R slice K]`` (JAX's tests/test_resilience.py:836),
    and exits ``anomaly_abort`` (4) without waiting for a slice verdict."""
    rcs, outs = worlds["aborted"]
    assert rcs == [4, 4], rcs
    for r, text in enumerate(outs):
        assert f"[proc {r} slice {r}] anomaly guard: 2 consecutive" in text, text[-3000:]
        assert "slice 0 lost" not in text and "slice 1 lost" not in text


def test_metrics_carry_the_collective_split(worlds):
    """The 2-slice world's records: the probe's within-slice and
    cross-slice seconds above 0, and the overlap estimate in [0, 1]."""
    with open(worlds["tmp"] / "obs_big" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == STEPS
    for rec in records:
        assert rec["ici_collective_s"] > 0 and rec["dcn_collective_s"] > 0
        assert 0.0 <= rec["dcn_overlap_frac"] <= 1.0
