"""PyTorch port, multi-slice pieces held against the JAX package in one
process: the DCN-overlap plan (``parallel/overlap.py``), the bucketed
reduce wire, the observer's overlap estimate, the slice health monitor
and the watchdog's slice tag.

Each JAX function and its port counterpart take the same inputs: the
param shapes (JAX's ``eval_shape`` of its init, the port's meta-device
init), the same seeded gradients, the same windows, the same heartbeat
files under one fake clock. The gloo worlds that train at two slices are
tests/test_torch_multislice.py.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init_llama
from fms_fsdp_tpu.models.mamba import init_mamba_params as j_init_mamba
from fms_fsdp_tpu.models.mixtral import init_mixtral_params as j_init_mixtral
from fms_fsdp_tpu.obs.observer import Observer as JObserver
from fms_fsdp_tpu.parallel import mesh as j_mesh
from fms_fsdp_tpu.parallel import overlap as j_overlap
from fms_fsdp_tpu.parallel.sharding import init_amax_state as j_init_amax
from fms_fsdp_tpu.resilience import guards as j_guards
from fms_fsdp_tpu.resilience import slices as j_slices
from fms_fsdp_tpu_torch.models.configs import (
    LlamaConfig,
    MambaAttnConfig,
    MambaConfig,
    MixtralConfig,
)
from fms_fsdp_tpu_torch.obs.observer import Observer
from fms_fsdp_tpu_torch.parallel import mesh, overlap
from fms_fsdp_tpu_torch.parallel.sharding import QuantLeaf, quantized_grad_reduce
from fms_fsdp_tpu_torch.resilience import guards, slices
from fms_fsdp_tpu_torch.train.step import param_shapes
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_LLAMA = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
              max_expected_seq_len=256)
_ATTN = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_MAMBA = dict(d_model=64, d_intermediate=128, n_layer=3, vocab_size=256,
              attn_layer_idx=(1,), d_state=16, d_conv=4, expand=2, headdim=16,
              chunk_size=16, pad_vocab_size_multiple=16)
_MIXTRAL = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                hidden_dim=96, num_experts=4, top_k=2, max_expected_seq_len=64)
# wider models whose gradients fill several 1 MB buckets (TINY's fit in one)
_WIDE = {"llama": dict(_LLAMA, emb_dim=256, src_vocab_size=512),
         "mamba": dict(_MAMBA, d_model=256, d_intermediate=512, vocab_size=512),
         "mixtral": dict(_MIXTRAL, emb_dim=256, hidden_dim=512, src_vocab_size=512)}


def _configs(family, kw):
    if family == "llama":
        return JLlamaConfig(**kw), LlamaConfig(**kw), j_init_llama
    if family == "mixtral":
        return JMixtralConfig(**kw), MixtralConfig(**kw), j_init_mixtral
    return (JMambaConfig(attn_cfg=JMambaAttnConfig(**_ATTN), **kw),
            MambaConfig(attn_cfg=MambaAttnConfig(**_ATTN), **kw), j_init_mamba)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.mark.parametrize("wire", [1, 2])
@pytest.mark.parametrize("target_mb", [1, 2, 4])
@pytest.mark.parametrize("family,width", [
    (f, w) for f in ("llama", "mamba", "mixtral") for w in ("tiny", "wide")])
def test_assign_buckets_is_jax_plan(family, width, target_mb, wire):
    """The port's plan over its meta-device param shapes is JAX's over its
    ``eval_shape``: the same buckets of the same leaf names and bytes."""
    kw = {"llama": _LLAMA, "mamba": _MAMBA, "mixtral": _MIXTRAL}[family]
    jcfg, cfg, j_init = _configs(family, _WIDE[family] if width == "wide" else kw)
    j_shapes = jax.eval_shape(lambda k: j_init(k, jcfg, dtype=jnp.bfloat16),
                              jax.random.PRNGKey(0))
    shapes = param_shapes(cfg, torch.bfloat16)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(
        shapes, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want = j_overlap.assign_buckets(j_shapes, target_mb, wire)
    got = overlap.assign_buckets(shapes, target_mb, wire)
    assert got.summary() == want.summary()
    assert got.buckets == want.buckets
    if width == "wide" and target_mb == 1:
        assert len(got.buckets) >= 2


@pytest.mark.parametrize("mode", ["none", "int8", "fp8", "fp8_delayed"])
def test_wire_bytes_per_element(mode):
    assert overlap.wire_bytes_per_element(mode) == j_overlap.wire_bytes_per_element(mode)


class _Mesh:
    """A mesh's axis sizes as ``num_mesh_slices`` reads them."""

    mesh_dim_names = mesh.MESH_AXES

    def __init__(self, dcn):
        self.dcn = dcn

    def size(self, dim):
        return self.dcn if dim == 0 else 1


@pytest.mark.parametrize("mode", ["off", "on", "auto", "AUTO", None, "bogus"])
def test_overlap_enabled_modes(mode):
    """Off never, on always, auto above one slice: JAX's answers on its
    1- and 2-slice meshes, and its error for an unknown mode."""
    j1 = j_mesh.build_mesh(j_mesh.MeshConfig(sharding_strategy="fsdp"))
    j2 = j_mesh.build_mesh(j_mesh.MeshConfig(sharding_strategy="fsdp", num_slices=2))
    if mode == "bogus":
        with pytest.raises(ValueError, match="dcn_overlap must be off|auto|on") as err:
            overlap.overlap_enabled(mode, _Mesh(2))
        with pytest.raises(ValueError) as j_err:
            j_overlap.overlap_enabled(mode, j2)
        assert str(err.value) == str(j_err.value)
        return
    for port_mesh, j in ((_Mesh(1), j1), (_Mesh(2), j2), (None, j1)):
        assert overlap.overlap_enabled(mode, port_mesh) == j_overlap.overlap_enabled(mode, j)
    assert mesh.num_mesh_slices(_Mesh(2)) == j_mesh.num_mesh_slices(j2) == 2


def test_plan_summary_registry_roundtrip():
    try:
        for mod in (overlap, j_overlap):
            mod.set_plan_summary({"buckets": 3, "bytes_per_bucket": [1, 2, 3]})
            got = mod.plan_summary()
            assert got == {"buckets": 3, "bytes_per_bucket": [1, 2, 3]}
            got["buckets"] = 99  # a copy, not the registry
            assert mod.plan_summary()["buckets"] == 3
            mod.set_plan_summary(None)
            assert mod.plan_summary() is None
    finally:
        overlap.set_plan_summary(None)
        j_overlap.set_plan_summary(None)


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint32)


@pytest.mark.parametrize("mode", ["int8", "fp8", "fp8_delayed"])
def test_bucketed_quant_reduce_matches_plain_and_jax(mode):
    """With a hand-built two-bucket plan: the port's bucketed wire bit for
    bit its plain wire and JAX's bucketed wire on the same gradients (the
    delayed amax rows too, rolled once each); ``plan=None`` is the plain
    wire."""
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(17, 64)), "b": rng.normal(size=(3,)),
              "c": rng.normal(size=(128,)) * 5.0}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    jgrads = {k: jnp.asarray(v) for k, v in arrays.items()}
    keys = sorted(f"g.{k}" for k in arrays)
    leaves = [QuantLeaf(f"g.{k}", v.ndim, None) for k, v in arrays.items()]
    grads = [torch.from_numpy(v.copy()) for v in arrays.values()]
    jquant = quant = None
    if mode == "fp8_delayed":
        hist = {k: np.zeros(4, np.float32) + 0.25 * (i + 1) for i, k in enumerate(keys)}
        jquant = {"amax_history": {k: jnp.asarray(v) for k, v in hist.items()}}
        quant = {"amax_history": {k: torch.from_numpy(v.copy()) for k, v in hist.items()}}
        assert sorted(j_init_amax(jgrads, 4)["amax_history"]) == keys
    j_plan = j_overlap.BucketPlan(buckets=(tuple(keys[:1]), tuple(keys[1:])),
                                  bucket_bytes=(0, 0), target_mb=1, wire_bytes=1, total_bytes=0)
    plan = overlap.BucketPlan(buckets=j_plan.buckets, bucket_bytes=(0, 0), target_mb=1,
                              wire_bytes=1, total_bytes=0)
    out_b, q_b = overlap.bucketed_quantized_grad_reduce(grads, mode, quant, plan, leaves)
    out_p, q_p = quantized_grad_reduce(grads, mode, quant, leaves)
    out_n, _ = overlap.bucketed_quantized_grad_reduce(grads, mode, quant, None, leaves)
    j_out, j_q = j_overlap.bucketed_quantized_grad_reduce(jgrads, mode, jquant, j_plan)
    for i, k in enumerate(arrays):
        assert np.array_equal(_bits(out_b[i]), _bits(out_p[i])), k
        assert np.array_equal(_bits(out_n[i]), _bits(out_p[i])), k
        assert np.array_equal(_bits(out_b[i]), _bits(j_out[k])), k
    if mode == "fp8_delayed":
        for k in keys:
            assert np.array_equal(_bits(q_b["amax_history"][k]), _bits(q_p["amax_history"][k]))
            assert np.array_equal(_bits(q_b["amax_history"][k]), _bits(j_q["amax_history"][k]))
    else:
        assert q_b is quant
    with pytest.raises(ValueError, match="unknown quantized_reduce mode"):
        overlap.bucketed_quantized_grad_reduce(grads, "int4", quant, plan, leaves)


@pytest.mark.parametrize("schedule,window", [
    (None, {"dcn_collective": 1.0, "compute": 9.0}),
    ({"buckets": 4, "bytes_per_bucket": [1] * 4}, {"dcn_collective": 0.0, "compute": 9.0}),
    ({"buckets": 4, "bytes_per_bucket": [1] * 4}, {"dcn_collective": 1.0, "compute": 30.0}),
    ({"buckets": 4, "bytes_per_bucket": [1] * 4}, {"dcn_collective": 1.0, "compute": 0.0}),
    ({"buckets": 3}, {"dcn_collective": 2.0, "compute": 1.5}),
    ({"buckets": 1}, {"dcn_collective": 2.0, "compute": 100.0}),
])
def test_observer_overlap_frac(schedule, window):
    """The overlap estimate: 0 without a schedule or a probe reading,
    1 - 1/K with ample backward compute, 0 with none; JAX's value on every
    window."""
    obs, j_obs = Observer(), JObserver()
    obs.attach_overlap_schedule(schedule)
    j_obs.attach_overlap_schedule(schedule)
    assert obs._overlap_frac(window) == j_obs._overlap_frac(window)
    if schedule and schedule["buckets"] == 4 and window["compute"] == 30.0:
        assert obs._overlap_frac(window) == pytest.approx(0.75)


# ---------------------------------------------------------------------------
# the slice health monitor, port and JAX side by side
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _write_peer(d, slice_idx, proc, step=5, run_id=None):
    os.makedirs(d, exist_ok=True)
    payload = {"slice": slice_idx, "proc": proc, "step": step}
    if run_id is not None:
        payload["run_id"] = run_id
    with open(os.path.join(d, f"slice{slice_idx}_proc{proc}.hb"), "w") as f:
        json.dump(payload, f)


def _pair(tmp_path, **kw):
    """The port's and JAX's monitors over one directory and one fake
    clock, not started (their scans are driven by hand)."""
    clock = _Clock()
    d = str(tmp_path / "hb")
    args = dict(num_slices=2, slice_index=0, process_index=0, timeout_s=0.6, poll_s=0.1,
                clock=clock, on_dead=lambda m: None)
    args.update(kw)
    return (slices.SliceHealthMonitor(d, **args), j_slices.SliceHealthMonitor(d, **args),
            clock, d)


def test_slice_monitor_declares_a_silent_slice_as_jax_does(tmp_path):
    """Peers of slice 1 that wrote once and went silent past the timeout:
    no verdict before it, the same verdict and the same line after it."""
    mon, j_mon, clock, d = _pair(tmp_path)
    _write_peer(d, 1, 2, step=7)
    _write_peer(d, 1, 3, step=7)
    assert mon._scan() is None and j_mon._scan() is None
    clock.t += 0.5
    assert mon._scan() is None and j_mon._scan() is None
    clock.t += 0.5
    dead, j_dead = mon._scan(), j_mon._scan()
    assert dead == j_dead and dead["slice"] == 1 and dead["procs"] == [2, 3]
    assert dead["last_step"] == 7
    msg = mon.describe_loss(dead)
    assert msg == j_mon.describe_loss(j_dead)
    for part in ("slice 1 lost", "[proc 0 slice 0]", "world minus one fault domain",
                 "2 -> 1 slice(s)", "(last progress at step 7)"):
        assert part in msg, msg
    assert mon.wait_classify() == j_mon.wait_classify() == dead
    assert mon.EXIT_CODE == j_mon.EXIT_CODE == 3


def test_slice_monitor_live_peers_and_own_slice_never_declared(tmp_path):
    """A peer whose file keeps changing is alive however old; a silent
    peer of the monitor's own slice is not a lost slice."""
    mon, j_mon, clock, d = _pair(tmp_path)
    _write_peer(d, 0, 1)
    for i in range(12):
        _write_peer(d, 1, 2, step=i)
        os.utime(os.path.join(d, "slice1_proc2.hb"), (1000.0 + i, 1000.0 + i))
        clock.t += 0.3
        assert mon._scan() is None and j_mon._scan() is None


def test_slice_monitor_ignores_a_previous_incarnation(tmp_path):
    """Files stamped with another run id are not evidence; the current
    incarnation's silent peers still classify."""
    mon, j_mon, clock, d = _pair(tmp_path, run_id="incarnation-1")
    _write_peer(d, 1, 2, run_id="incarnation-0")
    _write_peer(d, 1, 3, run_id="incarnation-0")
    mon._scan(), j_mon._scan()
    clock.t += 2.0
    assert mon._scan() is None and j_mon._scan() is None
    _write_peer(d, 1, 2, run_id="incarnation-1")
    _write_peer(d, 1, 3, run_id="incarnation-1")
    os.utime(os.path.join(d, "slice1_proc2.hb"), (2000.0, 2000.0))
    os.utime(os.path.join(d, "slice1_proc3.hb"), (2000.0, 2000.0))
    mon._scan(), j_mon._scan()
    clock.t += 1.0
    dead = mon._scan()
    assert dead == j_mon._scan() and dead["slice"] == 1


def test_slice_monitor_thread_writes_liveness_and_reports(tmp_path):
    """Started, the monitor's thread keeps this process's file fresh with
    its run id and step, and reports a silent slice through ``on_dead``
    with JAX's line."""
    deaths = []
    _write_peer(str(tmp_path / "hb"), 1, 2, step=9)
    mon = slices.SliceHealthMonitor(str(tmp_path / "hb"), 2, 0, 0, timeout_s=0.4,
                                    poll_s=0.05, on_dead=deaths.append,
                                    run_id="inc-7").start()
    try:
        mon.beat(11)
        deadline = time.monotonic() + 5
        while not deaths and time.monotonic() < deadline:
            time.sleep(0.05)
        with open(tmp_path / "hb" / "slice0_proc0.hb") as f:
            own = json.load(f)
    finally:
        mon.stop()
    assert own["run_id"] == "inc-7" and own["step"] == 11
    assert deaths and "slice 1 lost" in deaths[0]


def test_slice_lost_error_classifies_as_slice_loss():
    from fms_fsdp_tpu_torch.resilience.exits import EXIT_CODES, classify_exception

    assert classify_exception(slices.SliceLostError("slice 1 lost")) == "slice_loss"
    assert EXIT_CODES["slice_loss"] == 3


@pytest.mark.parametrize("kw,tag", [
    (dict(process_index=3, slice_index=1), "step watchdog [proc 3 slice 1]"),
    (dict(process_index=3), "step watchdog [proc 3]"),
    ({}, "step watchdog"),
])
def test_watchdog_tag_names_the_slice(kw, tag):
    assert guards.StepWatchdog(5, **kw)._tag == tag
    assert j_guards.StepWatchdog(5, **kw)._tag == tag
