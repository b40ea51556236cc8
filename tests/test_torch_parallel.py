"""PyTorch port, data-parallel slice: the mesh, the placement plan, the
elastic batch policy and the divergence fingerprint, held against the
JAX package in one process.

JAX's ``build_mesh`` lays out its 8-device CPU mesh (tests/conftest.py);
the port's ``mesh_shape`` lays out a world of as many processes, one
device each. The multi-process runs are tests/test_torch_multiprocess.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.data.loader import elastic_batch_size as j_elastic_batch_size
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init_llama
from fms_fsdp_tpu.models.mamba import init_mamba_params as j_init_mamba
from fms_fsdp_tpu.models.mamba import mamba_param_specs as j_mamba_specs
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.models.mixtral import init_mixtral_params as j_init_mixtral
from fms_fsdp_tpu.models.mixtral import mixtral_param_specs as j_mixtral_specs
from fms_fsdp_tpu.parallel import mesh as j_mesh
from fms_fsdp_tpu.parallel import sharding as j_sharding
from fms_fsdp_tpu.resilience import divergence as j_div
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.data.loader import elastic_batch_size
from fms_fsdp_tpu_torch.models.configs import (
    LlamaConfig,
    MambaAttnConfig,
    MambaConfig,
    MixtralConfig,
)
from fms_fsdp_tpu_torch.parallel import mesh, sharding
from fms_fsdp_tpu_torch.resilience import divergence
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TINY_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
               max_expected_seq_len=256)
_ATTN_KW = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_MAMBA_KW = dict(d_model=64, d_intermediate=128, n_layer=3, vocab_size=256,
                 attn_layer_idx=(1,), d_state=16, d_conv=4, expand=2, headdim=16,
                 chunk_size=16, pad_vocab_size_multiple=16)
_MIXTRAL_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                   hidden_dim=96, num_experts=4, top_k=2, max_expected_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


_MESH_CASES = [
    (dict(sharding_strategy="ddp"), (1, 2, 4, 8)),
    (dict(sharding_strategy="fsdp"), (1, 2, 4, 8)),
    (dict(sharding_strategy="hsdp"), (1, 2, 4, 8)),
    (dict(sharding_strategy="hsdp", sharding_group_size=2), (2, 4, 8)),
    (dict(sharding_strategy="hsdp", sharding_group_size=4), (4, 8)),
    (dict(sharding_strategy="fsdp", tensor_parallel_size=2), (2, 4, 8)),
    (dict(sharding_strategy="fsdp", context_parallel_size=2), (4, 8)),
    (dict(sharding_strategy="fsdp", expert_parallel_size=4), (8,)),
    (dict(sharding_strategy="fsdp", num_slices=2), (2, 8)),
    (dict(sharding_strategy="hsdp", num_slices=2, sharding_group_size=2), (4, 8)),
]


@pytest.mark.parametrize("kw,worlds", _MESH_CASES)
def test_mesh_axis_sizes_match_jax(kw, worlds):
    """Each strategy's axis sizes on a world of n processes equal JAX's
    mesh over n of its devices (one host, as the 8 CPU devices are)."""
    for n in worlds:
        ref = j_mesh.build_mesh(j_mesh.MeshConfig(**kw), devices=jax.devices()[:n])
        assert mesh.mesh_shape(mesh.MeshConfig(**kw), n) == dict(ref.shape), (kw, n)


def test_mesh_refusals_and_errors_match_jax():
    for kw, n in ((dict(sharding_strategy="hsdp", sharding_group_size=3), 8),
                  (dict(sharding_strategy="fsdp", tensor_parallel_size=3), 8),
                  (dict(sharding_strategy="fsdp", num_slices=3), 8),
                  (dict(sharding_strategy="zero"), 8)):
        with pytest.raises(ValueError) as port:
            mesh.mesh_shape(mesh.MeshConfig(**kw), n)
        with pytest.raises(ValueError) as ref:
            j_mesh.build_mesh(j_mesh.MeshConfig(**kw), devices=jax.devices()[:n])
        assert str(port.value) == str(ref.value)
    # hsdp's default group: the processes of a host when the world spans
    # hosts (JAX: the devices of a process), else the world
    assert mesh.mesh_shape(mesh.MeshConfig("hsdp"), 8, local_world=4)["fsdp"] == 4
    assert mesh.mesh_shape(mesh.MeshConfig("hsdp"), 6, local_world=4)["fsdp"] == 6


@pytest.mark.parametrize("kw,item", [
    (dict(sharding_strategy="tp"), "A.6b"),
    (dict(sharding_strategy="fsdp", tensor_parallel_size=2), "A.6b"),
    (dict(sharding_strategy="fsdp", num_slices=2), "A.6b"),
    (dict(sharding_strategy="fsdp", expert_parallel_size=2), "A.4b"),
])
def test_build_mesh_refuses_unported_axes(kw, item, monkeypatch):
    """No axis is refused any more (``item``: the ROADMAP.md item that
    brought it): the tensor axis, ``"tp"`` (A.6b's training half), the
    dcn axis (A.6b's multi-slice: two slices of two) and the expert axis
    (A.4b: expert 2 x fsdp 2) reach the device mesh with JAX's axis
    sizes."""
    import torch.distributed.device_mesh as dm

    cfg = mesh.MeshConfig(**kw)
    seen = []
    monkeypatch.setattr(dm, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: seen.append(shape))
    mesh.build_mesh(cfg, device_type="cpu", world=4)
    shape = mesh.mesh_shape(cfg, 4)
    assert seen == [tuple(shape[a] for a in mesh.MESH_AXES)]
    ref = j_mesh.build_mesh(j_mesh.MeshConfig(**kw), devices=jax.devices()[:4])
    assert shape == dict(ref.shape)
    if item == "A.4b":
        assert (shape["expert"], shape["fsdp"]) == (2, 2)


class _RankMesh:
    """A process's view of a row-major mesh: its local rank on each axis."""

    mesh_dim_names = mesh.MESH_AXES

    def __init__(self, shape, rank):
        self.shape = shape
        self.coords = dict(zip(shape, np.unravel_index(rank, tuple(shape.values()))))

    def size(self, dim):
        return self.shape[self.mesh_dim_names[dim]]

    def get_local_rank(self, axis):
        return int(self.coords[axis])


@pytest.mark.parametrize("kw,n", [
    (dict(sharding_strategy="fsdp", context_parallel_size=2), 8),
    (dict(sharding_strategy="fsdp", context_parallel_size=4), 8),
    (dict(sharding_strategy="hsdp", sharding_group_size=2, context_parallel_size=2), 8),
    (dict(sharding_strategy="ddp", context_parallel_size=2), 4),
])
def test_context_mesh_matches_jax(kw, n):
    """The context axis builds (no refusal): its axis sizes equal JAX's
    mesh over n devices, and each rank's data index and context index are
    the coordinates JAX's mesh gives device ``rank`` (context innermost:
    adjacent ranks are context peers; the data index ravels DATA_AXES)."""
    assert not hasattr(mesh, "_UNPORTED_AXES")  # no axis is refused
    ref = j_mesh.build_mesh(j_mesh.MeshConfig(**kw), devices=jax.devices()[:n])
    shape = mesh.mesh_shape(mesh.MeshConfig(**kw), n)
    assert shape == dict(ref.shape)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    cp = shape[mesh.AXIS_CONTEXT]
    for rank in range(n):
        coords = dict(zip(mesh.MESH_AXES, (int(c[0]) for c in np.nonzero(ids == rank))))
        fake = _RankMesh(shape, rank)
        assert mesh.context_index(fake) == coords[mesh.AXIS_CONTEXT] == rank % cp
        want = 0
        for a in mesh.DATA_AXES:
            want = want * shape[a] + coords[a]
        assert mesh.data_index(fake) == want == rank // cp


def test_slice_assignments_match_jax(monkeypatch):
    assert mesh.slice_assignments(8) == ([0] * 8, 1)
    ids, n = mesh.slice_assignments(8, 2)
    assert (ids, n) == j_mesh.slice_assignments(jax.devices(), 2)
    monkeypatch.setenv(mesh.SIM_SLICES_ENV, "4")
    assert mesh.slice_assignments(8) == ([0, 0, 1, 1, 2, 2, 3, 3], 4)
    monkeypatch.delenv(mesh.SIM_SLICES_ENV)
    assert mesh.process_slice_context() == j_mesh.process_slice_context() == (1, 0)

    class Cfg:
        num_slices = 2

    assert mesh.process_slice_context(Cfg()) == j_mesh.process_slice_context(Cfg()) == (2, 0)


def test_axes_and_batch_spec_match_jax():
    assert mesh.MESH_AXES == j_mesh.MESH_AXES
    assert mesh.DATA_AXES == j_mesh.DATA_AXES
    assert tuple(sharding.batch_pspec()) == tuple(j_sharding.batch_pspec())


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _key(path):
    return "params." + ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _spec_at(specs, path):
    for k in path:
        specs = specs[getattr(k, "key", getattr(k, "idx", None))]
    return specs


@pytest.mark.parametrize("family", ["llama", "mamba", "mixtral"])
@pytest.mark.parametrize("strategy,n,group", [("fsdp", 2, None), ("fsdp", 4, None),
                                              ("fsdp", 8, None), ("hsdp", 8, 2),
                                              ("ddp", 4, None)])
def test_placement_plan_matches_jax_resolved_specs(family, strategy, n, group):
    """Leaf by leaf, the port's spec resolves as JAX's on the same mesh
    shape, and the dim the port splits is the one JAX's resolved spec
    puts ``fsdp`` on (none for a leaf whose dim fsdp does not divide)."""
    if family == "llama":
        params = j_init_llama(jax.random.PRNGKey(0), JLlamaConfig(**TINY_KW))
        j_specs, t_specs = (j_sharding.llama_param_specs(scan=True),
                            sharding.param_specs(LlamaConfig(**TINY_KW)))
    elif family == "mixtral":
        params = j_init_mixtral(jax.random.PRNGKey(0), JMixtralConfig(**_MIXTRAL_KW))
        j_specs = j_mixtral_specs(scan=True)
        t_specs = sharding.param_specs(MixtralConfig(**_MIXTRAL_KW))
    else:
        jcfg = JMambaConfig(attn_cfg=JMambaAttnConfig(**_ATTN_KW), **_MAMBA_KW)
        params = j_init_mamba(jax.random.PRNGKey(0), jcfg)
        j_specs = j_mamba_specs(jcfg)
        t_specs = sharding.param_specs(
            MambaConfig(attn_cfg=MambaAttnConfig(**_ATTN_KW), **_MAMBA_KW))
    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(strategy, group), devices=jax.devices()[:n])
    shape = mesh.mesh_shape(mesh.MeshConfig(strategy, group), n)
    np_params = jax.tree.map(np.asarray, params)
    dims = sharding.shard_dims(np_params, t_specs, shape)
    split = 0
    for path, leaf in _leaves(np_params):
        ref = j_sharding.resolve_spec(_spec_at(j_specs, path), leaf.shape, jmesh)
        port = sharding.resolve_spec(_spec_at(t_specs, path), leaf.shape, shape)
        assert tuple(port) == tuple(ref), _key(path)
        fsdp_dims = [i for i, e in enumerate(ref)
                     if "fsdp" in (e if isinstance(e, tuple) else (e,))]
        want = fsdp_dims[0] if fsdp_dims and shape["fsdp"] > 1 else None
        assert dims[_key(path)] == want, _key(path)
        split += want is not None
    assert (split > 0) == (shape["fsdp"] > 1)
    if family == "llama" and shape["fsdp"] > 1:
        # the stacked L axis is never split
        assert dims["params.layers.wq"] == 1 and dims["params.layers.wo"] == 2
    if family == "mixtral" and shape["fsdp"] > 1:
        # E is not split over fsdp; the router is replicated
        assert dims["params.layers.w1"] == 2 and dims["params.layers.w2"] == 3
        assert dims["params.layers.gate"] is None
    if family == "mixtral":
        # at ep 2 the dim JAX's resolved spec puts ``expert`` on: E (dim 1)
        # of every expert leaf, no other leaf
        ep_kw = dict(sharding_strategy=strategy, sharding_group_size=group,
                     expert_parallel_size=2)
        jmesh = j_mesh.build_mesh(j_mesh.MeshConfig(**ep_kw), devices=jax.devices()[:n])
        shape = mesh.mesh_shape(mesh.MeshConfig(**ep_kw), n)
        assert shape == dict(jmesh.shape)
        edims = sharding.shard_dims(np_params, t_specs, shape, mesh.AXIS_EXPERT)
        for path, leaf in _leaves(np_params):
            ref = j_sharding.resolve_spec(_spec_at(j_specs, path), leaf.shape, jmesh)
            want = [i for i, e in enumerate(ref)
                    if "expert" in (e if isinstance(e, tuple) else (e,))]
            assert edims[_key(path)] == (want[0] if want else None), _key(path)
        assert sorted(k for k, d in edims.items() if d is not None) == [
            "params.layers.w1", "params.layers.w2", "params.layers.w3"]
        assert {edims["params.layers.w1"], edims["params.layers.w2"]} == {1}


def test_moments_placed_as_their_params():
    """``infer_state_specs`` on the checkpoint's keys: Adam's moments take
    their param's spec, the scalars none, as JAX's on its tree."""
    specs = sharding.llama_param_specs()
    keys = ["params.layers.wq", "opt_state.inner_state.0.mu.layers.wq",
            "opt_state.inner_state.0.nu.lm_head", "opt_state.count", "step"]
    got = sharding.infer_state_specs(keys, specs)
    assert got["opt_state.inner_state.0.mu.layers.wq"] == specs["layers"]["wq"]
    assert got["opt_state.inner_state.0.nu.lm_head"] == specs["lm_head"]
    assert got["opt_state.count"] == sharding.P() and got["step"] == sharding.P()
    assert sharding.param_key("opt_state.inner_state.0.nu.layers.w2") == "params.layers.w2"


def test_unported_reduce_and_layout_refused():
    """JAX's quantized reduce is ported: the policy carries the mode as
    JAX's does, and the amax rows are replicated (their flat keys match
    no param's spec). A serving layout without an extent ("tp") is
    refused with JAX's message (``parse_serve_layout``)."""
    from fms_fsdp_tpu.parallel.mixed_precision import get_dtype_policy as j_policy
    from fms_fsdp_tpu_torch.parallel.mixed_precision import get_dtype_policy
    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine

    assert get_dtype_policy(TrainConfig(quantized_reduce="int8")).reduce_quant == "int8"
    assert j_policy(TrainConfig(quantized_reduce="int8")).reduce_quant == "int8"
    specs = sharding.llama_param_specs(scan=True)
    key = "quant.amax_history.g.layers.wq"
    assert sharding.infer_state_specs([key], specs)[key] == sharding.P()
    with pytest.raises(ValueError, match="positive integer extent"):
        ServingEngine({}, LlamaConfig(**TINY_KW), ServeConfig(serve_layout="tp"), device="cpu")


def test_elastic_batch_size_matches_jax(capsys):
    """tests/test_elastic.py's cases through both packages: the same
    returns, errors and notices."""
    cases = [(None, 8), ({"global_batch_rows": 16}, 8), ({"global_batch_rows": 16}, 4),
             ({"global_batch_rows": 16}, 3),
             ({"global_batch_rows": 16, "device_count": 8}, 8),
             ({"global_batch_rows": 24, "device_count": 8}, 8),
             ({"global_batch_rows": 0}, 4)]
    for allow in (False, True):
        for topo, extent in cases:
            outs = []
            for cfg, fn in ((JTrainConfig(batch_size=2), j_elastic_batch_size),
                            (TrainConfig(batch_size=2), elastic_batch_size)):
                cfg.allow_batch_change = allow
                try:
                    outs.append(("ok", fn(cfg, topo, extent)))
                except ValueError as e:
                    outs.append(("err", str(e)))
                outs.append(capsys.readouterr().out)
            assert outs[:2] == outs[2:], (topo, extent, allow)
    cfg = TrainConfig(batch_size=2)
    assert elastic_batch_size(cfg, {"global_batch_rows": 16}, 4) == 4
    assert "preserving the global batch of 16 rows" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the divergence fingerprint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "float16"])
def test_leaf_checksum_matches_jax_state_checksum(dtype):
    """The bits summed mod 2^32, as JAX's jitted whole-state checksum
    sums a one-leaf state."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((37, 11)) * 100).astype(np.float32)
    j = jnp.asarray(a).astype(dtype)
    ref = j_div.state_checksum({"w": j})
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(getattr(torch, dtype))
    assert divergence.leaf_checksum(t) == ref


def test_scalar_digest_and_minority_match_jax():
    for loss, g in ((2.5, 1.25), (float("nan"), -1.0), (1e-9, 3e7)):
        assert divergence.scalar_digest(loss, g) == j_div.scalar_digest(loss, g)
    for labels, values in (([0, 1, 2], [5, 5, 7]), ([0, 1], [1, 2]),
                           ([0, 1, 2, 3], [1, 1, 2, 2]), ([3, 4, 5], [9, 9, 9])):
        assert divergence._minority(labels, values) == j_div._minority(labels, values)
    for step, last, every in ((4, None, 2), (4, 3, 2), (6, 4, 2), (6, 4, 0)):
        assert (divergence.divergence_due(step, last, every)
                == j_div.divergence_due(step, last, every))


def test_one_process_compare_is_a_no_op_and_sdc_scales_the_largest_leaf():
    from fms_fsdp_tpu_torch.bridge import params_from_numpy
    from fms_fsdp_tpu_torch.train.step import state_from_params

    params = params_from_numpy(jax.tree.map(
        np.asarray, j_init_llama(jax.random.PRNGKey(0), JLlamaConfig(**TINY_KW))))
    state = state_from_params(params, TrainConfig())
    assert state["dp"] is None
    before = divergence.state_checksum_parts(state)
    assert divergence.check_divergence(state, 1.0, 2.0, 4)
    w1 = state["params"]["layers"]["w1"].clone()
    key = divergence.inject_sdc(state, 1.5)
    assert key == max(("params.layers.w1", "params.layers.w2", "params.layers.w3"))
    assert divergence.state_checksum_parts(state) != before
    if key == "params.layers.w1":
        assert torch.equal(state["params"]["layers"]["w1"], w1 * 1.5)


def test_fingerprint_stamps_the_live_world():
    from fms_fsdp_tpu_torch.ckpt.elastic import current_fingerprint
    from fms_fsdp_tpu_torch.utils.dist import world_size

    fp = current_fingerprint(TrainConfig(batch_size=3, use_dummy_dataset=True))
    assert fp["process_count"] == fp["device_count"] == world_size() == 1
    fp = current_fingerprint(TrainConfig(batch_size=3), process_count=2)
    assert fp["device_count"] == 2 and fp["global_batch_rows"] == 6
