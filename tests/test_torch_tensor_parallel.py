"""PyTorch port, tensor parallelism in training: the tensor axis and the
Megatron layout held against the JAX package in one process.

JAX's ``build_mesh`` lays out its 8-device CPU mesh (tests/conftest.py)
with a ``tensor`` axis; the port's ``mesh_shape`` lays out a world of as
many processes, one device each. Each leaf's local shape (its fsdp part
of its tensor block) is held to JAX's ``NamedSharding(...).shard_shape``
on the same mesh, and the head guards to JAX's ``resolve_spec`` on the
q/kv and SSD operand shapes. The gloo worlds that train through the
layout are tests/test_torch_tp_worlds.py.
"""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init_llama
from fms_fsdp_tpu.models.mamba import init_mamba_params as j_init_mamba
from fms_fsdp_tpu.models.mamba import mamba_param_specs as j_mamba_specs
from fms_fsdp_tpu.models.mixtral import init_mixtral_params as j_init_mixtral
from fms_fsdp_tpu.models.mixtral import mixtral_param_specs as j_mixtral_specs
from fms_fsdp_tpu.parallel import mesh as j_mesh
from fms_fsdp_tpu.parallel import sharding as j_sharding
from fms_fsdp_tpu_torch.models.configs import (
    LlamaConfig,
    MambaAttnConfig,
    MambaConfig,
    MixtralConfig,
)
from fms_fsdp_tpu_torch.models.mamba import ssd_heads_split
from fms_fsdp_tpu_torch.ops.attention import heads_split
from fms_fsdp_tpu_torch.parallel import mesh, sharding
from fms_fsdp_tpu_torch.parallel.tensor import TensorParallel, is_split
from test_torch_parallel import _RankMesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TINY_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
               max_expected_seq_len=256)
_ATTN_KW = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_MAMBA_KW = dict(d_model=64, d_intermediate=128, n_layer=3, vocab_size=256,
                 attn_layer_idx=(1,), d_state=16, d_conv=4, expand=2, headdim=16,
                 chunk_size=16, pad_vocab_size_multiple=16, ngroups=2)
_MIXTRAL_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                   hidden_dim=96, num_experts=4, top_k=2, max_expected_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.mark.parametrize("kw,n", [
    (dict(sharding_strategy="fsdp", tensor_parallel_size=2), 2),
    (dict(sharding_strategy="fsdp", tensor_parallel_size=2), 8),
    (dict(sharding_strategy="fsdp", tensor_parallel_size=4), 4),
    (dict(sharding_strategy="fsdp", tensor_parallel_size=4), 8),
    (dict(sharding_strategy="tp", tensor_parallel_size=2), 8),
    (dict(sharding_strategy="tp", tensor_parallel_size=8), 8),
    (dict(sharding_strategy="hsdp", sharding_group_size=2, tensor_parallel_size=2), 8),
    (dict(sharding_strategy="ddp", tensor_parallel_size=2), 4),
    (dict(sharding_strategy="fsdp", context_parallel_size=2, tensor_parallel_size=2), 4),
    (dict(sharding_strategy="fsdp", context_parallel_size=2, tensor_parallel_size=2), 8),
])
def test_tensor_mesh_matches_jax(kw, n):
    """The tensor axis and ``"tp"`` build (no refusal): the axis sizes of
    JAX's mesh over n devices, and each rank's tensor, context and data
    indices are the coordinates JAX's mesh gives device ``rank`` (tensor
    innermost: adjacent ranks are tensor peers, and they share a data
    index, so they read the same rows)."""
    assert not hasattr(mesh, "_UNPORTED_AXES")  # no axis is refused
    ref = j_mesh.build_mesh(j_mesh.MeshConfig(**kw), devices=jax.devices()[:n])
    shape = mesh.mesh_shape(mesh.MeshConfig(**kw), n)
    assert shape == dict(ref.shape)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    tp, cp = shape[mesh.AXIS_TENSOR], shape[mesh.AXIS_CONTEXT]
    for rank in range(n):
        coords = dict(zip(mesh.MESH_AXES, (int(c[0]) for c in np.nonzero(ids == rank))))
        fake = _RankMesh(shape, rank)
        assert mesh.tensor_index(fake) == coords[mesh.AXIS_TENSOR] == rank % tp
        assert mesh.context_index(fake) == coords[mesh.AXIS_CONTEXT] == rank // tp % cp
        want = 0
        for a in mesh.DATA_AXES:
            want = want * shape[a] + coords[a]
        assert mesh.data_index(fake) == want == rank // (tp * cp)
    assert mesh.data_parallel_extent(_RankMesh(shape, 0)) == n // (tp * cp)


def test_build_mesh_reaches_the_tensor_axis(monkeypatch):
    """``build_mesh`` hands the tensor axis and ``"tp"`` to the device
    mesh, and the expert axis beside them."""
    import torch.distributed.device_mesh as dm

    seen = []
    monkeypatch.setattr(dm, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: seen.append(shape))
    mesh.build_mesh(mesh.MeshConfig("tp", tensor_parallel_size=2), device_type="cpu",
                    world=8)
    mesh.build_mesh(mesh.MeshConfig("fsdp", tensor_parallel_size=4, context_parallel_size=2),
                    device_type="cpu", world=8)
    mesh.build_mesh(mesh.MeshConfig("fsdp", expert_parallel_size=2, tensor_parallel_size=2),
                    device_type="cpu", world=8)
    assert seen == [(1, 1, 4, 1, 1, 2), (1, 1, 1, 1, 2, 4), (1, 1, 2, 2, 1, 2)]


def _family(name):
    if name == "llama":
        params = j_init_llama(jax.random.PRNGKey(0), JLlamaConfig(**TINY_KW))
        return params, j_sharding.llama_param_specs(scan=True), sharding.param_specs(
            LlamaConfig(**TINY_KW))
    if name == "mixtral":
        params = j_init_mixtral(jax.random.PRNGKey(0), JMixtralConfig(**_MIXTRAL_KW))
        return params, j_mixtral_specs(scan=True), sharding.param_specs(
            MixtralConfig(**_MIXTRAL_KW))
    jcfg = JMambaConfig(attn_cfg=JMambaAttnConfig(**_ATTN_KW), **_MAMBA_KW)
    params = j_init_mamba(jax.random.PRNGKey(0), jcfg)
    return params, j_mamba_specs(jcfg), sharding.param_specs(
        MambaConfig(attn_cfg=MambaAttnConfig(**_ATTN_KW), **_MAMBA_KW))


def _spec_at(specs, path):
    for k in path:
        specs = specs[getattr(k, "key", getattr(k, "idx", None))]
    return specs


def _key(path):
    return "params." + ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.mark.parametrize("family", ["llama", "mixtral", "mamba"])
@pytest.mark.parametrize("tp", [2, 4])
def test_local_shapes_match_jax_shard_shape(family, tp):
    """Every leaf's local shape on the 8-device mesh at tp 2 and 4 (fsdp
    8 / tp): its tensor block's fsdp part, where ``shard_dims`` records
    the dim each axis splits through ``resolve_spec`` (a dim the axis
    does not divide stays whole), equals JAX's
    ``NamedSharding(mesh, spec).shard_shape``. The Megatron layout
    shows: wq's columns, wo's rows, the embedding's and the lm_head's
    vocabulary, the experts' hidden columns, Mamba's in_proj columns and
    out_proj rows split over tensor; the norms, the router, dt_bias,
    A_log and D whole."""
    params, j_specs, t_specs = _family(family)
    cfg = j_mesh.MeshConfig("fsdp", tensor_parallel_size=tp)
    jmesh = j_mesh.build_mesh(cfg, devices=jax.devices())
    shape = mesh.mesh_shape(mesh.MeshConfig("fsdp", tensor_parallel_size=tp), 8)
    np_params = jax.tree.map(np.asarray, params)
    fdims = sharding.shard_dims(np_params, t_specs, shape)
    tdims = sharding.shard_dims(np_params, t_specs, shape, mesh.AXIS_TENSOR)
    tensor_split = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        key = _key(path)
        spec = j_sharding.resolve_spec(_spec_at(j_specs, path), leaf.shape, jmesh)
        want = NamedSharding(jmesh, spec).shard_shape(leaf.shape)
        local = list(leaf.shape)
        if fdims[key] is not None:
            local[fdims[key]] //= shape["fsdp"]
        if tdims[key] is not None:
            local[tdims[key]] //= tp
            tensor_split.add(key.split(".")[-1])
        assert tuple(local) == tuple(want), key
    if family in ("llama", "mixtral"):
        assert tdims["params.layers.wq"] == 2 and tdims["params.layers.wo"] == 1
        assert tdims["params.embedding"] == 0 and tdims["params.lm_head"] == 1
        assert {"attn_norm", "ffn_norm", "norm"}.isdisjoint(tensor_split)
    if family == "mixtral":
        assert tdims["params.layers.w1"] == 3 and tdims["params.layers.w2"] == 2
        assert tdims["params.layers.gate"] is None
    if family == "mamba":
        assert tdims["params.layers.0.mixer.in_proj"] == 1
        assert tdims["params.layers.0.mixer.out_proj"] == 0
        assert {"dt_bias", "A_log", "D", "norm"}.isdisjoint(tensor_split)


def _j_heads_split(shape_q, shape_kv, tp):
    """JAX's GQA / group guard (``ops/attention.py:97-101``,
    ``ops/ssd.py:355-375``): the resolved specs of the two operands on a
    mesh with a tensor axis of ``tp``; split when both name ``tensor``."""
    from jax.sharding import PartitionSpec as P

    jmesh = j_mesh.build_mesh(j_mesh.MeshConfig("fsdp", tensor_parallel_size=tp),
                              devices=jax.devices())
    base = P(j_mesh.DATA_AXES, None, j_mesh.AXIS_TENSOR, None)
    sq = j_sharding.resolve_spec(base, shape_q, jmesh)
    skv = j_sharding.resolve_spec(base, shape_kv, jmesh)
    return sq[2] == skv[2] == j_mesh.AXIS_TENSOR


@pytest.mark.parametrize("nq,nkv,tp", [(4, 2, 2), (4, 2, 4), (32, 8, 2), (32, 8, 4),
                                       (32, 8, 8), (8, 1, 2), (6, 2, 4)])
def test_gqa_guard_matches_jax(nq, nkv, tp):
    """The attention runs on local heads exactly where JAX's shard_map
    splits them: both head counts divide the tensor extent (16 query and
    4 KV heads a rank at llama3_8b and tp 2; at nkv 2 and tp 4 every rank
    runs every head)."""
    want = _j_heads_split((8, 64, nq, 128), (8, 64, nkv, 128), tp)

    class Tp:
        size = tp

    assert heads_split(nq, nkv, Tp) == want
    assert heads_split(nq, nkv, None) is False


@pytest.mark.parametrize("h,g,tp", [(8, 1, 2), (8, 2, 2), (8, 2, 4), (128, 1, 2),
                                    (128, 8, 2), (6, 2, 4)])
def test_ssd_group_guard_matches_jax(h, g, tp):
    """The SSD runs on local heads and groups exactly where JAX's
    shard_map splits them (mamba_9.8b's one group runs every head on
    every rank)."""
    want = _j_heads_split((8, 64, h, 64), (8, 64, g, 128), tp)

    class Tp:
        size = tp

    assert ssd_heads_split(h, g, Tp) == want


def test_is_split_reads_the_local_block():
    """A dim is this rank's block (whole / tp), whole, or a layout error."""
    tp = TensorParallel(group=None, size=2, rank=1)
    assert is_split(tp, 64, 128) and not is_split(tp, 128, 128)
    assert not is_split(None, 64, 128)
    with pytest.raises(ValueError, match="neither"):
        is_split(tp, 48, 128)
    with pytest.raises(ValueError):
        TensorParallel(group=None, size=1, rank=0)
