"""PyTorch port, Mamba serving slice: held against the JAX package.

The tiny pure and hybrid configs of tests/test_serving_families.py:74-77,
JAX-initialised weights moved through the port's bridge, the same prompts
through both packages on CPU at fp32: ``mamba_prefill`` and
``mamba_decode_step`` logits within 2e-5, greedy engine tokens identical
on a ragged wave, padded-prefill invariance, the slab's lifecycle and
size, and the refused knobs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.models import mamba as j_mamba
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.serve import ServeConfig as JServeConfig
from fms_fsdp_tpu.serve import ServingEngine as JServingEngine
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.models import mamba as t_mamba
from fms_fsdp_tpu_torch.models.configs import MambaAttnConfig, MambaConfig, MixtralConfig
from fms_fsdp_tpu_torch.ops import ssd as t_ssd
from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
from fms_fsdp_tpu_torch.serve.families import (
    check_params_family,
    family_of,
    init_params_for,
    load_model_config,
)
from fms_fsdp_tpu_torch.serve.families.mamba import MambaAdapter

ATOL = 2e-5

_PURE_KW = dict(d_model=64, n_layer=2, vocab_size=128, d_state=16, headdim=16,
                chunk_size=8, attn_layer_idx=(), d_intermediate=128)
_ATTN_KW = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_HYBRID_KW = dict(_PURE_KW, n_layer=3, attn_layer_idx=(1,))
J_CFG = {
    "pure": JMambaConfig(**_PURE_KW),
    "hybrid": JMambaConfig(attn_cfg=JMambaAttnConfig(**_ATTN_KW), **_HYBRID_KW),
}
CFG = {
    "pure": MambaConfig(**_PURE_KW),
    "hybrid": MambaConfig(attn_cfg=MambaAttnConfig(**_ATTN_KW), **_HYBRID_KW),
}
KINDS = ("pure", "hybrid")


@pytest.fixture(scope="module")
def np_params():
    return {
        kind: jax.tree.map(np.asarray, j_mamba.init_mamba_params(
            jax.random.PRNGKey(i), J_CFG[kind]))
        for i, kind in enumerate(KINDS)
    }


def _jp(np_tree):
    """numpy leaves -> jax arrays, for the JAX functions called directly
    (they index the embedding with a traced token)."""
    return jax.tree.map(jnp.asarray, np_tree)


def _close(port, ref, atol=ATOL):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    assert err <= atol, err


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# prefill and the decode step vs JAX at fp32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_mamba_prefill_matches_jax(np_params, kind):
    """A ragged, padded batch: rows of 5 and 8 tokens in 8 columns."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 128, size=(2, 8)).astype(np.int32)
    lengths = np.array([5, 8], np.int32)
    kv_len = 16 if kind == "hybrid" else 0
    jl, jstate, jkv = j_mamba.mamba_prefill(
        _jp(np_params[kind]), jnp.asarray(toks), jnp.asarray(lengths), J_CFG[kind],
        compute_dtype=jnp.float32, kv_len=kv_len)
    tl, tstate, tkv = t_mamba.mamba_prefill(
        params_from_numpy(np_params[kind]), torch.from_numpy(toks).long(),
        torch.from_numpy(lengths).long(), CFG[kind],
        compute_dtype=torch.float32, kv_len=kv_len)
    _close(tl, jl)
    for tlayer, jlayer in zip(tstate, jstate):
        assert set(tlayer) == set(jlayer)
        for name in tlayer:
            _close(tlayer[name], jlayer[name])
    if kind == "hybrid":
        _close(tkv["k"], jkv["k"])
        _close(tkv["v"], jkv["v"])
        # padded rows' k/v are zeros past the prompt
        assert not tkv["k"][:, 0, 5:].any() and not tkv["v"][:, 0, 5:].any()
    else:
        assert tkv is None and jkv is None


@pytest.mark.parametrize("kind", KINDS)
def test_mamba_decode_step_matches_jax(np_params, kind):
    """Prefill two ragged rows, then three decode steps on both sides."""
    rng = np.random.default_rng(1)
    cfg, jcfg = CFG[kind], J_CFG[kind]
    toks = rng.integers(0, 128, size=(2, 8)).astype(np.int32)
    lengths = np.array([6, 8], np.int32)
    page, maxp = 16, 2
    hybrid = kind == "hybrid"
    kv_len = page if hybrid else 0
    params = params_from_numpy(np_params[kind])
    _, jstate, jkv = j_mamba.mamba_prefill(
        _jp(np_params[kind]), jnp.asarray(toks), jnp.asarray(lengths), jcfg,
        compute_dtype=jnp.float32, kv_len=kv_len)
    _, tstate, tkv = t_mamba.mamba_prefill(
        params, torch.from_numpy(toks).long(), torch.from_numpy(lengths).long(), cfg,
        compute_dtype=torch.float32, kv_len=kv_len)
    jpools = tpools = jtable = ttable = None
    if hybrid:
        # row b owns pages 2 + 2b and 3 + 2b; page 0 stays zero
        table = np.array([[2, 3], [4, 5]], np.int32)
        a = cfg.attn_cfg
        shape = (1, 6, page, a.num_heads_kv, a.head_dim)
        pools = {n: np.zeros(shape, np.float32) for n in ("k", "v")}
        for n in ("k", "v"):
            for b in range(2):
                pools[n][0, table[b, 0]] = np.asarray(jkv[n][0, b])
        jpools = {n: jnp.asarray(p) for n, p in pools.items()}
        tpools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
        jtable, ttable = jnp.asarray(table), torch.from_numpy(table)
    lens = lengths.copy()
    for step in range(3):
        cur = rng.integers(0, 128, size=(2,)).astype(np.int32)
        jl, jstate, jpools = j_mamba.mamba_decode_step(
            _jp(np_params[kind]), jstate, jpools, jtable, jnp.asarray(lens),
            jnp.asarray(cur), jcfg, page_size=page, compute_dtype=jnp.float32)
        tl, tstate, tpools = t_mamba.mamba_decode_step(
            params, tstate, tpools, ttable, torch.from_numpy(lens),
            torch.from_numpy(cur), cfg, page_size=page, compute_dtype=torch.float32)
        _close(tl, jl)
        lens = lens + 1
    for tlayer, jlayer in zip(tstate, jstate):
        for name in tlayer:
            _close(tlayer[name], jlayer[name])
    if hybrid:
        _close(tpools["k"], jpools["k"])


def test_mamba_prefill_equals_full_forward_reference(np_params):
    """The recurrent prefill's last-position logits equal the dense
    forward's through the per-token recurrence (mamba_kernel="reference")."""
    toks = np.random.default_rng(2).integers(0, 128, size=(1, 8)).astype(np.int32)
    params = params_from_numpy(np_params["hybrid"])
    logits, _, _ = t_mamba.mamba_prefill(
        params, torch.from_numpy(toks).long(), torch.tensor([8]), CFG["hybrid"],
        compute_dtype=torch.float32)
    dense = t_mamba.mamba_forward(
        params, torch.from_numpy(toks).long(), CFG["hybrid"],
        compute_dtype=torch.float32, attn_impl="xla", mamba_kernel="reference")
    _close(logits, dense[:, -1].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_WAVE = [([5, 9, 2, 7], 6), ([11, 3, 8, 1, 4, 4, 9], 9), ([7] * 13, 5), ([1, 2], 7)]


def _engines(np_params, kind, plans, **kw):
    kw = {"max_batch": 2, "max_seq_len": 64, "compute_dtype": "float32",
          "page_size": 16, "max_prefill_per_step": 2, "attn_impl": "reference", **kw}
    jeng = JServingEngine(np_params[kind], J_CFG[kind], JServeConfig(**kw))
    teng = ServingEngine(params_from_numpy(np_params[kind]), CFG[kind],
                         ServeConfig(**kw), device="cpu")
    jreqs = [jeng.submit(p, n) for p, n in plans]
    treqs = [teng.submit(p, n) for p, n in plans]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.state == j.state == "finished"
        assert t.generated == j.generated
    return jeng, teng


@pytest.mark.parametrize("kind", KINDS)
def test_mamba_engine_greedy_tokens_match_jax(np_params, kind):
    """A ragged wave of four requests over two slots."""
    t_ssd.reset_launches()
    jeng, teng = _engines(np_params, kind, _WAVE)
    assert teng.family == "mamba" and teng.serving_stats()["family"] == 1.0
    assert teng.attn_impl == jeng.attn_impl == ("reference" if kind == "hybrid" else "none")
    assert teng.adapter.state_bytes_per_stream == jeng.adapter.state_bytes_per_stream
    assert teng.serving_stats()["state_bytes_per_stream"] > 0
    assert teng.serving_stats()["paged_kernel_impl"] == 0.0
    assert t_ssd.LAUNCHES == {"fused": 0}  # serving runs no SSD scan
    if kind == "hybrid":
        assert teng.page_size == 16 and teng.cache.n_layers == 1
    else:
        assert teng.cache is None and teng.adapter.pages_in_use == 0
    # after drain every slot is released: all slab slices exactly zero
    assert not any(leaf.any() for leaf in _leaves(teng.adapter._state))


def test_mamba_hybrid_engine_eviction_tokens_match_jax(np_params):
    """3 allocatable attn pages of 16: the LIFO victim's slab slice is
    zeroed at eviction and recompute-on-resume re-prefills it."""
    jeng, teng = _engines(np_params, "hybrid",
                          [([5, 9, 2, 7], 20), ([11, 3, 8, 1], 20)], num_pages=3 + 2)
    assert teng.scheduler.evicted >= 1
    assert teng.scheduler.evicted == jeng.scheduler.evicted
    assert not any(leaf.any() for leaf in _leaves(teng.adapter._state))


@pytest.mark.parametrize("kind", KINDS)
def test_mamba_bucketed_prefill_padding_invariant(np_params, kind):
    """prefill_bucket > 1 pads the prompt; the prefill freezes per-row
    state past the real length, so padded and exact prefill serve
    identical streams."""
    prompt, max_new = [5, 9, 2, 7, 6], 6
    out = []
    for bucket in (1, 8):
        eng = ServingEngine(params_from_numpy(np_params[kind]), CFG[kind], ServeConfig(
            max_batch=2, max_seq_len=64, compute_dtype="float32", page_size=16,
            prefill_bucket=bucket), device="cpu")
        req = eng.submit(prompt, max_new)
        eng.run()
        out.append(req.generated)
    assert out[0] == out[1] and len(out[0]) == max_new


def test_mamba_slab_zeroed_on_completion(np_params):
    """Completion lands in release() like eviction does: the finished
    stream's slab slice is exactly zero while a neighbour keeps decoding
    (the live-row mask keeps idle slices zero mid-flight)."""
    eng = ServingEngine(params_from_numpy(np_params["pure"]), CFG["pure"], ServeConfig(
        max_batch=2, max_seq_len=64, compute_dtype="float32", max_prefill_per_step=2,
    ), device="cpu")
    short = eng.submit([5, 9, 2, 7], 2)
    long = eng.submit([11, 3, 8, 1], 12)
    checked = 0
    while eng.has_work():
        eng.step()
        if short.state == "finished" and long.state != "finished":
            assert not any(leaf.any() for leaf in _leaves(eng.adapter.slab_slice(0)))
            assert any(leaf.any() for leaf in _leaves(eng.adapter.slab_slice(1)))
            checked += 1
    assert short.state == long.state == "finished" and checked > 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_state_bytes_match_jax(kind, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = j_mamba.mamba_state_bytes_per_stream(J_CFG[kind], jdt)
    assert t_mamba.mamba_state_bytes_per_stream(CFG[kind], tdt) == want
    state = t_mamba.init_mamba_decode_state(CFG[kind], 1, tdt)
    assert sum(t.numel() * t.element_size() for t in _leaves(state)) == want


@pytest.mark.parametrize("field,value,match", [
    ("attn_impl", "kernel", "attn_impl"),
    ("kv_quant", "int8", "kv_quant"),
    ("serve_layout", "tp=2", "serve_layout"),
    ("speculator_path", "spec.pkl", "speculator_path"),
])
def test_mamba_refused_knobs_raise(np_params, field, value, match):
    """The adapter's four refusals, each naming its knob. The engine
    refuses serve_layout, whose path is not ported at all, before it
    builds the adapter."""
    params = params_from_numpy(np_params["pure"])
    scfg = ServeConfig(compute_dtype="float32", **{field: value})
    with pytest.raises(ValueError, match=match):
        MambaAdapter(params, CFG["pure"], scfg, torch.float32, "cpu")
    expected = (ValueError if field in ("attn_impl", "kv_quant", "speculator_path")
                else NotImplementedError)
    with pytest.raises(expected, match=match):
        ServingEngine(params, CFG["pure"], scfg, device="cpu")


def test_mamba_family_resolution(np_params):
    assert family_of(CFG["pure"]) == family_of(CFG["hybrid"]) == "mamba"
    d = dataclasses.asdict(CFG["hybrid"])
    d["attn_layer_idx"] = list(d["attn_layer_idx"])  # as JSON returns it
    assert load_model_config(d) == CFG["hybrid"]
    assert load_model_config(dict(d, family="mamba")) == CFG["hybrid"]
    mixtral = load_model_config({"family": "mixtral"})
    assert isinstance(mixtral, MixtralConfig) and family_of(mixtral) == "mixtral"
    params = init_params_for(CFG["pure"])(torch.Generator().manual_seed(0))
    check_params_family(params, "mamba")
    with pytest.raises(ValueError, match="family mismatch"):
        check_params_family(params, "llama")
    assert not MambaAdapter.supports_handoff
