"""PyTorch port, Mixtral serving: held against the JAX package on the CPU.

The TINY Mixtral of tests/test_serving_families.py:85-88, JAX-initialised
weights moved through the bridge, the same prompts through both packages
at fp32: ``mixtral_prefill``, ``mixtral_decode_step`` and
``mixtral_paged_decode_step`` within 1e-5, the grouped routed FFN against
JAX's routed and dense ``_moe_token``, the engines' greedy tokens equal
(routed and dense, a ragged wave, eviction), the family's resolution and
the adapter's refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.models import mixtral as jm
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.serve import ServeConfig as JServeConfig
from fms_fsdp_tpu.serve import ServingEngine as JServingEngine
from fms_fsdp_tpu_torch import ckpt  # noqa: F401  (before utils.checkpointing)
from fms_fsdp_tpu_torch.bridge import params_from_numpy, params_to_numpy
from fms_fsdp_tpu_torch.models import mixtral as tm
from fms_fsdp_tpu_torch.models.configs import MixtralConfig
from fms_fsdp_tpu_torch.ops import flash_attention as t_fa
from fms_fsdp_tpu_torch.ops import paged_attention as t_pa
from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
from fms_fsdp_tpu_torch.serve.families import (
    check_params_family,
    family_of,
    init_params_for,
    load_model_config,
)
from fms_fsdp_tpu_torch.serve.families.mixtral import MixtralAdapter

ATOL = 1e-5
_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
           hidden_dim=128, num_experts=4, top_k=2, max_expected_seq_len=64)
J_CFG = JMixtralConfig(**_KW)
CFG = MixtralConfig(**_KW)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jm.init_mixtral_params(jax.random.PRNGKey(2), J_CFG))


def _jp(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


def _close(port, ref, atol=ATOL):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    assert err <= atol, err


def _prompt(seed, b, s):
    return np.random.default_rng(seed).integers(0, 128, size=(b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full_logits", [False, True])
def test_prefill_matches_jax(np_params, full_logits):
    toks = _prompt(0, 2, 7)
    ref = jm.mixtral_prefill(_jp(np_params), jnp.asarray(toks), J_CFG, 16,
                             compute_dtype=jnp.float32, full_logits=full_logits)
    out = tm.mixtral_prefill(params_from_numpy(np_params), torch.from_numpy(toks).long(),
                             CFG, 16, compute_dtype=torch.float32,
                             full_logits=full_logits)
    for port, j in zip(out[:2], ref[:2]):
        _close(port, j)
    for key in ("k", "v"):
        _close(out[2][key], ref[2][key])


@pytest.mark.parametrize("moe_impl", ["dense", "routed"])
def test_decode_step_matches_jax(np_params, moe_impl):
    """Prefill 6 tokens, then three dense-cache decode steps."""
    toks = _prompt(1, 3, 6)
    jparams, tparams = _jp(np_params), params_from_numpy(np_params)
    _, _, jcache = jm.mixtral_prefill(jparams, jnp.asarray(toks), J_CFG, 16,
                                      compute_dtype=jnp.float32)
    _, _, tcache = tm.mixtral_prefill(tparams, torch.from_numpy(toks).long(), CFG, 16,
                                      compute_dtype=torch.float32)
    nxt = _prompt(2, 3, 3)
    for i in range(3):
        tok = nxt[:, i:i + 1]
        jl, jcache = jm.mixtral_decode_step(jparams, jcache, jnp.asarray(tok), 6 + i,
                                            J_CFG, compute_dtype=jnp.float32,
                                            moe_impl=moe_impl)
        tl, tcache = tm.mixtral_decode_step(tparams, tcache, torch.from_numpy(tok).long(),
                                            6 + i, CFG, compute_dtype=torch.float32,
                                            moe_impl=moe_impl)
        _close(tl, jl)
    _close(tcache["k"], jcache["k"])


@pytest.mark.parametrize("moe_impl", ["dense", "routed"])
def test_paged_decode_step_matches_jax(np_params, moe_impl):
    """Random pools, a ragged batch of four rows (one at position 0, one on
    a page boundary) over pages of 4; the pools written as JAX writes them."""
    rng = np.random.default_rng(3)
    L, pages, page, nkv, hd = 2, 12, 4, CFG.n_kv_heads, CFG.head_dim
    pools = {k: (0.5 * rng.standard_normal((L, pages, page, nkv, hd))).astype(np.float32)
             for k in ("k", "v")}
    table = rng.permutation(np.arange(1, pages))[:8].reshape(4, 2).astype(np.int32)
    lens = np.array([0, 4, 6, 3], np.int32)
    toks = np.array([5, 17, 99, 3], np.int32)
    jl, jpools = jm.mixtral_paged_decode_step(
        _jp(np_params), _jp(pools), jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(toks), J_CFG, page_size=page, compute_dtype=jnp.float32,
        moe_impl=moe_impl)
    tpools = params_from_numpy(pools)
    tl, tpools = tm.mixtral_paged_decode_step(
        params_from_numpy(np_params), tpools, torch.from_numpy(table),
        torch.from_numpy(lens), torch.from_numpy(toks), CFG, page_size=page,
        compute_dtype=torch.float32, moe_impl=moe_impl)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tpools[key], jpools[key])


@pytest.mark.parametrize("rows", [(2, 3), (5, 1), (1, 1)])
def test_grouped_routed_ffn_matches_jax_routed_and_dense(np_params, rows):
    """The port's routed FFN (rows grouped by expert) against JAX's
    routed ``_moe_token`` (the chosen experts' weights gathered per row)
    and its dense mixture, at fp32."""
    lp = {k: v[1] for k, v in np_params["layers"].items()}
    h = np.random.default_rng(4).standard_normal((*rows, 64)).astype(np.float32)
    j_routed = jm._moe_token(jnp.asarray(h), _jp(lp), J_CFG, "routed")
    j_dense = jm._moe_token(jnp.asarray(h), _jp(lp), J_CFG, "dense")
    t_lp = params_from_numpy(lp)
    routed = tm._moe_token(torch.from_numpy(h), t_lp, CFG, "routed")
    dense = tm._moe_token(torch.from_numpy(h), t_lp, CFG, "dense")
    _close(routed, j_routed, 1e-6)
    _close(routed, j_dense, 1e-6)
    _close(dense, j_dense, 1e-6)
    with pytest.raises(ValueError, match="moe_impl"):
        tm._moe_token(torch.from_numpy(h), t_lp, CFG, "sparse")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_WAVE = [([5, 9, 2, 7], 6), ([11, 3, 8, 1, 4, 4, 9], 9), ([7] * 13, 5), ([1, 2], 7)]


def _engines(np_params, plans, **kw):
    kw = {"max_batch": 2, "max_seq_len": 64, "compute_dtype": "float32",
          "page_size": 16, "max_prefill_per_step": 2, "attn_impl": "reference", **kw}
    jeng = JServingEngine(np_params, J_CFG, JServeConfig(**kw))
    teng = ServingEngine(params_from_numpy(np_params), CFG, ServeConfig(**kw),
                         device="cpu")
    jreqs = [jeng.submit(p, n) for p, n in plans]
    treqs = [teng.submit(p, n) for p, n in plans]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.state == j.state == "finished"
        assert t.generated == j.generated
    return jeng, teng


@pytest.mark.parametrize("moe_impl", ["routed", "dense"])
def test_engine_greedy_tokens_match_jax(np_params, moe_impl):
    """A ragged wave of four requests over two slots; no kernel of the
    repo runs (JAX's Mixtral serving refuses the ragged kernel)."""
    t_pa.reset_launches()
    t_fa.reset_launches()
    jeng, teng = _engines(np_params, _WAVE, moe_impl=moe_impl)
    assert teng.family == jeng.family == "mixtral"
    assert teng.adapter.moe_impl == jeng.adapter.moe_impl == moe_impl
    assert teng.attn_impl == jeng.attn_impl == "reference"
    assert teng.serving_stats()["family"] == 2.0
    assert teng.adapter.state_bytes_per_stream == 0 and teng.adapter.pages_in_use == 0
    assert not any(t_pa.LAUNCHES.values()) and not any(t_fa.LAUNCHES.values())


def test_engine_eviction_tokens_match_jax(np_params):
    """3 allocatable pages of 16: the LIFO victim re-prefills on resume
    and both engines evict alike."""
    jeng, teng = _engines(np_params, [([5, 9, 2, 7], 20), ([11, 3, 8, 1], 20)],
                          num_pages=3 + 2)
    assert teng.scheduler.evicted >= 1
    assert teng.scheduler.evicted == jeng.scheduler.evicted


def test_engine_from_a_params_pickle(np_params, tmp_path):
    """``from_checkpoint`` on a params pickle of numpy leaves serves the
    tokens of the engine built on the params."""
    import pickle

    path = tmp_path / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(params_to_numpy(params_from_numpy(np_params)), f)
    kw = dict(max_batch=2, max_seq_len=64, compute_dtype="float32", page_size=16)
    outs = []
    for eng in (ServingEngine(params_from_numpy(np_params), CFG, ServeConfig(**kw),
                              device="cpu"),
                ServingEngine.from_checkpoint(str(path), CFG, ServeConfig(**kw),
                                              device="cpu")):
        req = eng.submit([5, 9, 2, 7], 5)
        eng.run()
        outs.append(req.generated)
    assert outs[0] == outs[1] and len(outs[0]) == 5


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------


def test_family_resolution(np_params):
    assert family_of(CFG) == "mixtral"
    d = dataclasses.asdict(CFG)
    assert load_model_config(d) == CFG
    assert load_model_config(dict(d, family="mixtral")) == CFG
    assert isinstance(load_model_config({"num_experts": 4, "emb_dim": 64}), MixtralConfig)
    assert isinstance(load_model_config({"top_k": 1}), MixtralConfig)
    check_params_family(np_params, "mixtral")
    with pytest.raises(ValueError, match="family mismatch"):
        check_params_family(np_params, "llama")
    params = init_params_for(CFG)(torch.Generator().manual_seed(0))
    assert set(params["layers"]) == set(np_params["layers"])
    for k, v in params["layers"].items():
        assert tuple(v.shape) == np_params["layers"][k].shape, k


@pytest.mark.parametrize("kw,exc,match", [
    (dict(attn_impl="kernel"), ValueError, "reference"),
    (dict(kv_quant="int8"), ValueError, "kv_quant"),
    (dict(moe_impl="sparse"), ValueError, "moe_impl"),
    (dict(speculator_path="spec.pkl"), ValueError, "speculator_path"),
])
def test_engine_refuses_unserved_knobs(np_params, kw, exc, match):
    scfg = ServeConfig(max_batch=2, max_seq_len=64, compute_dtype="float32", **kw)
    with pytest.raises(exc, match=match):
        ServingEngine(params_from_numpy(np_params), CFG, scfg, device="cpu")


def test_adapter_refuses_a_speculator(np_params):
    """Built directly, the adapter refuses a speculator as JAX's does
    (the engine reaches the same refusal through it)."""
    scfg = ServeConfig(max_batch=2, max_seq_len=64, compute_dtype="float32",
                       speculator_path="spec.pkl")
    with pytest.raises(ValueError, match="speculator_path"):
        MixtralAdapter(params_from_numpy(np_params), CFG, scfg, torch.float32, "cpu")
