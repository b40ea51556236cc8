"""PyTorch port, serving slice: held against the JAX package.

The TINY config of tests/test_serving.py, JAX-initialised weights moved
through the port's bridge, and the same prompts through both packages on
CPU at fp32: prefill and paged-decode logits within 2e-5, greedy engine
tokens identical (plain, eviction, int8 pools), the allocator's
contract, a bit-exact weight round trip, and the port's import hygiene.
"""

import dataclasses
import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.generation import decode_chunk as j_decode_chunk
from fms_fsdp_tpu.models.generation import prefill as j_prefill
from fms_fsdp_tpu.models.llama import init_llama_params as j_init
from fms_fsdp_tpu.serve import PagedKVCache as JPagedKVCache
from fms_fsdp_tpu.serve import ServeConfig as JServeConfig
from fms_fsdp_tpu.serve import ServingEngine as JServingEngine
from fms_fsdp_tpu.serve.decode import paged_decode_step as j_paged_decode_step
from fms_fsdp_tpu.utils import config_utils as j_config_utils
from fms_fsdp_tpu_torch.bridge import params_from_numpy, params_to_numpy
from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MixtralConfig
from fms_fsdp_tpu_torch.models.generation import (
    decode_chunk,
    decode_step,
    prefill,
    sample_token,
)
from fms_fsdp_tpu_torch.models.llama import init_llama_params
from fms_fsdp_tpu_torch.ops.paged_attention import gather_pages
from fms_fsdp_tpu_torch.serve import (
    PagedKVCache,
    RequestRejected,
    ServeConfig,
    ServingEngine,
)
from fms_fsdp_tpu_torch.serve.decode import paged_decode_step
from fms_fsdp_tpu_torch.serve.families import family_of, load_model_config
from fms_fsdp_tpu_torch.serve.kv_cache import SCRATCH_PAGE, ZERO_PAGE
from fms_fsdp_tpu_torch.tune.lookup import resolve_paged_decode
from fms_fsdp_tpu_torch.utils import config_utils
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5

_TINY_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                max_expected_seq_len=256)
J_TINY = JLlamaConfig(**_TINY_KW)
TINY = LlamaConfig(**_TINY_KW)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), J_TINY))


@pytest.fixture(scope="module")
def params(np_params):
    return params_from_numpy(np_params, "cpu")


def _close(port, ref, atol=ATOL):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    err = float(np.abs(port - ref).max())
    assert err <= atol, err


# ---------------------------------------------------------------------------
# configs, bridge, init
# ---------------------------------------------------------------------------


def test_llama_variant_table_matches_jax():
    assert set(config_utils._LLAMA_VARIANTS) == set(j_config_utils._LLAMA_VARIANTS)
    for name in config_utils._LLAMA_VARIANTS:
        port = config_utils.get_model_config(name)
        ref = j_config_utils.get_model_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
        assert port.hidden_dim == ref.hidden_dim and port.head_dim == ref.head_dim
        assert port.n_params() == ref.n_params()
    port = config_utils.get_model_config("mixtral_8x7b")
    ref = j_config_utils.get_model_config("mixtral_8x7b")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.head_dim == ref.head_dim and port.n_kv_heads == ref.n_kv_heads
    assert port.n_params() == ref.n_params()
    port = config_utils.get_model_config("mamba_9.8b")
    ref = j_config_utils.get_model_config("mamba_9.8b")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_params() == ref.n_params()


def test_bridge_round_trip_bit_exact(np_params):
    back = params_to_numpy(params_from_numpy(np_params, "cpu"))
    flat_ref = jax.tree_util.tree_flatten_with_path(np_params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        got = flat_back[path]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        assert np.array_equal(got.view(np.uint32), leaf.view(np.uint32)), path


def test_init_llama_params_shapes_and_statistics():
    cfg = LlamaConfig(**{**_TINY_KW, "emb_dim": 128, "nlayers": 4})
    p = init_llama_params(torch.Generator().manual_seed(0), cfg)
    ref = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), J_TINY.__class__(
        **{**_TINY_KW, "emb_dim": 128, "nlayers": 4})))
    got = params_to_numpy(p)
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype), ref)
    assert jax.tree.map(lambda a: (a.shape, a.dtype), got) == shapes
    std = 0.02
    out_std = std / (2 * cfg.nlayers) ** 0.5
    for name, s in (("wq", std), ("w1", std), ("wo", out_std), ("w2", out_std)):
        w = got["layers"][name]
        assert np.abs(w).max() <= 3 * s * (1 + 1e-6)
        # the spread of JAX's draw (a normal truncated at 3 sigma)
        assert abs(w.std() - ref["layers"][name].std()) < 0.05 * s
    assert (got["layers"]["attn_norm"] == 1).all() and (got["norm"] == 1).all()
    again = init_llama_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again["embedding"], p["embedding"])


# ---------------------------------------------------------------------------
# prefill and the paged decode step vs JAX at fp32
# ---------------------------------------------------------------------------


def test_prefill_matches_jax(params, np_params):
    prompt = [[5, 9, 2, 7, 11, 3]]
    jl, je, jc = j_prefill(np_params, jnp.asarray(prompt, jnp.int32), J_TINY,
                           max_seq_len=32, compute_dtype=jnp.float32, full_logits=True)
    tl, te, tc = prefill(params, torch.tensor(prompt), TINY, max_seq_len=32,
                         compute_dtype=torch.float32, full_logits=True)
    _close(tl, jl)
    _close(te, je)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
        assert not tc[name][:, :, 6:].any()  # zero tail past the prompt
    tl_last, _, _ = prefill(params, torch.tensor(prompt), TINY, max_seq_len=32,
                            compute_dtype=torch.float32)
    _close(tl_last, np.asarray(jl)[:, -1:])


@pytest.mark.parametrize("m", [1, 3])
def test_dense_decode_matches_jax(params, np_params, m):
    """The dense cached path (decode_chunk; decode_step is m=1) after a
    prefill: logits, embeds and the updated cache within 2e-5."""
    prompt = [[5, 9, 2, 7], [11, 3, 8, 1]]
    toks = [[7, 9, 4][:m], [9, 1, 2][:m]]
    _, _, jc = j_prefill(np_params, jnp.asarray(prompt, jnp.int32), J_TINY,
                         max_seq_len=16, compute_dtype=jnp.float32)
    _, _, tc = prefill(params, torch.tensor(prompt), TINY, max_seq_len=16,
                       compute_dtype=torch.float32)
    jl, je, jc = j_decode_chunk(np_params, jc, jnp.asarray(toks, jnp.int32), 4,
                                J_TINY, compute_dtype=jnp.float32)
    if m == 1:
        tl, te, tc = decode_step(params, tc, torch.tensor(toks), 4, TINY,
                                 compute_dtype=torch.float32)
        jl, je = jl[:, 0], je[:, 0]
    else:
        tl, te, tc = decode_chunk(params, tc, torch.tensor(toks), 4, TINY,
                                  compute_dtype=torch.float32)
    _close(tl, jl)
    _close(te, je)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_sample_token_greedy_and_seeded_top_k():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 32)).astype(np.float32))
    assert torch.equal(sample_token(logits, None, 1.0, 10, False), logits.argmax(-1))
    draw = [sample_token(logits, torch.Generator().manual_seed(3), 0.7, 5, True)
            for _ in range(2)]
    assert torch.equal(draw[0], draw[1])  # the generator decides
    top5 = logits.topk(5, dim=-1).indices
    assert all(int(t) in top5[i].tolist() for i, t in enumerate(draw[0]))


def test_prefill_refuses_uncast_params(params):
    with pytest.raises(ValueError, match="cast"):
        prefill(params, torch.tensor([[1, 2]]), TINY, max_seq_len=16,
                compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("quant,impl", [("none", "reference"), ("none", "kernel"),
                                        ("int8", "reference"), ("fp8", "reference"),
                                        ("int8", "kernel")])
def test_paged_decode_step_matches_jax(params, np_params, quant, impl):
    """Same prefilled pools on both sides, one ragged decode step: logits
    and embeds within 2e-5, and the written pool rows equal."""
    prompts = [[5, 9, 2, 7], [11, 3, 8, 1, 6, 2, 9]]
    tok = [7, 9]
    jc = JPagedKVCache(J_TINY.nlayers, 12, 8, J_TINY.n_kv_heads, J_TINY.head_dim,
                       dtype=jnp.float32, quant=quant)
    tcache = PagedKVCache(TINY.nlayers, 12, 8, TINY.n_kv_heads, TINY.head_dim,
                          dtype=torch.float32, quant=quant, device="cpu")
    for i, p in enumerate(prompts):
        _, _, cache = j_prefill(np_params, jnp.asarray([p], jnp.int32), J_TINY,
                                max_seq_len=8, compute_dtype=jnp.float32)
        for c in (jc, tcache):
            c.ensure(i, len(p))
        jc.write_prompt(i, cache["k"][:, 0], cache["v"][:, 0])
        tcache.write_prompt(i, torch.from_numpy(np.array(cache["k"][:, 0])),
                            torch.from_numpy(np.array(cache["v"][:, 0])))
    for i, p in enumerate(prompts):  # room for the decoded token
        jc.ensure(i, len(p) + 1)
        tcache.ensure(i, len(p) + 1)
    table = jc.page_table([0, 1], max_pages=4)
    assert (table == tcache.page_table([0, 1], max_pages=4)).all()
    lens = np.asarray([len(p) for p in prompts], np.int32)
    jl, je, jpools = jax.jit(functools.partial(
        j_paged_decode_step, cfg=J_TINY, page_size=8, compute_dtype=jnp.float32,
        quant=quant, attn_impl=impl, interpret=True,
    ))(np_params, jc.pools, jnp.asarray(table), jnp.asarray(lens),
       jnp.asarray(tok, jnp.int32))
    tl, te, tpools = paged_decode_step(
        params, tcache.pools, torch.from_numpy(table), torch.from_numpy(lens),
        torch.tensor(tok, dtype=torch.int32), TINY, page_size=8,
        compute_dtype=torch.float32, quant=quant, attn_impl=impl,
    )
    _close(tl, jl)
    _close(te, je)
    for name in tpools:
        got = tpools[name].float() if tpools[name].dtype != torch.int8 else tpools[name]
        ref = np.asarray(jpools[name]).astype(np.float32)
        if tpools[name].dtype == torch.int8:
            # one int8 step of disagreement at a rounding tie of the
            # ~1e-7-different fp32 k/v is allowed; scales carry the rest
            assert np.abs(got.numpy().astype(np.float32) - ref).max() <= 1
        else:
            _close(got, ref, ATOL if quant == "none" else 0.07)


def test_write_prompt_gathers_to_the_dense_cache(params):
    """The zero-page discipline: a prefilled sequence's gathered pages
    equal the dense prefill cache bit for bit."""
    prompt = [5, 9, 2, 7, 11, 3]
    _, _, cache = prefill(params, torch.tensor([prompt]), TINY, max_seq_len=32,
                          compute_dtype=torch.float32)
    c = PagedKVCache(TINY.nlayers, 10, 8, TINY.n_kv_heads, TINY.head_dim,
                     dtype=torch.float32, device="cpu")
    c.ensure(1, len(prompt))
    c.write_prompt(1, cache["k"][:, 0, :8], cache["v"][:, 0, :8])
    table = torch.from_numpy(c.page_table([1], max_pages=4))
    for name in ("k", "v"):
        for layer in range(TINY.nlayers):
            g = gather_pages(c.pools[name][layer], table)
            assert torch.equal(g, cache[name][layer])


# ---------------------------------------------------------------------------
# allocator (tests/test_serving.py:98-137)
# ---------------------------------------------------------------------------


def test_allocator_alloc_free_reuse():
    c = PagedKVCache(1, 10, 4, 2, 8, device="cpu")
    assert c.pages_free == 8  # pages 0/1 reserved
    assert c.ensure(7, 9)  # 3 pages
    assert c.pages_of(7) == [2, 3, 4]
    assert c.pages_in_use == 3
    assert c.ensure(8, 4)
    assert c.pages_of(8) == [5]
    assert c.free(7) == 3
    assert c.ensure(9, 2)
    assert c.pages_of(9) == [2]
    assert c.free_count == 3 and c.alloc_count == 5


def test_allocator_all_or_nothing_oom():
    c = PagedKVCache(1, 4, 4, 2, 8, device="cpu")  # 2 allocatable pages
    assert c.ensure(1, 8)
    before = c.pages_of(1)
    assert not c.ensure(2, 5)
    assert c.pages_of(2) == [] and c.pages_of(1) == before
    assert c.failed_allocs == 1
    assert not c.can_ensure(2, 5) and c.can_ensure(1, 8)


def test_page_table_zero_and_scratch_fill():
    c = PagedKVCache(1, 10, 4, 2, 8, device="cpu")
    c.ensure(1, 6)
    t = c.page_table([1, None], max_pages=4)
    assert t.dtype == np.int32
    assert t[0].tolist() == [2, 3, ZERO_PAGE, ZERO_PAGE]
    assert t[1].tolist() == [SCRATCH_PAGE] * 4


def test_fragmentation_tail_waste():
    c = PagedKVCache(1, 10, 4, 2, 8, device="cpu")
    c.ensure(1, 5)
    assert c.fragmentation() == pytest.approx(3 / 8)
    c.free(1)
    assert c.fragmentation() == 0.0


def test_pool_layout_and_quantized_storage():
    c = PagedKVCache(2, 6, 4, 2, 8, dtype=torch.float32, quant="fp8", device="cpu")
    assert c.pools["k"].shape == (2, 6, 4, 2, 8)
    assert c.pools["k"].dtype == torch.float8_e4m3fn
    assert c.pools["k_scale"].shape == (2, 6, 4, 2, 1)
    with pytest.raises(ValueError):
        PagedKVCache(1, 2, 4, 2, 8, device="cpu")
    with pytest.raises(ValueError):
        PagedKVCache(1, 4, 4, 2, 8, quant="int4", device="cpu")


def test_cache_defaults_to_the_card():
    """Like every entry point of the port, the cache runs on cuda unless
    asked for the CPU, and raises without a card."""
    if torch.cuda.is_available():
        assert PagedKVCache(1, 4, 4, 2, 8).pools["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedKVCache(1, 4, 4, 2, 8)


def test_resolve_paged_decode_static():
    """The static page and split, JAX's signature: with tuning off page 64
    halved until it divides the capacity and the planner's split
    (block_kv == page); a requested page pins and must divide it. The
    table's answers are tests/test_torch_tune.py's."""
    from fms_fsdp_tpu_torch.tune import lookup

    geometry = (8, 32, 8, 128)
    lookup.configure_kernel_tuning("off")
    try:
        assert resolve_paged_decode(*geometry, 2048, "bfloat16") == (64, 64, "off")
        assert resolve_paged_decode(*geometry, 96, "bfloat16") == (32, 32, "off")
        lookup.configure_kernel_tuning("auto", chip="cpu")
        assert resolve_paged_decode(*geometry, 64, "bfloat16",
                                    requested_page_size=16) == (16, 16, "pinned")
        with pytest.raises(ValueError):
            resolve_paged_decode(*geometry, 100, "bfloat16", requested_page_size=16)
    finally:
        lookup.configure_kernel_tuning(None)


# ---------------------------------------------------------------------------
# engine: greedy tokens identical to the JAX engine
# ---------------------------------------------------------------------------


def _run_engines(params, np_params, plans, **kw):
    kw = {"max_batch": 2, "max_seq_len": 64, "compute_dtype": "float32",
          "page_size": 16, "max_prefill_per_step": 2, **kw}
    jeng = JServingEngine(np_params, J_TINY, JServeConfig(**{**kw, "attn_impl": "reference"}))
    teng = ServingEngine(params, TINY, ServeConfig(**kw), device="cpu")
    jreqs = [jeng.submit(p, n) for p, n in plans]
    treqs = [teng.submit(p, n) for p, n in plans]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.state == j.state == "finished"
        assert t.generated == j.generated
    return jeng, teng


def test_engine_greedy_tokens_match_jax(params, np_params):
    _, teng = _run_engines(params, np_params, [([5, 9, 2, 7], 5), ([11, 3, 8, 1], 5)])
    assert teng.attn_impl == "reference"  # "auto" on CPU tensors
    assert not teng.cache.pools["k"][:, ZERO_PAGE].any()


def test_engine_eviction_tokens_match_jax(params, np_params):
    """3 allocatable pages of 16: both prompts fit, both streams cannot
    grow a second page; the LIFO victim is evicted and recomputed."""
    jeng, teng = _run_engines(params, np_params,
                              [([5, 9, 2, 7], 20), ([11, 3, 8, 1], 20)],
                              num_pages=3 + 2)
    assert teng.scheduler.evicted >= 1
    assert teng.scheduler.evicted == jeng.scheduler.evicted


def test_engine_int8_pools_tokens_match_jax(params, np_params):
    _, teng = _run_engines(params, np_params,
                           [([5, 9, 2, 7, 6, 1, 12], 5), ([11, 3], 8)],
                           kv_quant="int8", attn_impl="kernel")
    assert teng.serving_stats()["paged_kernel_impl"] == 2.0


def test_engine_stats_and_admission(params):
    eng = ServingEngine(params, TINY, ServeConfig(
        max_batch=2, max_seq_len=64, compute_dtype="float32", page_size=16,
    ), device="cpu")
    with pytest.raises(RequestRejected) as e:
        eng.submit([1] * 60, 10)
    assert e.value.reason == "too_large"
    eng.submit([1, 2, 3], 3)
    eng.run()
    s = eng.serving_stats()
    assert s["requests_completed"] == 1.0 and s["family"] == 0.0
    assert s["paged_kernel_impl"] == 0.0 and eng.decode_steps == 2


def test_engine_from_params_pickle(np_params, tmp_path):
    path = tmp_path / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(np_params, f)
    scfg = ServeConfig(max_batch=1, max_seq_len=32, compute_dtype="float32", page_size=16)
    eng = ServingEngine.from_checkpoint(str(path), TINY, scfg, device="cpu")
    req = eng.submit([5, 9, 2], 3)
    eng.run()
    assert req.state == "finished" and len(req.generated) == 3
    # a directory is read as a checkpoints/ root: it holds no committed step
    with pytest.raises(AssertionError, match="no checkpoint"):
        ServingEngine.from_checkpoint(str(tmp_path), TINY, scfg, device="cpu")


def test_engine_without_cuda_raises_unless_cpu_asked(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, TINY, ServeConfig(compute_dtype="float32"))
    with pytest.raises(RuntimeError):
        ServingEngine(params, TINY, ServeConfig(compute_dtype="float32"), device="cuda")


@pytest.mark.parametrize("field,value", [("role", "prefill"),
                                         ("prefill_chunk_tokens", 16),
                                         ("serve_layout", "tp=2")])
def test_engine_refuses_unported_options(params, field, value):
    """Only the serving layout is still refused (it needs A.6b's tensor
    parallelism); disaggregation roles and chunked prefill are served."""
    scfg = ServeConfig(compute_dtype="float32", **{field: value})
    if field == "serve_layout":
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.6b"):
            ServingEngine(params, TINY, scfg, device="cpu")
        return
    eng = ServingEngine(params, TINY, scfg, device="cpu")
    assert getattr(eng.serve_cfg, field) == value
    req = eng.submit(list(range(1, 40)), 3)
    eng.run()
    assert req.state == "finished"
    stats = eng.serving_stats()
    if field == "role":
        # a prefill engine retires each stream packed after its first token
        assert stats["role"] == 1.0 and req.handoff_out is not None
        assert len(req.generated) == 1
    else:
        assert len(req.generated) == 3
        assert stats["prefill_chunks"] == 3.0


def test_families_llama_only():
    assert family_of(TINY) == "llama"
    assert load_model_config(dict(_TINY_KW)) == TINY
    # the Mamba and Mixtral families resolve too
    mamba = load_model_config({"d_model": 64, "attn_layer_idx": [1]})
    assert family_of(mamba) == "mamba" and mamba.attn_layer_idx == (1,)
    mixtral = load_model_config({"num_experts": 8})
    assert isinstance(mixtral, MixtralConfig) and family_of(mixtral) == "mixtral"


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------


def test_port_imports_no_jax_and_no_jax_package():
    """Every module of the port and scripts/torch_autotune_kernels.py,
    imported in a fresh interpreter (this process already holds jax:
    tests/conftest.py imports it)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fms_fsdp_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    fms_fsdp_tpu_torch.__path__, 'fms_fsdp_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'torch_autotune_kernels', 'scripts/torch_autotune_kernels.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'fms_fsdp_tpu')]\n"
        "need = {'fms_fsdp_tpu_torch.' + m for m in (\n"
        "    'ops.ssd', 'models.mamba', 'serve.families.mamba',\n"
        "    'models.mixtral', 'serve.families.mixtral', 'main_training_mixtral',\n"
        "    'main_training_mamba', 'ckpt', 'ckpt.elastic', 'ckpt.manager',\n"
        "    'ckpt.state', 'utils.checkpointing', 'utils.ckpt_paths',\n"
        "    'resilience.integrity', 'resilience.scrub', 'resilience.retry',\n"
        "    'data.stateful', 'data.handlers', 'data.streaming', 'data.buffering',\n"
        "    'data.synth', 'data.loader', 'data.device_feed', 'obs', 'obs.registry',\n"
        "    'obs.schema', 'obs.timing', 'obs.sinks', 'obs.scopes', 'obs.observer',\n"
        "    'resilience.faults', 'resilience.exits', 'resilience.guards',\n"
        "    'resilience.supervisor', 'utils.train_utils', 'models.speculator',\n"
        "    'models.speculative', 'models.gpt_bigcode', 'train.speculator',\n"
        "    'speculator', 'speculator.train_speculator', 'models.hf_import',\n"
        "    'eval_ppl', 'fms_to_hf_llama', 'fms_to_hf_mamba', 'fms_to_hf_mixtral',\n"
        "    'tune.candidates', 'tune.table', 'tune.lookup', 'ops.ring_attention')}\n"
        "print(len(mods), bad, need - set(mods))\n"
        "sys.exit(1 if bad or len(mods) < 90 or need - set(mods) else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
