"""PyTorch port, speculative serving: held against the JAX package on the
CPU.

The TINY config of tests/test_speculative.py, JAX-initialised base and
speculator weights (the speculator through a ``save_speculator`` file JAX
writes, which both engines load). fp32, the reference attention:
``paged_verify_step``'s logits at position j equal the port's sequential
``paged_decode_step`` and JAX's verify step within 1e-5 for plain, int8
and fp8 pools; the speculative engine's greedy tokens equal the plain
engine's and JAX's speculative engine's, with the same accept rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init
from fms_fsdp_tpu.models.speculator import SpeculatorConfig as JSpeculatorConfig
from fms_fsdp_tpu.models.speculator import init_speculator_params as j_init_spec
from fms_fsdp_tpu.models.speculator import save_speculator as j_save_speculator
from fms_fsdp_tpu.serve import PagedKVCache as JPagedKVCache
from fms_fsdp_tpu.serve import ServeConfig as JServeConfig
from fms_fsdp_tpu.serve import ServingEngine as JServingEngine
from fms_fsdp_tpu.serve.decode import paged_verify_step as j_paged_verify_step
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.models.generation import prefill
from fms_fsdp_tpu_torch.models.speculator import SpeculatorConfig, save_speculator
from fms_fsdp_tpu_torch.serve import PagedKVCache, ServeConfig, ServingEngine
from fms_fsdp_tpu_torch.serve.decode import paged_decode_step, paged_verify_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_TINY_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                max_expected_seq_len=256)
J_TINY = JLlamaConfig(**_TINY_KW)
TINY = LlamaConfig(**_TINY_KW)
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), J_TINY))


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    """A random speculator (acceptance near 0: every step takes the
    reject path, and the bonus token is committed every verify)."""
    scfg = JSpeculatorConfig(emb_dim=64, inner_dim=32, vocab_size=128, n_predict=3)
    path = str(tmp_path_factory.mktemp("spec") / "speculator.pkl")
    j_save_speculator(path, j_init_spec(jax.random.PRNGKey(7), scfg), scfg)
    return path


def _prompts(sizes=(37, 5, 60, 9, 23), seed=0):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, 128, size=n))) for n in sizes]


def _kw(max_batch=4, max_seq=128, **kw):
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("attn_impl", "reference")
    kw.setdefault("page_size", 16)
    kw.setdefault("max_prefill_per_step", max_batch)
    return dict(max_batch=max_batch, max_seq_len=max_seq, **kw)


def _serve(np_params, prompts, max_new=12, propose=None, **kw):
    eng = ServingEngine(params_from_numpy(np_params), TINY, ServeConfig(**_kw(**kw)),
                        device="cpu")
    if propose is not None:
        eng.adapter.propose = propose(eng)
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    assert all(r.state == "finished" for r in reqs)
    return eng, [r.generated for r in reqs]


def _j_serve(np_params, prompts, max_new=12, **kw):
    eng = JServingEngine(jax.tree.map(jnp.asarray, np_params), J_TINY,
                         JServeConfig(**_kw(**kw)))
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    assert all(r.state == "finished" for r in reqs)
    return eng, [r.generated for r in reqs]


@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
def test_verify_step_matches_sequential_decode_and_jax(np_params, quant):
    """Logits at position j of one verify forward = the port's sequential
    paged decode steps (reference branch) and JAX's verify step."""
    prompt = [5, 9, 2, 7, 11, 3]
    cand = np.asarray([[4, 8, 15, 16]], np.int32)
    params = params_from_numpy(np_params)
    _, _, kv = prefill(params, torch.tensor([prompt]), TINY, max_seq_len=32,
                       compute_dtype=torch.float32)

    def pools():
        c = PagedKVCache(TINY.nlayers, 12, 8, TINY.n_kv_heads, TINY.head_dim,
                         dtype=torch.float32, quant=quant, device="cpu")
        c.ensure(1, len(prompt) + cand.shape[1])
        c.write_prompt(1, kv["k"][:, 0, :8], kv["v"][:, 0, :8])
        return c, torch.from_numpy(c.page_table([1], 4))

    c, table = pools()
    lens = torch.tensor([len(prompt)], dtype=torch.int32)
    ver, emb, _ = paged_verify_step(params, c.pools, table, lens, torch.from_numpy(cand),
                                    TINY, page_size=8, compute_dtype=torch.float32,
                                    quant=quant)
    assert tuple(ver.shape) == (1, 4, 128) and tuple(emb.shape) == (1, 4, 64)
    c2, table2 = pools()
    for j in range(cand.shape[1]):
        lg, _, _ = paged_decode_step(params, c2.pools, table2, lens + j,
                                     torch.from_numpy(cand[:, j]), TINY, page_size=8,
                                     compute_dtype=torch.float32, quant=quant,
                                     attn_impl="reference")
        assert float((ver[:, j] - lg).abs().max()) <= ATOL, (quant, j)
    jc = JPagedKVCache(TINY.nlayers, 12, 8, TINY.n_kv_heads, TINY.head_dim,
                       dtype=jnp.float32, quant=quant)
    jc.ensure(1, len(prompt) + cand.shape[1])
    jkv = {k: jnp.asarray(v.numpy()) for k, v in kv.items()}
    jc.write_prompt(1, jkv["k"][:, 0, :8], jkv["v"][:, 0, :8])
    jver, jemb, jpools = j_paged_verify_step(
        jax.tree.map(jnp.asarray, np_params), jc.pools, jnp.asarray(jc.page_table([1], 4)),
        jnp.asarray([len(prompt)], jnp.int32), jnp.asarray(cand), J_TINY, page_size=8,
        compute_dtype=jnp.float32, quant=quant)
    assert float(np.abs(ver.numpy() - np.asarray(jver)).max()) <= ATOL
    assert float(np.abs(emb.numpy() - np.asarray(jemb)).max()) <= ATOL
    # the pools hold the same bytes after the write
    for name, pool in c.pools.items():
        want = np.asarray(jpools[name].astype(jnp.float32))
        np.testing.assert_allclose(pool.float().numpy(), want, atol=ATOL, err_msg=name)


# (name, prompt sizes, max_new, engine knobs): JAX tests/test_speculative.py
ENGINE_CASES = {
    "plain": ((37, 5, 60, 9, 23), 12, {}),
    "draft_cap": ((12, 30, 7), 12, dict(eos_token=3, spec_draft_tokens=1)),
    "eos": ((12, 30, 7), 12, dict(eos_token=3)),
    "eviction": ((40, 44, 48), 12, dict(max_batch=3, num_pages=12)),
    "int8": ((20, 9, 33), 12, dict(kv_quant="int8")),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_speculative_engine_tokens(np_params, spec_path, case):
    """Greedy speculative tokens = plain greedy tokens = JAX's speculative
    engine's, with JAX's serving_stats spec fields."""
    sizes, max_new, kw = ENGINE_CASES[case]
    prompts = _prompts(sizes)
    plain_kw = {k: v for k, v in kw.items() if k != "spec_draft_tokens"}
    _, ref = _serve(np_params, prompts, max_new, **plain_kw)
    eng, spec = _serve(np_params, prompts, max_new, speculator_path=spec_path, **kw)
    jeng, jspec = _j_serve(np_params, prompts, max_new, speculator_path=spec_path, **kw)
    assert spec == ref == jspec
    st, jst = eng.serving_stats(), jeng.serving_stats()
    assert st["spec_draft_tokens"] == jst["spec_draft_tokens"] == kw.get(
        "spec_draft_tokens", 3)
    assert st["spec_accept_rate"] == pytest.approx(jst["spec_accept_rate"], abs=1e-12)
    if case == "eviction":
        assert st["requests_evicted"] > 0


def test_oracle_drafter_accepts_every_draft(np_params, spec_path):
    """The control of the full-accept commit: a drafter that proposes the
    plain run's own continuation is accepted every time (accept rate 1.0)
    and gives the same tokens, with fewer verify steps than tokens."""
    prompts = _prompts((20, 9, 33))
    n = 3
    _, ref = _serve(np_params, prompts, 12)
    # the plain streams n tokens further: the drafts of the last steps
    _, longer = _serve(np_params, prompts, 12 + n)
    assert [r[:12] for r in longer] == ref
    by_prompt = {tuple(p): r for p, r in zip(prompts, longer)}

    def oracle(eng):
        def propose(embed, tokens):
            out = torch.zeros((len(eng._slots), n), dtype=torch.long)
            for slot, req in enumerate(eng._slots):
                if req is not None:
                    done = len(req.generated)
                    out[slot] = torch.tensor(by_prompt[tuple(req.prompt)][done:done + n])
            return out

        return propose

    eng, spec = _serve(np_params, prompts, 12, propose=oracle, speculator_path=spec_path)
    assert spec == ref
    assert eng.serving_stats()["spec_accept_rate"] == 1.0
    assert eng.decode_steps < sum(len(r) - 1 for r in ref)


def test_speculative_refusals(np_params, spec_path, tmp_path):
    params = params_from_numpy(np_params)
    with pytest.raises(ValueError, match="greedy-only"):
        ServingEngine(params, TINY, ServeConfig(**_kw(speculator_path=spec_path,
                                                      do_sample=True)), device="cpu")
    with pytest.raises(ValueError, match="spec_draft_tokens"):
        ServingEngine(params, TINY, ServeConfig(**_kw(speculator_path=spec_path,
                                                      spec_draft_tokens=9)), device="cpu")
    wrong = str(tmp_path / "wide.pkl")
    scfg = SpeculatorConfig(emb_dim=32, inner_dim=16, vocab_size=128, n_predict=2)
    from fms_fsdp_tpu_torch.models.speculator import init_speculator_params

    save_speculator(wrong, init_speculator_params(torch.Generator().manual_seed(0), scfg), scfg)
    with pytest.raises(ValueError, match="geometry"):
        ServingEngine(params, TINY, ServeConfig(**_kw(speculator_path=wrong)), device="cpu")
    # the draft headroom tightens the request budget by draft - 1
    eng = ServingEngine(params, TINY, ServeConfig(**_kw(speculator_path=spec_path)),
                        device="cpu")
    with pytest.raises(ValueError, match="draft headroom"):
        eng.submit([1] * 100, 27)
