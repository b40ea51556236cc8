"""PyTorch port, speculator slice (training): held against the JAX package
on the CPU.

The TINY sizes of tests/test_speculator.py. Inputs come from numpy seeds
and go through both packages; weights are initialised by JAX and moved
into the port with the bridge. Tolerances: the fp32 head chain, its loss
and gradients 1e-5; a bf16 chain 2e-2 of the largest logit; the LR
schedule 1e-7 relative; three AdamW updates 1e-6; stage-1 steps through a
bf16 base 2e-2 relative (both packages run the base in bf16); generation
tokens equal and its embeds 1e-5 in fp32.
"""

import functools
import json
import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models import BaseModelAPI as JBaseModelAPI
from fms_fsdp_tpu.models import generation as jgen
from fms_fsdp_tpu.models import get_base_api as j_get_base_api
from fms_fsdp_tpu.models import mixtral as jm
from fms_fsdp_tpu.models import speculator as js
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init_llama
from fms_fsdp_tpu.models.speculative import speculator_propose as j_propose
from fms_fsdp_tpu.train import speculator as jts
from fms_fsdp_tpu_torch.bridge import (
    params_from_numpy,
    params_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from fms_fsdp_tpu_torch.ckpt.state import flatten
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.models import BaseModelAPI, get_base_api
from fms_fsdp_tpu_torch.models import speculator as ts
from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MixtralConfig
from fms_fsdp_tpu_torch.models.generation import generate
from fms_fsdp_tpu_torch.models.llama import llama_forward
from fms_fsdp_tpu_torch.models.speculative import speculative_decode, speculator_propose
from fms_fsdp_tpu_torch.obs.registry import MetricRegistry
from fms_fsdp_tpu_torch.speculator import train_speculator as entry
from fms_fsdp_tpu_torch.train import speculator as tts

_TINY_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                multiple_of=16, max_expected_seq_len=128)
J_TINY = JLlamaConfig(**_TINY_KW)
TINY = LlamaConfig(**_TINY_KW)
# the entry's overrides: the TINY base through the CLI's dotted keys
ENTRY_MODEL = {f"LlamaConfig.{k}": v for k, v in _TINY_KW.items()}
ENTRY_RUN = dict(vocab_size=128, speculator_width=32, use_dummy_dataset=True,
                 batch_size=2, seq_length=64, num_steps=4, stage2_start_step=2,
                 stage2_batch_size=4, stage2_prompt_length=8, stage2_seq_length=16,
                 report_interval=1, attention_kernel="xla", seed=3)
_MIX_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
               hidden_dim=96, num_experts=4, top_k=2, max_expected_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def np_base():
    return jax.tree.map(np.asarray, j_init_llama(jax.random.PRNGKey(0), J_TINY))


def _scfgs(**kw):
    kw = dict(dict(emb_dim=64, inner_dim=32, vocab_size=128, n_predict=3), **kw)
    return js.SpeculatorConfig(**kw), ts.SpeculatorConfig(**kw)


def _spec_params(jscfg, seed=5):
    jp = js.init_speculator_params(jax.random.PRNGKey(seed), jscfg)
    return jp, jax.tree.map(np.asarray, jp)


def _np(t):
    return t.detach().float().cpu().numpy()


def _train_cfgs(**kw):
    kw = dict(dict(seq_length=32, batch_size=4, num_steps=100, stage2_start_step=50,
                   n_speculator_heads=3, speculator_width=32, learning_rate=5e-3,
                   attention_kernel="xla"), **kw)
    return JTrainConfig(**kw), TrainConfig(**kw)


# ---------------------------------------------------------------------------
# the speculator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("n_predict", [1, 2, 3, 4])
def test_config_and_init_match_jax(tie, n_predict):
    jscfg, scfg = _scfgs(n_predict=n_predict, tie_weights=tie)
    assert scfg.n_params() == jscfg.n_params()
    jp = jax.tree.map(np.asarray, js.init_speculator_params(jax.random.PRNGKey(0), jscfg))
    tp = ts.init_speculator_params(torch.Generator().manual_seed(0), scfg)
    assert sorted(tp) == sorted(jp)
    for name in jp:
        assert [tuple(t.shape) for t in tp[name]] == [a.shape for a in jp[name]], name
        assert all(t.dtype == torch.float32 for t in tp[name])
    assert sum(t.numel() for v in tp.values() for t in v) == scfg.n_params()
    # truncated at 3 std of 0.02, ones and zeros for the LayerNorm
    assert max(float(t.abs().max()) for t in tp["emb"] + tp["head"]) <= 0.06 + 1e-7
    assert all(bool((t == 1).all()) for t in tp["ln_w"])
    assert all(bool((t == 0).all()) for t in tp["ln_b"])


def _forward_case(tie, scale, dtype=np.float32, seed=0):
    jscfg, scfg = _scfgs(tie_weights=tie, scale_input=scale)
    jp, npp = _spec_params(jscfg)
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((2, 10, 64)).astype(np.float32)
    inds = rng.integers(0, 128, size=(2, 12)).astype(np.int32)
    return jscfg, scfg, jp, params_from_numpy(npp), state, inds


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("scale", [True, False])
def test_forward_and_propose_match_jax_fp32(tie, scale):
    jscfg, scfg, jp, tp, state, inds = _forward_case(tie, scale)
    want = np.asarray(js.speculator_forward(jp, jnp.asarray(state), jnp.asarray(inds), jscfg))
    got = ts.speculator_forward(tp, torch.from_numpy(state), torch.from_numpy(inds).long(), scfg)
    assert got.shape == want.shape == (3, 2, 10, 128)
    assert float(np.abs(_np(got) - want).max()) <= 1e-5
    embed, last = state[:, 3], inds[:, 0]
    want_p = np.asarray(j_propose(jp, jnp.asarray(embed), jnp.asarray(last), jscfg))
    got_p = speculator_propose(tp, torch.from_numpy(embed), torch.from_numpy(last), scfg)
    np.testing.assert_array_equal(got_p.numpy(), want_p)


def test_exact_gelu_control_fails(monkeypatch):
    """The control of the fp32 parity: the head chain with the exact erf
    gelu (torch's default) is more than 1e-5 from JAX's."""
    jscfg, scfg, jp, tp, state, inds = _forward_case(True, True)
    want = np.asarray(js.speculator_forward(jp, jnp.asarray(state), jnp.asarray(inds), jscfg))

    class ExactGelu:
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def gelu(x, approximate="none"):
            return F.gelu(x)

    monkeypatch.setattr(ts, "F", ExactGelu())
    got = ts.speculator_forward(tp, torch.from_numpy(state), torch.from_numpy(inds).long(), scfg)
    assert float(np.abs(_np(got) - want).max()) > 1e-5


def test_forward_matches_jax_bf16():
    """A bf16 state: the chain's matmuls and logits in bf16 over fp32
    weights, within 2e-2 of the largest logit."""
    jscfg, scfg, jp, tp, state, inds = _forward_case(True, True)
    want = np.asarray(js.speculator_forward(
        jp, jnp.asarray(state, jnp.bfloat16), jnp.asarray(inds), jscfg), np.float32)
    got = ts.speculator_forward(
        tp, torch.from_numpy(state).bfloat16(), torch.from_numpy(inds).long(), scfg)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(_np(got) - want).max()) <= 2e-2 * float(np.abs(want).max())


def test_save_speculator_files_cross_load(tmp_path):
    """A file JAX writes loads in the port and proposes JAX's drafts; a
    file the port writes loads in JAX and proposes the port's."""
    jscfg, scfg = _scfgs(n_predict=2)
    jp, _ = _spec_params(jscfg, seed=1)
    rng = np.random.default_rng(2)
    embed = rng.standard_normal((3, 64)).astype(np.float32)
    last = rng.integers(0, 128, size=(3,)).astype(np.int32)
    want = np.asarray(j_propose(jp, jnp.asarray(embed), jnp.asarray(last), jscfg))
    jpath = str(tmp_path / "jax.pkl")
    js.save_speculator(jpath, jp, jscfg)
    tp, tcfg = ts.load_speculator(jpath)
    assert tcfg == scfg
    got = speculator_propose(tp, torch.from_numpy(embed), torch.from_numpy(last), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    tpath = str(tmp_path / "port.pkl")
    tp2 = ts.init_speculator_params(torch.Generator().manual_seed(4), scfg)
    ts.save_speculator(tpath, tp2, scfg)
    jp2, jcfg2 = js.load_speculator(tpath)
    assert jcfg2 == jscfg
    want2 = speculator_propose(tp2, torch.from_numpy(embed), torch.from_numpy(last), scfg)
    got2 = np.asarray(j_propose(jp2, jnp.asarray(embed), jnp.asarray(last), jcfg2))
    np.testing.assert_array_equal(got2, want2.numpy())
    bare = str(tmp_path / "bare.pkl")
    with open(bare, "wb") as f:
        pickle.dump({"model_state": {}}, f)
    with pytest.raises(ValueError, match="speculator_config"):
        ts.load_speculator(bare)


# ---------------------------------------------------------------------------
# the trainer's pieces
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_jax():
    jcfg, cfg = _train_cfgs(num_steps=300, stage2_start_step=200, learning_rate=3e-3)
    jsched = jts.get_speculator_lr_schedule(jcfg)
    sched = tts.get_speculator_lr_schedule(cfg)
    want = np.asarray([float(jsched(jnp.asarray(s, jnp.int32))) for s in range(301)])
    got = np.asarray([sched(s) for s in range(301)])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    # the stage-2 restart is below 10% of the peak
    assert got[201] < 0.1 * 3e-3 < got[100]


@pytest.mark.parametrize("scale", [1e-3, 30.0])
def test_apply_matches_jax(scale):
    """Three updates from the same grads: params, moments and count as
    JAX's. Scale 30 engages the clip (the norm is ~30x the threshold)."""
    jcfg, cfg = _train_cfgs(learning_rate=1e-2, stage2_start_step=5)
    jscfg, scfg = _scfgs()
    jp, npp = _spec_params(jscfg)
    jopt = jts.make_speculator_optimizer(jcfg)
    jstate = {"params": jp, "opt_state": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    state = tts.speculator_state(params_from_numpy(npp), cfg)
    jsched = jts.get_speculator_lr_schedule(jcfg)
    sched = tts.get_speculator_lr_schedule(cfg)
    rng = np.random.default_rng(3)
    gnorms = []
    for _ in range(3):
        g_np = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                            npp)
        loss = jnp.asarray(1.0)
        jstate, jmet = jts._apply(jstate, jax.tree.map(jnp.asarray, g_np), jopt, jsched,
                                  loss, jnp.ones((3,)), jcfg.grad_clip_thresh)
        grads = tuple(flatten("g", params_from_numpy(g_np), {}).values())
        state, met = tts._apply(state, grads, sched, torch.tensor(1.0), torch.ones(3),
                                cfg.grad_clip_thresh)
        np.testing.assert_allclose(float(met["gnorm"]), float(jmet["gnorm"]), rtol=1e-6)
        assert met["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-7)
        gnorms.append(float(met["gnorm"]))
    assert (max(gnorms) > cfg.grad_clip_thresh) == (scale > 1)
    flat = train_state_to_numpy(state)
    jflat = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert sorted(flat) == sorted(jflat)
    for key, want in jflat.items():
        np.testing.assert_allclose(flat[key], want, rtol=1e-6, atol=1e-6, err_msg=key)
    assert int(flat["opt_state.count"]) == 3 and int(flat["step"]) == 3
    assert "opt_state.inner_state.0.mu.proj.1" in flat and "params.emb.0" in flat
    # JAX's state crosses the bridge and continues: one more update each
    crossed = train_state_from_numpy(jflat, cfg, state_fn=tts.speculator_state)
    g_np = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                        npp)
    jstate, _ = jts._apply(jstate, jax.tree.map(jnp.asarray, g_np), jopt, jsched,
                           jnp.asarray(1.0), jnp.ones((3,)), jcfg.grad_clip_thresh)
    crossed, _ = tts._apply(crossed, tuple(flatten("g", params_from_numpy(g_np), {}).values()),
                            sched, torch.tensor(1.0), torch.ones(3), cfg.grad_clip_thresh)
    for t, a in zip(crossed["params"]["head"] + crossed["params"]["proj"],
                    jstate["params"]["head"] + jstate["params"]["proj"]):
        np.testing.assert_allclose(_np(t), np.asarray(a), rtol=1e-6, atol=1e-6)
    assert crossed["step"] == 4


def test_stage1_loss_and_grads_match_jax_fp32():
    """The speculator's loss and gradients on the same fp32 embeds."""
    jscfg, scfg = _scfgs()
    jp, npp = _spec_params(jscfg)
    rng = np.random.default_rng(4)
    inputs = rng.integers(0, 128, size=(2, 20)).astype(np.int32)
    embeds = rng.standard_normal((2, 16, 64)).astype(np.float32)

    def jloss(p):
        preds = js.speculator_forward(p, jnp.asarray(embeds), jnp.asarray(inputs)[:, 1:], jscfg)
        n = preds.shape[2]
        return jts._per_head_ce(preds, lambda i: jnp.asarray(inputs)[:, i + 2:n + i + 2])

    (jl, jph), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = params_from_numpy(npp)
    for leaf in (t for v in tp.values() for t in v):
        leaf.requires_grad_(True)
    loss, per_head = tts.stage1_loss(tp, torch.from_numpy(embeds),
                                     torch.from_numpy(inputs).long(), scfg)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(_np(per_head), np.asarray(jph), rtol=1e-5)
    for name in jg:
        for t, g in zip(tp[name], jg[name]):
            np.testing.assert_allclose(_np(t.grad), np.asarray(g), atol=1e-5, err_msg=name)


def _stage1_both(base_api_j, base_api_t, j_base, t_base, model_j, model_t, steps=3, **cfg_kw):
    jcfg, cfg = _train_cfgs(**cfg_kw)
    jscfg, scfg = _scfgs()
    jp, npp = _spec_params(jscfg)
    jopt = jts.make_speculator_optimizer(jcfg)
    jstate = {"params": jp, "opt_state": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jts.make_stage1_step(j_base, model_j, jscfg, jcfg, jopt, base_api=base_api_j)
    state = tts.speculator_state(params_from_numpy(npp), cfg)
    step = tts.make_stage1_step(t_base, model_t, scfg, cfg, base_api=base_api_t)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        inputs = rng.integers(0, 128, size=(4, 32)).astype(np.int32)
        jstate, jm_ = jstep(jstate, jnp.asarray(inputs))
        state, m = step(state, torch.from_numpy(inputs).long())
        out.append((np.asarray(jm_["per_head"]), _np(m["per_head"]),
                    float(jm_["gnorm"]), float(m["gnorm"])))
    return out


def test_stage1_steps_match_jax(np_base):
    """Three steps through the frozen bf16 base (both packages run it in
    bf16): per-head losses within 2e-2 relative."""
    rows = _stage1_both(None, None, jax.tree.map(jnp.asarray, np_base),
                        params_from_numpy(np_base), J_TINY, TINY)
    for want, got, jg, tg in rows:
        np.testing.assert_allclose(got, want, rtol=2e-2)
        assert tg == pytest.approx(jg, rel=2e-2)


def test_stage1_learns(np_base):
    _, cfg = _train_cfgs()
    _, scfg = _scfgs()
    state = tts.speculator_state(
        ts.init_speculator_params(torch.Generator().manual_seed(5), scfg), cfg)
    step = tts.make_stage1_step(params_from_numpy(np_base), TINY, scfg, cfg)
    inputs = torch.from_numpy(np.random.default_rng(7).integers(0, 128, size=(4, 32)))
    losses = []
    for _ in range(12):
        state, m = step(state, inputs)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert tuple(m["per_head"].shape) == (3,)


def test_frozen_base_builds_no_graph(np_base):
    """The base forward of a stage-1 step runs with no grad: no base
    tensor gets a gradient and the hidden states carry no graph."""
    base = params_from_numpy(np_base)
    api = get_base_api("embedllama")
    seen = []
    hidden = api.forward_hidden

    def spy(*a, **k):
        out = hidden(*a, **k)
        seen.append(out)
        return out

    spied = BaseModelAPI("llama", api.init, spy, api.generate)
    _, cfg = _train_cfgs()
    _, scfg = _scfgs()
    state = tts.speculator_state(
        ts.init_speculator_params(torch.Generator().manual_seed(5), scfg), cfg)
    step = tts.make_stage1_step(base, TINY, scfg, cfg, base_api=spied)
    step(state, torch.randint(0, 128, (2, 32), generator=torch.Generator().manual_seed(1)))
    assert seen and seen[0].grad_fn is None and not seen[0].requires_grad
    assert all(not t.requires_grad and t.grad is None
               for t in [base["embedding"], *base["layers"].values()])


class _Stream:
    """A base whose generate returns a fixed stream (both packages)."""

    def __init__(self, targs, embeds):
        self.targs, self.embeds = targs, embeds

    def jax_api(self):
        api = j_get_base_api("embedllama")
        return JBaseModelAPI("llama", api.init, api.forward_embeds,
                             lambda *a, **k: (jnp.asarray(self.targs), jnp.asarray(self.embeds)),
                             api.param_specs)

    def port_api(self):
        api = get_base_api("embedllama")
        return BaseModelAPI("llama", api.init, api.forward_hidden,
                            lambda *a, **k: (torch.from_numpy(self.targs).long(),
                                             torch.from_numpy(self.embeds)))


def test_stage2_loss_on_injected_stream_matches_jax(np_base):
    """Stage 2's loss is a function of the generated stream: fed the same
    stream, both packages' steps give the same per-head losses and
    updates."""
    # stage2_start_step 1: at 0, JAX's schedule divides 0 by 0 at step 0
    jcfg, cfg = _train_cfgs(seq_length=64, batch_size=2, stage2_start_step=1,
                            n_speculator_heads=2, stage2_batch_size=4,
                            stage2_prompt_length=8, stage2_seq_length=16,
                            learning_rate=1e-3)
    jscfg, scfg = _scfgs(n_predict=2)
    jp, npp = _spec_params(jscfg)
    rng = np.random.default_rng(9)
    stream = _Stream(rng.integers(0, 128, size=(4, 24)).astype(np.int32),
                     rng.standard_normal((4, 16, 64)).astype(np.float32))
    jopt = jts.make_speculator_optimizer(jcfg)
    jstate = {"params": jp, "opt_state": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jts.make_stage2_step(jax.tree.map(jnp.asarray, np_base), J_TINY, jscfg, jcfg,
                                 jopt, base_api=stream.jax_api())
    state = tts.speculator_state(params_from_numpy(npp), cfg)
    step = tts.make_stage2_step(params_from_numpy(np_base), TINY, scfg, cfg,
                                base_api=stream.port_api())
    inputs = rng.integers(0, 128, size=(2, 64)).astype(np.int32)
    for _ in range(2):
        jstate, jmet = jstep(jstate, jnp.asarray(inputs), jax.random.PRNGKey(0))
        state, met = step(state, torch.from_numpy(inputs).long(), None)
        np.testing.assert_allclose(_np(met["per_head"]), np.asarray(jmet["per_head"]),
                                   rtol=1e-5)
        assert float(met["gnorm"]) == pytest.approx(float(jmet["gnorm"]), rel=1e-5)
    for name in jp:
        for t, a in zip(state["params"][name], jstate["params"][name]):
            np.testing.assert_allclose(_np(t), np.asarray(a), atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_generate_fp32(monkeypatch):
    """JAX's ``generate`` runs its base in bf16 (``prefill``'s default);
    here its prefill and decode step run in fp32, on a fresh trace."""
    jax.clear_caches()
    monkeypatch.setattr(jgen, "prefill", functools.partial(jgen.prefill,
                                                           compute_dtype=jnp.float32))
    monkeypatch.setattr(jgen, "decode_step", functools.partial(jgen.decode_step,
                                                               compute_dtype=jnp.float32))
    yield jgen.generate
    jax.clear_caches()


def test_greedy_generate_matches_jax_fp32(np_base, jax_generate_fp32):
    prompt = np.random.default_rng(2).integers(0, 128, size=(2, 7)).astype(np.int32)
    want, want_e = jax_generate_fp32(
        jax.tree.map(jnp.asarray, np_base), jnp.asarray(prompt), J_TINY,
        key=jax.random.PRNGKey(0), max_seq_len=40, max_new_tokens=9, do_sample=False,
        include_embeds=True)
    got, got_e = generate(params_from_numpy(np_base), torch.from_numpy(prompt).long(), TINY,
                          max_seq_len=40, max_new_tokens=9, do_sample=False,
                          include_embeds=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(got_e.shape) == (2, 9, 64)
    assert float(np.abs(_np(got_e) - np.asarray(want_e)).max()) <= 1e-5


def test_generate_matches_uncached_forward(np_base):
    """Greedy cached decode equals re-running the full forward, and
    embeds[t] is the hidden state that predicted token t."""
    base = params_from_numpy(np_base)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, 128, size=(1, 8)))
    out, embeds = generate(base, prompt, TINY, max_seq_len=32, max_new_tokens=6,
                           do_sample=False)
    seq = prompt
    for _ in range(6):
        logits = llama_forward(base, seq, TINY, attn_impl="xla", compute_dtype=torch.float32)
        seq = torch.cat([seq, logits[:, -1].argmax(-1)[:, None]], dim=1)
    assert torch.equal(out, seq)
    _, full = llama_forward(base, out[:, :-1], TINY, attn_impl="xla",
                            compute_dtype=torch.float32, return_embeds=True)
    np.testing.assert_allclose(_np(embeds), _np(full[:, 7:]), atol=1e-5)


def test_sampled_generate_top10_and_repeatable(np_base):
    base = params_from_numpy(np_base)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, 128, size=(3, 8)))

    def run(seed):
        return generate(base, prompt, TINY, generator=torch.Generator().manual_seed(seed),
                        max_seq_len=32, max_new_tokens=10, do_sample=True,
                        include_embeds=False)

    out = run(11)
    assert torch.equal(out, run(11))
    assert not torch.equal(out, run(12))
    logits = llama_forward(base, out[:, :-1], TINY, attn_impl="xla",
                           compute_dtype=torch.float32)
    top = logits[:, 7:].topk(10, dim=-1).indices  # (B, 10 positions, 10)
    assert bool((top == out[:, 8:, None]).any(-1).all())


def test_speculative_decode_equals_greedy(np_base):
    _, scfg = _scfgs()
    spec = ts.init_speculator_params(torch.Generator().manual_seed(1), scfg)
    base = params_from_numpy(np_base)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, 128, size=(1, 9)))
    want = generate(base, prompt, TINY, max_seq_len=64, max_new_tokens=20,
                    do_sample=False, include_embeds=False)
    got = speculative_decode(base, spec, prompt, TINY, scfg, max_seq_len=64,
                             max_new_tokens=20)
    assert torch.equal(got["tokens"], want)
    assert 0.0 <= got["accept_rate"] <= 3.0


# ---------------------------------------------------------------------------
# the base registry
# ---------------------------------------------------------------------------


def test_mixtral_base_stage1_matches_jax():
    jcfg_m, cfg_m = JMixtralConfig(**_MIX_KW), MixtralConfig(**_MIX_KW)
    np_mix = jax.tree.map(np.asarray, jm.init_mixtral_params(jax.random.PRNGKey(0), jcfg_m))
    rows = _stage1_both(j_get_base_api("embedmixtral"), get_base_api("embedmixtral"),
                        jax.tree.map(jnp.asarray, np_mix), params_from_numpy(np_mix),
                        jcfg_m, cfg_m, steps=1)
    for want, got, jg, tg in rows:
        np.testing.assert_allclose(got, want, rtol=2e-2)
        assert tg == pytest.approx(jg, rel=2e-2)


def test_base_registry_refusals():
    with pytest.raises(ValueError, match="unknown speculator base arch"):
        get_base_api("embedfalcon")
    assert get_base_api("llama").arch == "llama"
    assert get_base_api("EmbedMixtral").arch == "mixtral"
    assert get_base_api("embedgptbigcode").arch == get_base_api("gpt_bigcode").arch == "gpt_bigcode"


_BIGCODE_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, nlayers=2, max_expected_seq_len=64)


def test_gpt_bigcode_base_stage1_matches_jax():
    """Stage-1 steps through the frozen GPTBigCode base (bf16 in both
    packages): per-head losses and the gradient norm within 2e-2."""
    from fms_fsdp_tpu.models import gpt_bigcode as jgb
    from fms_fsdp_tpu_torch.models import gpt_bigcode as tgb

    jcfg, cfg = jgb.GPTBigCodeConfig(**_BIGCODE_KW), tgb.GPTBigCodeConfig(**_BIGCODE_KW)
    np_base = jax.tree.map(np.asarray, jgb.init_gpt_bigcode_params(jax.random.PRNGKey(0), jcfg))
    rows = _stage1_both(j_get_base_api("embedgptbigcode"), get_base_api("embedgptbigcode"),
                        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), np_base),
                        params_from_numpy(np_base, dtype=torch.bfloat16), jcfg, cfg, steps=2)
    for want, got, jg, tg in rows:
        np.testing.assert_allclose(got, want, rtol=2e-2)
        assert tg == pytest.approx(jg, rel=2e-2)


def test_quantized_base_warns_counts_or_refuses(np_base, caplog):
    """quantized_matmuls on a Mixtral base: one warning, counted, the step
    runs unquantized; on a Llama base the frozen forward runs int8, with
    no warning and nothing counted."""
    _, cfg = _train_cfgs(quantized_matmuls="int8")
    _, scfg = _scfgs()
    mix_np = jax.tree.map(np.asarray, jm.init_mixtral_params(jax.random.PRNGKey(0),
                                                             JMixtralConfig(**_MIX_KW)))
    tts._QUANT_IGNORED_WARNED.clear()
    tts._QUANT_IGNORED_PENDING = 0
    api = get_base_api("embedmixtral")
    with caplog.at_level(logging.WARNING, logger="fms_fsdp_tpu_torch.train.speculator"):
        step = tts.make_stage1_step(params_from_numpy(mix_np), MixtralConfig(**_MIX_KW),
                                    scfg, cfg, base_api=api)
        tts.make_stage1_step(params_from_numpy(mix_np), MixtralConfig(**_MIX_KW),
                             scfg, cfg, base_api=api)
    warns = [r for r in caplog.records if "quantized_matmuls" in r.getMessage()]
    assert len(warns) == 1 and "mixtral" in warns[0].getMessage()
    reg = MetricRegistry()
    tts._drain_quant_ignored(reg)
    assert reg.snapshot()["speculator.quant_ignored"] == 2
    assert tts._QUANT_IGNORED_PENDING == 0
    state = tts.speculator_state(
        ts.init_speculator_params(torch.Generator().manual_seed(5), scfg), cfg)
    _, m = step(state, torch.randint(0, 128, (2, 32), generator=torch.Generator()))
    assert np.isfinite(float(m["loss"]))
    assert tts._frozen_quant(cfg, "llama") == "int8"
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="fms_fsdp_tpu_torch.train.speculator"):
        llama_step = tts.make_stage1_step(params_from_numpy(np_base), TINY, scfg, cfg)
    assert not caplog.records and tts._QUANT_IGNORED_PENDING == 0
    _, m = llama_step(state, torch.randint(0, 128, (2, 32), generator=torch.Generator()))
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def _report_keys(text):
    """The report lines' labels, in order, of the first report."""
    lines = text.splitlines()
    i = next(k for k, line in enumerate(lines) if line.startswith("step:"))
    out = []
    for line in lines[i:]:
        if not line.strip():
            break
        out.append(line.split(":")[0])
    return out


def test_entry_trains_across_stage2_with_jax_report_lines(tmp_path, capsys, monkeypatch):
    """The port's entry on the CPU runs stage 1 then stage 2, finite, with
    the report lines of JAX's entry (run here too on one step)."""
    res = entry.main(device="cpu", **ENTRY_MODEL, **ENTRY_RUN,
                     ckpt_save_path=str(tmp_path / "ck"), ckpt_load_path=str(tmp_path / "ck"),
                     obs_dir=str(tmp_path / "obs"))
    out = capsys.readouterr().out
    # the observer's records: per-head losses in extra, no MFU (the frozen
    # base's FLOPs are not the trained model's)
    with open(tmp_path / "obs" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    assert all(r["mfu"] is None and r["hfu"] is None for r in records)
    assert [r["extra"]["loss_head_1"] for r in records] == [
        pytest.approx(r["per_head"][0]) for r in res["reports"]]
    assert res["steps"] == 4 and res["start_step"] == 0
    assert [r["step"] for r in res["reports"]] == [1, 2, 3, 4]
    assert all(np.isfinite(r["per_head"]).all() for r in res["reports"])
    # stage 2 prices a step at its generated tokens
    assert [r["tokens_seen"] for r in res["reports"]] == [136, 272, 336, 400]
    assert "smoke-test mode" in out and "sanity generation:" in out
    keys = _report_keys(out)
    import speculator.train_speculator as jentry

    monkeypatch.setattr(jentry, "setup", lambda: None)
    jentry.main(**ENTRY_MODEL, **dict(ENTRY_RUN, num_steps=1, batch_size=1),
                ckpt_save_path=str(tmp_path / "jck"), ckpt_load_path=str(tmp_path / "jck"))
    jout = capsys.readouterr().out
    assert keys == _report_keys(jout) == [
        "step", "tokens seen", "loss 1", "loss 2", "loss 3", "gradient norm",
        "speed for these 1 steps", "overall speed", "LR",
        "overall token per chip per sec", "token per day"]
    assert os.path.isdir(tmp_path / "ck" / "checkpoints" / "step_4_ckp")


def test_entry_resumes_bitwise(tmp_path):
    """A save at step 4 resumes at start_step 4 with the saved state
    bitwise (a rerun to the same num_steps trains nothing)."""
    kw = dict(**ENTRY_MODEL, **ENTRY_RUN, ckpt_save_path=str(tmp_path),
              ckpt_load_path=str(tmp_path))
    first = entry.main(device="cpu", **kw)
    again = entry.main(device="cpu", **kw)
    assert again["start_step"] == 4 and again["steps"] == 0
    a, b = train_state_to_numpy(first["state"]), train_state_to_numpy(again["state"])
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    more = entry.main(device="cpu", **dict(kw, num_steps=6))
    assert more["start_step"] == 4 and [r["step"] for r in more["reports"]] == [5, 6]


def test_entry_streams_arrow_shards_and_resumes_bitwise(tmp_path):
    """On streaming data (raw packed sequences, no causal shift) with the
    loader's state in the checkpoint: 3 steps, a save, a resume to 6 equal
    bitwise to 6 straight steps (stage 1: stage 2's sampling restarts its
    generator from the seed on a resume, as JAX's key does)."""
    from fms_fsdp_tpu_torch.data.synth import build_arrow_corpus

    corpus = build_arrow_corpus(tmp_path / "corpus", vocab=128)
    kw = dict(ENTRY_MODEL, **dict(
        ENTRY_RUN, use_dummy_dataset=False, datasets="dataset_1", weights="1",
        file_type="arrow", data_path=corpus, logical_shards=8, loader_shuffle_window=16,
        num_workers=1, feed_prefetch=0, seq_length=28, stage2_start_step=100))

    def run(ck, steps):
        return entry.main(device="cpu", **dict(kw, num_steps=steps, ckpt_save_path=ck,
                                               ckpt_load_path=ck))

    straight = run(str(tmp_path / "a"), 6)
    first = run(str(tmp_path / "b"), 3)
    assert first["loader"] is not None and first["start_step"] == 0
    resumed = run(str(tmp_path / "b"), 6)
    assert resumed["start_step"] == 3 and [r["step"] for r in resumed["reports"]] == [4, 5, 6]
    a, b = train_state_to_numpy(straight["state"]), train_state_to_numpy(resumed["state"])
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert [r["per_head"] for r in resumed["reports"]] == [
        r["per_head"] for r in straight["reports"][3:]]


def test_do_ckpt_flag(tmp_path):
    """The on-demand checkpoint flag: '1' in <save>/do_ckpt asks for a
    save; the reset writes '0'."""
    assert tts.do_ckpt(str(tmp_path)) is False
    (tmp_path / "do_ckpt").write_text("1\n")
    assert tts.do_ckpt(str(tmp_path)) is True
    assert tts.do_ckpt(str(tmp_path), reset=True) is False
    assert (tmp_path / "do_ckpt").read_text() == "0"
    assert tts.do_ckpt(str(tmp_path)) is jts.do_ckpt(str(tmp_path)) is False


def test_entry_refusals(tmp_path, monkeypatch):
    kw = dict(**ENTRY_MODEL, **ENTRY_RUN, ckpt_save_path=str(tmp_path / "ck"),
              ckpt_load_path=str(tmp_path / "ck"))
    import transformers

    hf = str(tmp_path / "hf")
    transformers.GPT2Config(n_embd=32, n_layer=1, n_head=2).save_pretrained(hf)
    with pytest.raises(ValueError, match="unsupported HF base architecture 'gpt2'"):
        entry.main(device="cpu", **dict(kw, model_path=hf))
    with pytest.raises(NotImplementedError, match="A.6b"):
        entry.main(device="cpu", **dict(kw, sharding_strategy="tp"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.main(**kw)


def test_entry_base_from_port_checkpoint(tmp_path):
    """A base from a checkpoint the port's Llama trainer wrote: its params
    in bf16; and that trainer's checkpoint dir is never resumed as a
    speculator state."""
    from fms_fsdp_tpu_torch import main_training_llama

    ck = str(tmp_path / "pre")
    pre = main_training_llama.main(
        device="cpu", **ENTRY_MODEL, vocab_size=128, use_dummy_dataset=True, batch_size=2,
        seq_length=32, num_steps=2, report_interval=1, attention_kernel="xla",
        mixed_precision=False, ckpt_save_path=ck, ckpt_load_path=ck)
    spec = str(tmp_path / "spec")
    res = entry.main(device="cpu", **dict(ENTRY_MODEL, **dict(ENTRY_RUN, num_steps=1)),
                     model_path=os.path.join(ck, "checkpoints"), ckpt_save_path=spec,
                     ckpt_load_path=spec)
    want = params_to_numpy(pre["state"]["params"])
    got = params_to_numpy(res["base_params"])
    assert res["base_params"]["embedding"].dtype == torch.bfloat16
    for key in ("embedding", "lm_head"):
        np.testing.assert_array_equal(
            got[key], torch.from_numpy(want[key]).bfloat16().float().numpy())
    with pytest.raises(RuntimeError, match="speculator:llama"):
        entry.main(device="cpu", **dict(ENTRY_MODEL, **ENTRY_RUN), ckpt_save_path=ck,
                   ckpt_load_path=ck)


def test_speculator_gpt_bigcode_base_stage2(tmp_path, capsys):
    """tests/test_hf_import.py's GPTBigCode run on the port's entry: a
    random GPTBigCode base (smoke mode) from the bare overrides, stage 1
    then stage 2 through generate_simple, finite losses."""
    res = entry.main(
        device="cpu", model_arch="embedgptbigcode", model_path="/nonexistent",
        use_dummy_dataset=True, ckpt_save_path=str(tmp_path / "ckpt"),
        ckpt_load_path=str(tmp_path / "ckpt"), batch_size=2, seq_length=32, vocab_size=64,
        num_steps=3, report_interval=1, checkpoint_interval=10000, stage2_start_step=1,
        stage2_batch_size=4, stage2_prompt_length=8, stage2_seq_length=16,
        n_speculator_heads=2, speculator_width=32, attention_kernel="xla",
        src_vocab_size=64, emb_dim=32, nheads=2, nlayers=2, max_expected_seq_len=64)
    out = capsys.readouterr().out
    assert "smoke-test mode" in out and "sanity generation:" in out
    cfg = res["model_cfg"]
    assert (type(cfg).__name__, cfg.src_vocab_size, cfg.emb_dim, cfg.nheads, cfg.nlayers) == (
        "GPTBigCodeConfig", 64, 32, 2, 2)
    assert res["base_params"]["wte"].dtype == torch.bfloat16
    assert [r["step"] for r in res["reports"]] == [1, 2, 3]
    # stage 2 prices a step at its generated tokens: 2 rows x 2 x 16
    assert [r["tokens_seen"] for r in res["reports"]] == [70, 134, 198]
    assert all(np.isfinite(r["per_head"]).all() for r in res["reports"])


def test_speculator_trains_against_hf_llama(tmp_path, capsys):
    """An HF Llama directory at model_path: its architecture overrides
    model_arch (the message printed), its config and weights (bf16,
    bitwise JAX's load_hf_base) are the base, the entry trains; and
    stage-1 steps on that base match JAX's within 2e-2."""
    from fms_fsdp_tpu.models.hf_import import load_hf_base as j_load_hf_base
    from fms_fsdp_tpu_torch.fms_to_hf_llama import convert_to_hf
    from fms_fsdp_tpu_torch.models.hf_import import load_hf_base

    tiny = dict(_TINY_KW, max_expected_seq_len=64)
    np_params = jax.tree.map(np.asarray, j_init_llama(jax.random.PRNGKey(0),
                                                      JLlamaConfig(**tiny)))
    path = str(tmp_path / "hf_llama")
    convert_to_hf(params_from_numpy(np_params), LlamaConfig(**tiny)).save_pretrained(
        path, safe_serialization=True)
    res = entry.main(device="cpu", model_arch="embedgptbigcode", model_path=path,
                     use_dummy_dataset=True, ckpt_save_path=str(tmp_path / "ckpt"),
                     ckpt_load_path=str(tmp_path / "ckpt"), batch_size=2, seq_length=32,
                     vocab_size=128, num_steps=3, report_interval=1,
                     checkpoint_interval=10000, stage2_start_step=100,
                     n_speculator_heads=2, speculator_width=64, attention_kernel="xla")
    out = capsys.readouterr().out
    assert "model_arch=embedgptbigcode overridden by HF checkpoint arch llama" in out
    assert "smoke-test mode" not in out
    cfg = res["model_cfg"]
    assert (cfg.emb_dim, cfg.nheads, cfg.n_kv_heads, cfg.hidden_dim, cfg.nlayers) == (
        64, 4, 2, LlamaConfig(**tiny).hidden_dim, 2)
    assert res["checkpointer"].fingerprint["model"] == "speculator:llama"
    _, jcfg, j_base = j_load_hf_base(path)
    want = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), j_base)
    got = params_to_numpy(res["base_params"])
    assert res["base_params"]["embedding"].dtype == torch.bfloat16
    for key in ("embedding", "norm", "lm_head"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in want["layers"]:
        np.testing.assert_array_equal(got["layers"][key], want["layers"][key], err_msg=key)
    assert [r["step"] for r in res["reports"]] == [1, 2, 3]
    assert all(np.isfinite(r["per_head"]).all() for r in res["reports"])

    _, cfg_t, t_base = load_hf_base(path)
    for want_ph, got_ph, jg, tg in _stage1_both(None, None, j_base, t_base, jcfg, cfg_t,
                                                steps=2):
        np.testing.assert_allclose(got_ph, want_ph, rtol=2e-2)
        assert tg == pytest.approx(jg, rel=2e-2)
