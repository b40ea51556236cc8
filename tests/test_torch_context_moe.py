"""PyTorch port, long context for Mixtral in one process: the capacity
routing of a context-split sequence, the Mixtral forward and backward
over a ``LocalRing``, eval over a ``LocalRing`` and the speculator's
context setting, held against JAX and against the whole sequence.

Every chunk lives in this process (``ops/ring_attention.py::LocalRing``),
which runs the code path of a ``GroupRing`` with a list for the
transport; the gloo worlds are tests/test_torch_context_worlds.py's.
Inputs come from numpy seeds; tolerances are the fp32 ones of
tests/test_torch_mixtral.py (logits 1e-5, balance 1e-6 relative,
``drop_frac`` equal) and 1e-5 relative for gradients and NLL sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.models import mixtral as jm
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init_llama
from fms_fsdp_tpu.models.mamba import init_mamba_params as j_init_mamba
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.eval_ppl import make_eval_step
from fms_fsdp_tpu_torch.models import mixtral as tm
from fms_fsdp_tpu_torch.models.configs import (
    LlamaConfig,
    MambaAttnConfig,
    MambaConfig,
    MixtralConfig,
)
from fms_fsdp_tpu_torch.ops.ring_attention import LocalRing
from fms_fsdp_tpu_torch.train.speculator import check_speculator_options, report_chips
from fms_fsdp_tpu_torch.train.step import check_supported
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TINY = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
            hidden_dim=96, num_experts=4, top_k=2, max_expected_seq_len=64)
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jm.init_mixtral_params(jax.random.PRNGKey(0),
                                                           JMixtralConfig(**TINY)))


def _top_idx(seed, b=2, s=64, e=8, k=2, skew=1.5):
    """Top-k choices of a seeded router whose logits favour the low
    experts (so that some expert overflows its buffer)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, s, e)) - skew * np.arange(e) / e
    return tm.top_k_lower_first(torch.from_numpy(logits), k)


def _chunk_local(top_idx, cp, E, C):
    """The control: each chunk's own priority slots at the capacity of its
    own length."""
    return [tm._priority_slots(t, E, -(-C // cp)) for t in top_idx.chunk(cp, 1)]


# ---------------------------------------------------------------------------
# the routing of a context-split sequence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("capacity_factor", [0.5, 2.0])
def test_context_slots_equal_the_whole_sequence(cp, capacity_factor):
    """The chunks' slots and keeps, from their gathered per-round counts,
    are the whole sequence's ``_priority_slots`` bit for bit at the whole
    length's capacity; the chunk-local routing's are not."""
    cfg = MixtralConfig(**dict(TINY, num_experts=8, capacity_factor=capacity_factor))
    top_idx = _top_idx(cp)
    E, S = cfg.num_experts, top_idx.shape[1]
    C = tm.moe_capacity(cfg, S)
    want_slot, want_keep = tm._priority_slots(top_idx, E, C)
    ring = LocalRing(cp)
    got = tm.context_slots(ring.split(top_idx), ring, E, C)
    assert torch.equal(torch.cat([s for s, _ in got], 1), want_slot)
    assert torch.equal(torch.cat([k for _, k in got], 1), want_keep)
    assert (not bool(want_keep.all())) == (capacity_factor < 1)
    local = _chunk_local(top_idx, cp, E, C)
    assert -(-C // cp) == tm.moe_capacity(cfg, S // cp)
    assert not torch.equal(torch.cat([s for s, _ in local], 1), want_slot)
    if capacity_factor < 1:
        assert not torch.equal(torch.cat([k for _, k in local], 1), want_keep)


def test_context_slots_fill_each_expert_to_its_capacity():
    """Kept slots are distinct per (row, expert) and below the capacity,
    and each expert keeps min(its choices, C): the chunks' buffers never
    collide."""
    cfg = MixtralConfig(**dict(TINY, num_experts=8, capacity_factor=0.5))
    top_idx = _top_idx(7)
    E, C = cfg.num_experts, tm.moe_capacity(cfg, top_idx.shape[1])
    ring = LocalRing(4)
    got = tm.context_slots(ring.split(top_idx), ring, E, C)
    slot = torch.cat([s for s, _ in got], 1)
    keep = torch.cat([k for _, k in got], 1)
    for b in range(top_idx.shape[0]):
        for e in range(E):
            mine = (top_idx[b] == e)
            kept = slot[b][mine & keep[b]]
            assert sorted(kept.tolist()) == list(range(min(int(mine.sum()), C)))


# ---------------------------------------------------------------------------
# the Mixtral forward and backward over a LocalRing
# ---------------------------------------------------------------------------


def _inputs(seed=1, rows=2):
    toks = np.random.default_rng(seed).integers(0, 128, size=(rows, SEQ + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int64)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
@pytest.mark.parametrize("impl", ["dense", "dispatch", "dispatch_einsum"])
def test_ring_forward_matches_jax_whole_sequence(np_params, impl, capacity_factor):
    """``mixtral_forward(ring=LocalRing(cp))``: the ring's attention, the
    rotary table at each chunk's offset and the whole sequence's routing
    give JAX's whole-sequence logits (1e-5), its balance term and its
    dropped share, for cp 2 and 4."""
    jcfg = JMixtralConfig(**TINY, capacity_factor=capacity_factor)
    cfg = MixtralConfig(**TINY, capacity_factor=capacity_factor)
    inputs, _ = _inputs()
    ref, j_aux = jm.mixtral_forward(np_params, jnp.asarray(inputs), jcfg,
                                    compute_dtype=jnp.float32,
                                    moe_impl="dispatch" if impl != "dense" else "dense",
                                    return_aux=True)
    params = params_from_numpy(np_params)
    for cp in (2, 4):
        out, aux = tm.mixtral_forward(params, torch.from_numpy(inputs).long(), cfg,
                                      compute_dtype=torch.float32, attn_impl="xla",
                                      moe_impl=impl, return_aux=True, ring=LocalRing(cp))
        assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-5, cp
        assert float(aux["balance"]) == pytest.approx(float(j_aux["balance"]), rel=1e-6)
        assert float(aux["drop_frac"]) == float(j_aux["drop_frac"]), cp
        assert (float(aux["drop_frac"]) > 0) == (impl != "dense" and capacity_factor < 1)
        assert float(aux["route"]["tokens"]) == inputs.size


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_ring_backward_matches_the_whole_sequence(np_params, capacity_factor):
    """The gradient of every weight through the ring (the flash partials'
    plain versions, the per-chunk expert buffers, the chunks' router
    probabilities in the balance term) within 1e-5 of the whole
    sequence's, which tests/test_torch_mixtral.py holds against JAX."""
    cfg = MixtralConfig(**TINY, capacity_factor=capacity_factor)
    inputs, _ = _inputs(seed=2)
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, SEQ, cfg.src_vocab_size)).astype(np.float32))

    def grads(ring):
        params = params_from_numpy(np_params)
        leaves = [params["embedding"], params["lm_head"], *params["layers"].values()]
        for w in leaves:
            w.requires_grad_(True)
        out, aux = tm.mixtral_forward(params, torch.from_numpy(inputs).long(), cfg,
                                      compute_dtype=torch.float32, moe_impl="dispatch",
                                      return_aux=True, ring=ring)
        return torch.autograd.grad((out * cot).sum() + 10 * aux["balance"], leaves)

    for got, want in zip(grads(LocalRing(2)), grads(None)):
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-5 * max(1.0, scale)


# ---------------------------------------------------------------------------
# eval and the speculator
# ---------------------------------------------------------------------------


_MAMBA_ATTN = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_LLAMA = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
              multiple_of=16, max_expected_seq_len=64)
_MAMBA = dict(d_model=64, d_intermediate=128, n_layer=3, vocab_size=128,
              attn_layer_idx=(1,), d_state=16, headdim=16, chunk_size=8)


def _family(name):
    if name == "llama":
        return j_init_llama(jax.random.PRNGKey(0), JLlamaConfig(**_LLAMA)), LlamaConfig(**_LLAMA)
    if name == "mamba":
        jcfg = JMambaConfig(**_MAMBA, attn_cfg=JMambaAttnConfig(**_MAMBA_ATTN))
        return (j_init_mamba(jax.random.PRNGKey(0), jcfg),
                MambaConfig(**_MAMBA, attn_cfg=MambaAttnConfig(**_MAMBA_ATTN)))
    return (jm.init_mixtral_params(jax.random.PRNGKey(0), JMixtralConfig(**TINY)),
            MixtralConfig(**TINY))


@pytest.mark.parametrize("family", ["llama", "mamba", "mixtral"])
def test_eval_step_over_a_local_ring(family):
    """``make_eval_step(ring=)``: the chunks' NLL sums and counts add up
    to the whole sequence's (1e-5), through ring attention, the conv halo
    and ``ssd_scan_cp`` (Mamba) and the dense mix (Mixtral)."""
    j_params, cfg = _family(family)
    params = params_from_numpy(jax.tree.map(np.asarray, j_params))
    inputs, labels = _inputs(seed=4)
    labels[np.random.default_rng(5).random(labels.shape) < 0.25] = -100
    run = TrainConfig(mixed_precision=False, attention_kernel="xla")
    batch = (torch.from_numpy(inputs).long(), torch.from_numpy(labels))
    want_nll, want_n = make_eval_step(cfg, run)(params, batch)
    cp = 2
    ring = LocalRing(cp)
    nll, n = make_eval_step(cfg, run, ring)(params, batch)
    assert int(n) == int(want_n) == int((labels != -100).sum())
    assert float(nll) == pytest.approx(float(want_nll), rel=1e-5)


@pytest.mark.parametrize("world,tp,cp", [(1, 1, 1), (2, 1, 2), (4, 1, 2), (8, 1, 4),
                                         (8, 1, 1), (1, 1, 4)])
def test_speculator_report_chips_are_jax_arithmetic(world, tp, cp):
    """The report's per-chip world: the processes over the tensor and the
    context settings, at least 1 (``fms_fsdp_tpu/train/speculator.py:
    297-302``); the context setting is accepted, not refused."""
    cfg = TrainConfig(context_parallel_size=cp, tensor_parallel_size=tp)
    check_speculator_options(cfg)
    assert report_chips(cfg, world) == max(1, world // max(1, tp) // max(1, cp))


def test_mixtral_takes_a_context_axis():
    """``check_supported`` accepts Mixtral at ``context_parallel_size=2``."""
    check_supported(TrainConfig(model_variant="mixtral_8x7b", context_parallel_size=2))


def test_route_sums_of_the_chunks_are_the_whole_sequence(np_params):
    """Each layer's routing sums over the chunks (counts, summed router
    probabilities, kept choices, tokens) equal the whole sequence's, so
    the balance term formed from them is the whole sequence's."""
    cfg = MixtralConfig(**TINY, capacity_factor=0.5)
    inputs, _ = _inputs(seed=6)
    params = params_from_numpy(np_params)
    toks = torch.from_numpy(inputs).long()
    _, whole = tm.mixtral_forward(params, toks, cfg, compute_dtype=torch.float32,
                                  moe_impl="dispatch", return_aux=True)
    _, ring = tm.mixtral_forward(params, toks, cfg, compute_dtype=torch.float32,
                                 moe_impl="dispatch", return_aux=True, ring=LocalRing(4))
    for key in ("counts", "kept", "tokens"):
        assert torch.equal(ring["route"][key], whole["route"][key]), key
    torch.testing.assert_close(ring["route"]["probs"], whole["route"]["probs"],
                               rtol=1e-6, atol=1e-6)
    assert float(whole["route"]["kept"].sum()) < float(whole["route"]["counts"].sum())
