"""PyTorch port, the serving layout: a replica over a tensor x fsdp group
of gloo ranks held against JAX's sharded engine on the same weights.

One module-scoped fixture starts a gloo world of 2 and one of 4, each rank
a fresh interpreter (tests/torch_layout_child.py) that imports no JAX and
runs all of its world's cases, and meanwhile computes JAX's references on
the 8-device CPU mesh of tests/conftest.py: its unified engine and its
``serve_layout`` engines, from the same JAX-initialised weights carried
over as numpy (``bridge.py``). TINY of tests/test_serving.py:47, fp32:

- the port's ``"tp=2"`` and ``"tp=2,fsdp=2"`` Llama engines emit the
  tokens of JAX's sharded engine, which are its unified engine's, and
  their last decode step's logits lie within 2e-5 of it; each rank holds
  its blocks (wq's columns, one of the two KV heads in its pools), and
  under fsdp a layer is gathered once a forward;
- the tp 2 Mixtral engine, ``moe_impl`` dense and routed, against JAX's;
- a tp 2 prefill replica hands off to a tp 2 decode replica and to a
  one-card one, and a one-card prefill to the tp 2 decode replica, with
  the unified tokens; a one-card ``FMSH`` wire written into the tp 2
  pools and read out again is the same bytes, and a tp 2 prefill's wire
  has a one-card prefill's header and leaves, its values within 2e-5;
- int8 pools, chunked prefill, speculative decode and a mid-wave defrag
  at tp 2 give the port's one-card tokens in the same mode;
- the control (the row-parallel reduces dropped) fails the logits check;
- in process: ``parse_serve_layout`` / ``serve_layout_code`` and the
  pool and param specs follow JAX's, Mamba refuses a layout
  ("single-chip"), a layout needs a world of its size, and the tuning
  lookup reads the local heads. The fleet's replicas over rank groups:
  tests/test_torch_fleet_layout.py.
"""

import json
import os
import pickle
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.models import mixtral as j_mixtral
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init
from fms_fsdp_tpu.models.speculator import SpeculatorConfig as JSpeculatorConfig
from fms_fsdp_tpu.models.speculator import init_speculator_params as j_init_spec
from fms_fsdp_tpu.models.speculator import save_speculator as j_save_speculator
from fms_fsdp_tpu.parallel import sharding as j_sharding
from fms_fsdp_tpu.serve import ServeConfig as JServeConfig
from fms_fsdp_tpu.serve import ServingEngine as JServingEngine
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.models.configs import MambaConfig
from fms_fsdp_tpu_torch.parallel import sharding
from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
from fms_fsdp_tpu_torch.serve.families import paged_decode_tiles
from test_torch_multiprocess import REPO, _env, _finish, _free_port
from torch_layout_child import (
    CASES_2,
    CASES_4,
    LLAMA_KW,
    MAX_NEW,
    MIXTRAL_KW,
    PROMPTS,
    SCFG,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LAYOUT_CHILD = os.path.join(REPO, "tests", "torch_layout_child.py")
ATOL = 2e-5
J_CFG = {"llama": JLlamaConfig(**LLAMA_KW), "mixtral": JMixtralConfig(**MIXTRAL_KW)}
_J_INIT = {"llama": j_init, "mixtral": j_mixtral.init_mixtral_params}
# JAX's engines the cases are held against: (family, layout, overrides)
J_REFS = {
    "llama": ("llama", "", {}),
    "llama_tp2": ("llama", "tp=2", {}),
    "llama_tp2_fsdp2": ("llama", "tp=2,fsdp=2", {}),
    "mixtral_dense": ("mixtral", "", {"moe_impl": "dense"}),
    "mixtral_tp2_dense": ("mixtral", "tp=2", {"moe_impl": "dense"}),
    "mixtral_tp2_routed": ("mixtral", "tp=2", {"moe_impl": "routed"}),
}


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _j_serve(np_params, family, layout, over):
    """JAX's engine on ``np_params``: (tokens, the last decode step's
    logits rows of the prompts' slots), as the child's ``drive``."""
    eng = JServingEngine(jax.tree.map(jnp.asarray, np_params), J_CFG[family],
                         JServeConfig(**SCFG, serve_layout=layout, **over))
    reqs = [eng.submit(p, MAX_NEW) for p in PROMPTS]
    eng.run()
    return ([list(map(int, r.generated)) for r in reqs],
            np.asarray(eng.last_logits)[:len(PROMPTS)])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layout")
    np_params, paths = {}, {}
    for i, (family, init) in enumerate(_J_INIT.items()):
        np_params[family] = jax.tree.map(np.asarray, init(jax.random.PRNGKey(i), J_CFG[family]))
        paths[family] = str(tmp / f"{family}.pkl")
        with open(paths[family], "wb") as f:
            pickle.dump(np_params[family], f)
    spec_cfg = JSpeculatorConfig(emb_dim=64, inner_dim=32, vocab_size=128, n_predict=3)
    spec_path = str(tmp / "speculator.pkl")
    j_save_speculator(spec_path, j_init_spec(jax.random.PRNGKey(7), spec_cfg), spec_cfg)
    procs = {}
    for world in (2, 4):
        spec = {"out": str(tmp / f"w{world}"), "params": paths, "speculator": spec_path,
                "world": world}
        os.makedirs(spec["out"])
        port = _free_port()
        procs[world] = [subprocess.Popen(
            [sys.executable, "-u", LAYOUT_CHILD, json.dumps(spec)], cwd=REPO,
            env=_env(r, world, port), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
    # JAX's references while the worlds run
    with ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(_j_serve, np_params[fam], fam, layout, over)
                   for name, (fam, layout, over) in J_REFS.items()}
        refs = {name: fut.result() for name, fut in futures.items()}
    ranks = {}
    for world, ps in procs.items():
        outs = _finish(ps, timeout=300)
        for r, (p, text) in enumerate(zip(ps, outs)):
            assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{text[-4000:]}"
        ranks[world] = []
        for r in range(world):
            with open(tmp / f"w{world}" / f"rank{r}.json") as f:
                ranks[world].append(json.load(f))
    return {"refs": refs, "ranks": ranks}


def _logits_diff(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - want).max())


@pytest.mark.parametrize("case,world,want_pool_heads", [("llama_tp2", 2, 1),
                                                        ("llama_tp2_fsdp2", 4, 1)])
def test_layout_llama_matches_jax(worlds, case, world, want_pool_heads):
    refs, lead = worlds["refs"], worlds["ranks"][world][0]
    tokens, logits = refs[case]
    assert tokens == refs["llama"][0]  # JAX's sharded tokens are its unified ones
    got = lead[case]
    assert got["tokens"] == tokens
    assert _logits_diff(got["logits"], logits) <= ATOL
    assert got["stats"]["serve_layout"] == {"llama_tp2": 201.0, "llama_tp2_fsdp2": 202.0}[case]
    # each rank's blocks: wq (L, d / fsdp, nq * hd / tp), the pools its KV head
    fsdp = world // 2
    for rank in worlds["ranks"][world]:
        assert rank[case]["wq"] == [2, 64 // fsdp, 32]
        assert rank[case]["pool"][3] == want_pool_heads
    if fsdp > 1:
        # a layer gathered once a forward, the top-level leaves once: the
        # 3 prefills and the decode steps
        forwards = len(PROMPTS) + got["decode_steps"]
        assert got["gathers"] == {"layer": 2 * forwards, "top": forwards}
    else:
        assert got["gathers"] == {"layer": 0, "top": 0}


@pytest.mark.parametrize("moe_impl", ["dense", "routed"])
def test_layout_mixtral_matches_jax(worlds, moe_impl):
    case = f"mixtral_tp2_{moe_impl}"
    refs = worlds["refs"]
    tokens, logits = refs[case]
    got = worlds["ranks"][2][0][case]
    assert tokens == refs["mixtral_dense"][0]
    assert got["tokens"] == tokens
    assert _logits_diff(got["logits"], logits) <= ATOL
    assert got["pool"][3] == 1


def test_layout_handoff_composes(worlds):
    """tp 2 prefill -> tp 2 decode, -> one card, and one card -> tp 2
    decode: the unified tokens. The wire bytes of a page set are a
    one-card replica's: a one-card wire imported by the tp 2 replica
    (each rank its KV head) and exported again (the heads gathered) is
    the same bytes; a tp 2 prefill's wire has the one-card prefill's
    header and leaves, its values within the logits' bound (its row-split
    products sum in another order, so the bits of later layers' pages
    differ)."""
    got = worlds["ranks"][2][0]["handoff"]
    unified = worlds["refs"]["llama"][0]
    assert got["tp_to_tp"] == unified
    assert got["tp_to_one"] == unified
    assert got["one_to_tp"] == unified
    # a one-card wire through the tp 2 pools and back: the same bytes
    assert got["round_trip"] == [True] * len(PROMPTS)
    # the tp 2 prefill's wire against a one-card prefill's: the same
    # header and leaves; the pages' values differ by rounding only
    for wire in got["wires"]:
        assert wire["header_equal"] and wire["length_equal"] and wire["leaves_equal"]
        assert wire["max_abs_diff"] <= ATOL
    assert got["prefill_stats"]["serve_layout"] == 201.0
    assert got["prefill_stats"]["role"] == 1.0 and got["decode_stats"]["role"] == 2.0
    assert got["decode_stats"]["handoff_bytes"] > 0


def test_layout_defrag_keeps_the_ranks_in_step(worlds):
    """A defrag through the leader's adapter moves the same pages on
    every rank; the decode after it gives a one-card engine's tokens."""
    got = worlds["ranks"][2][0]["defrag"]
    assert got["moved"] > 0 and got["moved"] == got["one_card_moved"]
    assert got["tokens"] == got["one_card_tokens"]
    assert worlds["ranks"][2][1]["defrag"]["moved"] == got["moved"]


@pytest.mark.parametrize("case", ["llama_tp2_int8", "llama_tp2_chunked", "llama_tp2_spec"])
def test_layout_modes_match_one_card(worlds, case):
    got = worlds["ranks"][2][0][case]
    assert got["tokens"] == got["one_card_tokens"]
    assert all(len(t) == MAX_NEW for t in got["tokens"])
    stats = got["stats"]
    if case == "llama_tp2_chunked":
        assert stats["prefill_chunks"] > len(PROMPTS)
    if case == "llama_tp2_spec":
        assert stats["spec_draft_tokens"] == 3.0


def test_layout_control_fails_the_logits_check(worlds):
    """The forward's row-parallel reduces dropped (each rank keeps its
    partial sums): the same logits check fails by far."""
    got = worlds["ranks"][2][0]["control_drop_reduce"]
    assert _logits_diff(got["logits"], worlds["refs"]["llama_tp2"][1]) > 100 * ATOL


def test_layout_followers_ran_the_leaders_calls(worlds):
    """Every follower ran the leader's adapter calls: the prefills and
    decode steps of each case (the allocator's calls ride along)."""
    for world, cases in ((2, CASES_2), (4, CASES_4)):
        lead = worlds["ranks"][world][0]
        for rank in worlds["ranks"][world][1:]:
            for name, *_ in cases:
                assert rank[name]["calls"] >= len(PROMPTS) + lead[name]["decode_steps"]
                assert rank[name]["wq"] == lead[name]["wq"]
    assert worlds["ranks"][2][1]["handoff"]["calls"] > 0


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


def test_parse_serve_layout_contract():
    """tests/test_disagg.py::test_parse_serve_layout_contract through both
    packages, errors included."""
    for layout in ("", "tp=2", "tp=2,fsdp=4", "fsdp=2", "tensor=4", " tp=2 , fsdp=2 ", "tp=1"):
        assert sharding.parse_serve_layout(layout) == j_sharding.parse_serve_layout(layout)
        assert sharding.serve_layout_code(layout) == j_sharding.serve_layout_code(layout)
    assert sharding.serve_layout_code("tp=2") == 201
    assert sharding.serve_layout_code("tp=2,fsdp=2") == 202
    for bad in ("dp=2", "tp=0", "tp", "tp=x"):
        with pytest.raises(ValueError) as want:
            j_sharding.parse_serve_layout(bad)
        with pytest.raises(ValueError) as got:
            sharding.parse_serve_layout(bad)
        assert str(got.value) == str(want.value)


def test_serve_specs_match_jax():
    for quant in ("none", "int8"):
        assert ({k: tuple(v) for k, v in sharding.serve_kv_pool_specs(quant).items()}
                == {k: tuple(v) for k, v in j_sharding.serve_kv_pool_specs(quant).items()})
    for family in ("llama", "mixtral", "mamba"):
        want = j_sharding.serve_param_specs(family)
        got = sharding.serve_param_specs(family)
        if want is None:
            assert got is None
            continue
        flat = dict(sharding._paths(got))
        assert {k: tuple(v) for k, v in flat.items()} == {
            tuple(str(getattr(p, "key", p)) for p in path): tuple(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


def test_mamba_refuses_a_layout():
    """tests/test_disagg.py::test_mamba_roles_and_layout_gates' layout
    gate: JAX's "single-chip" ValueError, before any group is needed."""
    from fms_fsdp_tpu_torch.models.mamba import init_mamba_params

    cfg = MambaConfig(d_model=64, n_layer=2, vocab_size=128, d_state=16, headdim=16,
                      chunk_size=8, attn_layer_idx=(), d_intermediate=128)
    params = init_mamba_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="single-chip"):
        ServingEngine(params, cfg, ServeConfig(serve_layout="tp=2", compute_dtype="float32"),
                      device="cpu")


def test_layout_needs_a_world_of_its_size():
    """No process group here: a world of one, which a layout of two ranks
    refuses rather than serving on one card."""
    params = params_from_numpy(jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                                               J_CFG["llama"])))
    from fms_fsdp_tpu_torch.models.configs import LlamaConfig

    with pytest.raises(ValueError, match="needs 2 ranks"):
        ServingEngine(params, LlamaConfig(**LLAMA_KW), ServeConfig(**SCFG, serve_layout="tp=2"),
                      device="cpu")
    eng = ServingEngine(params, LlamaConfig(**LLAMA_KW), ServeConfig(**SCFG, serve_layout="tp=1"),
                        device="cpu")
    assert eng.mesh is None and eng.is_leader
    assert eng.serving_stats()["serve_layout"] == 101.0


def test_tile_lookup_reads_the_local_heads(monkeypatch):
    """Under a split of the heads the split is looked up at Nq / tp and
    Nkv / tp; the page size stays the whole model's."""
    from fms_fsdp_tpu_torch.models.configs import LlamaConfig
    from fms_fsdp_tpu_torch.tune import lookup

    seen = []

    def fake(batch, nq, nkv, head, max_seq, dtype, requested_page_size=None):
        seen.append((nq, nkv))
        return (64, 256, "exact") if nkv == 8 else (64 if nq == 16 else 32, 128, "nearest")

    monkeypatch.setattr(lookup, "resolve_paged_decode", fake)
    cfg = LlamaConfig(emb_dim=4096, nheads=32, kvheads=8)
    scfg = ServeConfig(max_batch=8, max_seq_len=2048)
    assert paged_decode_tiles(cfg, scfg) == (64, 256, "exact")
    assert paged_decode_tiles(cfg, scfg, types.SimpleNamespace(size=2)) == (64, 128, "nearest")
    # a local entry at another page size: the whole model's page, the planner's split
    assert paged_decode_tiles(cfg, scfg, types.SimpleNamespace(size=4)) == (64, 64, "default")
    # the GQA guard (heads not split): the whole heads only
    assert paged_decode_tiles(cfg, scfg, types.SimpleNamespace(size=3)) == (64, 256, "exact")
    assert seen == [(32, 8), (32, 8), (16, 4), (32, 8), (8, 2), (32, 8)]


def test_paged_head_launches_reset():
    from fms_fsdp_tpu_torch.ops import paged_attention as pa

    pa.HEAD_LAUNCHES["16/4"] = 3
    pa.reset_launches()
    assert pa.HEAD_LAUNCHES == {} and set(pa.LAUNCHES.values()) == {0}
