"""The port's kernel tuner (``fms_fsdp_tpu_torch/tune/``) against JAX's
(``fms_fsdp_tpu/tune/``) on the CPU.

One table document read through both packages gives the same answers and
violations; under chip "cpu", with entries legal under both cost models,
the SSD, CE, paged-decode and dcn-bucket resolvers return what JAX's
return, pinned and off cases included; the lookup contract of
tests/test_tune.py holds for the port (pinned tiles, an explicit bad table
raising, env-versus-config precedence, cache invalidation, no clock); the
tuned chunks engage in ``ssd_scan`` and the train step with JAX's results
on the same table; the committed table serves ``chip_smoke.py``'s shapes
by exact hit; the sweep script's ``--dry-run`` runs without CUDA.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.ops import ssd as j_ssd
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu.tune import candidates as j_cand
from fms_fsdp_tpu.tune import lookup as j_lookup
from fms_fsdp_tpu.tune import table as j_table
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.obs.observer import build_observer
from fms_fsdp_tpu_torch.ops import flash_attention as fa
from fms_fsdp_tpu_torch.ops import ssd
from fms_fsdp_tpu_torch.train.step import make_train_step, state_from_params
from fms_fsdp_tpu_torch.tune import candidates as cand
from fms_fsdp_tpu_torch.tune import lookup
from fms_fsdp_tpu_torch.tune import table as t_table
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_autotune_kernels.py")

FLASH_SIG = {"batch": 1, "nq": 4, "nkv": 2, "seq_q": 512, "seq_k": 512, "head": 128}
SSD_SIG = {"batch": 1, "seq": 1024, "heads": 4, "headdim": 64, "groups": 2, "dstate": 32}
CE_SIG = {"d_model": 64, "vocab": 512}
PAGED_SIG = {"batch": 8, "nq": 32, "nkv": 8, "head": 128, "max_seq": 2048}
PACKAGES = {"jax": (j_lookup, j_table), "port": (lookup, t_table)}


@pytest.fixture(autouse=True)
def _reset_tuning():
    """Both packages start from their import-time defaults and keep no
    forcing or registry afterwards."""
    for lk, _ in PACKAGES.values():
        lk.configure_kernel_tuning(None)
        lk.attach_registry(None)
    yield
    for lk, _ in PACKAGES.values():
        lk.configure_kernel_tuning(None)
        lk.attach_registry(None)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _table_with(tmp_path, entries, name="table.json"):
    """One document through the port's writer (JAX reads it too)."""
    t = t_table.TuningTable(path=str(tmp_path / name))
    for kernel, chip, dtype, sig, config in entries:
        t.add(kernel, chip, dtype, sig, config, source="measured", measured_ms=1.0)
    return t.save()


def _both(fn):
    """fn(lookup_module) through each package: {"jax": ..., "port": ...}."""
    return {pkg: fn(lk) for pkg, (lk, _) in PACKAGES.items()}


# ---------------------------------------------------------------------------
# the table: one document, both packages
# ---------------------------------------------------------------------------


def test_table_same_answers_both_packages(tmp_path):
    far = dict(FLASH_SIG, seq_q=8192, seq_k=8192)
    close = dict(FLASH_SIG, seq_q=1024, seq_k=1024)
    path = _table_with(tmp_path, [
        ("flash_attention", "h100", "bfloat16", far,
         {"family": "resident", "block_q": 128, "block_k": 128}),
        ("flash_attention", "h100", "bfloat16", close,
         {"family": "kvgrid", "block_q": 128, "block_k": 64}),
        ("ssd", "h100", "bfloat16", SSD_SIG, {"chunk": 128}),
    ])
    with open(path) as f:
        doc = json.load(f)
    doc["card"] = "NVIDIA H100 80GB HBM3, 700.00 W"  # a free top-level field
    with open(path, "w") as f:
        json.dump(doc, f)
    queries = [
        ("flash_attention", "h100", "bfloat16", close),                        # exact
        ("flash_attention", "h100", "bfloat16", dict(FLASH_SIG, seq_q=2048,
                                                     seq_k=2048)),             # nearest
        ("flash_attention", "h100", "float32", close),                         # dtype miss
        ("flash_attention", "v5e", "bfloat16", close),                         # chip miss
        ("ssd", "h100", "bfloat16", dict(SSD_SIG, seq=4096)),                  # nearest
        ("fused_ce", "h100", "bfloat16", CE_SIG),                              # kernel miss
    ]
    answers = {pkg: [tb.TuningTable.load(path).lookup(*q) for q in queries]
               for pkg, (_, tb) in PACKAGES.items()}
    assert answers["port"] == answers["jax"]
    assert [how for _, how in answers["port"]] == [
        "exact", "nearest", None, None, "nearest", None]
    assert answers["port"][1][0]["block_k"] == 64


@pytest.mark.parametrize("doc", [
    {"schema_version": 999, "entries": []},
    {"schema_version": 1},
    {"schema_version": 1, "entries": [{"kernel": "nope"}]},
    {"schema_version": 1, "entries": [
        {"kernel": "ssd", "chip": "h100", "dtype": "bfloat16", "signature": {"seq": 1.5},
         "config": {}, "source": "measured"}]},
    {"schema_version": 1, "entries": [
        {"kernel": "ssd", "chip": "h100", "dtype": "bfloat16", "signature": {"seq": 8},
         "config": {"chunk": 64}, "source": "guess"}] * 2},
    [],
])
def test_validate_table_same_violations(doc):
    assert t_table.validate_table(doc) == j_table.validate_table(doc)
    assert t_table.validate_table(doc)


def test_measured_entry_not_clobbered_by_cost_model(tmp_path):
    t = t_table.TuningTable(path=str(tmp_path / "t.json"))
    t.add("ssd", "h100", "bfloat16", {"seq": 4096}, {"chunk": 128},
          source="measured", measured_ms=2.0)
    t.add("ssd", "h100", "bfloat16", {"seq": 4096}, {"chunk": 64}, source="cost_model")
    assert t.lookup("ssd", "h100", "bfloat16", {"seq": 4096})[0] == {"chunk": 128}
    t.add("ssd", "h100", "bfloat16", {"seq": 4096}, {"chunk": 256},
          source="measured", measured_ms=1.0)
    assert t.lookup("ssd", "h100", "bfloat16", {"seq": 4096})[0] == {"chunk": 256}
    assert t_table.default_table_path().endswith(
        os.path.join("fms_fsdp_tpu_torch", "tune", "kernel_tuning_h100.json"))


def test_port_exports_jax_tune_names():
    import fms_fsdp_tpu.tune as j_tune
    import fms_fsdp_tpu_torch.tune as t_tune

    public = {n for n in dir(j_tune) if not n.startswith("_")}
    assert public <= set(dir(t_tune))
    for name in ("configure_kernel_tuning", "tuning_mode", "attach_registry", "choices",
                 "chip_kind", "resolve_flash", "record_final_flash_blocks",
                 "resolve_ssd_chunk", "resolve_paged_decode", "resolve_ce_chunk",
                 "resolve_dcn_bucket", "note_block_degradation"):
        assert callable(getattr(lookup, name)), name
    for name in ("flash_sig", "ssd_sig", "ce_sig", "paged_decode_sig", "dcn_bucket_sig",
                 "config_legal", "LEGALITY", "CANDIDATES"):
        assert hasattr(cand, name), name


# ---------------------------------------------------------------------------
# the cost model: JAX's signatures, Hopper's tiles
# ---------------------------------------------------------------------------


def test_signatures_equal_jax():
    assert cand.flash_sig((2, 4096, 32, 128), (2, 4096, 8, 128)) == \
        j_cand.flash_sig((2, 4096, 32, 128), (2, 4096, 8, 128))
    assert cand.ssd_sig((2, 4096, 128, 64), 1, 128) == j_cand.ssd_sig((2, 4096, 128, 64), 1, 128)
    assert cand.ce_sig(4096, 128256) == j_cand.ce_sig(4096, 128256)
    assert cand.paged_decode_sig(8, 32, 8, 128, 2048) == \
        j_cand.paged_decode_sig(8, 32, 8, 128, 2048)
    assert cand.dcn_bucket_sig(0.5, 11, 2, 1) == j_cand.dcn_bucket_sig(0.5, 11, 2, 1)
    sig = cand.dcn_bucket_sig(1024, 11, 2, 2)
    assert cand.dcn_bucket_candidates(sig, "bfloat16", "cpu") == \
        j_cand.dcn_bucket_candidates(sig, "bfloat16", "cpu")


def test_flash_candidates_are_the_kernels_tiles():
    sig4k = dict(FLASH_SIG, batch=2, nq=32, nkv=8, seq_q=4096, seq_k=4096)
    cands = cand.flash_candidates(sig4k, "bfloat16", "h100")
    assert {(c["block_q"], c["block_k"]) for c in cands} == {(128, 64), (128, 128)}
    assert {c["family"] for c in cands} == {"resident", "kvgrid"}
    assert {c.get("quant") for c in cands} == {None, "int8", "fp8"}
    assert len(cands) == 12
    assert cand.flash_candidates(sig4k, "bfloat16", "cpu") == cands
    # past MAX_KERNEL_SEQ only the kvgrid contract; fp32 has one tile
    sig16k = dict(sig4k, seq_q=16384, seq_k=16384)
    assert {c["family"] for c in cand.flash_candidates(sig16k, "bfloat16", "h100")} == \
        {"kvgrid"}
    assert {(c["block_q"], c["block_k"])
            for c in cand.flash_candidates(sig4k, "float32", "h100")} == {(64, 64)}
    # a length that is an odd multiple of 64 takes only the 64-key tile;
    # one the query tile does not divide takes none
    odd = dict(sig4k, seq_k=4160)
    assert {c["block_k"] for c in cand.flash_candidates(odd, "bfloat16", "h100")} == {64}
    assert not cand.flash_candidates(dict(sig4k, seq_q=192), "bfloat16", "h100")
    legal = {"family": "resident", "block_q": 128, "block_k": 64}
    assert cand.flash_config_legal(legal, sig4k, "bfloat16", "h100")
    for bad in (dict(legal, block_k=256), dict(legal, block_q=512),
                dict(legal, quant="int4"), dict(legal, family="ring")):
        assert not cand.flash_config_legal(bad, sig4k, "bfloat16", "h100"), bad
    assert not cand.flash_config_legal(legal, sig16k, "bfloat16", "h100")
    assert not cand.flash_config_legal(legal, sig4k, "float32", "h100")


def test_flash_smem_model_is_the_kernels_formula():
    """The byte counts restated from csrc/flash_*_sm90.cu: a 128-key tile
    in a 2-stage ring, a 64-key tile in a 4-stage ring (the same bytes in
    flight), every block under sm_90's opt-in maximum; the card holds them
    against the kernels' C functions (chip_smoke.py's tune phase)."""
    assert cand.flash_fwd_smem_bytes(128) == 1024 + 32768 * 5 + 64 == 164928
    assert cand.flash_dq_smem_bytes(128) == 1024 + 32768 * 6 + 64 == 197696
    assert cand.flash_fwd_smem_bytes(64) - cand.flash_fwd_smem_bytes(128) == 64
    assert cand.flash_dq_smem_bytes(64) - cand.flash_dq_smem_bytes(128) == 64
    assert cand.flash_dkv_smem_bytes() == 215616
    assert max(cand.flash_dkv_smem_bytes(), cand.flash_dq_smem_bytes(64)) <= \
        cand.smem_budget("h100") == 232448


def test_ssd_candidates_take_the_kernels_chunks():
    sig = {"batch": 2, "seq": 4096, "heads": 128, "headdim": 64, "groups": 1, "dstate": 128}
    cands = cand.ssd_candidates(sig, "bfloat16", "h100")
    assert [c["chunk"] for c in cands] == [64, 128, 256]
    assert cands[-1]["smem_bytes"] == 227328  # two heads a block at L = 256
    assert cand.ssd_heads_per_block(dict(sig, heads=3)) == 1
    assert not cand.ssd_config_legal({"chunk": 512}, dict(sig, seq=8192), "bfloat16", "h100")
    assert not cand.ssd_config_legal({"chunk": 96}, sig, "bfloat16", "h100")
    assert [c["chunk"] for c in cand.ssd_candidates(dict(sig, seq=192), "float32", "cpu")] \
        == [64]


def test_ce_budget_is_the_cards():
    sig = {"d_model": 4096, "vocab": 128256}
    assert [c["chunk"] for c in cand.ce_candidates(sig, "bfloat16", "h100")] == \
        [1024, 2048, 4096, 8192]
    assert not cand.ce_config_legal({"chunk": 16384}, sig, "bfloat16", "h100")


def test_paged_candidates_are_pages_and_splits():
    cands = cand.paged_decode_candidates(PAGED_SIG, "bfloat16", "h100")
    pairs = {(c["page_size"], c["block_kv"]) for c in cands}
    assert {ps for ps, _ in pairs} == {16, 32, 64, 128, 256}
    for ps, bkv in pairs:
        assert bkv == ps or (bkv % cand.split_unit(ps) == 0 and 64 <= bkv <= 2048), (ps, bkv)
    assert (64, 64) in pairs and (64, 2048) in pairs and (16, 16) in pairs
    assert (256, 256) in pairs and (256, 128) not in pairs
    # a split longer than the capacity needs is no candidate
    small = dict(PAGED_SIG, max_seq=256)
    assert max(c["block_kv"] for c in cand.paged_decode_candidates(small, "int8", "h100")) \
        == 256
    assert cand.paged_decode_config_legal({"page_size": 32, "block_kv": 128}, PAGED_SIG,
                                          "bfloat16", "h100")
    assert not cand.paged_decode_config_legal({"page_size": 16, "block_kv": 48}, PAGED_SIG,
                                              "bfloat16", "h100")
    assert not cand.paged_decode_config_legal({"page_size": 64, "block_kv": 4096},
                                              PAGED_SIG, "bfloat16", "h100")


# ---------------------------------------------------------------------------
# the resolvers against JAX's, chip "cpu"
# ---------------------------------------------------------------------------


def test_resolve_ssd_and_ce_match_jax(tmp_path):
    path = _table_with(tmp_path, [
        ("ssd", "cpu", "float32", SSD_SIG, {"chunk": 128}),
        ("fused_ce", "cpu", "float32", CE_SIG, {"chunk": 2048}),
    ])
    x_shape = (1, 1024, 4, 64)

    def run(lk):
        lk.configure_kernel_tuning("auto", path, chip="cpu")
        out = [lk.resolve_ssd_chunk(x_shape, 2, 32, "float32", requested=256),
               lk.resolve_ce_chunk(64, 512, "float32", requested=4096),
               # nearest signatures
               lk.resolve_ssd_chunk((1, 2048, 4, 64), 2, 32, "float32", requested=256),
               lk.resolve_ce_chunk(64, 1024, "float32", requested=4096),
               # a non-default request pins under auto
               lk.resolve_ssd_chunk(x_shape, 2, 32, "float32", requested=64),
               lk.resolve_ce_chunk(64, 512, "float32", requested=1024),
               # no entry for the dtype: the default
               lk.resolve_ssd_chunk(x_shape, 2, 32, "bfloat16", requested=256)]
        hows = lk.choices()
        lk.configure_kernel_tuning("off")
        out += [lk.resolve_ssd_chunk(x_shape, 2, 32, "float32", requested=256),
                lk.resolve_ce_chunk(64, 512, "float32", requested=4096)]
        return out, hows, lk.choices()

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [128, 2048, 128, 2048, 64, 1024, 256, 256, 4096]
    assert got["port"][2]["ssd"]["how"] == "off"


def test_resolve_paged_decode_matches_jax(tmp_path):
    path = _table_with(tmp_path, [
        ("paged_decode", "cpu", "bfloat16", PAGED_SIG, {"page_size": 32, "block_kv": 128}),
        ("paged_decode", "cpu", "int8", PAGED_SIG, {"page_size": 128, "block_kv": 128}),
    ])

    def run(lk):
        lk.configure_kernel_tuning("auto", path, chip="cpu")
        out = [lk.resolve_paged_decode(8, 32, 8, 128, 2048, "bfloat16"),
               lk.resolve_paged_decode(8, 32, 8, 128, 2048, "int8"),
               lk.resolve_paged_decode(4, 32, 8, 128, 4096, "bfloat16"),   # nearest
               lk.resolve_paged_decode(8, 32, 8, 128, 2048, "float32"),    # default
               lk.resolve_paged_decode(8, 32, 8, 128, 2048, "bfloat16",
                                       requested_page_size=16),            # pinned
               # a nearest hit whose page does not divide this capacity halves
               lk.resolve_paged_decode(8, 32, 8, 128, 2016, "int8")]
        with pytest.raises(ValueError, match="does not divide"):
            lk.resolve_paged_decode(8, 32, 8, 128, 2000, "bfloat16", requested_page_size=64)
        lk.configure_kernel_tuning("off")
        out.append(lk.resolve_paged_decode(8, 32, 8, 128, 2048, "bfloat16"))
        out.append(lk.resolve_paged_decode(8, 32, 8, 128, 1000, "bfloat16"))
        return out

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (32, 128, "exact")
    assert got["port"][2] == (32, 128, "nearest")
    assert got["port"][3] == (64, 64, "default")
    assert got["port"][4] == (16, 16, "pinned")
    assert got["port"][-2:] == [(64, 64, "off"), (8, 8, "off")]


def test_resolve_dcn_bucket_matches_jax(tmp_path):
    sig = cand.dcn_bucket_sig(1024, 11, 2, 2)
    path = _table_with(tmp_path, [("dcn_bucket", "cpu", "bfloat16", sig, {"bucket_mb": 64})])
    other = _table_with(tmp_path, [("ssd", "cpu", "bfloat16", {"seq": 4096}, {"chunk": 256})],
                        name="other.json")

    def run(lk):
        lk.configure_kernel_tuning("auto", path, chip="cpu")
        out = [lk.resolve_dcn_bucket(1024, 11, 2, 2, chip="cpu"),
               lk.choices()["dcn_bucket"]["how"],
               lk.resolve_dcn_bucket(1024, 11, 2, 2, requested=8, chip="cpu"),
               lk.choices()["dcn_bucket"]["how"]]
        lk.configure_kernel_tuning("auto", other, chip="cpu")
        out += [lk.resolve_dcn_bucket(1024, 11, 2, 2, chip="cpu"),
                lk.resolve_dcn_bucket(300, 11, 4, 1, chip="cpu")]
        lk.configure_kernel_tuning("off")
        out += [lk.resolve_dcn_bucket(1024, 11, 2, 2, requested=16),
                lk.resolve_dcn_bucket(1024, 11, 2, 2), lk.choices()["dcn_bucket"]["how"]]
        return out

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][:4] == [64, "exact", 8, "pinned"]
    assert got["port"][-3:] == [16, cand.DCN_BUCKET_DEFAULT_MB, "off"]


# ---------------------------------------------------------------------------
# the rest of the lookup contract (tests/test_tune.py's counterparts)
# ---------------------------------------------------------------------------


def test_resolve_flash_auto_off_pinned(tmp_path):
    path = _table_with(tmp_path, [
        ("flash_attention", "h100", "bfloat16", FLASH_SIG,
         {"family": "kvgrid", "block_q": 128, "block_k": 64}),
        ("flash_attention", "h100", "float32", FLASH_SIG,
         {"family": "kvgrid", "block_q": 128, "block_k": 64}),  # illegal for fp32
    ])
    q, k = (1, 512, 4, 128), (1, 512, 2, 128)
    lookup.configure_kernel_tuning("auto", path, chip="h100")
    assert lookup.resolve_flash(q, k, "bfloat16") == (128, 64, "kvgrid", None, "exact")
    assert lookup.choices()["flash"]["kvgrid"] == 1
    # the caller's tiles win over the table, labelled pinned under auto
    assert lookup.resolve_flash(q, k, "bfloat16", requested_q=128,
                                requested_k=128) == (128, 128, None, None, "pinned")
    # the requested family and quant pin those pieces, the table the rest
    assert lookup.resolve_flash(q, k, "bfloat16", requested_variant="resident",
                                requested_quant="int8")[:4] == (128, 64, "resident", "int8")
    # an illegal entry falls to the defaults: fp32's one tile
    assert lookup.resolve_flash(q, k, "float32") == (64, 64, None, None, "default")
    # nearest, re-checked for this shape: a length the tile divides
    assert lookup.resolve_flash((1, 1024, 4, 128), (1, 1024, 2, 128), "bfloat16")[4] == \
        "nearest"
    lookup.configure_kernel_tuning("off")
    assert lookup.resolve_flash(q, k, "bfloat16") == (128, 128, None, None, "off")
    assert lookup.resolve_flash(q, k, "float32") == (64, 64, None, None, "off")


def test_flash_attention_records_what_runs(tmp_path):
    """flash_attention resolves through the table and records the tile and
    family it runs; on the CPU the plain versions run whatever the tile,
    so a tuned call equals an untuned one bit for bit."""
    path = _table_with(tmp_path, [
        ("flash_attention", "cpu", "float32", dict(FLASH_SIG, seq_q=128, seq_k=128),
         {"family": "kvgrid", "block_q": 64, "block_k": 64})])
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 128, 4, 128), (1, 128, 2, 128), (1, 128, 2, 128)))
    lookup.configure_kernel_tuning("auto", path, chip="cpu")
    tuned = fa.flash_attention(q, k, v)
    rec = lookup.choices()["flash"]
    assert (rec["block_q"], rec["block_k"], rec["kvgrid"], rec["how"]) == (64, 64, 1, "exact")
    lookup.configure_kernel_tuning("off")
    assert torch.equal(fa.flash_attention(q, k, v), tuned)
    rec = lookup.choices()["flash"]
    assert (rec["block_k"], rec["kvgrid"], rec["how"]) == (64, 0, "off")
    # the sequence rule decides the family the record states
    fa.flash_attention(q, k, v, variant="kvgrid")
    assert lookup.choices()["flash"]["kvgrid"] == 1


def test_flash_attention_resolves_once_per_build(tmp_path):
    """An eager flash_attention resolves a shape's tiles at its first call
    after a configure: the record and the ``kernel.tune.<how>`` counter
    are written once per build, not once per layer call, and the next
    configure (a new table) is read by the next call."""
    from fms_fsdp_tpu_torch.obs.registry import MetricRegistry

    sig = dict(FLASH_SIG, seq_q=128, seq_k=128)
    path = _table_with(tmp_path, [("flash_attention", "cpu", "float32", sig,
                                   {"family": "kvgrid", "block_q": 64, "block_k": 64})])
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 128, 4, 128), (1, 128, 2, 128), (1, 128, 2, 128)))
    registry = MetricRegistry()
    lookup.attach_registry(registry)
    lookup.configure_kernel_tuning("auto", path, chip="cpu")
    for _ in range(3):
        fa.flash_attention(q, k, v)
    assert registry.counter("kernel.tune.exact").value == 1
    assert lookup.choices()["flash"]["kvgrid"] == 1
    # a pinned piece is another request: resolved (and counted) apart
    fa.flash_attention(q, k, v, variant="resident")
    fa.flash_attention(q, k, v, variant="resident")
    assert registry.counter("kernel.tune.exact").value == 2
    lookup.configure_kernel_tuning("off")
    fa.flash_attention(q, k, v)
    assert lookup.choices()["flash"]["how"] == "off"
    assert lookup.choices()["flash"]["kvgrid"] == 0


def test_pick_block_runs_the_kernels_tiles():
    assert fa._pick_block(4096, 128, "k", torch.bfloat16) == 128
    assert fa._pick_block(192, 128, "k", torch.bfloat16) == 128  # the kernel masks the tail
    assert fa._pick_block(64, 128, "k", torch.bfloat16) == 64
    assert fa._pick_block(64, 128, "q", torch.bfloat16) == 128
    assert fa._pick_block(64, 64, "k", torch.float32) == 64
    with pytest.raises(ValueError, match="key tile"):
        fa._kernel_block_k(torch.bfloat16, 256)
    with pytest.raises(ValueError, match="one 64-key"):
        fa._kernel_block_k(torch.float32, 128)


def test_configure_precedence_env_vs_config(monkeypatch, tmp_path):
    path = _table_with(tmp_path, [("fused_ce", "cpu", "float32", CE_SIG, {"chunk": 1024})])
    monkeypatch.setattr(lookup, "_ENV_MODE", "off")
    monkeypatch.setattr(lookup, "_ENV_TABLE", None)
    lookup.configure_kernel_tuning(None)
    assert lookup.tuning_mode() == "off"
    lookup.configure_kernel_tuning(path, chip="cpu")  # a path means auto
    assert lookup.tuning_mode() == "auto"
    assert lookup.resolve_ce_chunk(64, 512, "float32", requested=4096) == 1024
    with pytest.raises(ValueError):
        lookup.configure_kernel_tuning("warp-speed")
    monkeypatch.setenv("FMS_KERNEL_TUNING", "sideways")
    with pytest.raises(ValueError, match="FMS_KERNEL_TUNING"):
        lookup._env_default()
    monkeypatch.setenv("FMS_KERNEL_TUNING", path)
    assert lookup._env_default() == ("auto", path)


def test_explicit_bad_table_raises(tmp_path):
    with pytest.raises(ValueError):
        lookup.configure_kernel_tuning("auto", str(tmp_path / "missing.json"), chip="cpu")
    bad = tmp_path / "corrupt.json"
    bad.write_text("{not json")
    with pytest.raises(ValueError):
        lookup.configure_kernel_tuning(str(bad), chip="cpu")
    # the committed default stays soft: a missing file means the defaults
    lookup.configure_kernel_tuning("auto", chip="cpu")
    assert lookup.resolve_ce_chunk(64, 512, "float32", requested=4096) == 4096


def test_configure_invalidates_table_cache(tmp_path):
    path = _table_with(tmp_path, [("fused_ce", "cpu", "float32", CE_SIG, {"chunk": 1024})])
    lookup.configure_kernel_tuning("auto", path, chip="cpu")
    assert lookup.resolve_ce_chunk(64, 512, "float32", requested=4096) == 1024
    t = t_table.TuningTable.load(path)
    t.add("fused_ce", "cpu", "float32", CE_SIG, {"chunk": 2048}, source="measured",
          measured_ms=0.5)
    t.save(path)
    assert lookup.resolve_ce_chunk(64, 512, "float32", requested=4096) == 1024  # cached
    lookup.configure_kernel_tuning("auto", path, chip="cpu")
    assert lookup.resolve_ce_chunk(64, 512, "float32", requested=4096) == 2048


def test_lookup_deterministic_and_clock_free(tmp_path):
    for mod in (lookup, t_table, cand):
        assert "time" not in dir(mod), mod.__name__
        with open(mod.__file__) as f:
            src = f.read()
        assert "import time" not in src and "perf_counter" not in src, mod.__name__
    lookup.configure_kernel_tuning("auto", chip="h100")
    shapes = ((2, 4096, 32, 128), (2, 4096, 8, 128), "bfloat16")
    assert lookup.resolve_flash(*shapes) == lookup.resolve_flash(*shapes)
    assert lookup.chip_kind() == "h100"
    lookup.configure_kernel_tuning("auto")
    assert lookup.chip_kind() == "cpu"  # no card here


def test_choices_land_in_observer_records(tmp_path):
    """build_observer attaches its registry: the resolved tiles reach the
    records as kernel.tune.* gauges, and the record names the mode."""
    path = _table_with(tmp_path, [("fused_ce", "cpu", "float32", CE_SIG, {"chunk": 1024})])
    cfg = TrainConfig(kernel_tuning=path)
    lookup.configure_kernel_tuning(cfg.kernel_tuning, chip="cpu")
    lookup.resolve_ce_chunk(64, 512, "float32", requested=4096)  # before the attach
    obs = build_observer(cfg, rank=0)
    lookup.resolve_ssd_chunk((1, 1024, 4, 64), 2, 32, "float32", requested=256)
    rec = obs.report(1, 1, loss=2.0, tokens_per_sec_per_chip=1.0, skipped_steps_total=0,
                     skipped_steps_window=0)
    extra = {**rec.get("extra", {}), **rec}
    assert extra["kernel.tune.ce.chunk"] == 1024
    assert extra["kernel.tune.ssd.chunk"] == 256
    assert rec["kernel_tuning"] == path


# ---------------------------------------------------------------------------
# engagement: the tuned chunks in the ops and the step, against JAX's
# ---------------------------------------------------------------------------


def test_ssd_scan_tuned_chunk_matches_jax(tmp_path):
    """A chunk-128 entry for the scan's signature: both packages run L=128
    (their default would be 256) and agree at fp32, atol 2e-5."""
    B, S, H, P, G, N = 1, 256, 4, 64, 2, 32
    sig = {"batch": B, "seq": S, "heads": H, "headdim": P, "groups": G, "dstate": N}
    path = _table_with(tmp_path, [("ssd", "cpu", "float32", sig, {"chunk": 128})])
    rng = np.random.default_rng(5)
    inp = [rng.normal(size=(B, S, H, P)), np.abs(rng.normal(size=(B, S, H))) * 0.1 + 0.01,
           -(np.abs(rng.normal(size=(H,))) + 0.5), rng.normal(size=(B, S, G, N)),
           rng.normal(size=(B, S, G, N)), rng.normal(size=(H,))]
    inp = [a.astype(np.float32) for a in inp]
    for lk, _ in PACKAGES.values():
        lk.configure_kernel_tuning("auto", path, chip="cpu")
    ref = j_ssd.ssd_scan(*[jnp.asarray(a) for a in inp], kernel="xla")
    assert j_lookup.choices()["ssd"]["chunk"] == 128
    for route in ("auto", "xla"):
        out = ssd.ssd_scan(*[torch.from_numpy(a) for a in inp], kernel=route)
        assert lookup.choices()["ssd"] == {"chunk": 128, "how": "exact", "seq": S}
        assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 2e-5, route


def test_train_steps_with_tuned_ce_chunk_match_jax(tmp_path):
    """Three fp32 Llama steps through the fused CE with a CE-chunk entry
    (512 rows a chunk of the 2048 tokens a step, against the default 4096)
    in both packages, at tests/test_torch_training.py's tolerance (loss and
    gnorm 1e-5 relative)."""
    kw = dict(src_vocab_size=512, emb_dim=256, nheads=2, kvheads=1, nlayers=2,
              max_expected_seq_len=256)
    jcfg_model, tcfg_model = JLlamaConfig(**kw), LlamaConfig(**kw)
    path = _table_with(tmp_path, [("fused_ce", "cpu", "float32", {"d_model": 256, "vocab": 512},
                                   {"chunk": 512})])
    step_kw = dict(seq_length=256, batch_size=8, num_steps=20, vocab_size=512,
                   attention_kernel="xla", sharding_strategy="fsdp", learning_rate=1e-3,
                   mixed_precision=False, fused_loss=True, kernel_tuning=path)
    jcfg = JTrainConfig(**step_kw)
    mesh = build_mesh(MeshConfig.from_train_config(jcfg))
    opt = j_step.make_optimizer(jcfg)
    jstate, _ = j_step.init_train_state(jax.random.PRNGKey(0), jcfg_model, jcfg, mesh, opt)
    jfn = j_step.make_train_step(jcfg_model, jcfg, mesh, opt)
    assert j_lookup.choices()["ce"]["chunk"] == 512
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]))
    tcfg = TrainConfig(**step_kw)
    tstate = state_from_params(params, tcfg)
    tfn = make_train_step(tcfg_model, tcfg)
    assert lookup.choices()["ce"] == {"chunk": 512, "how": "exact", "vocab": 512}
    for i in range(3):
        toks = np.random.default_rng(10 + i).integers(0, 512, size=(8, 257))
        inputs, labels = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
        jstate, jm = jfn(jstate, (jnp.asarray(inputs), jnp.asarray(labels)))
        tm = tfn(tstate, (torch.from_numpy(inputs).long(), torch.from_numpy(labels).long()))
        for key in ("loss", "gnorm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), (i, key)


# ---------------------------------------------------------------------------
# the committed table and the sweep script
# ---------------------------------------------------------------------------


def _script():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_autotune_kernels", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_committed_table_serves_the_suite_by_exact_hit():
    """The port's table validates, names the card, holds measured entries
    only, and answers every shape of the sweep's suite (chip_smoke.py's
    shapes) exactly under chip "h100" with a legal config."""
    with open(t_table.default_table_path()) as f:
        doc = json.load(f)
    assert t_table.validate_table(doc) == []
    assert "H100" in doc["card"] and "W" in doc["card"]
    assert all(e["source"] == "measured" and e["measured_ms"] > 0 for e in doc["entries"])
    assert {e["chip"] for e in doc["entries"]} == {"h100"}
    mod = _script()
    resolved = mod.lookup_suite(t_table.default_table_path(), "h100")
    assert len(resolved) == len(mod.SUITE)
    for r in resolved:
        assert r["resolved"]["how"] == "exact", r


def test_sweep_winner_keeps_the_default_within_margin():
    """scripts/torch_autotune_kernels.py's rule: noise flips no knob."""
    mod = _script()
    default = {"chunk": 4096}
    timed = [{"config": {"chunk": 2048}, "ms": 1.0}, {"config": default, "ms": 1.02},
             {"config": {"chunk": 8192}, "ms": None}]
    assert mod.pick_winner(timed, default)["config"] == default
    timed[1]["ms"] = 1.1
    assert mod.pick_winner(timed, default)["config"] == {"chunk": 2048}
    assert mod.pick_winner([{"config": default, "ms": None}], default) is None
    # within the margin the candidate closest to the default wins: a page
    # size that does not matter at a split keeps its default
    paged = {"page_size": 64, "block_kv": 64}
    timed = [{"config": {"page_size": 128, "block_kv": 512}, "ms": 1.0},
             {"config": {"page_size": 64, "block_kv": 512}, "ms": 1.02},
             {"config": paged, "ms": 1.2}]
    assert mod.pick_winner(timed, paged)["config"] == {"page_size": 64, "block_kv": 512}
    for kernel, sig, dtype in mod.SUITE:
        cands = [mod.strip(c) for c in cand.CANDIDATES[kernel](sig, dtype, "h100")]
        assert mod.default_config(kernel, sig, dtype) in cands, (kernel, sig, dtype)


def test_sweep_times_decode_at_the_serve_rows():
    """A paged-decode signature holds no row lengths, so the sweep times a
    batch at the serve phases' rows (prompts of 64 to cap / 2, seeded,
    halfway through 64 new tokens) and one row at cap - 2 keys; --match
    narrows the suite to the signatures it names."""
    mod = _script()
    lens = mod.decode_lens(8, 2048)
    assert lens == mod.decode_lens(8, 2048) and len(lens) == 8
    assert all(64 + 32 <= n <= 1024 + 32 for n in lens)
    assert mod.decode_lens(1, 16384) == [16382]
    picked = mod.suite_candidates("h100", ["paged_decode"], {"batch": "8"})
    assert [(s["batch"], d) for _, s, d, _ in picked] == [
        (8, "bfloat16"), (8, "int8"), (8, "float8_e4m3fn")]
    assert len(mod.suite_candidates("h100", None, {"dtype": "int8"})) == 2


def test_sweep_dry_run_needs_no_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, SCRIPT, "--dry-run"], capture_output=True,
                          text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["mode"] == "dry_run" and doc["chip"] == "h100"
    assert len(doc["suite"]) == len(_script().SUITE)
    assert all(r["legal_candidates"] > 0 for r in doc["suite"])
    assert doc["table_violations"] == []
    code = ("import runpy, sys, io, contextlib\n"
            f"sys.argv = [{SCRIPT!r}, '--dry-run']\n"
            "with contextlib.redirect_stdout(io.StringIO()):\n"
            "    try:\n"
            f"        runpy.run_path({SCRIPT!r}, run_name='__main__')\n"
            "    except SystemExit:\n"
            "        pass\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
