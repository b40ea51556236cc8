"""PyTorch port, disaggregated serving: held against the JAX package.

The TINY configs of tests/test_serving.py:47 (Llama), tests/
test_serving_families.py (Mixtral, the Mamba hybrid), JAX-initialised
weights moved through the port's bridge, prompts from numpy seeds, fp32 on
the CPU:

- the page and slab codecs: for the same header and leaves the port's
  wire bytes equal JAX's, per dtype (fp32, bf16, int8, e4m3); each
  package unpacks the other's bytes bit for bit; corruption is a typed
  ``HandoffError``;
- cross-package disaggregation: a JAX ``prefill``-role engine's handoff
  bytes resumed by the port's ``decode``-role engine give JAX's unified
  greedy tokens (Llama with and without int8 pools, Mixtral, Mamba);
- chunked prefill: the first-token logits within 2e-5 of the port's
  whole-prompt logits and of JAX's chunked logits; engine tokens equal;
- pages: ``scatter_pages`` and ``defrag`` keep the reserved pages, bump
  ``table_version``, and match JAX's allocator; a defrag whose bump is
  undone (a stale cached page table) gives wrong decode logits.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.models import mamba as j_mamba
from fms_fsdp_tpu.models import mixtral as j_mixtral
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init
from fms_fsdp_tpu.serve import ServeConfig as JServeConfig
from fms_fsdp_tpu.serve import ServingEngine as JServingEngine
from fms_fsdp_tpu.serve.disagg import handoff as j_handoff
from fms_fsdp_tpu.serve.disagg import slab as j_slab
from fms_fsdp_tpu.serve.kv_cache import PagedKVCache as JPagedKVCache
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.models.configs import (
    LlamaConfig,
    MambaAttnConfig,
    MambaConfig,
    MixtralConfig,
)
from fms_fsdp_tpu_torch.serve import RequestRejected, ServeConfig, ServingEngine
from fms_fsdp_tpu_torch.serve.disagg import handoff as t_handoff
from fms_fsdp_tpu_torch.serve.disagg import slab as t_slab
from fms_fsdp_tpu_torch.serve.disagg.handoff import HandoffError
from fms_fsdp_tpu_torch.serve.kv_cache import SCRATCH_PAGE, ZERO_PAGE, PagedKVCache
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ATOL = 2e-5

_LLAMA_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                 max_expected_seq_len=256)
_MIXTRAL_KW = dict(_LLAMA_KW, hidden_dim=128, num_experts=4, top_k=2,
                   max_expected_seq_len=64)
_MAMBA_KW = dict(d_model=64, n_layer=3, vocab_size=128, d_state=16, headdim=16,
                 chunk_size=8, attn_layer_idx=(1,), d_intermediate=128)
_ATTN_KW = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
J_CFG = {
    "llama": JLlamaConfig(**_LLAMA_KW),
    "mixtral": JMixtralConfig(**_MIXTRAL_KW),
    "mamba": JMambaConfig(attn_cfg=JMambaAttnConfig(**_ATTN_KW), **_MAMBA_KW),
}
CFG = {
    "llama": LlamaConfig(**_LLAMA_KW),
    "mixtral": MixtralConfig(**_MIXTRAL_KW),
    "mamba": MambaConfig(attn_cfg=MambaAttnConfig(**_ATTN_KW), **_MAMBA_KW),
}
_J_INIT = {"llama": j_init, "mixtral": j_mixtral.init_mixtral_params,
           "mamba": j_mamba.init_mamba_params}


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def np_params():
    return {fam: jax.tree.map(np.asarray, init(jax.random.PRNGKey(i), J_CFG[fam]))
            for i, (fam, init) in enumerate(_J_INIT.items())}


def _scfg(**kw):
    kw = {"max_batch": 2, "max_seq_len": 64, "compute_dtype": "float32",
          "page_size": 16, "max_prefill_per_step": 2, "attn_impl": "reference", **kw}
    return kw


def _engines(np_params, fam, **kw):
    """(JAX engine, port engine) on the same weights and ServeConfig."""
    kw = _scfg(**kw)
    return (JServingEngine(jax.tree.map(jnp.asarray, np_params[fam]), J_CFG[fam],
                           JServeConfig(**kw)),
            ServingEngine(params_from_numpy(np_params[fam]), CFG[fam],
                          ServeConfig(**kw), device="cpu"))


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, size=n).tolist() for n in lengths]


# ---------------------------------------------------------------------------
# the codecs: wire bytes equal JAX's
# ---------------------------------------------------------------------------

_NP_DTYPE = {"float32": np.float32, "int8": np.int8,
             "bfloat16": ml_dtypes.bfloat16, "float8_e4m3fn": ml_dtypes.float8_e4m3fn}
_TORCH_DTYPE = {"float32": torch.float32, "int8": torch.int8,
                "bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
_HEADER = {"codec": "pages", "codec_version": 1, "family": "llama", "quant": "none",
           "page_size": 8, "prompt": [3, 5, 7], "generated": [11], "seq_len": 4,
           "alloc_tokens": 4, "max_new_tokens": 6, "n_kv_heads": 2, "head_dim": 16,
           "n_layers": 2}


def _leaf_pair(dtype, seed, shape=(2, 3, 8, 2, 16)):
    """The same leaf as a numpy array (ml_dtypes for 16/8-bit floats) and a
    torch tensor, from one seeded fp32 draw."""
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32) * 3
    if dtype == "int8":
        x = np.clip(np.round(x * 20), -127, 127)
    arr = x.astype(_NP_DTYPE[dtype])
    return arr, torch.from_numpy(x).to(_TORCH_DTYPE[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "float8_e4m3fn"])
def test_page_codec_bytes_equal_jax(dtype):
    """Both packages pack the same header and leaves (plus an fp32 scale
    leaf, as a quantized pool ships) into identical bytes, and each
    unpacks the other's bit for bit."""
    j_k, t_k = _leaf_pair(dtype, 0)
    j_v, t_v = _leaf_pair(dtype, 1)
    j_s, t_s = _leaf_pair("float32", 2, shape=(2, 3, 8, 2, 1))
    j_wire = j_handoff.pack_handoff(_HEADER, {"k": j_k, "v": j_v, "k_scale": j_s})
    t_wire = t_handoff.pack_handoff(_HEADER, {"v": t_v, "k": t_k, "k_scale": t_s})
    assert t_wire == j_wire
    header, arrays = t_handoff.unpack_handoff(j_wire)
    assert header == j_handoff.unpack_handoff(j_wire)[0]
    for name, ref in (("k", t_k), ("v", t_v), ("k_scale", t_s)):
        assert arrays[name].dtype == ref.dtype and arrays[name].shape == ref.shape
        assert torch.equal(arrays[name].view(torch.uint8), ref.view(torch.uint8))
    _, j_arrays = j_handoff.unpack_handoff(t_wire)
    assert j_arrays["k"].dtype == j_k.dtype and j_arrays["k"].tobytes() == j_k.tobytes()
    # the port's own round trip repacks to the same bytes
    assert t_handoff.pack_handoff(header, arrays) == t_wire


def _corrupt(wire, how):
    if how == "crc":
        return wire[:20] + bytes([wire[20] ^ 0xFF]) + wire[21:]
    if how == "magic":
        return b"XXXX" + wire[4:]
    if how == "truncated":
        return wire[:-30]
    if how == "version":
        bad = bytearray(wire[:-4])
        bad[4] = 9
        import struct
        import zlib
        return bytes(bad) + struct.pack("<I", zlib.crc32(bytes(bad)) & 0xFFFFFFFF)
    raise ValueError(how)


@pytest.mark.parametrize("how", ["crc", "magic", "truncated", "version"])
def test_unpack_rejects_corruption_typed(how):
    _, t_k = _leaf_pair("bfloat16", 0)
    wire = t_handoff.pack_handoff(_HEADER, {"k": t_k})
    with pytest.raises(HandoffError):
        t_handoff.unpack_handoff(_corrupt(wire, how))
    with pytest.raises(j_handoff.HandoffError):
        j_handoff.unpack_handoff(_corrupt(wire, how))


def test_unshippable_dtype_and_codec_skew_are_typed():
    with pytest.raises(HandoffError, match="unshippable"):
        t_handoff.pack_handoff({}, {"x": torch.zeros(2, dtype=torch.int32)})
    with pytest.raises(HandoffError, match="version 99, this replica speaks version 1"):
        t_handoff.check_codec_version({"codec": "pages", "codec_version": 99}, "pages", 1)


def test_slab_codec_bytes_equal_jax(np_params):
    """A hybrid Mamba stream's slab frame: JAX's export (header + slab rows
    + attention pages), packed by both packages, gives identical bytes; the
    port's own export of the same stream carries JAX's header and leaves
    within 2e-5; the leaf names split back identically."""
    jeng, teng = _engines(np_params, "mamba")
    prompt = _prompts(3, [7])[0]
    jr, tr = jeng.submit(prompt, 8), teng.submit(prompt, 8)
    for _ in range(3):
        jeng.step()
        teng.step()
    jh, ja = jeng.adapter.export_handoff(jr.rid, jeng._slots.index(jr))
    th, ta = teng.adapter.export_handoff(tr.rid, teng._slots.index(tr))
    assert th == jh
    assert set(ta) == set(ja) == {"slab.0000.conv", "slab.0000.ssd", "slab.0002.conv",
                                  "slab.0002.ssd", "kv.k", "kv.v"}
    for name in ja:
        assert ta[name].dtype == torch.float32
        np.testing.assert_allclose(ta[name].numpy(), np.asarray(ja[name]), atol=ATOL)
    j_wire = j_handoff.pack_handoff(jh, ja)
    t_wire = t_handoff.pack_handoff(
        jh, {n: torch.from_numpy(np.asarray(a).copy()) for n, a in ja.items()})
    assert t_wire == j_wire
    _, arrays = t_handoff.unpack_handoff(j_wire)
    t_layers, t_kv = t_slab.split_slab_leaves(arrays)
    j_layers, j_kv = j_slab.split_slab_leaves(j_handoff.unpack_handoff(j_wire)[1])
    assert sorted(t_layers) == sorted(j_layers) == [0, 2] and set(t_kv) == set(j_kv)
    t_slab.check_slab_header(th, teng.adapter._slab_geometry())
    with pytest.raises(HandoffError, match="n_layer"):
        t_slab.check_slab_header(dict(th, n_layer=4), teng.adapter._slab_geometry())
    with pytest.raises(HandoffError, match="unrecognized leaf"):
        t_slab.split_slab_leaves({"pages.k": arrays["kv.k"]})


# ---------------------------------------------------------------------------
# cross-package disaggregation
# ---------------------------------------------------------------------------

_DISAGG = [("llama", "none"), ("llama", "int8"), ("mixtral", "none"), ("mamba", "none")]


@pytest.mark.parametrize("fam,kv_quant", _DISAGG)
def test_jax_prefill_handoff_resumes_on_port_decode(np_params, fam, kv_quant):
    """JAX's prefill-role engine packs each stream after its first token;
    the port's decode-role engine resumes the bytes and its greedy tokens
    equal JAX's unified engine's. The port's own prefill engine's frames
    carry the same headers and leaves."""
    prompts = _prompts(5, [5, 17, 9, 30])
    ju, _ = _engines(np_params, fam, kv_quant=kv_quant)
    jp, tp = _engines(np_params, fam, kv_quant=kv_quant, role="prefill")
    _, td = _engines(np_params, fam, kv_quant=kv_quant, role="decode")
    ref = [ju.submit(p, 6) for p in prompts]
    ju.run()
    jreqs = [jp.submit(p, 6) for p in prompts]
    treqs = [tp.submit(p, 6) for p in prompts]
    jp.run()
    tp.run()
    resumed = [td.submit_handoff(r.handoff_out) for r in jreqs]
    td.run()
    for r, u in zip(resumed, ref):
        assert r.state == "finished" and r.generated == u.generated
    stats = td.serving_stats()
    assert stats["role"] == 2.0 and stats["handoff_bytes"] == sum(
        len(r.handoff_out) for r in jreqs)
    assert tp.serving_stats()["role"] == 1.0
    for jr, tr in zip(jreqs, treqs):
        jh, ja = j_handoff.unpack_handoff(jr.handoff_out)
        th, ta = t_handoff.unpack_handoff(tr.handoff_out)
        assert th == jh
        for name in ja:
            got = ta[name].float().numpy()
            want = np.asarray(ja[name]).astype(np.float32)
            if ta[name].dtype == torch.int8:  # one rounding step apart at most
                assert np.abs(got - want).max() <= 1
            else:
                np.testing.assert_allclose(got, want, atol=ATOL)


def test_port_pack_stream_migrates_mid_decode(np_params):
    """A live Llama stream packed mid-decode resumes on a sibling with the
    uninterrupted engine's tokens; serving_stats counts the bytes."""
    prompt = _prompts(6, [11])[0]
    _, ref = _engines(np_params, "llama")
    r0 = ref.submit(prompt, 10)
    ref.run()
    _, src = _engines(np_params, "llama")
    req = src.submit(prompt, 10)
    for _ in range(4):
        src.step()
    assert req in src.live_requests() and 0 < len(req.generated) < 10
    data = src.pack_stream(req)
    _, dst = _engines(np_params, "llama", role="decode")
    r2 = dst.submit_handoff(data)
    dst.run()
    assert r2.generated == r0.generated
    assert src.serving_stats()["handoff_bytes"] == len(data)


def test_prefill_handoff_max_bytes_and_role_gates(np_params):
    _, tp = _engines(np_params, "llama", role="prefill", handoff_max_bytes=1000)
    with pytest.raises(RequestRejected) as e:
        tp.submit(list(range(20)), 4)
    assert e.value.reason == "too_large"
    with pytest.raises(ValueError, match="unknown serving role"):
        _engines(np_params, "llama", role="both")
    _, td = _engines(np_params, "llama", role="decode")
    _, jm = _engines(np_params, "mixtral", role="prefill")
    req = jm.submit([1, 2, 3], 4)
    jm.run()
    with pytest.raises(HandoffError, match="family"):
        td.submit_handoff(req.handoff_out)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p_len,chunk,bucket", [(37, 8, 1), (37, 16, 1), (20, 8, 16), (64, 64, 1)])
def test_chunked_prefill_logits_match(np_params, p_len, chunk, bucket):
    """The first-token logits of the chunked path within 2e-5 of the
    port's whole-prompt path and of JAX's chunked path (bucketed prompts
    included: the padding chunks after the last real position)."""
    prompt = _prompts(7, [p_len])[0]
    je, te = _engines(np_params, "llama", prefill_chunk_tokens=chunk, prefill_bucket=bucket)
    _, whole = _engines(np_params, "llama", prefill_bucket=bucket)
    te.adapter.prefill_start(0, 0, prompt)
    je.adapter.prefill_start(0, 0, prompt)
    chunks, row, jrow = 0, None, None
    while row is None:
        row = te.adapter.prefill_chunk(0)
        jrow = je.adapter.prefill_chunk(0)
        chunks += 1
    assert jrow is not None and chunks == -(-te.adapter._padded(p_len) // chunk)
    ref = whole.adapter.prefill(0, 0, prompt)
    np.testing.assert_allclose(row.numpy(), ref.numpy(), atol=ATOL)
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow), atol=ATOL)
    # the pages the final write landed equal the whole path's
    for name in ("k", "v"):
        np.testing.assert_allclose(te.cache.gather_pages(0)[name].numpy(),
                                   whole.cache.gather_pages(0)[name].numpy(), atol=ATOL)


def test_chunked_prefill_engine_tokens_interleave(np_params):
    """An engine with 8-token chunks serves a ragged wave with JAX's
    chunked engine's tokens, counts its chunks, and keeps a short request
    decoding while a long prompt streams in."""
    prompts = _prompts(8, [40, 3, 25])
    je, te = _engines(np_params, "llama", prefill_chunk_tokens=8, max_batch=3)
    jr = [je.submit(p, 5) for p in prompts]
    tr = [te.submit(p, 5) for p in prompts]
    te.step()
    assert tr[0].rid in te._chunking and te._slots[0] is tr[0]
    je.run()
    te.run()
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert te.serving_stats()["prefill_chunks"] == je.serving_stats()["prefill_chunks"] == 9


# ---------------------------------------------------------------------------
# pages: scatter, defrag, table_version
# ---------------------------------------------------------------------------


def _filled_cache(quant="none"):
    cache = PagedKVCache(2, 10, 4, 2, 8, dtype=torch.float32, quant=quant, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for rid, n in ((0, 6), (1, 9), (2, 3)):
        cache.ensure(rid, n)
        k = torch.randn((2, 4 * cache.pages_needed(n), 2, 8), generator=gen)
        cache.write_prompt(rid, k, -k)
    return cache


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_scatter_pages_keeps_reserved_and_bumps_version(quant):
    src = _filled_cache(quant)
    dst = PagedKVCache(2, 10, 4, 2, 8, dtype=torch.float32, quant=quant, device="cpu")
    dst.ensure(7, 4)
    scratch = {n: p[:, SCRATCH_PAGE].clone() for n, p in dst.pools.items()}
    v0 = dst.table_version
    arrays = src.gather_pages(1)
    if quant == "int8":
        assert arrays["k"].dtype == torch.int8 and arrays["k_scale"].dtype == torch.float32
    assert dst.scatter_pages(3, arrays, src.tokens_of(1))
    assert dst.table_version > v0 and dst.tokens_of(3) == src.tokens_of(1)
    assert ZERO_PAGE not in dst.pages_of(3) and SCRATCH_PAGE not in dst.pages_of(3)
    for name, pool in dst.pools.items():
        assert not pool[:, ZERO_PAGE].any()
        assert torch.equal(pool[:, SCRATCH_PAGE], scratch[name])
        assert torch.equal(dst.gather_pages(3)[name], arrays[name])
    with pytest.raises(HandoffError, match="leaves"):
        dst.scatter_pages(4, {"k": arrays["k"]}, 3)
    free = dst.pages_free
    bad = dict(arrays, k=torch.empty(arrays["k"].shape, dtype=arrays["k"].dtype, device="meta"))
    with pytest.raises(HandoffError, match="pages freed"):
        dst.scatter_pages(5, bad, 3)
    assert dst.pages_free == free and dst.pages_of(5) == []


def test_defrag_matches_jax_and_keeps_reserved():
    """The same allocation history through both packages' allocators:
    defrag moves the same pages, gives the same page lists, and the moved
    pools hold JAX's content; reserved pages stay put, the version bumps."""
    t = _filled_cache()
    j = JPagedKVCache(2, 10, 4, 2, 8, dtype=jnp.float32)
    for rid, n in ((0, 6), (1, 9), (2, 3)):
        j.ensure(rid, n)
    j.pools = {n: jnp.asarray(p.numpy().copy()) for n, p in t.pools.items()}
    t.free(0)
    j.free(0)
    v0 = t.table_version
    before = {rid: t.gather_pages(rid) for rid in (1, 2)}
    zero = {n: p[:, ZERO_PAGE].clone() for n, p in t.pools.items()}
    moves = t.defrag()
    assert moves == j.defrag() > 0 and t.defrag_moves == moves
    assert t.table_version == v0 + 1
    for rid in (1, 2):
        assert t.pages_of(rid) == j.pages_of(rid)
        for name in ("k", "v"):
            assert torch.equal(t.gather_pages(rid)[name], before[rid][name])
    for name, pool in t.pools.items():
        np.testing.assert_array_equal(pool.numpy(), np.asarray(j.pools[name]))
        assert torch.equal(pool[:, ZERO_PAGE], zero[name])
    assert t.defrag() == 0 and t.table_version == v0 + 1  # nothing to move


@pytest.mark.parametrize("bump", [True, False])
def test_defrag_decode_logits_and_stale_table_control(np_params, bump):
    """A decode step after defrag gives the step's logits before it,
    bitwise; with the bump undone (the control), the adapter's cached page
    table points at the old pages and the logits are wrong."""
    _, eng = _engines(np_params, "llama", max_batch=3)
    reqs = [eng.submit(p, n) for p, n in zip(_prompts(9, [20, 5, 30]), (3, 30, 30))]
    while reqs[0].state != "finished":
        eng.step()
    assert reqs[1].state == reqs[2].state == "running"
    ad = eng.adapter
    slot_rids = [r.rid if r is not None else None for r in eng._slots]
    lens, toks = eng._lens.copy(), eng._tokens.copy()
    _, before = ad.decode(slot_rids, lens, toks, eng.generator)
    v0 = eng.cache.table_version
    assert eng.cache.defrag() >= 1
    if not bump:
        eng.cache.table_version = v0
    _, after = ad.decode(slot_rids, lens, toks, eng.generator)
    live = [s for s, r in enumerate(slot_rids) if r is not None]
    if bump:
        assert torch.equal(after[live], before[live])
    else:
        assert (after[live] - before[live]).abs().max() > 1e-3
