"""PyTorch port, ops: held against the JAX package on the same inputs.

Inputs come from numpy seeds and go through both the JAX function (on
CPU; Pallas kernels in interpret mode) and its counterpart in
``fms_fsdp_tpu_torch``. Tolerances are the JAX tests' own: fp32 atol
2e-5 for the plain ops (tests/test_flash_attention.py) and 1e-5 for
paged attention (tests/test_serving.py:215).

The CUDA kernel against its plain version on the card is in
tests/test_torch_card.py, which imports no JAX.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.ops import attention as j_attention
from fms_fsdp_tpu.ops import norms as j_norms
from fms_fsdp_tpu.ops import paged_attention as j_paged
from fms_fsdp_tpu.ops import quant as j_quant
from fms_fsdp_tpu.ops import rope as j_rope
from fms_fsdp_tpu_torch.ops import attention as t_attention
from fms_fsdp_tpu_torch.ops import norms as t_norms
from fms_fsdp_tpu_torch.ops import paged_attention as t_paged
from fms_fsdp_tpu_torch.ops import quant as t_quant
from fms_fsdp_tpu_torch.ops import rope as t_rope

ATOL_OPS = 2e-5
ATOL_PAGED = 1e-5


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(port, ref, atol):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    err = float(np.abs(port - ref).max())
    assert err <= atol, err


# ---------------------------------------------------------------------------
# norms, rotary, attention
# ---------------------------------------------------------------------------


def test_rms_norm_matches_jax():
    x, w = _rand(0, (3, 5, 64)), _rand(1, (64,))
    ref = j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    _close(t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           ref, ATOL_OPS)


@pytest.mark.parametrize("seq_len,head_dim,theta", [(64, 16, 1e4), (2048, 128, 5e5)])
def test_rope_table_matches_jax(seq_len, head_dim, theta):
    jc, js = j_rope.rope_table(seq_len, head_dim, theta)
    tc, ts = t_rope.rope_table(seq_len, head_dim, theta)
    _close(tc, jc, ATOL_OPS)
    _close(ts, js, ATOL_OPS)


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rotary_matches_jax(with_positions):
    x = _rand(2, (2, 8, 4, 16))
    pos = np.random.default_rng(3).integers(0, 64, (2, 8)).astype(np.int32)
    jc, js = j_rope.rope_table(64, 16, 1e4)
    tc, ts = t_rope.rope_table(64, 16, 1e4)
    ref = j_rope.apply_rotary(
        jnp.asarray(x), jc, js, jnp.asarray(pos) if with_positions else None
    )
    out = t_rope.apply_rotary(
        torch.from_numpy(x), tc, ts,
        torch.from_numpy(pos).long() if with_positions else None,
    )
    _close(out, ref, ATOL_OPS)


@pytest.mark.parametrize("sq,sk,causal", [(8, 8, True), (4, 8, True), (8, 8, False)])
def test_xla_attention_matches_jax(sq, sk, causal):
    q, k, v = _rand(4, (2, sq, 4, 16)), _rand(5, (2, sk, 2, 16)), _rand(6, (2, sk, 2, 16))
    ref = j_attention.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal
    )
    out = t_attention.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    _close(out, ref, ATOL_OPS)


def test_gqa_attend_matches_jax():
    q, k, v = _rand(7, (2, 3, 4, 16)), _rand(8, (2, 12, 2, 16)), _rand(9, (2, 12, 2, 16))
    pos = np.asarray([[2, 5, 11], [0, 1, 7]], np.int32)
    ref = j_paged.gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    out = t_paged.gqa_attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos).long(),
    )
    _close(out, ref, ATOL_OPS)


# ---------------------------------------------------------------------------
# KV quantization
# ---------------------------------------------------------------------------


def _to_torch(a):
    """numpy (incl. ml_dtypes fp8 / bf16 from JAX) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_kv_quantize_bitwise_vs_jax(wire, dtype):
    """int8 and e4m3 values and scales are bit-identical to JAX's: both
    round half-to-even (torch.round / jnp.round, and the fp32 -> e4m3fn
    cast) after the same clamp, and the absmax is divided in the input
    dtype first in both. An all-zero row keeps scale 0."""
    x = _rand(10, (4, 8, 2, 16)) * 3.0
    x[0, 0, 0] = 0.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _to_torch(np.asarray(jx))
    jq, js = j_quant.kv_quantize(jx, wire)
    tq, ts = t_quant.kv_quantize(tx, wire)
    assert tq.dtype == _to_torch(np.asarray(jq)).dtype
    assert torch.equal(tq.view(torch.uint8), _to_torch(np.asarray(jq)).view(torch.uint8))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0, 0, 0, 0]) == 0.0
    back = t_quant.kv_dequantize(tq, ts, torch.float32)
    _close(back, j_quant.kv_dequantize(jq, js, jnp.float32), 0.0)


def test_kv_quantize_rejects_unknown_wire():
    with pytest.raises(ValueError):
        t_quant.kv_quantize(torch.zeros(2, 4), "int4")


# ---------------------------------------------------------------------------
# paged attention: the port's plain versions vs JAX's reference and its
# Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


def _paged_case(nq, nkv, P=12, ps=8, hd=128, seed=2, table=None, lens=None):
    kp, vp = _rand(seed, (P, ps, nkv, hd)), _rand(seed + 1, (P, ps, nkv, hd))
    q = _rand(seed + 2, (len(table), nq, hd))
    return q, kp, vp, np.asarray(table, np.int32), np.asarray(lens, np.int32)


# tests/test_serving.py:206-230 and tests/test_speculative.py:338-396
_SERVING_TABLE = [[2, 3, 4, 0], [5, 6, 0, 0], [7, 8, 9, 2]]
_SERVING_LENS = [17, 9, 30]
_V2_TABLE = [[2, 3, 4, 5, 6], [7, 8, 9, 0, 0], [10, 11, 2, 3, 4]]
_V2_LENS = [33, 17, 39]


@pytest.mark.parametrize("nq,nkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("block_kv", [8, 16, 32])
def test_paged_reference_matches_jax_reference_and_kernel(nq, nkv, block_kv):
    table, lens = (_SERVING_TABLE, _SERVING_LENS) if block_kv == 8 else (_V2_TABLE, _V2_LENS)
    q, kp, vp, table, lens = _paged_case(nq, nkv, table=table, lens=lens)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lens)]
    targs = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    j_ref = j_paged.paged_attention_reference(*jargs)
    j_ker = j_paged.paged_attention_kernel(*jargs, block_kv=block_kv, interpret=True)
    port = t_paged.paged_attention_reference(*targs)
    _close(port, j_ref, ATOL_PAGED)
    _close(port, j_ker, ATOL_PAGED)
    # the kernel wrapper on CPU tensors runs the plain version
    port_k = t_paged.paged_attention_kernel(*targs, block_kv=block_kv)
    _close(port_k, j_ker, ATOL_PAGED)


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("block_kv", [8, 16])
def test_paged_quantized_matches_jax_kernel(wire, block_kv):
    """Quantized pools: the port's kernel wrapper (plain version on CPU)
    against JAX's v2 kernel reading the same quantized pools natively,
    and the port's reference over dequantised pools against JAX's."""
    q, k, v, table, lens = _paged_case(8, 2, P=10, seed=5, table=_SERVING_TABLE,
                                       lens=_SERVING_LENS)
    kq, ks = j_quant.kv_quantize(jnp.asarray(k), wire)
    vq, vs = j_quant.kv_quantize(jnp.asarray(v), wire)
    jt, jl = jnp.asarray(table), jnp.asarray(lens)
    j_ker = j_paged.paged_attention_kernel(
        jnp.asarray(q), kq, vq, jt, jl, k_scales=ks, v_scales=vs,
        block_kv=block_kv, compute_dtype=jnp.float32, interpret=True,
    )
    j_ref = j_paged.paged_attention_reference(
        jnp.asarray(q), j_quant.kv_dequantize(kq, ks, jnp.float32),
        j_quant.kv_dequantize(vq, vs, jnp.float32), jt, jl,
    )
    tq, tt, tl = torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(lens)
    tkq, tvq = _to_torch(kq), _to_torch(vq)
    tks, tvs = _to_torch(ks), _to_torch(vs)
    port_k = t_paged.paged_attention_kernel(
        tq, tkq, tvq, tt, tl, k_scales=tks, v_scales=tvs, block_kv=block_kv,
        compute_dtype=torch.float32,
    )
    _close(port_k, j_ker, ATOL_PAGED)
    port_ref = t_paged.paged_attention_reference(
        tq, t_quant.kv_dequantize(tkq, tks, torch.float32),
        t_quant.kv_dequantize(tvq, tvs, torch.float32), tt, tl,
    )
    _close(port_ref, j_ref, ATOL_PAGED)


@pytest.mark.parametrize("block_kv", [8, 16])
def test_paged_zero_length_rows_finite(block_kv):
    """Rows at position 0 attend one token: finite, and equal to JAX."""
    q, kp, vp, table, lens = _paged_case(4, 2, P=6, seed=7, table=[[2, 3], [4, 5]],
                                         lens=[0, 0])
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lens)]
    j_ker = j_paged.paged_attention_kernel(*jargs, block_kv=block_kv, interpret=True)
    port = t_paged.paged_attention_kernel(
        *[torch.from_numpy(a) for a in (q, kp, vp, table, lens)], block_kv=block_kv
    )
    assert torch.isfinite(port).all()
    _close(port, j_ker, ATOL_PAGED)
    _close(port, j_paged.paged_attention_reference(*jargs), ATOL_PAGED)


def test_paged_kernel_contract_errors():
    kp = torch.zeros(4, 8, 2, 128)
    q = torch.zeros(1, 4, 128)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.zeros(1, dtype=torch.int32)
    for bad in (12, 0, -8):
        with pytest.raises(ValueError, match="block_kv"):
            t_paged.paged_attention_kernel(q, kp, kp, table, lens, block_kv=bad)
    with pytest.raises(ValueError, match="together"):
        t_paged.paged_attention_kernel(q, kp, kp, table, lens,
                                       k_scales=torch.zeros(4, 8, 2, 1))
    with pytest.raises(ValueError, match="impl"):
        t_paged.paged_attention(q, kp, kp, table, lens, impl="pallas")


def test_paged_dispatch_auto_is_reference_on_cpu():
    q, kp, vp, table, lens = _paged_case(8, 2, table=_SERVING_TABLE, lens=_SERVING_LENS)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    t_paged.reset_launches()
    out = t_paged.paged_attention(*args, impl="auto")
    assert torch.equal(out, t_paged.paged_attention_reference(*args))
    # the plain version on CPU tensors is not a kernel launch
    assert t_paged.LAUNCHES == {"v1": 0, "v2": 0}


# ---------------------------------------------------------------------------
# split-KV: the kernel's grid planner and its merge rule, in plain fp32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,nkv,capacity,page,sm,want", [
    (8, 8, 2048, 64, 132, (256, 8)),       # the kernels phase: 512 blocks
    (1, 8, 16384, 64, 132, (256, 64)),     # one long row
    (8, 8, 2048, 16, 132, (256, 8)),       # page 16: 16 pages a split
    (1, 8, 2048, 16, 132, (64, 32)),       # few rows: splits shrink to fill the card
    (2, 1, 64, 16, 132, (64, 1)),          # a cache shorter than one split
    (1, 1, 80, 16, 132, (64, 2)),          # capacity not a multiple of the stage
    (8, 8, 2048, 512, 132, (512, 4)),      # a page longer than a split
    (4, 2, 96, 32, 132, (64, 2)),
])
def test_decode_splits_shapes(batch, nkv, capacity, page, sm, want):
    split, n = t_paged.decode_splits(batch, nkv, capacity, page, sm)
    assert (split, n) == want
    assert split % page == 0 and split % t_paged.STAGE_KEYS == 0
    assert split * n >= capacity > split * (n - 1)


def test_decode_splits_fill_the_card_and_reject_bad_sizes():
    # at least two blocks per SM wherever a split can still shrink
    for batch in (1, 2, 8, 32):
        split, n = t_paged.decode_splits(batch, 8, 4096, 16, 132)
        assert batch * 8 * n >= 2 * 132 or split == t_paged.STAGE_KEYS
    for bad in ((0, 8, 2048, 64, 132), (8, 8, 0, 64, 132), (8, 8, 2048, 64, 0)):
        with pytest.raises(ValueError, match="positive"):
            t_paged.decode_splits(*bad)


def _split_merge(q, kp, vp, table, lens, split_keys, n_splits):
    """The kernel's algorithm in plain fp32: each split's base-2 (m, l, o)
    over its keys, a split past the row's length skipped, then the merge
    o = sum(o_s 2^(m_s - M)) / sum(l_s 2^(m_s - M)), zeros where l == 0."""
    b, nq, hd = q.shape
    nkv = kp.shape[2]
    g = nq // nkv
    k = t_paged.gather_pages(kp, table).float()
    v = t_paged.gather_pages(vp, table).float()
    q2 = q.float() * (hd**-0.5 * t_paged.LOG2E)
    s = torch.einsum("bkgh,bskh->bkgs", q2.reshape(b, nkv, g, hd), k)
    out = torch.zeros(b, nkv, g, hd)
    for row in range(b):
        pos = int(lens[row])
        n_keys = 0 if pos < 0 else min(pos + 1, k.shape[1])
        parts = []
        for sp in range(n_splits):
            lo, hi = sp * split_keys, min((sp + 1) * split_keys, n_keys)
            if lo >= n_keys:
                continue
            ss = s[row, ..., lo:hi]
            m = ss.amax(-1)
            p = torch.exp2(ss - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgs,skh->kgh", p, v[row, lo:hi])))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        f = [torch.exp2(m - mx) for m, _, _ in parts]
        l_sum = sum(l * fi for (_, l, _), fi in zip(parts, f))
        o_sum = sum(o * fi[..., None] for (_, _, o), fi in zip(parts, f))
        out[row] = torch.where(l_sum[..., None] == 0, torch.zeros(()), o_sum / l_sum[..., None])
    return out.reshape(b, nq * hd)


@pytest.mark.parametrize("nq,nkv", [(4, 2), (8, 1), (8, 8)])
def test_split_merge_matches_references(nq, nkv):
    """Four 64-key splits over a 256-key cache (page 8): rows of one key,
    across a page and a split boundary, the whole cache, and a row at -1
    (no key, l == 0) whose splits are all empty. fp32 against the port's
    reference and JAX's at the paged tests' 1e-5."""
    ps, maxp = 8, 32
    lens = [0, 70, 255, 130, -1]
    table = np.zeros((len(lens), maxp), np.int32)
    perm = np.random.default_rng(9).permutation(len(lens) * maxp) + 2
    for r, pos in enumerate(lens):
        n = max(pos, 0) // ps + 1
        table[r, :n] = perm[r * maxp: r * maxp + n]
    q, kp, vp, table, lens = _paged_case(nq, nkv, P=len(lens) * maxp + 2, ps=ps, seed=4,
                                         table=table, lens=lens)
    split_keys, n_splits = t_paged.decode_splits(len(lens), nkv, maxp * ps, ps, 132)
    assert (split_keys, n_splits) == (64, 4)
    targs = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    got = _split_merge(*targs, split_keys, n_splits)
    assert torch.count_nonzero(got[-1]) == 0
    live = slice(0, len(lens) - 1)
    tq, tk, tv, tt, tl = targs
    port = t_paged.paged_attention_reference(tq[live], tk, tv, tt[live], tl[live])
    _close(got[live], port, ATOL_PAGED)
    jax_ref = j_paged.paged_attention_reference(
        *[jnp.asarray(a) for a in (q[live], kp, vp, table[live], lens[live])])
    _close(got[live], jax_ref, ATOL_PAGED)


def test_drop_split_control_attends_the_keys_past_the_split():
    """The control of the card checks (chip_smoke.py, tests/test_torch_card.py):
    the plain version over the page table without a row's first split and
    the position moved back by it attends exactly keys split_keys..pos; on
    rows of two to four 64-key splits it moves the output by more than
    ``REL_TOL`` of the 16-bit types."""
    ps, maxp = 8, 32
    lens = [70, 255, 130, 64]
    table = np.zeros((len(lens), maxp), np.int32)
    perm = np.random.default_rng(5).permutation(len(lens) * maxp) + 2
    for r, pos in enumerate(lens):
        table[r, :pos // ps + 1] = perm[r * maxp: r * maxp + pos // ps + 1]
    q, kp, vp, table, lens = [torch.from_numpy(a) for a in _paged_case(
        4, 2, P=len(lens) * maxp + 2, ps=ps, seed=6, table=table, lens=lens)]
    split_keys, _ = t_paged.decode_splits(len(lens), 2, maxp * ps, ps, 132)
    assert split_keys == 64
    control = t_paged.paged_attention_plain(
        q, kp, vp, table[:, split_keys // ps:].contiguous(), lens - split_keys)
    k, v = t_paged.gather_pages(kp, table), t_paged.gather_pages(vp, table)
    for r, pos in enumerate(lens.tolist()):
        kr, vr = k[r, split_keys:pos + 1], v[r, split_keys:pos + 1]  # (n, 2, H)
        qr = q[r].reshape(2, 2, -1)
        s = torch.einsum("kgh,nkh->kgn", qr, kr) * q.shape[-1] ** -0.5
        want = torch.einsum("kgn,nkh->kgh", torch.softmax(s, -1), vr).reshape(-1)
        _close(control[r], want, ATOL_PAGED)
    ref = t_paged.paged_attention_reference(q, kp, vp, table, lens)
    rel = (control - ref).norm(dim=1) / ref.norm(dim=1)
    assert rel.min().item() > t_paged.REL_TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# the kernel build (the card compiles; the report parsing runs anywhere)
# ---------------------------------------------------------------------------


def test_build_key_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a source or to a shared ``csrc/*.cuh`` header gives a new
    build directory; any other file of the directory does not."""
    from fms_fsdp_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = cuda_build._paths("k")[1]
    (tmp_path / "notes.txt").write_text("x")
    assert cuda_build._paths("k")[1] == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = cuda_build._paths("k")[1]
    assert second != first
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert cuda_build._paths("k")[1] not in (first, second)


def test_ptxas_report_parsing_and_missing_nvcc(monkeypatch, tmp_path):
    from fms_fsdp_tpu_torch.ops import cuda_build

    report = (
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 38112 bytes smem, 400 bytes cmem[0]\n"
    )
    assert cuda_build.ptxas_summary(report) == {"_Z3fooPf": {
        "registers": 96, "static_smem_bytes": 38112, "spill_stores": 8, "spill_loads": 12,
    }}
    src, out_dir = cuda_build._paths("paged_decode")
    assert os.path.exists(src) and os.path.basename(out_dir).startswith("paged_decode-")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.find_nvcc()
