"""PyTorch port on an NVIDIA card: the CUDA paged-decode, flash-attention
and SSD kernels against their plain versions, the engine through the kernel
against the engine through the reference attention, and one full-width
train step through the flash kernels against the same step through the
einsum attention.

Every test here is marked ``card`` and asks for a card inside a fixture,
so it skips where there is none. The file imports no JAX, so it runs on
a machine without it:

    python -m pytest tests/test_torch_card.py -m card --noconftest

(``--noconftest`` because tests/conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.models.llama import init_llama_params
from fms_fsdp_tpu_torch.ops import paged_attention as t_paged
from fms_fsdp_tpu_torch.ops import quant as t_quant
from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine

# llama3_8b decode shapes: B=8, Nq=32, Nkv=8, H=128, page 64, 32 pages/row
_LENS = [0, 63, 64, 127, 2047, 300, 1500, 1024]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest tests/test_torch_card.py -m card --noconftest")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    )


def _case(device, kind):
    B, nq, nkv, hd, ps, maxp = 8, 32, 8, 128, 64, 32
    P = B * maxp + 2
    q_dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    q = _rand(11, (B, nq, hd)).to(device, q_dtype)
    k = _rand(12, (P, ps, nkv, hd)).to(device)
    v = _rand(13, (P, ps, nkv, hd)).to(device)
    ks = vs = None
    if kind in ("int8", "fp8"):
        k, ks = t_quant.kv_quantize(k, kind)
        v, vs = t_quant.kv_quantize(v, kind)
    else:
        k, v = k.to(q_dtype), v.to(q_dtype)
    perm = np.random.default_rng(14).permutation(P - 2) + 2
    table = np.zeros((B, maxp), np.int32)
    for b, pos in enumerate(_LENS):
        n = pos // ps + 1
        table[b, :n] = perm[b * maxp: b * maxp + n]
    table = torch.from_numpy(table).to(device)
    lens = torch.tensor(_LENS, dtype=torch.int32, device=device)
    return q, k, v, table, lens, ks, vs


def _split_case(device, kind, nq, nkv, ps, maxp, lens, seed=31):
    """A ragged decode batch whose rows own disjoint pages; table slots
    past a row's length point at the zero page 0."""
    B = len(lens)
    P = B * maxp + 2
    rng = np.random.default_rng(seed)
    q_dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((B, nq, 128)).astype(np.float32)).to(device, q_dtype)
    k = torch.from_numpy(rng.standard_normal((P, ps, nkv, 128)).astype(np.float32)).to(device)
    v = torch.from_numpy(rng.standard_normal((P, ps, nkv, 128)).astype(np.float32)).to(device)
    k[0].zero_()
    v[0].zero_()
    ks = vs = None
    if kind in ("int8", "fp8"):
        k, ks = t_quant.kv_quantize(k, kind)
        v, vs = t_quant.kv_quantize(v, kind)
    else:
        k, v = k.to(q_dtype), v.to(q_dtype)
    perm = rng.permutation(P - 2) + 2
    table = np.zeros((B, maxp), np.int32)
    for b, pos in enumerate(lens):
        n = max(pos, 0) // ps + 1
        table[b, :n] = perm[b * maxp: b * maxp + n]
    return (q, k, v, torch.from_numpy(table).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device), ks, vs)


# (nq, nkv, page, pages per row, positions): the split planner's corners at
# 256-key splits: one key, two, a page boundary, exactly one split, one
# past it, many splits, every row inside one split, group 1 / 4 / 8, page
# 16 and 64, and one row of 16,383 keys (64 splits)
_SPLIT_CASES = {
    "corners-g4-p64": (32, 8, 64, 32, [0, 1, 63, 64, 255, 256, 2047, 1000]),
    "short-g4-p16": (32, 8, 16, 128, [0, 5, 15, 16, 100, 200, 254, 31]),
    "g1-p16": (8, 8, 16, 32, [0, 17, 255, 511, 300]),
    "g8-p64": (32, 4, 64, 16, [1023, 0, 255, 256, 640]),
    "long-b1": (32, 8, 64, 256, [16382]),
}


def _row_rel_err(out, ref):
    """Per row: ||out - ref|| / ||ref|| over all its query heads."""
    ref = ref.float().flatten(1)
    return (out.float().flatten(1) - ref).norm(dim=1) / ref.norm(dim=1)


def _check_paged(q, k, v, table, lens, ks, vs, out, atol):
    """``out`` against the plain version: max abs within ``atol``; per row
    within ``REL_TOL``, which the control (the plain version with each
    row's first split of keys left out) exceeds on every row with keys
    past that split."""
    ref = t_paged.paged_attention_plain(q, k, v, table, lens, ks, vs)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= atol
    tol = t_paged.REL_TOL[q.dtype]
    rel = _row_rel_err(out, ref)
    assert rel.max().item() <= tol, rel.tolist()
    split_keys, _ = t_paged.decode_splits(
        q.shape[0], k.shape[2], table.shape[1] * k.shape[1], k.shape[1],
        torch.cuda.get_device_properties(0).multi_processor_count)
    pages = split_keys // k.shape[1]
    rows = (lens >= split_keys).nonzero().flatten()
    if rows.numel():
        control = t_paged.paged_attention_plain(
            q[rows].contiguous(), k, v, table[rows, pages:].contiguous(),
            lens[rows] - split_keys, ks, vs)
        rel_control = _row_rel_err(control, ref[rows])
        assert rel_control.min().item() > tol, rel_control.tolist()


# head_dim 128 (the kernel's), two layers, tiny vocab
_SMALL = LlamaConfig(src_vocab_size=128, emb_dim=256, nheads=2, kvheads=1,
                     nlayers=2, max_expected_seq_len=256)


class TestPagedDecodeCard:
    """The paged-decode kernel (csrc/paged_decode.cu): ``-k paged``."""

    @pytest.mark.card
    @pytest.mark.parametrize("kind,atol", [("bf16", 2e-2), ("fp32", 1e-5),
                                           ("int8", 2e-2), ("fp8", 2e-2)])
    def test_card_kernel_matches_plain(self, cuda_device, kind, atol):
        """Tolerances: fp32 as tests/test_serving.py:215; bf16 and the
        quantized pools (bf16 compute) at 2e-2, a few bf16 ulps at |out| ~ 1;
        and per row ``REL_TOL``, which the first-split-dropped control fails."""
        q, k, v, table, lens, ks, vs = _case(cuda_device, kind)
        t_paged.reset_launches()
        out = t_paged.paged_attention_kernel(q, k, v, table, lens, k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        assert t_paged.LAUNCHES["v2" if ks is not None else "v1"] == 1
        _check_paged(q, k, v, table, lens, ks, vs, out, atol)

    @pytest.mark.card
    @pytest.mark.parametrize("kind,atol", [("bf16", 2e-2), ("fp32", 1e-5),
                                           ("int8", 2e-2), ("fp8", 2e-2)])
    @pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
    def test_card_kernel_split_cases_match_plain(self, cuda_device, case, kind, atol):
        """The split-KV kernel against its plain version at the planner's
        corner cases, with the tolerances and the control of
        test_card_kernel_matches_plain."""
        nq, nkv, ps, maxp, lens = _SPLIT_CASES[case]
        q, k, v, table, lens_t, ks, vs = _split_case(cuda_device, kind, nq, nkv, ps, maxp, lens)
        split_keys, n_splits = t_paged.decode_splits(
            len(lens), nkv, maxp * ps, ps, torch.cuda.get_device_properties(0).multi_processor_count)
        assert split_keys % ps == 0 and split_keys * n_splits >= maxp * ps
        t_paged.reset_launches()
        out = t_paged.paged_attention_kernel(q, k, v, table, lens_t, k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        assert t_paged.LAUNCHES["v2" if ks is not None else "v1"] == 1
        _check_paged(q, k, v, table, lens_t, ks, vs, out, atol)

    @pytest.mark.card
    def test_card_kernel_row_without_keys_writes_zeros(self, cuda_device):
        """A row whose position is negative attends no key (l == 0): the
        kernel writes zeros there, not NaN, and the other rows are unchanged."""
        q, k, v, table, lens, _, _ = _split_case(cuda_device, "bf16", 32, 8, 64, 8, [100, 300])
        want = t_paged.paged_attention_kernel(q, k, v, table, lens)
        lens_neg = lens.clone()
        lens_neg[0] = -1
        out = t_paged.paged_attention_kernel(q, k, v, table, lens_neg)
        torch.cuda.synchronize()
        assert torch.count_nonzero(out[0]) == 0
        assert torch.equal(out[1], want[1])

    @pytest.mark.card
    def test_card_kernel_rejects_bad_input(self, cuda_device):
        q, k, v, table, lens, _, _ = _case(cuda_device, "bf16")
        with pytest.raises(ValueError, match="int32"):
            t_paged.paged_attention_kernel(q, k, v, table.long(), lens)
        with pytest.raises(ValueError, match="contiguous"):
            t_paged.paged_attention_kernel(
                q.transpose(0, 1).contiguous().transpose(0, 1), k, v, table, lens
            )
        with pytest.raises(ValueError, match="dtype"):
            t_paged.paged_attention_kernel(q.float(), k, v, table, lens)
        with pytest.raises(ValueError, match="head_dim"):
            t_paged.paged_attention_kernel(q[..., :64].contiguous(), k[..., :64].contiguous(),
                                           v[..., :64].contiguous(), table, lens)

    @pytest.mark.card
    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_card_engine_kernel_tokens_match_reference(self, cuda_device, kv_quant):
        """fp32 greedy decode through the kernel picks the same tokens as
        through the reference attention, and launches once per layer per
        decode step."""
        params = init_llama_params(torch.Generator(device=cuda_device).manual_seed(0), _SMALL)
        plans = [([5, 9, 2, 7], 6), ([11, 3, 8, 1, 4, 4, 9], 9), ([7] * 20, 5)]
        out = {}
        for impl in ("reference", "kernel"):
            eng = ServingEngine(params, _SMALL, ServeConfig(
                max_batch=2, max_seq_len=64, page_size=16, compute_dtype="float32",
                attn_impl=impl, kv_quant=kv_quant, max_prefill_per_step=2,
            ))
            reqs = [eng.submit(p, n) for p, n in plans]
            t_paged.reset_launches()
            eng.run()
            out[impl] = [r.generated for r in reqs]
            if impl == "kernel":
                key = "v2" if kv_quant != "none" else "v1"
                assert t_paged.LAUNCHES[key] == eng.decode_steps * _SMALL.nlayers
        assert out["kernel"] == out["reference"]


# ---------------------------------------------------------------------------
# flash attention (training path)
# ---------------------------------------------------------------------------


def _flash_case(device, dtype, b, sq, sk, nq, nkv, seed=21):
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, nq, 128), (b, sk, nkv, 128), (b, sk, nkv, 128), (b, sq, nq, 128)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in shapes]


def _flash_all(fa, q, k, v, do, kernel, causal=True, block_k=None):
    """o, lse, dq, dk, dv of one call through the kernels (the forward and
    dq at key tile ``block_k``, None for the default) or the plain
    versions, with delta from the output of the same path."""
    fwd, dq_fn, dkv_fn = ((fa.flash_fwd, fa.flash_dq, fa.flash_dkv) if kernel else
                          (fa.flash_fwd_plain, fa.flash_dq_plain, fa.flash_dkv_plain))
    tile = {"block_k": block_k} if kernel and block_k else {}
    o, lse = fwd(q, k, v, causal=causal, **tile)
    delta = torch.einsum("bsnh,bsnh->bns", o.float(), do.float()).contiguous()
    dq = dq_fn(q, k, v, do, lse, delta, causal=causal, **tile)
    dk, dv = dkv_fn(q, k, v, do, lse, delta, causal=causal)
    return [o, lse, dq, dk, dv]


def _rel_err(a, r):
    r = r.float()
    return ((a.float() - r).norm() / r.norm()).item()


def _bwd_per_block(fa, q, k, v, do, got, causal):
    """Each 128-row dq block and 128-key dk/dv block of the backward
    kernels (``got``: the kernels' o, lse, dq, dk, dv) within
    ``BF16_BLOCK_REL_TOL`` of the plain backward on the same inputs, the
    kernel forward's lse and delta; the control (that plain backward with
    the last 64-row query tile of the last head and batch left out of key
    block 0's walk) beyond it on the one block of each output it changes."""
    lse = got[1]
    delta = torch.einsum("bsnh,bsnh->bns", got[0].float(), do.float()).contiguous()
    kw = dict(causal=causal)
    ref = [fa.flash_dq_plain(q, k, v, do, lse, delta, **kw),
           *fa.flash_dkv_plain(q, k, v, do, lse, delta, **kw)]
    control = fa.flash_bwd_drop_tile_plain(
        q, k, v, do, lse, delta, *ref, batch=q.shape[0] - 1, head=q.shape[2] - 1,
        q_tile=q.shape[1] // fa.BWD_Q_TILE - 1, k_block=0, causal=causal)
    for name, a, r, c in zip(("dq", "dk", "dv"), got[2:], ref, control):
        tol = fa.BF16_BLOCK_REL_TOL[name]
        rel, ctl = fa.block_rel_err(a, r), fa.block_rel_err(c, r)
        assert rel.max().item() <= tol, (name, rel.max().item(), tol)
        changed = ctl > 0
        assert int(changed.sum()) == 1, (name, int(changed.sum()))
        assert ctl[changed].min().item() > tol, (name, ctl[changed].min().item(), tol)


def _check_flash(fa, q, k, v, do, got, causal):
    """o, lse, dq, dk, dv of the kernels (``got``; the forward's o and lse
    feed the backward) against the plain version on the same inputs. fp32:
    within 1e-4 (fp32 sums in another order over up to 8448 keys). 16-bit:
    within twice the plain version's own distance from the plain version
    on the inputs widened to fp32 (plus 1e-6), and per block as in
    :func:`_bwd_per_block`; bf16 also within ``BF16_REL_TOL`` relative
    error of the plain bf16 version, a bound that the plain version with
    its scores rounded to bf16 before exp2 (the control) exceeds. Keys
    past the last query (causal) get zero dk and dv."""
    ref = _flash_all(fa, q, k, v, do, kernel=False, causal=causal)
    names = ("o", "lse", "dq", "dk", "dv")
    if q.dtype == torch.float32:
        tols = [1e-4] * 5
    else:
        wide = _flash_all(fa, q.float(), k.float(), v.float(), do.float(), kernel=False,
                          causal=causal)
        tols = [2 * (r.float() - w).abs().max().item() + 1e-6 for r, w in zip(ref, wide)]
        _bwd_per_block(fa, q, k, v, do, got, causal)
    if q.dtype == torch.bfloat16:
        scores = fa._scores2
        fa._scores2 = lambda *x: scores(*x).to(torch.bfloat16).float()
        try:
            control = _flash_all(fa, q, k, v, do, kernel=False, causal=causal)
        finally:
            fa._scores2 = scores
        for name, a, c, r in zip(names, got, control, ref):
            rel, rel_control = _rel_err(a, r), _rel_err(c, r)
            assert rel <= fa.BF16_REL_TOL[name] < rel_control, (name, rel, rel_control)
    for name, a, r, tol in zip(names, got, ref, tols):
        assert torch.isfinite(a).all(), name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol, (name, err, tol)
    sq = q.shape[1]
    if causal and k.shape[1] > sq:
        assert torch.count_nonzero(got[3][:, sq:]) == 0
        assert torch.count_nonzero(got[4][:, sq:]) == 0


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,nq,nkv", [
    (2, 256, 256, 4, 1),     # group 4
    (1, 512, 512, 2, 2),     # group 1
    (1, 256, 512, 4, 2),     # causal cross length: keys past the last query
    (1, 8448, 8448, 2, 1),   # the kvgrid contract (seq_k > 8192)
])
def test_card_flash_kernels_match_plain(cuda_device, dtype, b, sq, sk, nq, nkv):
    """Causal: each launch counted once under its contract, and the checks
    of :func:`_check_flash`."""
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(cuda_device, dtype, b, sq, sk, nq, nkv)
    fa.reset_launches()
    got = _flash_all(fa, q, k, v, do, kernel=True)
    torch.cuda.synchronize()
    kv = "_kvgrid" if sk > fa.MAX_KERNEL_SEQ else ""
    assert fa.LAUNCHES == {"fwd": 0, "fwd_kvgrid": 0, "dq": 0, "dq_kvgrid": 0, "dkv": 0,
                           "fwd" + kv: 1, "dq" + kv: 1, "dkv": 1}
    _check_flash(fa, q, k, v, do, got, causal=True)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,nq,nkv,causal", [
    (1, 192, 192, 4, 1, True),      # a 64-row tail of a 128-row block, group 4
    (1, 192, 192, 4, 4, False),     # the tail, group 1, non-causal
    (1, 2048, 4096, 4, 1, True),    # cross length: keys past the last query
    (2, 256, 512, 8, 2, False),     # non-causal cross length, group 4
    (1, 8448, 8448, 4, 1, True),    # the kvgrid length, group 4
    # the 64-row tail of a dq block and the 64-key tail of a dk/dv block
    (1, 192, 192, 4, 4, True),
    (1, 192, 192, 4, 1, False),
    (1, 320, 320, 4, 4, True),
    (1, 320, 320, 4, 1, True),
    (1, 320, 320, 4, 4, False),
    (1, 320, 320, 4, 1, False),
    (1, 192, 320, 4, 4, True),      # and Sq != Sk
    (1, 192, 320, 4, 1, True),
    (1, 192, 320, 4, 4, False),
    (1, 192, 320, 4, 1, False),
])
def test_card_flash_more_shapes_match_plain(cuda_device, dtype, b, sq, sk, nq, nkv, causal):
    """The shapes the 128-row wgmma blocks (the forward's and dq's 128
    query rows, dk/dv's 128 keys) must also get right, in bf16, fp16
    (the fp16 instantiations of the three wgmma kernels) and fp32, with
    the checks of :func:`_check_flash`."""
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(cuda_device, dtype, b, sq, sk, nq, nkv, seed=23)
    fa.reset_launches()
    got = _flash_all(fa, q, k, v, do, kernel=True, causal=causal)
    torch.cuda.synchronize()
    kv = "_kvgrid" if sk > fa.MAX_KERNEL_SEQ else ""
    assert fa.LAUNCHES["fwd" + kv] == 1 and fa.LAUNCHES["dq" + kv] == 1
    assert fa.LAUNCHES["dkv"] == 1
    _check_flash(fa, q, k, v, do, got, causal)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,sq,sk,nq,nkv,causal", [
    (2, 256, 256, 4, 1, True),      # two 64-key tiles cross each 128-row diagonal
    (1, 512, 512, 2, 2, True),      # group 1
    (1, 256, 512, 4, 2, True),      # causal cross length: keys past the last query
    (1, 192, 192, 4, 1, True),      # a 64-row tail of a 128-row block
    (1, 192, 320, 4, 4, True),      # tails and Sq != Sk
    (2, 256, 512, 8, 2, False),     # non-causal cross length
    (1, 8448, 8448, 2, 1, True),    # the kvgrid contract (seq_k > 8192)
])
def test_card_flash_key_tile_64_matches_plain(cuda_device, dtype, b, sq, sk, nq, nkv, causal):
    """The 64-key instantiations of the forward and dq kernels (4-stage
    rings, m64n64 score products): each launch counted once under its
    contract and its key tile, and the checks of :func:`_check_flash`
    (per 128-row dq block and 128-key dk/dv block, with the control)."""
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(cuda_device, dtype, b, sq, sk, nq, nkv, seed=41)
    fa.reset_launches()
    got = _flash_all(fa, q, k, v, do, kernel=True, causal=causal, block_k=64)
    torch.cuda.synchronize()
    kv = "_kvgrid" if sk > fa.MAX_KERNEL_SEQ else ""
    assert fa.LAUNCHES["fwd" + kv] == 1 and fa.LAUNCHES["dq" + kv] == 1
    assert fa.TILE_LAUNCHES["fwd" + kv] == {64: 1, 128: 0}
    assert fa.TILE_LAUNCHES["dq" + kv] == {64: 1, 128: 0}
    assert sum(n for t in fa.TILE_LAUNCHES.values() for n in t.values()) == 2
    _check_flash(fa, q, k, v, do, got, causal)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block_k", [128, 64])
@pytest.mark.parametrize("b,sq,sk,nq,nkv", [
    (1, 512, 512, 4, 1),     # group 4
    (1, 256, 512, 4, 2),     # cross length: every key visible to every query
    (1, 320, 320, 4, 4),     # the 64-row and 64-key tails, group 1
])
def test_card_flash_noncausal_and_fp32_dq_match_plain(cuda_device, dtype, block_k,
                                                      b, sq, sk, nq, nkv):
    """The two modes ring attention runs: the non-causal forward, dq and
    dk/dv (the checks of :func:`_check_flash`), and dq stored fp32, which
    rounded to the inputs' dtype is the 16-bit dq bit for bit and per
    128-row block lies within ``BF16_BLOCK_REL_TOL`` of the plain
    fp32-output dq, a bound the dropped-tile control exceeds. Each launch
    is counted under its mode."""
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(cuda_device, dtype, b, sq, sk, nq, nkv, seed=43)
    fa.reset_launches()
    got = _flash_all(fa, q, k, v, do, kernel=True, causal=False, block_k=block_k)
    lse = got[1]
    delta = torch.einsum("bsnh,bsnh->bns", got[0].float(), do.float()).contiguous()
    dq32 = fa.flash_dq(q, k, v, do, lse, delta, causal=False, block_k=block_k,
                       out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fa.MODE_LAUNCHES == {"fwd_noncausal": 1, "dq_noncausal": 2, "dkv_noncausal": 1,
                                "dq_f32": 1}
    assert fa.TILE_LAUNCHES["dq"] == {64: 2 * (block_k == 64), 128: 2 * (block_k == 128)}
    _check_flash(fa, q, k, v, do, got, causal=False)
    assert dq32.dtype == torch.float32 and torch.equal(dq32.to(dtype), got[2])
    ref = fa.flash_dq_plain(q, k, v, do, lse, delta, causal=False, out_dtype=torch.float32)
    dkv = fa.flash_dkv_plain(q, k, v, do, lse, delta, causal=False)
    control = fa.flash_bwd_drop_tile_plain(
        q, k, v, do, lse, delta, ref, *dkv, batch=0, head=0,
        q_tile=sq // fa.BWD_Q_TILE - 1, k_block=0, causal=False)[0]
    tol = fa.BF16_BLOCK_REL_TOL["dq"]
    rel, ctl = fa.block_rel_err(dq32, ref), fa.block_rel_err(control, ref)
    assert rel.max().item() <= tol < ctl[ctl > 0].min().item()
    # the fp32 kernel is fp32 already: out_dtype asks nothing of it
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = fa.flash_fwd(q32, k32, v32, causal=False)
    d32 = torch.einsum("bsnh,bsnh->bns", o32, do32).contiguous()
    assert torch.equal(fa.flash_dq(q32, k32, v32, do32, lse32, d32, causal=False,
                                   out_dtype=torch.float32),
                       fa.flash_dq(q32, k32, v32, do32, lse32, d32, causal=False))


@pytest.mark.card
@pytest.mark.parametrize("causal", [True, False])
def test_card_ring_attention_matches_plain_ring(cuda_device, causal):
    """Ring attention with every chunk on the card (cp=4, 256 positions a
    chunk, bf16): o, dq, dk and dv within twice the plain bf16 ring's
    distance from the plain fp32 ring, against the ring through the plain
    versions (chip_smoke.py's ``_plain_partials``); the launches by chunk
    relation (causal: 4 diagonal, 6 visible, 6 skipped; non-causal: 16
    visible), every dq stored fp32."""
    from chip_smoke import _plain_partials
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops.ring_attention import LocalRing, ring_attention

    q, k, v, do = _flash_case(cuda_device, torch.bfloat16, 1, 1024, 1024, 8, 2, seed=47)

    def run(*xs, g):
        leaves = [x.detach().requires_grad_() for x in xs]
        o = ring_attention(*leaves, LocalRing(4), causal=causal)
        return [o.detach(), *torch.autograd.grad(o, leaves, g)]

    fa.reset_launches()
    got = run(q, k, v, g=do)
    torch.cuda.synchronize()
    calls = 10 if causal else 16
    noncausal = 6 if causal else 16
    assert fa.LAUNCHES == {"fwd": calls, "fwd_kvgrid": 0, "dq": calls, "dq_kvgrid": 0,
                           "dkv": calls}
    assert fa.TILE_LAUNCHES["fwd"][128] == fa.TILE_LAUNCHES["dq"][128] == calls
    assert fa.MODE_LAUNCHES == {"fwd_noncausal": noncausal, "dq_noncausal": noncausal,
                                "dkv_noncausal": noncausal, "dq_f32": calls}
    with _plain_partials(fa):
        plain = run(q, k, v, g=do)
        wide = run(q.float(), k.float(), v.float(), g=do.float())
    for name, a, p_, w in zip(("o", "dq", "dk", "dv"), got, plain, wide):
        assert torch.isfinite(a).all(), name
        tol = 2 * _rel_err(p_, w)
        assert _rel_err(a, p_) <= tol, (name, _rel_err(a, p_), tol)


@pytest.mark.card
def test_card_flash_smem_bytes_match_cost_model(cuda_device):
    """Each kernel's dynamic shared memory from its C function equals the
    tuner's Hopper cost model (tune/candidates.py), at both key tiles; a
    tile the kernels lack reads -1 and a launch at it raises."""
    from fms_fsdp_tpu_torch.ops import cuda_build
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.tune import candidates as cand

    fwd = cuda_build.load("flash_fwd_sm90").lib
    bwd = cuda_build.load("flash_bwd_sm90").lib
    scan = cuda_build.load("ssd_sm90").lib
    for bk in (64, 128):
        assert fwd.flash_fwd_sm90_smem_bytes(bk) == cand.flash_fwd_smem_bytes(bk)
        assert bwd.flash_bwd_sm90_smem_bytes(0, bk) == cand.flash_dq_smem_bytes(bk)
    assert bwd.flash_bwd_sm90_smem_bytes(1, 128) == cand.flash_dkv_smem_bytes()
    assert fwd.flash_fwd_sm90_smem_bytes(96) == -1
    for heads in (128, 3):  # two heads a block, one
        sig = cand.ssd_sig((2, 4096, heads, 64), 1, 128)
        for chunk in (64, 128, 256):
            assert scan.ssd_sm90_smem_bytes(cand.ssd_heads_per_block(sig), chunk) == \
                cand.ssd_smem_bytes(sig, "bfloat16", chunk)
    q, k, v, _ = _flash_case(cuda_device, torch.bfloat16, 1, 256, 256, 4, 2)
    with pytest.raises(ValueError, match="key tile"):
        fa.flash_fwd(q, k, v, block_k=96)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_card_flash_bwd_is_deterministic(cuda_device, dtype):
    """dq, dk and dv of two calls on the same inputs are equal bit for bit:
    no atomics, one fixed order of sums."""
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(cuda_device, dtype, 2, 1024, 1024, 8, 2, seed=35)
    o, lse = fa.flash_fwd(q, k, v)
    delta = torch.einsum("bsnh,bsnh->bns", o.float(), do.float()).contiguous()
    first = [fa.flash_dq(q, k, v, do, lse, delta), *fa.flash_dkv(q, k, v, do, lse, delta)]
    second = [fa.flash_dq(q, k, v, do, lse, delta), *fa.flash_dkv(q, k, v, do, lse, delta)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.card
def test_card_flash_autograd_grads_are_the_kernels(cuda_device):
    """dq, dk, dv through the autograd Function are the backward kernels'
    results on the forward kernel's o and lse, bit for bit."""
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(cuda_device, torch.bfloat16, 2, 256, 256, 8, 2, seed=25)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launches()
    o = fa.flash_attention(*leaves)
    o.backward(do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fwd"] == 1 and fa.LAUNCHES["dq"] == 1 and fa.LAUNCHES["dkv"] == 1
    o2, lse = fa.flash_fwd(q, k, v)
    delta = torch.einsum("bsnh,bsnh->bns", o2.float(), do.float()).contiguous()
    dq = fa.flash_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
    assert torch.equal(o, o2)
    assert torch.equal(leaves[0].grad, dq)
    assert torch.equal(leaves[1].grad, dk.to(k.dtype))
    assert torch.equal(leaves[2].grad, dv.to(v.dtype))


@pytest.mark.card
def test_card_auto_attention_launches_or_raises(cuda_device):
    """impl="auto" on CUDA tensors launches the kernels or raises; it never
    takes the einsum path there."""
    from fms_fsdp_tpu_torch.ops import attention as attn
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_case(cuda_device, torch.bfloat16, 1, 256, 256, 4, 2)
    fa.reset_launches()
    attn.attention(q, k, v, impl="auto")
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fwd"] == 1
    with pytest.raises(NotImplementedError, match="xla"):
        attn.attention(q[:, :100], k[:, :100], v[:, :100], impl="auto")


@pytest.mark.card
def test_card_flash_rejects_bad_input(cuda_device):
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_case(cuda_device, torch.bfloat16, 1, 256, 256, 4, 2)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q[..., :64].contiguous(), k[..., :64].contiguous(),
                     v[..., :64].contiguous())
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_fwd(q[:, :100].contiguous(), k[:, :100].contiguous(), v[:, :100].contiguous())
    with pytest.raises(ValueError, match="share"):
        fa.flash_fwd(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2), k, v)


def _params_clone(tree):
    return {k: _params_clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@pytest.mark.card
def test_card_full_width_step_kernel_vs_einsum(cuda_device):
    """One train step at llama3_8b_4k width (2 layers, seq 4096, batch 1,
    the same random weights and dummy batch) three ways: bf16 through the
    flash kernels, bf16 through the einsum attention (``impl="xla"``),
    and fp32 through the einsum attention. The kernel step's loss and
    gradient norm must lie within three times the einsum bf16 step's own
    distance from the fp32 step, plus 1e-4 relative: the two bf16 steps
    round at different places, each about as far from fp32."""
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
    from fms_fsdp_tpu_torch.data.loader import get_dummy_loader
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.train.step import make_train_step, state_from_params
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config

    model = get_model_config("llama3_8b_4k")
    update_config(model, **{"LlamaConfig.nlayers": 2})
    params0 = init_llama_params(torch.Generator(device=cuda_device).manual_seed(0), model)

    def step(attn, mixed):
        cfg = TrainConfig(seq_length=4096, batch_size=1, vocab_size=128256,
                          attention_kernel=attn, mixed_precision=mixed,
                          use_dummy_dataset=True, num_steps=12)
        state = state_from_params(_params_clone(params0), cfg)
        batch = next(iter(DeviceFeed(get_dummy_loader(cfg, 0, 1), cuda_device)))
        fa.reset_launches()
        m = make_train_step(model, cfg)(state, batch)
        out = (float(m["loss"]), float(m["gnorm"]), dict(fa.LAUNCHES))
        del state
        torch.cuda.empty_cache()
        return out

    kernel, einsum, fp32 = step("pallas", True), step("xla", True), step("xla", False)
    assert kernel[2]["fwd"] == 2 and kernel[2]["dq"] == 2 and kernel[2]["dkv"] == 2
    assert sum(einsum[2].values()) == 0 and sum(fp32[2].values()) == 0
    for i in (0, 1):
        tol = 3 * abs(einsum[i] - fp32[i]) + 1e-4 * abs(fp32[i])
        assert np.isfinite(kernel[i])
        assert abs(kernel[i] - einsum[i]) <= tol, (i, kernel, einsum, fp32)


@pytest.mark.card
def test_card_mixtral_step_kernel_vs_plain_attention(cuda_device):
    """One bfSixteen Mixtral train step at a narrow width (512 wide, 4/2
    heads of 128, 4 experts of hidden 1024, top-2, 2 layers, seq 1024,
    batch 2) through the flash kernels and through the plain attention,
    on the same weights and batch: the losses within bf16's 2e-2
    relative, the gradient norms finite, and the kernel step launching
    the forward, dq and dk/dv once a layer (no AC), the plain one none."""
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
    from fms_fsdp_tpu_torch.data.loader import get_dummy_loader
    from fms_fsdp_tpu_torch.models.configs import MixtralConfig
    from fms_fsdp_tpu_torch.models.mixtral import init_mixtral_params
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.train.step import make_train_step, state_from_params

    model = MixtralConfig(src_vocab_size=32000, emb_dim=512, nheads=4, kvheads=2,
                          nlayers=2, hidden_dim=1024, num_experts=4, top_k=2)
    params0 = init_mixtral_params(torch.Generator(device=cuda_device).manual_seed(0), model)

    def step(attn):
        cfg = TrainConfig(seq_length=1024, batch_size=2, vocab_size=32000,
                          attention_kernel=attn, mixed_precision=True,
                          use_dummy_dataset=True, num_steps=12)
        state = state_from_params(_params_clone(params0), cfg)
        batch = next(iter(DeviceFeed(get_dummy_loader(cfg, 0, 1), cuda_device)))
        fa.reset_launches()
        m = make_train_step(model, cfg)(state, batch)
        return (float(m["loss"]), float(m["gnorm"]), float(m["moe_drop_frac"]),
                dict(fa.LAUNCHES))

    kernel, plain = step("pallas"), step("xla")
    assert (kernel[3]["fwd"], kernel[3]["dq"], kernel[3]["dkv"]) == (2, 2, 2)
    assert sum(plain[3].values()) == 0
    assert all(np.isfinite(x) for x in kernel[:3] + plain[:3])
    assert abs(kernel[0] - plain[0]) <= 2e-2 * abs(plain[0]), (kernel, plain)
    assert 0.0 <= kernel[2] < 1.0


@pytest.mark.card
def test_card_speculator_stage1_kernel_vs_plain_attention(cuda_device):
    """The frozen base forward of a stage-1 speculator step on a bf16
    Llama base at a narrow width (512 wide, 4/2 heads of 128, 2 layers,
    vocab 32000, seq 1024, batch 2; speculator width 512, 3 heads): its
    hidden states through the flash forward lie within twice the plain
    bf16 forward's distance from the fp32 forward, of both. Then one
    stage-1 step each way from the same speculator and batch: the per-head
    losses within bf16's 2e-2 relative, and the kernel step launching the
    forward once a layer and no backward (the base is frozen), the plain
    one nothing."""
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.models import get_base_api
    from fms_fsdp_tpu_torch.models.speculator import SpeculatorConfig, init_speculator_params
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.train.speculator import make_stage1_step, speculator_state

    model = LlamaConfig(src_vocab_size=32000, emb_dim=512, nheads=4, kvheads=2, nlayers=2)
    base = init_llama_params(torch.Generator(device=cuda_device).manual_seed(0), model,
                             dtype=torch.bfloat16)
    scfg = SpeculatorConfig(emb_dim=512, inner_dim=512, vocab_size=32000, n_predict=3)
    inputs = torch.randint(0, 32000, (2, 1024 + 4), device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(1))

    hidden = get_base_api("embedllama").forward_hidden
    with torch.no_grad():
        h = {impl: hidden(base, inputs[:, :-4], model, attn_impl=impl).float()
             for impl in ("pallas", "xla")}
        h32 = hidden(base, inputs[:, :-4], model, attn_impl="xla",
                     compute_dtype=torch.float32)
    tol = 2 * (h["xla"] - h32).abs().max().item()
    assert (h["pallas"] - h["xla"]).abs().max().item() <= tol
    assert (h["pallas"] - h32).abs().max().item() <= tol

    def step(attn):
        cfg = TrainConfig(seq_length=1028, batch_size=2, attention_kernel=attn,
                          speculator_width=512, num_steps=10, stage2_start_step=5)
        spec = init_speculator_params(torch.Generator(device=cuda_device).manual_seed(2), scfg)
        fa.reset_launches()
        _, m = make_stage1_step(base, model, scfg, cfg)(speculator_state(spec, cfg), inputs)
        return m["per_head"].float().cpu().numpy(), float(m["gnorm"]), dict(fa.LAUNCHES)

    kernel, plain = step("pallas"), step("xla")
    assert (kernel[2]["fwd"], kernel[2]["dq"], kernel[2]["dkv"]) == (2, 0, 0), kernel[2]
    assert sum(plain[2].values()) == 0
    assert np.isfinite(kernel[0]).all() and np.isfinite(kernel[1])
    np.testing.assert_allclose(kernel[0], plain[0], rtol=2e-2)

# ---------------------------------------------------------------------------
# the fused SSD scan kernels (csrc/ssd_sm90.cu for bf16/fp16, csrc/ssd.cu
# for fp32)
# ---------------------------------------------------------------------------


def _ssd_inputs(device, dtype, B, S, H, G, seed=0):
    """x, dt, a, Bm, Cm with dt and A in the ranges of init_mamba_params
    (dt in [1e-3, 1e-1], A in [-16, -1])."""
    from fms_fsdp_tpu_torch.ops import ssd as t_ssd

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, H, 64)).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((B, S, G, 128)).astype(np.float32))
    Cm = torch.from_numpy(rng.standard_normal((B, S, G, 128)).astype(np.float32))
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                             (B, S, H))).astype(np.float32))
    A = -torch.from_numpy(rng.uniform(1.0, 16.0, (H,)).astype(np.float32))
    dev = lambda t, d=torch.float32: t.to(device, d)  # noqa: E731
    return t_ssd, dev(x, dtype), dev(dt), dev(dt * A), dev(Bm, dtype), dev(Cm, dtype), dev(A)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(2, 1024, 16, 1, 256), (1, 512, 16, 8, 64),
                                   (1, 256, 8, 2, 256), (1, 384, 8, 1, 128)])
def test_card_ssd_kernel_matches_plain(cuda_device, kind, shape):
    """B, S, H, G, chunk: several chunks at G=1, G>1, one chunk (S=L), and
    a chunk of two tiles. fp32 within 1e-4 of the largest value (sums in
    another order over a 256-token chunk); bf16 within 1e-2 of it (the
    same rounding points, other summation order)."""
    B, S, H, G, L = shape
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    t_ssd, x, dt, a, Bm, Cm, _ = _ssd_inputs(cuda_device, dtype, B, S, H, G)
    t_ssd.reset_launches()
    y = t_ssd.ssd_fused(x, dt, a, Bm, Cm, L)
    torch.cuda.synchronize()
    assert t_ssd.LAUNCHES == {"fused": 1}
    ref = t_ssd.ssd_core_plain(x, dt, a, Bm, Cm, L)
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert torch.isfinite(y).all()
    tol = (1e-4 if kind == "fp32" else 1e-2) * max(1.0, ref.abs().max().item())
    assert (y - ref).abs().max().item() <= tol
    per_chunk = t_ssd.chunk_check(y, ref, x, dt, a, Bm, Cm, L)
    assert per_chunk["ok"], per_chunk


# (B, S, H, G, chunk): chip_smoke.py's SSD_CASES (the Mamba training shape,
# G=8, one chunk), H/G = 1 and 3 (one head a block), and every chunk length
_SM90_CASES = [(2, 4096, 128, 1, 256), (2, 1024, 128, 8, 256), (2, 256, 128, 1, 256),
               (1, 512, 8, 8, 128), (1, 1024, 6, 2, 256), (1, 512, 16, 1, 64),
               (1, 512, 16, 2, 128), (1, 768, 16, 1, 192)]


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bf16", "fp16"])
@pytest.mark.parametrize("shape", _SM90_CASES)
def test_card_ssd_sm90_matches_plain(cuda_device, kind, shape):
    """csrc/ssd_sm90.cu against the plain version in its own dtype: within
    1e-2 of the largest value and ``BF16_REL_TOL`` over the whole tensor,
    and per (batch, chunk, head) within ``BF16_CHUNK_REL_TOL`` with the
    drop-tile control above it."""
    B, S, H, G, L = shape
    dtype = torch.bfloat16 if kind == "bf16" else torch.float16
    t_ssd, x, dt, a, Bm, Cm, _ = _ssd_inputs(cuda_device, dtype, B, S, H, G)
    assert t_ssd.kernel_source(dtype) == ("ssd_sm90", "ssd_fused_sm90")
    t_ssd.reset_launches()
    y = t_ssd.ssd_fused(x, dt, a, Bm, Cm, L)
    torch.cuda.synchronize()
    assert t_ssd.LAUNCHES == {"fused": 1}
    ref = t_ssd.ssd_core_plain(x, dt, a, Bm, Cm, L)
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert torch.isfinite(y).all()
    assert (y - ref).abs().max().item() <= 1e-2 * max(1.0, ref.abs().max().item())
    rel = ((y - ref).norm() / ref.norm()).item()
    assert rel <= t_ssd.BF16_REL_TOL, rel
    per_chunk = t_ssd.chunk_check(y, ref, x, dt, a, Bm, Cm, L)
    assert per_chunk["ok"], per_chunk


@pytest.mark.card
def test_card_ssd_kernel_reads_strided_views(cuda_device):
    """x, Bm and Cm as the mixer hands them over: views into one
    (B, S, conv_dim) tensor, read through their strides."""
    B, S, H, G, L = 2, 512, 16, 2, 256
    t_ssd, x, dt, a, Bm, Cm, _ = _ssd_inputs(cuda_device, torch.bfloat16, B, S, H, G)
    packed = torch.cat([x.reshape(B, S, -1), Bm.reshape(B, S, -1),
                        Cm.reshape(B, S, -1)], dim=-1)
    d_inner, gn = H * 64, G * 128
    xv = packed[..., :d_inner].reshape(B, S, H, 64)
    bv = packed[..., d_inner:d_inner + gn].reshape(B, S, G, 128)
    cv = packed[..., d_inner + gn:].reshape(B, S, G, 128)
    assert not xv.is_contiguous() and xv.data_ptr() == packed.data_ptr()
    y = t_ssd.ssd_fused(xv, dt, a, bv, cv, L)
    assert torch.equal(y, t_ssd.ssd_fused(x, dt, a, Bm, Cm, L))


@pytest.mark.card
def test_card_ssd_scan_auto_launches_or_raises(cuda_device):
    B, S, H, G = 1, 256, 8, 1
    t_ssd, x, dt, a, Bm, Cm, A = _ssd_inputs(cuda_device, torch.float32, B, S, H, G)
    D = torch.ones(H, device=cuda_device)
    for kernel in ("auto", "pallas"):
        t_ssd.reset_launches()
        leaves = [t.clone().requires_grad_() for t in (x, dt, Bm, Cm)]
        y = t_ssd.ssd_scan(leaves[0], leaves[1], A, leaves[2], leaves[3], D,
                           chunk_size=256, kernel=kernel)
        (y ** 2).mean().backward()
        assert t_ssd.LAUNCHES == {"fused": 1}  # the backward launches none
        ref_leaves = [t.clone().requires_grad_() for t in (x, dt, Bm, Cm)]
        ref = t_ssd.ssd_scan(ref_leaves[0], ref_leaves[1], A, ref_leaves[2],
                             ref_leaves[3], D, chunk_size=256, kernel="xla")
        (ref ** 2).mean().backward()
        assert t_ssd.LAUNCHES == {"fused": 1}
        assert (y - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
        for got, want in zip(leaves, ref_leaves):
            assert torch.allclose(got.grad, want.grad, atol=1e-5, rtol=1e-4)
    # a shape the kernel does not take raises on the card: no fallback
    with pytest.raises(NotImplementedError, match="headdim 64"):
        t_ssd.ssd_scan(x[..., :32].contiguous(), dt, A, Bm, Cm, chunk_size=256,
                       kernel="auto")
    with pytest.raises(NotImplementedError, match="chunk"):
        t_ssd.ssd_scan(x, dt, A, Bm, Cm, chunk_size=32, kernel="pallas")


# ---------------------------------------------------------------------------
# checkpoints of a train state on the card
# ---------------------------------------------------------------------------

_CKPT_MODEL = dict(src_vocab_size=512, emb_dim=256, nheads=2, kvheads=1, nlayers=2,
                   max_expected_seq_len=256)


def _card_state(device, seed=0):
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.train.step import make_train_step, state_from_params

    model = LlamaConfig(**_CKPT_MODEL)
    cfg = TrainConfig(seq_length=256, batch_size=2, vocab_size=512, attention_kernel="xla",
                      mixed_precision=False, learning_rate=1e-2, sharding_strategy="fsdp")
    params = init_llama_params(torch.Generator(device=device).manual_seed(seed), model)
    state = state_from_params(params, cfg)
    step = make_train_step(model, cfg)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, 512, size=(2, 257)))
    batch = (toks[:, :-1].to(device), toks[:, 1:].to(device))
    step(state, batch)
    return state, step, batch, cfg


def _card_bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _slow_writer(monkeypatch, delay=0.5):
    """The manager's payload write, delayed, recording what it was handed
    and on which thread."""
    from fms_fsdp_tpu_torch.ckpt import manager
    from fms_fsdp_tpu_torch.utils import checkpointing

    seen = []

    def write(path, flat):
        import threading
        import time

        seen.append((threading.current_thread().name,
                     {t.device.type for t in flat.values()},
                     all(t.is_pinned() for t in flat.values() if t.dim())))
        time.sleep(delay)
        checkpointing.write_state(path, flat)

    monkeypatch.setattr(manager, "write_state", write)
    return seen


@pytest.mark.card
def test_card_checkpoint_snapshot_isolated_from_next_step(cuda_device, tmp_path, monkeypatch):
    from fms_fsdp_tpu_torch.ckpt import build_checkpoint_manager
    from fms_fsdp_tpu_torch.ckpt.state import checkpoint_state
    from fms_fsdp_tpu_torch.config import TrainConfig

    _slow_writer(monkeypatch)
    state, step, batch, _ = _card_state(cuda_device)
    before = {k: v.clone() for k, v in checkpoint_state(state).items()}
    mgr = build_checkpoint_manager(TrainConfig(ckpt_save_path=str(tmp_path),
                                               sharding_strategy="fsdp"))
    mgr.save(1, state, None)
    step(state, batch)  # the next AdamW step writes in place during the write
    torch.cuda.synchronize()
    assert not torch.equal(before["params.layers.wq"], state["params"]["layers"]["wq"])
    mgr.finalize()
    fresh, _, _, _ = _card_state(cuda_device, seed=1)
    mgr.load(fresh, None)
    for key, t in checkpoint_state(fresh).items():
        assert torch.equal(_card_bits(t), _card_bits(before[key])), key


@pytest.mark.card
@pytest.mark.parametrize("route", ["checkpointer", "manager"])
def test_card_checkpoint_round_trip_onto_cuda_is_bitwise(cuda_device, tmp_path, route):
    from fms_fsdp_tpu_torch.ckpt import build_checkpoint_manager
    from fms_fsdp_tpu_torch.ckpt.state import checkpoint_state
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.utils.checkpointing import Checkpointer

    state, step, batch, _ = _card_state(cuda_device)
    saved = {k: v.clone() for k, v in checkpoint_state(state).items()}
    ck = (Checkpointer(str(tmp_path), 2, "fsdp") if route == "checkpointer" else
          build_checkpoint_manager(TrainConfig(ckpt_save_path=str(tmp_path),
                                               sharding_strategy="fsdp")))
    ck.save(1, state, None, tokens_seen=512)
    ck.finalize()
    fresh, _, _, _ = _card_state(cuda_device, seed=1)
    _, _, at, ntok, resuming = ck.load(fresh, None)
    assert (at, ntok, resuming) == (1, 512, True)
    loaded = checkpoint_state(fresh)
    for key, t in saved.items():
        assert loaded[key].device == t.device and t.dtype == loaded[key].dtype, key
        assert torch.equal(_card_bits(t), _card_bits(loaded[key])), key
    # the two states take the same next step, bitwise
    step(state, batch)
    step(fresh, batch)
    for key, t in checkpoint_state(state).items():
        assert torch.equal(_card_bits(t), _card_bits(checkpoint_state(fresh)[key])), key


@pytest.mark.card
def test_card_checkpoint_writer_touches_no_cuda_tensor(cuda_device, tmp_path, monkeypatch):
    from fms_fsdp_tpu_torch.ckpt import build_checkpoint_manager
    from fms_fsdp_tpu_torch.config import TrainConfig

    seen = _slow_writer(monkeypatch, delay=0.0)
    state, _, _, _ = _card_state(cuda_device)
    mgr = build_checkpoint_manager(TrainConfig(ckpt_save_path=str(tmp_path),
                                               checkpoint_interval=1,
                                               sharding_strategy="fsdp"))
    for step in (1, 2):
        mgr.save(step, state, None)
    mgr.finalize()
    assert seen == [("ckpt-writer", {"cpu"}, True)] * 2
    assert [r["step"] for r in mgr.save_log] == [1, 2]


# ---------------------------------------------------------------------------
# the streaming loader's feed onto the card
# ---------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("prefetch", [0, 2])
def test_card_feed_batches_equal_host_batches(cuda_device, prefetch):
    """The feed's thread copies each pinned batch with non_blocking=True;
    a kernel the consumer launches at once sees the whole batch."""
    from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed

    rng = np.random.default_rng(5)
    host = [tuple(rng.integers(0, 128256, (2, 4097)).astype(np.int32) for _ in range(2))
            for _ in range(24)]
    got = 0
    for (x, y), (a, b) in zip(DeviceFeed(host, cuda_device, prefetch=prefetch), host):
        assert x.device.type == "cuda" and x.dtype == torch.int64
        # launched on the default stream right after the batch arrives
        sums = torch.stack([x.sum(), y.sum()]).cpu()
        assert sums.tolist() == [int(a.astype(np.int64).sum()), int(b.astype(np.int64).sum())]
        assert np.array_equal(x.cpu().numpy(), a) and np.array_equal(y.cpu().numpy(), b)
        got += 1
    assert got == len(host)


@pytest.mark.card
def test_card_feed_from_process_workers(cuda_device, tmp_path):
    """Forked loader workers (the parent holds a CUDA context and a live
    tensor) feed the card; the batches equal a thread-mode host walk of
    the same config, and shutdown reaps the workers."""
    import multiprocessing

    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
    from fms_fsdp_tpu_torch.data.loader import get_data_loader
    from fms_fsdp_tpu_torch.data.synth import build_arrow_corpus

    live = torch.ones(1 << 20, device=cuda_device)
    data = build_arrow_corpus(tmp_path / "data")

    def loader(mode, ck):
        return get_data_loader(TrainConfig(
            use_dummy_dataset=False, data_path=data, datasets="dataset_1", weights="1",
            seq_length=64, batch_size=2, num_workers=2, worker_mode=mode, logical_shards=8,
            loader_shuffle_window=16, ckpt_save_path=str(tmp_path / ck),
            ckpt_load_path=str(tmp_path / ck)), 0, 1)

    ref = loader("thread", "t")
    want = [next(it) for it in [iter(ref)] for _ in range(10)]
    ref.shutdown()
    procs = loader("process", "p")
    feed = iter(DeviceFeed(procs, cuda_device, prefetch=2))
    for (x, y), (a, b) in zip(feed, want):
        assert np.array_equal(x.cpu().numpy(), a) and np.array_equal(y.cpu().numpy(), b)
    feed.close()
    procs.shutdown()
    assert multiprocessing.active_children() == [] and float(live.sum()) == 1 << 20


@pytest.mark.card
def test_card_trainer_with_process_workers_saves_and_resumes(cuda_device, tmp_path, capsys):
    """The Llama entry on the card with 2 forked loader workers behind a
    prefetching feed: the workers fork from the feed's thread while the
    card is up, the async checkpoint writer commits their state (read
    through the command channel) at every save, a resume restores it, and
    every worker is reaped when main returns."""
    import multiprocessing

    from fms_fsdp_tpu_torch.data.synth import build_arrow_corpus
    from fms_fsdp_tpu_torch.main_training_llama import main

    ck = str(tmp_path / "ck")
    kw = dict(model_variant="llama2_7b", use_dummy_dataset=False,
              data_path=build_arrow_corpus(tmp_path / "data"), datasets="dataset_1",
              weights="1", seq_length=64, vocab_size=256, batch_size=2, num_workers=2,
              worker_mode="process", feed_prefetch=2, logical_shards=8,
              loader_shuffle_window=16, report_interval=2, checkpoint_interval=2,
              attention_kernel="xla", ckpt_save_path=ck, ckpt_load_path=ck,
              **{"LlamaConfig.nlayers": 2, "LlamaConfig.emb_dim": 64,
                 "LlamaConfig.nheads": 4, "LlamaConfig.kvheads": 2,
                 "LlamaConfig.src_vocab_size": 256, "LlamaConfig.multiple_of": 16})
    first = main(device=cuda_device, num_steps=6, **kw)
    assert [r["step"] for r in first["checkpointer"].save_log] == [2, 4, 6]
    assert multiprocessing.active_children() == []
    capsys.readouterr()
    second = main(device=cuda_device, num_steps=8, resuming_dataset=True, **kw)
    out = capsys.readouterr().out
    assert second["start_step"] == 6 and "Dataset checkpoint loaded" in out
    assert all(np.isfinite(r["loss"]) for r in second["reports"])
    assert multiprocessing.active_children() == []


# ---------------------------------------------------------------------------
# the trainer's observability and resilience layer on the card
# ---------------------------------------------------------------------------

# a tiny Llama whose heads (128 wide) the flash kernels take
_CARD_TINY = {"model_variant": "llama2_7b", "LlamaConfig.nlayers": 2,
              "LlamaConfig.emb_dim": 256, "LlamaConfig.nheads": 2,
              "LlamaConfig.kvheads": 1, "LlamaConfig.src_vocab_size": 256,
              "vocab_size": 256, "seq_length": 128, "batch_size": 2,
              "use_dummy_dataset": True}


@pytest.mark.card
def test_card_profiler_trace_names_the_flash_kernels(cuda_device, tmp_path, monkeypatch):
    """use_profiler on the card: the windowed torch.profiler trace (steps
    4-6) lands in profile_traces/ and names the three flash kernels as
    CUPTI records them from the ctypes launches, and the train step's
    fwd_bwd scope."""
    import json
    import os

    from fms_fsdp_tpu_torch.main_training_llama import main

    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "ck")
    main(device=cuda_device, num_steps=7, report_interval=7, use_profiler=True,
         ckpt_save_path=ck, ckpt_load_path=ck, **_CARD_TINY)
    traces = os.listdir(tmp_path / "profile_traces")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "profile_traces" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    for sym in ("flash_fwd_kernel_sm90", "flash_dq_kernel_sm90", "flash_dkv_kernel_sm90"):
        assert any(sym in k for k in kernels), sym
    assert "fwd_bwd" in {e["name"] for e in events if e.get("cat") == "user_annotation"}


@pytest.mark.card
def test_card_watchdog_fires_on_a_parked_step_without_touching_cuda(cuda_device, tmp_path):
    """The Llama entry on the card with a dcn_reduce_stall parking step 3:
    the watchdog exits 2 with its stall report quoting the heartbeat, and
    no frame of torch.cuda ever runs on its thread (a trace function on
    every thread started after the entry's import says so)."""
    import os
    import subprocess
    import sys

    from fms_fsdp_tpu_torch.ops import cuda_build

    # built here, so no step of the child carries nvcc under the watchdog
    for name in ("flash_fwd_sm90", "flash_bwd_sm90"):
        cuda_build.compile_source(name)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    obs = str(tmp_path / "obs")
    code = (
        "import sys, threading\n"
        "from fms_fsdp_tpu_torch.main_training_llama import main\n"
        "def tracer(frame, event, arg):\n"
        "    if (threading.current_thread().name == 'step-watchdog'\n"
        "            and 'torch' in frame.f_code.co_filename\n"
        "            and 'cuda' in frame.f_code.co_filename):\n"
        "        sys.stderr.write('WATCHDOG THREAD RAN ' + frame.f_code.co_filename + '\\n')\n"
        "threading.settrace(tracer)\n"
        f"main(num_steps=6, report_interval=1, step_timeout_s=10.0, obs_dir={obs!r},\n"
        "     faults='dcn_reduce_stall:step=3:seconds=120',\n"
        f"     ckpt_save_path={str(tmp_path / 'ck')!r}, ckpt_load_path={str(tmp_path / 'ck')!r},\n"
        f"     **{_CARD_TINY!r})\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=240,
                          env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 2, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "step watchdog [proc 0]: no training progress" in proc.stderr
    assert "'step': 2" in proc.stderr  # the heartbeat it quotes: step 2's report
    assert "WATCHDOG THREAD RAN" not in proc.stderr


@pytest.mark.card
def test_card_observer_mfu_uses_the_cards_peak(cuda_device):
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.obs import build_observer
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config
    from fms_fsdp_tpu_torch.utils.flops import peak_flops_per_card, train_flops_per_token

    cfg = TrainConfig(seq_length=4096, fsdp_activation_checkpointing=True,
                      selective_checkpointing=0.5)
    model_cfg = get_model_config("llama3_8b_4k")
    update_config(model_cfg, **{"LlamaConfig.nlayers": 8})
    obs = build_observer(cfg, 0, model_cfg=model_cfg, device=cuda_device)
    peak = peak_flops_per_card(torch.cuda.get_device_name(cuda_device))
    assert obs.peak_flops == peak
    rec = obs.report(4, 4, loss=1.0, tokens_per_sec_per_chip=20000.0)
    flops = train_flops_per_token(model_cfg, 4096)
    assert rec["mfu"] == pytest.approx(20000.0 * flops / peak, rel=1e-12)
    assert rec["hfu"] == pytest.approx(20000.0 * train_flops_per_token(model_cfg, 4096, 0.5)
                                       / peak, rel=1e-12)


# ---------------------------------------------------------------------------
# every launch on its tensor's device (the ctypes entry points launch on
# the calling thread's current device)
# ---------------------------------------------------------------------------


@pytest.mark.card
def test_card_every_wrapper_launches_on_its_tensors_device(cuda_device, monkeypatch):
    """Each kernel wrapper enters ``torch.cuda.device`` of its tensors for
    its launch, with the thread's current device set elsewhere when the
    machine has a second card (else left at the default): the results
    still equal the plain versions, on the tensors' card."""
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import ssd as t_ssd

    entered = []
    real = torch.cuda.device

    class Recorder(real):
        def __init__(self, device):
            entered.append(device)
            super().__init__(device)

    dev = torch.device("cuda", 0)
    q, k, v, do = _flash_case(dev, torch.bfloat16, 1, 256, 256, 4, 1)
    _, x, dt, a, Bm, Cm, _ = _ssd_inputs(dev, torch.bfloat16, 1, 512, 8, 1)
    pq, pk, pv, table, lens, _, _ = _case(dev, "bf16")
    o, lse = fa.flash_fwd(q, k, v)  # builds and loads the libraries
    delta = torch.einsum("bsnh,bsnh->bns", o.float(), do.float()).contiguous()
    t_ssd.ssd_fused(x, dt, a, Bm, Cm, 256)
    t_paged.paged_attention_kernel(pq, pk, pv, table, lens)
    torch.cuda.synchronize(dev)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v),
        "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse, delta),
        "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta),
        "ssd_fused": lambda: t_ssd.ssd_fused(x, dt, a, Bm, Cm, 256),
        "paged_decode": lambda: t_paged.paged_attention_kernel(pq, pk, pv, table, lens),
    }
    outs = {}
    if torch.cuda.device_count() > 1:
        torch.cuda.set_device(1)
    try:
        for name, call in calls.items():
            entered.clear()
            monkeypatch.setattr(torch.cuda, "device", Recorder)
            outs[name] = call()
            monkeypatch.setattr(torch.cuda, "device", real)
            assert [torch.device(d) for d in entered] == [dev], (name, entered)
    finally:
        monkeypatch.setattr(torch.cuda, "device", real)
        torch.cuda.set_device(0)
    torch.cuda.synchronize(dev)
    got = [*outs["flash_fwd"], outs["flash_dq"], *outs["flash_dkv"]]
    assert all(t.device == dev for t in (*got, outs["ssd_fused"], outs["paged_decode"]))
    _check_flash(fa, q, k, v, do, got, causal=True)
    ref = t_ssd.ssd_core_plain(x, dt, a, Bm, Cm, 256)
    y = outs["ssd_fused"]
    assert (y - ref).abs().max().item() <= 1e-2 * max(1.0, ref.abs().max().item())
    ref = t_paged.paged_attention_plain(pq, pk, pv, table, lens)
    assert (outs["paged_decode"].float() - ref.float()).abs().max().item() <= 2e-2


# ---------------------------------------------------------------------------
# HF interop and native eval (eval_ppl.py, fms_to_hf_*.py, models/hf_import.py)
# ---------------------------------------------------------------------------

# a narrow Llama the flash kernels take: head_dim 128, 2/1 heads
_EVAL_MODEL = {"LlamaConfig.src_vocab_size": 4096, "LlamaConfig.emb_dim": 256,
               "LlamaConfig.nheads": 2, "LlamaConfig.kvheads": 1, "LlamaConfig.nlayers": 2,
               "LlamaConfig.max_expected_seq_len": 512}


@pytest.mark.card
def test_card_eval_kernel_vs_plain_attention(cuda_device, capsys):
    """``eval_ppl.main`` on the card through the flash forward (one launch
    a layer a batch, no backward) and through the einsum attention
    (none): token counts equal, nll within bf16's 2e-2 relative."""
    from fms_fsdp_tpu_torch import eval_ppl
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    run = dict(model_variant="llama2_7b", use_dummy_dataset=True, vocab_size=4096,
               seq_length=512, batch_size=2, ckpt_load_path="", eval_batches=3, **_EVAL_MODEL)
    out = {}
    for impl in ("pallas", "xla"):
        fa.reset_launches()
        out[impl] = (eval_ppl.main(attention_kernel=impl, **run), dict(fa.LAUNCHES))
    kernel, plain = out["pallas"], out["xla"]
    assert (kernel[1]["fwd"], kernel[1]["dq"], kernel[1]["dkv"]) == (2 * 3, 0, 0), kernel[1]
    assert sum(plain[1].values()) == 0
    assert kernel[0]["tokens"] == plain[0]["tokens"] == 3 * 2 * 512
    assert kernel[0]["nll"] == pytest.approx(plain[0]["nll"], rel=2e-2)
    assert "nll" in capsys.readouterr().out


@pytest.mark.card
def test_card_hf_round_trip(cuda_device, tmp_path):
    """The port's bf16 Llama on the card -> fms_to_hf_llama's HF
    directory -> load_hf_base -> the card: the params bitwise; the logits
    of transformers' model (bf16, on the card) and of the port's forward
    through the kernel each within twice the plain bf16 forward's
    distance from the fp32 forward, of that fp32 forward."""
    from transformers import LlamaForCausalLM

    from fms_fsdp_tpu_torch.fms_to_hf_llama import convert_to_hf
    from fms_fsdp_tpu_torch.models.hf_import import load_hf_base
    from fms_fsdp_tpu_torch.models.llama import llama_forward
    from fms_fsdp_tpu_torch.utils.tree import tree_map

    cfg = LlamaConfig(**{k.split(".")[1]: v for k, v in _EVAL_MODEL.items()})
    params = init_llama_params(torch.Generator(device=cuda_device).manual_seed(0), cfg,
                               dtype=torch.bfloat16)
    path = str(tmp_path / "hf")
    convert_to_hf(params, cfg).save_pretrained(path, safe_serialization=True)
    arch, cfg2, back = load_hf_base(path)
    back = tree_map(lambda w: w.to(cuda_device), back)
    assert arch == "llama" and cfg2.hidden_dim == cfg.hidden_dim
    for name, w in params["layers"].items():
        assert torch.equal(back["layers"][name], w), name
    for key in ("embedding", "norm", "lm_head"):
        assert torch.equal(back[key], params[key])
    tokens = torch.randint(0, 4096, (2, 512), device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(1))
    with torch.no_grad():
        kernel = llama_forward(back, tokens, cfg2, attn_impl="pallas").float()
        plain = llama_forward(back, tokens, cfg2, attn_impl="xla").float()
        fp32 = llama_forward(back, tokens, cfg2, attn_impl="xla", compute_dtype=torch.float32)
        hf = LlamaForCausalLM.from_pretrained(path, torch_dtype=torch.bfloat16).to(cuda_device)
        theirs = hf(tokens).logits.float()
    tol = 2 * (plain - fp32).abs().max().item()
    assert (kernel - fp32).abs().max().item() <= tol
    assert (theirs - fp32).abs().max().item() <= tol
    assert (kernel.argmax(-1) == theirs.argmax(-1)).float().mean().item() > 0.9


@pytest.mark.card
def test_card_gpt_bigcode_bf16_vs_fp32(cuda_device):
    """``gpt_bigcode_forward`` on the card in bf16 against fp32 (the
    einsum attention, no kernel): the logits within 2e-2 of the largest,
    and the hidden states of ``return_hidden`` those of ``return_embeds``."""
    from fms_fsdp_tpu_torch.models.gpt_bigcode import (
        GPTBigCodeConfig,
        gpt_bigcode_forward,
        init_gpt_bigcode_params,
    )
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    cfg = GPTBigCodeConfig(src_vocab_size=4096, emb_dim=512, nheads=4, nlayers=2,
                           max_expected_seq_len=512)
    params = init_gpt_bigcode_params(torch.Generator(device=cuda_device).manual_seed(0), cfg)
    tokens = torch.randint(0, 4096, (2, 512), device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(1))
    fa.reset_launches()
    with torch.no_grad():
        logits, embeds = gpt_bigcode_forward(params, tokens, cfg, return_embeds=True)
        hidden = gpt_bigcode_forward(params, tokens, cfg, return_hidden=True)
        ref = gpt_bigcode_forward(params, tokens, cfg, compute_dtype=torch.float32)
    assert logits.dtype == torch.bfloat16 and torch.equal(hidden, embeds)
    assert sum(fa.LAUNCHES.values()) == 0
    err = (logits.float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


# ---------------------------------------------------------------------------
# disaggregated serving: the page handoff and defrag under the kernel
# ---------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_card_handoff_round_trip_and_defrag_bitwise(cuda_device, kv_quant):
    """A prefill-role engine's handoff bytes resumed by a decode-role engine
    on the card: the imported pages equal the shipped ones, the decode
    engine's first kernel step equals a unified engine's bitwise, and it
    launches the kernel once per layer per step. Then, with the short
    requests finished, ``defrag`` moves pages and the next kernel step's
    logits equal that step's before the defrag bitwise; the page table
    cached before it (a missed version bump) reads wrong pages."""
    from fms_fsdp_tpu_torch.serve.decode import paged_decode_step
    from fms_fsdp_tpu_torch.serve.disagg import unpack_handoff

    params = init_llama_params(torch.Generator(device=cuda_device).manual_seed(0), _SMALL)
    plans = [([5, 9, 2, 7] * 3, 3), ([11, 3, 8, 1, 4, 4, 9], 12), ([7] * 20, 12), ([1, 2] * 9, 12)]
    key = "v2" if kv_quant != "none" else "v1"

    def engine(**kw):
        return ServingEngine(params, _SMALL, ServeConfig(
            max_batch=4, max_seq_len=64, page_size=16, compute_dtype="float32",
            kv_quant=kv_quant, max_prefill_per_step=4, **kw))

    pe = engine(role="prefill")
    t_paged.reset_launches()
    frames = [r for r in (pe.submit(p, n) for p, n in plans)]
    pe.run()
    assert not any(t_paged.LAUNCHES.values())
    frames = [r.handoff_out for r in frames]
    de, ue = engine(role="decode"), engine()
    dreqs = [de.submit_handoff(f) for f in frames]
    for p, n in plans:
        ue.submit(p, n)
    t_paged.reset_launches()
    de.step()
    ue.step()
    assert torch.equal(de.last_logits, ue.last_logits)
    for r, f in zip(dreqs, frames):
        header, arrays = unpack_handoff(f)
        seq = header["seq_len"]
        got = de.cache.gather_pages(r.rid)
        for name, ship in arrays.items():
            assert torch.equal(got[name].flatten(1, 2)[:, :seq], ship.flatten(1, 2)[:, :seq])
    while dreqs[0].state != "finished":
        de.step()
    ad = de.adapter
    slot_rids = [r.rid if r is not None else None for r in de._slots]
    live = [s for s, r in enumerate(slot_rids) if r is not None]
    lens, toks = de._lens.copy(), de._tokens.copy()
    _, before = ad.decode(slot_rids, lens, toks, de.generator)
    stale_table = ad._table_dev.clone()
    assert de.cache.defrag() >= 1
    _, after = ad.decode(slot_rids, lens, toks, de.generator)
    assert torch.equal(after[live], before[live])
    pools = {n: p.clone() for n, p in de.cache.pools.items()}
    stale, _, _ = paged_decode_step(
        params, pools, stale_table, torch.from_numpy(lens).to(cuda_device),
        torch.from_numpy(toks).to(cuda_device), _SMALL, page_size=16,
        compute_dtype=torch.float32, quant=kv_quant, attn_impl="kernel",
        block_kv=ad.block_kv, rope=ad.rope)
    assert not torch.equal(stale[live], before[live])
    t_paged.reset_launches()
    steps = de.decode_steps
    de.run()
    assert t_paged.LAUNCHES[key] == (de.decode_steps - steps) * _SMALL.nlayers
    assert all(r.state == "finished" for r in dreqs)


# ---------------------------------------------------------------------------
# quantized matmuls: cuBLASLt int8 / fp8 against their plain versions
# ---------------------------------------------------------------------------

# llama3_8b's GEMM widths (K, N), as chip_smoke.py's micro-table
_QUANT_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# e4m3 / e5m2 products on Hopper's tensor cores against the exact sum,
# over the largest |product| (chip_smoke.FP8_GEMM_REL_TOL)
_FP8_REL = 1e-3


def _plain_gemm(a, b_t, kind):
    """The 1-byte GEMM as a float64 product on the card: exact for int8,
    exact up to float64 rounding for fp8."""
    out = a.double() @ b_t.double().t()
    return out.round().to(torch.int32) if a.dtype == torch.int8 else out.float()


def _capturing(gemm, into):
    def run(a, b_t, kind):
        out = gemm(a, b_t, kind)
        into.append(out)
        return out

    return run


@pytest.mark.card
@pytest.mark.parametrize("mode", ["int8", "fp8", "fp8_dgrad"])
@pytest.mark.parametrize("k,n", _QUANT_SHAPES)
def test_card_quant_matmul_matches_plain(cuda_device, monkeypatch, mode, k, n):
    """The forward and backward of ``ops/quant.py::matmul`` at M = 8192
    through ``torch._int_mm`` / ``torch._scaled_mm`` against the same
    functions with the GEMM as an exact float64 product: the GEMMs' int32
    / fp32 results int8 bitwise, fp8 within ``_FP8_REL``; the bf16
    outputs int8 bitwise, fp8 within ``_FP8_REL`` plus a bf16 rounding
    step (2^-8) of the largest; each real call counted in ``GEMMS``."""
    gen = torch.Generator(device=cuda_device).manual_seed(k + n)
    x = torch.randn(2, 4096, k, generator=gen, device=cuda_device).bfloat16()
    w = (0.02 * torch.randn(k, n, generator=gen, device=cuda_device)).bfloat16()
    g = torch.randn(2, 4096, n, generator=gen, device=cuda_device).bfloat16()

    def run(gemm):
        accs = []
        monkeypatch.setattr(t_quant, "_gemm", _capturing(gemm, accs))
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = t_quant.matmul(xs, ws, quant=mode)
        out.backward(g)
        return (out.detach(), xs.grad, ws.grad), accs

    t_quant.reset_gemms()
    got, got_accs = run(t_quant._gemm)
    assert t_quant.GEMMS == {"fwd": 1, "dgrad": int(mode.endswith("_dgrad"))}
    want, want_accs = run(_plain_gemm)
    assert len(got_accs) == len(want_accs) == 1 + int(mode.endswith("_dgrad"))
    for a, b in zip(got_accs, want_accs):
        if mode == "int8":
            assert a.dtype == torch.int32 and torch.equal(a, b)
        else:
            assert float((a - b).abs().max() / b.abs().max()) <= _FP8_REL
    for name, a, b in zip(("out", "dx", "dw"), got, want):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        if mode == "int8" or name == "dw" or (name == "dx" and mode == "fp8"):
            assert torch.equal(a, b), name
        else:
            rel = float((a.float() - b.float()).abs().max() / b.float().abs().max())
            assert rel <= _FP8_REL + 2 ** -8, (name, rel)


@pytest.mark.card
def test_card_quant_expert_matmul_matches_plain(cuda_device, monkeypatch):
    """The expert form at mixtral_8x7b's widths (E = 8, 1280 capacity
    rows, 4096 <-> 14336): one 2-D call an expert, int8_dgrad bitwise its
    plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(8, 1280, 4096, generator=gen, device=cuda_device).bfloat16()
    w = (0.02 * torch.randn(8, 4096, 14336, generator=gen, device=cuda_device)).bfloat16()
    g = torch.randn(8, 1280, 14336, generator=gen, device=cuda_device).bfloat16()

    def run():
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = t_quant.expert_matmul(xs, ws, quant="int8_dgrad")
        out.backward(g)
        return out.detach(), xs.grad, ws.grad

    t_quant.reset_gemms()
    got = run()
    assert t_quant.GEMMS == {"fwd": 8, "dgrad": 8}
    monkeypatch.setattr(t_quant, "_gemm", _plain_gemm)
    for a, b in zip(got, run()):
        assert torch.equal(a, b)


@pytest.mark.card
def test_card_quant_misaligned_shape_raises(cuda_device):
    """A shape the library calls cannot take raises with the shape; no
    16-bit or plain fallback runs for a card tensor."""
    t_quant.reset_gemms()
    x = torch.randn(64, 100, device=cuda_device).bfloat16()
    with pytest.raises(ValueError, match=r"\(64, 100, 32\)"):
        t_quant.matmul(x, torch.randn(100, 32, device=cuda_device).bfloat16(), quant="int8")
    with pytest.raises(ValueError, match="_scaled_mm"):
        t_quant.matmul(torch.randn(64, 128, device=cuda_device).bfloat16(),
                       torch.randn(128, 40, device=cuda_device).bfloat16(), quant="fp8")
    with pytest.raises(ValueError, match="M > 16"):
        t_quant.matmul(torch.randn(16, 128, device=cuda_device).bfloat16(),
                       torch.randn(128, 64, device=cuda_device).bfloat16(), quant="int8")
    assert t_quant.GEMMS == {"fwd": 0, "dgrad": 0}
