"""PyTorch port on an NVIDIA card: the CUDA paged-decode kernel against its
plain version, and the engine through the kernel against the engine
through the reference attention.

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


@pytest.mark.card
@pytest.mark.parametrize("kind,atol", [("bf16", 2e-2), ("fp32", 1e-5),
                                       ("int8", 2e-2), ("fp8", 2e-2)])
def test_card_kernel_matches_plain(cuda_device, kind, atol):
    """Tolerances: fp32 as tests/test_serving.py:215; bf16 and the
    quantized pools (bf16 compute) at 2e-2, a few bf16 ulps at |out| ~ 1."""
    q, k, v, table, lens, ks, vs = _case(cuda_device, kind)
    t_paged.reset_launches()
    out = t_paged.paged_attention_kernel(q, k, v, table, lens, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert t_paged.LAUNCHES["v2" if ks is not None else "v1"] == 1
    ref = t_paged.paged_attention_plain(q, k, v, table, lens, ks, vs)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.card
def test_card_kernel_rejects_bad_input(cuda_device):
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


# head_dim 128 (the kernel's), two layers, tiny vocab
_SMALL = LlamaConfig(src_vocab_size=128, emb_dim=256, nheads=2, kvheads=1,
                     nlayers=2, max_expected_seq_len=256)


@pytest.mark.card
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_card_engine_kernel_tokens_match_reference(cuda_device, kv_quant):
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
