"""PyTorch port, flash backward: the checks around the wgmma dq and dk/dv
kernels of ``csrc/flash_bwd_sm90.cu`` that run without a card.

- The leave-one-tile-out control of the per-block checks
  (``flash_bwd_drop_tile_plain``, used by chip_smoke.py's flash phase and
  tests/test_torch_card.py) changes exactly one 128-row dq block and one
  128-key dk/dv block, each by more than ``BF16_BLOCK_REL_TOL``, and what it
  removes is exactly one step of a dk/dv block's walk: removing every step
  of a block leaves zeros (fp32, 1e-5 of the block's largest value).
- ``block_rel_err`` on known answers.
- The profile of chip_smoke.py counts every flash kernel of the sources
  under the family its name says (``flash_dq_kernel_sm90`` as dq).
- The build key of ops/cuda_build.py covers the shared ``csrc/sm90.cuh``.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from fms_fsdp_tpu_torch.ops import cuda_build
from fms_fsdp_tpu_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _case(dtype, b, sq, sk, nq, nkv, seed):
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, nq, 128), (b, sk, nkv, 128), (b, sk, nkv, 128), (b, sq, nq, 128)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in shapes]


def _plain(q, k, v, do, causal):
    """o, lse, delta, dq, dk, dv of the plain versions."""
    o, lse = fa.flash_fwd_plain(q, k, v, causal=causal)
    delta = torch.einsum("bsnh,bsnh->bns", o.float(), do.float()).contiguous()
    dq = fa.flash_dq_plain(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa.flash_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    return o, lse, delta, dq, dk, dv


@pytest.mark.parametrize("b,sq,sk,nq,nkv,causal,batch,head,q_tile,k_block", [
    (2, 384, 384, 4, 2, True, 1, 3, 5, 0),     # the last tile of the last head
    (1, 384, 384, 4, 1, False, 0, 1, 0, 2),    # non-causal: a tile before the block
    (1, 192, 320, 4, 2, True, 0, 2, 2, 1),     # 64-row and 64-key tails, Sq != Sk
    (1, 320, 320, 2, 2, False, 0, 0, 4, 2),    # the 64-key tail block, group 1
])
def test_drop_tile_control_changes_exactly_its_blocks(b, sq, sk, nq, nkv, causal, batch,
                                                      head, q_tile, k_block):
    """bf16: the control differs from the plain version in exactly the dq
    block of its query tile and the dk/dv block of its key block, each by a
    relative error above ``BF16_BLOCK_REL_TOL``; everything else is equal."""
    q, k, v, do = _case(torch.bfloat16, b, sq, sk, nq, nkv, seed=41)
    _, lse, delta, dq, dk, dv = _plain(q, k, v, do, causal)
    ctl = fa.flash_bwd_drop_tile_plain(q, k, v, do, lse, delta, dq, dk, dv, batch=batch,
                                       head=head, q_tile=q_tile, k_block=k_block,
                                       causal=causal)
    kvh = head // (nq // nkv)
    want = {"dq": (batch, q_tile * fa.BWD_Q_TILE // fa.BWD_BLOCK, head),
            "dk": (batch, k_block, kvh), "dv": (batch, k_block, kvh)}
    for name, c, r in zip(("dq", "dk", "dv"), ctl, (dq, dk, dv)):
        rel = fa.block_rel_err(c, r)
        changed = (rel > 0).nonzero().tolist()
        assert changed == [list(want[name])], (name, changed)
        assert rel[want[name]].item() > fa.BF16_BLOCK_REL_TOL[name], (name, rel[want[name]].item())
        assert c.dtype == r.dtype and c.shape == r.shape


@pytest.mark.parametrize("causal", [True, False])
def test_drop_tile_steps_sum_to_the_plain_blocks(causal):
    """fp32: what the control removes is exactly one step of the walk.
    Leaving every (q head of the group, query tile) step out of key block
    1's walk zeroes its dk and dv; leaving every key block out of one query
    tile's rows zeroes their dq."""
    b, sq, sk, nq, nkv = 1, 192, 320, 4, 2
    q, k, v, do = _case(torch.float32, b, sq, sk, nq, nkv, seed=43)
    _, lse, delta, dq, dk, dv = _plain(q, k, v, do, causal)
    kw = dict(causal=causal)
    out = (dq, dk, dv)
    for head in (2, 3):  # the q heads of kv head 1
        for t in range(sq // fa.BWD_Q_TILE):
            out = fa.flash_bwd_drop_tile_plain(q, k, v, do, lse, delta, *out, batch=0,
                                               head=head, q_tile=t, k_block=1, **kw)
    for name, a, r in zip(("dk", "dv"), out[1:], (dk, dv)):
        block = r[0, 128:256, 1]
        assert block.abs().max() > 0, name
        assert a[0, 128:256, 1].abs().max() <= 1e-5 * block.abs().max(), name
        a[0, 128:256, 1] = 0
        r = r.clone()
        r[0, 128:256, 1] = 0
        assert torch.equal(a, r), name  # nothing else moved
    out = (dq, dk, dv)
    for kb in range(-(-sk // fa.BWD_BLOCK)):
        out = fa.flash_bwd_drop_tile_plain(q, k, v, do, lse, delta, *out, batch=0, head=1,
                                           q_tile=2, k_block=kb, **kw)
    rows = dq[0, 128:192, 1]
    assert rows.abs().max() > 0
    assert out[0][0, 128:192, 1].abs().max() <= 1e-5 * rows.abs().max()


def test_block_rel_err_known_answers():
    """One entry per (batch, 128-row block, head), the last block short;
    a zero reference block reads 0 where the other is zero too, else inf."""
    r = torch.zeros(1, 192, 2, 4)
    r[0, :128, 0] = 2.0
    r[0, 128:, 1] = 1.0
    a = r.clone()
    a[0, 0, 0, 0] += 1.0           # block (0, 0): ||d|| = 1, ||r|| = 2 * sqrt(512)
    a[0, 130, 0, 1] = 3.0          # block (1, 0): reference zero, a not
    rel = fa.block_rel_err(a, r)
    assert rel.shape == (1, 2, 2)
    assert rel[0, 0, 0].item() == pytest.approx(1 / (2 * 512**0.5))
    assert rel[0, 1, 0].item() == float("inf")
    assert rel[0, 0, 1].item() == 0.0 and rel[0, 1, 1].item() == 0.0


def _kernel_names(path):
    with open(path) as f:
        return re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(", f.read())


def test_profile_counts_the_flash_kernels_by_name():
    """Every kernel of the flash sources is a "flash" kernel to the
    profile, and ``_flash_ms`` puts its time under the family of its name:
    the sm90 dq and dk/dv kernels under dq and dk/dv, as the fp32 ones."""
    names = {}
    for src in ("flash_attention", "flash_fwd_sm90", "flash_bwd_sm90"):
        for name in _kernel_names(os.path.join(cuda_build.CSRC_DIR, src + ".cu")):
            names[name] = src
    assert set(names) == {"flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                          "flash_fwd_kernel_sm90", "flash_dq_kernel_sm90",
                          "flash_dkv_kernel_sm90"}
    family = {"fwd": "fwd", "dq": "dq", "dkv": "dkv"}
    for i, name in enumerate(sorted(names)):
        # as torch.profiler names a templated kernel of an anonymous namespace
        shown = f"void (anonymous namespace)::{name}<__nv_bfloat16>(CUtensorMap_st, int)"
        assert chip_smoke._kernel_kind(shown) == "flash", shown
        key = family[name.split("_")[1]]
        ms = chip_smoke._flash_ms([(1.0 + i, shown, 8), (100.0, "nvjet_gemm", 1)])
        assert ms == {k: (1.0 + i if k == key else 0) for k in family}, (name, ms)


def test_build_key_covers_the_sm90_header(tmp_path, monkeypatch):
    """Both wgmma sources include csrc/sm90.cuh, and an edit of the header
    changes their build directories, so an edited header rebuilds them."""
    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, src)
    for name in ("flash_fwd_sm90", "flash_bwd_sm90"):
        assert '#include "sm90.cuh"' in (src / f"{name}.cu").read_text()
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    before = {n: cuda_build._paths(n)[1] for n in ("flash_fwd_sm90", "flash_bwd_sm90")}
    with open(src / "sm90.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: cuda_build._paths(n)[1] for n in before}
    for name in before:
        assert before[name] != after[name], name
