"""PyTorch port: the per-chunk check of the fused SSD scan and its control,
on the CPU through the plain version, and the wrapper's choice of kernel
source by dtype.

The card runs the same check against the kernels (tests/test_torch_card.py
and chip_smoke.py's ssd phase); here it is held to what it must see without
a card: no error on identical outputs, and a control (one 64-token tile
left out of the state one chunk hands on) that changes exactly the chunks
after it, each by more than ``BF16_CHUNK_REL_TOL``.
"""

import numpy as np
import pytest
import torch

from fms_fsdp_tpu_torch.ops import cuda_build
from fms_fsdp_tpu_torch.ops import ssd as t_ssd
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}


def _inputs(dtype, B, S, H, G, seed=0):
    """x, dt, a, Bm, Cm with dt and A in the ranges of init_mamba_params."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, H, 64)).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((B, S, G, 128)).astype(np.float32))
    Cm = torch.from_numpy(rng.standard_normal((B, S, G, 128)).astype(np.float32))
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                             (B, S, H))).astype(np.float32))
    A = -torch.from_numpy(rng.uniform(1.0, 16.0, (H,)).astype(np.float32))
    return x.to(dtype), dt, dt * A, Bm.to(dtype), Cm.to(dtype)


def test_chunk_rel_err_reads_zero_on_identical_outputs():
    x, dt, a, Bm, Cm = _inputs(torch.bfloat16, 2, 256, 4, 2)
    y = t_ssd.ssd_core_plain(x, dt, a, Bm, Cm, 128)
    err = t_ssd.chunk_rel_err(y.clone(), y, 128)
    assert err.shape == (2, 2, 4)
    assert torch.count_nonzero(err) == 0
    # the CPU wrapper is the plain version itself
    assert torch.count_nonzero(t_ssd.chunk_rel_err(t_ssd.ssd_fused(x, dt, a, Bm, Cm, 128),
                                                   y, 128)) == 0


def test_chunk_rel_err_known_answer():
    """One chunk of one head scaled by 1.5 reads 0.5 there, 0 elsewhere."""
    y = torch.randn(1, 192, 3, 64, generator=torch.Generator().manual_seed(1))
    out = y.clone()
    out[0, 64:128, 2] *= 1.5
    err = t_ssd.chunk_rel_err(out, y, 64)
    want = torch.zeros(1, 3, 3)
    want[0, 1, 2] = 0.5
    torch.testing.assert_close(err, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["bf16", "fp16"])
@pytest.mark.parametrize("chunk,tile", [(2, 1), (1, 1)])
def test_drop_tile_control_changes_exactly_the_following_chunks(kind, chunk, tile):
    """B=2, S=512, H=4, G=2, L=128: the last tile of chunk ``chunk`` left
    out for (batch 1, head 3) changes y of that head in the next chunk and
    in no chunk that is not after ``chunk``, and every chunk it changes by
    more than the per-chunk bound. (Further chunks see the dropped tile
    through the decay exp(total) of each chunk between, which at these
    ranges of dt and A leaves the state's rounding to T unchanged.)"""
    L = 128
    x, dt, a, Bm, Cm = _inputs(_DTYPES[kind], 2, 512, 4, 2)
    ref = t_ssd.ssd_core_plain(x, dt, a, Bm, Cm, L)
    control = t_ssd.ssd_drop_tile_plain(x, dt, a, Bm, Cm, L, batch=1, head=3,
                                        chunk=chunk, tile=tile)
    err = t_ssd.chunk_rel_err(control, ref, L)
    changed = err > 0
    after = torch.zeros_like(changed)
    after[1, chunk + 1:, 3] = True
    assert changed[1, chunk + 1, 3] and not (changed & ~after).any(), err
    assert err[changed].min().item() > t_ssd.BF16_CHUNK_REL_TOL, err[changed]


@pytest.mark.parametrize("kind,source,entry", [
    ("bf16", "ssd_sm90", "ssd_fused_sm90"),
    ("fp16", "ssd_sm90", "ssd_fused_sm90"),
    ("fp32", "ssd", "ssd_fused"),
])
def test_kernel_source_by_dtype(kind, source, entry):
    """The wrapper's dispatch names the 16-bit Hopper source for bf16 and
    fp16 and keeps ssd.cu for fp32, without loading any library."""
    loaded = dict(cuda_build._LOADED)
    assert t_ssd.kernel_source(_DTYPES[kind]) == (source, entry)
    assert cuda_build._LOADED == loaded
    with open(f"{cuda_build.CSRC_DIR}/{source}.cu") as f:
        assert f'extern "C" int {entry}(' in f.read()
    with pytest.raises(ValueError, match="bf16, fp16 or fp32"):
        t_ssd.kernel_source(torch.int8)


@pytest.mark.parametrize("kind", ["bf16", "fp16"])
def test_chunk_check_passes_the_plain_version_and_fails_the_control(kind):
    """chunk_check, as the card runs it: the plain version passes against
    itself with its control above the bound on the one chunk it changes;
    the control itself, taken as the kernel's output, fails."""
    L = 128
    x, dt, a, Bm, Cm = _inputs(_DTYPES[kind], 2, 512, 4, 2, seed=5)
    ref = t_ssd.ssd_core_plain(x, dt, a, Bm, Cm, L)
    out = t_ssd.chunk_check(ref.clone(), ref, x, dt, a, Bm, Cm, L)
    assert out["ok"] and out["kernel_max"] == 0 and out["control_chunks"] == 1
    assert out["control_min"] > out["tol"]
    faulty = t_ssd.ssd_drop_tile_plain(x, dt, a, Bm, Cm, L, batch=1, head=2, chunk=0, tile=1)
    assert not t_ssd.chunk_check(faulty, ref, x, dt, a, Bm, Cm, L)["ok"]
    # one chunk: no carried state, no control
    one = t_ssd.chunk_check(ref[:, :L], ref[:, :L], x[:, :L], dt[:, :L], a[:, :L],
                            Bm[:, :L], Cm[:, :L], L)
    assert one["ok"] and one["control_min"] is None and one["control_chunks"] == 0


def test_profile_counts_both_ssd_kernels_by_name():
    """chip_smoke.py's step profile puts the kernels of ssd.cu and
    ssd_sm90.cu under the SSD family, by the names torch.profiler shows."""
    import re

    import chip_smoke

    names = []
    for src in ("ssd", "ssd_sm90"):
        with open(f"{cuda_build.CSRC_DIR}/{src}.cu") as f:
            names += re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(",
                                f.read())
    assert names == ["ssd_fused_kernel", "ssd_fused_sm90_kernel"]
    for name in names:
        shown = f"void (anonymous namespace)::{name}<__nv_bfloat16, 2>(__nv_bfloat16 const*)"
        assert chip_smoke._kernel_kind(shown) == "ssd_fused", shown
