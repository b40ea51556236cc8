#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card
and check them.

    python chip_smoke.py                 # every phase, one card
    python chip_smoke.py --phases device,build,kernels

Phases, one JSON line each; any failure exits non-zero:

1. device  — card name and count, ``nvidia-smi`` name and power limit.
2. build   — compiles ``fms_fsdp_tpu_torch/csrc/*.cu`` (one nvcc per
   source, all started together) and reports each kernel's registers,
   shared memory and spills from ``-Xptxas -v``.
3. kernels — the paged-decode kernel against its plain PyTorch version at
   llama3_8b decode shapes (B=8, Nq=32, Nkv=8, H=128, page 64, 32 pages
   per row, seeded ragged lengths with 0 and page-boundary values), for
   bf16, fp32, int8 and e4m3 pools, with times from CUDA events.
4. serve   — ``ServingEngine`` on llama3_8b at full width (32 layers,
   vocab 128256, random bf16 weights from a seeded generator), 16
   requests of 64-1024 prompt tokens and 64 new tokens each, through
   the CUDA kernel. Checks completions, finite logits and launches ==
   decode steps x 32 on that wave; then refills the 8 slots and holds
   one decode step through the kernel against the same step through
   the reference attention and an fp32 step, and profiles one step.
5. serve-int8 — the same engine with int8 pools on a shorter wave, so
   the quantized (v2) contract runs end to end.
6. flash   — the three flash-attention kernels (forward, dq, dk/dv)
   against their plain versions for bf16 and fp32: the training shape
   (B=2, Nq=32, Nkv=8, S=4096, H=128, causal, group 4), the kvgrid
   contract (B=1, S=16384), a causal cross-length case (Sq=2048,
   Sk=4096) and group 1; o, lse, dq, dk and dv each within tolerance:
   fp32 within 1e-4 x max(1, |value|); bf16 within twice the plain bf16
   version's distance from fp32, and within the relative error
   ``flash_attention.BF16_REL_TOL`` of the plain bf16 version, which a
   control (the plain version with its scores rounded to bf16) must
   exceed; CUDA-event times of the first two shapes beside the plain
   versions, the bound, and SDPA (flash backend) forward and backward.
7. train   — ``fms_fsdp_tpu_torch.main_training_llama.main`` at
   llama3_8b_4k width (4096 wide, 32/8 heads, hidden 14336, vocab
   128256) and 8 layers, seq 4096, batch 2, selective AC 1/2, dummy
   data, 12 steps: finite and decreasing loss, no skipped batch, launches
   == steps x (layers + rematerialised layers) forward and steps x layers
   dq and dk/dv; tokens per card per second, MFU/HFU, peak memory and a
   profile of one step.
8. train-kvgrid — the same trainer for one step with
   ``flash_kernel_variant="kvgrid"``, so the launches of the kv-streamed
   contracts are counted on the main path too.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "serve", "serve-int8", "flash", "train",
          "train-kvgrid")

# llama3_8b decode shapes of the kernel phase
B, NQ, NKV, H, PAGE, MAXP = 8, 32, 8, 128, 64, 32
# copies of the pools the timed loops rotate through, as the layers of a
# decode step do, so K/V reads are not served from a warm L2 (50 MB)
POOL_COPIES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}  # dense bf16 tensor / fp32 SIMT
TOL = {"bf16": 2e-2, "fp32": 1e-5, "int8": 2e-2, "e4m3": 2e-2}
# Pallas kernels the port's kernels replace, by the contract a launch
# fulfils
REPLACES = {
    "v1": "fms_fsdp_tpu/ops/paged_attention.py:129",
    "v2": "fms_fsdp_tpu/ops/paged_attention.py:195",
    "fwd": "fms_fsdp_tpu/ops/flash_attention.py:62",
    "fwd_kvgrid": "fms_fsdp_tpu/ops/flash_attention.py:179",
    "dq": "fms_fsdp_tpu/ops/flash_attention.py:318",
    "dq_kvgrid": "fms_fsdp_tpu/ops/flash_attention.py:368",
    "dkv": "fms_fsdp_tpu/ops/flash_attention.py:484",
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 5) -> float:
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(state):
    import torch

    state["smi"] = nvidia_smi_line()
    state["kind"] = torch.cuda.get_device_name(0)
    state["count"] = torch.cuda.device_count()
    emit("device", kind=state["kind"], count=state["count"],
         nvidia_smi=state["smi"], torch=torch.__version__,
         cuda=torch.version.cuda)


def phase_build(state):
    from fms_fsdp_tpu_torch.ops import cuda_build

    sources = sorted(
        f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu")
    )
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    procs = {}
    for name in sources:
        procs[name] = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from fms_fsdp_tpu_torch.ops import cuda_build; "
             "cuda_build.compile_source(sys.argv[1])", name],
            cwd=REPO, stderr=subprocess.PIPE, text=True,
        )
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{err}")
    wall = time.perf_counter() - t0
    report = {}
    for name in sources:
        built = cuda_build.load(name)
        report[name] = {"library": os.path.relpath(built.path, REPO),
                        "kernels": cuda_build.ptxas_summary(built.ptxas)}
    state["build_s"] = wall
    emit("build", seconds=wall, sources=report)


def _kernel_inputs(kind, gen):
    """Seeded decode inputs: q, POOL_COPIES layers of pools (+scales),
    page table, seq_lens."""
    import torch

    from fms_fsdp_tpu_torch.ops.quant import kv_quantize

    dev = "cuda"
    q_dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    num_pages = B * MAXP + 2
    shape = (POOL_COPIES, num_pages, PAGE, NKV, H)
    q = torch.randn((B, NQ, H), generator=gen, device=dev).to(q_dtype)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    if kind in ("int8", "e4m3"):
        wire = "int8" if kind == "int8" else "fp8"
        k, ks = kv_quantize(k, wire)
        v, vs = kv_quantize(v, wire)
    else:
        k, v, ks, vs = k.to(q_dtype), v.to(q_dtype), None, None
    # rows own disjoint pages (a permutation of the allocatable ones);
    # slots past a row's length point at the zero page
    lens = [0, PAGE - 1, PAGE, 2 * PAGE - 1, MAXP * PAGE - 1]
    lens += torch.randint(1, MAXP * PAGE, (B - len(lens),), generator=gen,
                          device=dev).tolist()
    perm = (torch.randperm(num_pages - 2, generator=gen, device=dev) + 2).tolist()
    table = torch.zeros((B, MAXP), dtype=torch.int32)
    for b, pos in enumerate(lens):
        n = pos // PAGE + 1
        table[b, :n] = torch.tensor(perm[b * MAXP: b * MAXP + n])
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, ks, vs, table.to(dev), seq_lens


def _bound(kind, lens):
    """Least time for one call: bytes (each live K/V row, q, out, table
    and lens once) over HBM rate vs operations over the peak of their
    type; the larger one bounds."""
    elem = {"bf16": 2, "fp32": 4, "int8": 1, "e4m3": 1}[kind]
    q_elem = 4 if kind == "fp32" else 2
    keys = sum(min(p + 1, MAXP * PAGE) for p in lens)
    row = NKV * H * elem + (NKV * 4 if kind in ("int8", "e4m3") else 0)
    nbytes = 2 * keys * row + 2 * B * NQ * H * q_elem + B * MAXP * 4 + B * 4
    ops = 4 * keys * NQ * H  # QK^T and PV, 2 flops per MAC
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS["fp32" if kind == "fp32" else "bf16"] * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes, ops
    return ops_ms, "operations", nbytes, ops


def phase_kernels(state):
    import torch
    import torch.nn.functional as F

    from fms_fsdp_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for kind in ("bf16", "fp32", "int8", "e4m3"):
        q, k, v, ks, vs, table, lens = _kernel_inputs(kind, gen)
        scaled = ks is not None
        layer = lambda i: (k[i % POOL_COPIES], v[i % POOL_COPIES],  # noqa: E731
                           ks[i % POOL_COPIES] if scaled else None,
                           vs[i % POOL_COPIES] if scaled else None)
        kp, vp, ksp, vsp = layer(0)
        out = pa.paged_attention_kernel(q, kp, vp, table, lens,
                                        k_scales=ksp, v_scales=vsp)
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(q, kp, vp, table, lens, ksp, vsp)
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        ok = finite and err <= TOL[kind]

        def kernel(i):
            kp, vp, ksp, vsp = layer(i)
            pa.paged_attention_kernel(q, kp, vp, table, lens,
                                      k_scales=ksp, v_scales=vsp)

        def plain(i):
            kp, vp, ksp, vsp = layer(i)
            pa.paged_attention_plain(q, kp, vp, table, lens, ksp, vsp)

        ms = cuda_time_ms(kernel, reps=200, warmup=10)
        plain_ms = cuda_time_ms(plain, reps=20, warmup=3)
        # yardstick only (the port never calls it): SDPA over the
        # gathered (and dequantised) cache with a ragged-length mask
        caches = []
        for i in range(POOL_COPIES):
            kp, vp, ksp, vsp = layer(i)
            if scaled:
                kg = pa.kv_dequantize(pa.gather_pages(kp, table),
                                      pa.gather_pages(ksp, table), q.dtype)
                vg = pa.kv_dequantize(pa.gather_pages(vp, table),
                                      pa.gather_pages(vsp, table), q.dtype)
            else:
                kg, vg = pa.gather_pages(kp, table), pa.gather_pages(vp, table)
            caches.append((kg.transpose(1, 2).contiguous(),
                           vg.transpose(1, 2).contiguous()))
        mask = (torch.arange(MAXP * PAGE, device="cuda")[None, :]
                <= lens[:, None].long())[:, None, None, :]
        q4 = q[:, :, None, :]

        def library(i):
            kg, vg = caches[i % POOL_COPIES]
            F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask,
                                           enable_gqa=True)

        library_ms = cuda_time_ms(library, reps=50, warmup=5)
        lens_list = lens.tolist()
        bound_ms, bound_by, nbytes, ops = _bound(kind, lens_list)
        results[kind] = dict(
            max_abs_err=err, tol=TOL[kind], finite=finite, ok=ok, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes, ops=ops, seq_lens=lens_list,
        )
        emit("kernels", pools=kind, **results[kind])
        del q, k, v, ks, vs, caches
        torch.cuda.empty_cache()
    state["kernels"] = results
    bad = [kind for kind, r in results.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _serve(state, phase, kv_quant, n_requests, max_prompt, max_new, seed):
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.models.llama import init_llama_params
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
    from fms_fsdp_tpu_torch.serve.decode import paged_decode_step
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config

    cfg = get_model_config("llama3_8b")
    if "params" not in state:
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        state["params"] = init_llama_params(gen, cfg, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        state["init_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(
        state["params"], cfg,
        ServeConfig(max_batch=8, max_seq_len=2048, kv_quant=kv_quant),
        seed=seed,
    )
    rng = np.random.RandomState(seed)
    prompts = [
        rng.randint(0, cfg.src_vocab_size, size=int(n)).tolist()
        for n in rng.randint(64, max_prompt + 1, size=n_requests)
    ]
    reqs = [eng.submit(p, max_new) for p in prompts]
    key = "v2" if kv_quant != "none" else "v1"

    pa.reset_launches()
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        if eng.last_logits is not None and not torch.isfinite(eng.last_logits).all():
            raise AssertionError(f"{phase}: non-finite decode logits")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.LAUNCHES[key]
    other = pa.LAUNCHES["v1" if key == "v2" else "v2"]
    steps = eng.decode_steps

    stats = eng.serving_stats()
    ttft = sorted(eng.registry.hist("serve.ttft_s").samples)
    result = dict(
        kv_quant=kv_quant, requests=n_requests, max_new_tokens=max_new,
        prompt_tokens=sum(len(p) for p in prompts),
        finished=sum(r.state == "finished" for r in reqs),
        all_lengths_ok=all(len(r.generated) == max_new for r in reqs),
        decode_steps=steps, layers=cfg.nlayers,
        kernel_launches=launches, other_contract_launches=other,
        decode_tokens_per_s=stats["tokens_per_s"],
        ttft_mean_s=float(np.mean(ttft)) if ttft else None,
        ttft_p99_s=ttft[min(len(ttft) - 1, int(0.99 * len(ttft)))] if ttft else None,
        wall_s=wall, max_memory_allocated=torch.cuda.max_memory_allocated(),
        weight_bytes=_nbytes(eng.params), pool_bytes=_nbytes(eng.cache.pools),
        paged_kernel_impl=stats["paged_kernel_impl"],
    )

    # after the measured wave: fill all 8 slots again, decode a few
    # steps, then compare one step kernel vs reference vs fp32 and
    # profile one step on that state
    for p in prompts[:8]:
        eng.submit(p, max_new)
    while eng.has_work() and (sum(r is not None for r in eng._slots) < 8
                              or eng.decode_steps < steps + 12):
        eng.step()
    result["compare"] = _compare_step(eng, paged_decode_step)
    result["step_profile"] = _profile_step(eng, paged_decode_step)
    eng.run()
    result["nvidia_smi"] = state["smi"]
    if phase == "serve":
        result["param_init_s"] = state["init_s"]
    emit(phase, **result)
    state[phase] = result
    problems = []
    if result["finished"] != n_requests or not result["all_lengths_ok"]:
        problems.append("not every request finished with max_new_tokens")
    if launches != steps * cfg.nlayers or other != 0:
        problems.append(
            f"launches {launches} (other {other}) != decode steps "
            f"{steps} x {cfg.nlayers}"
        )
    if not result["compare"]["ok"]:
        problems.append(f"kernel step vs reference step: {result['compare']}")
    if problems:
        raise AssertionError(f"{phase}: " + "; ".join(problems))
    del eng
    torch.cuda.empty_cache()


def _step_inputs(eng):
    """The engine's current decode inputs on the card."""
    import torch

    ad = eng.adapter
    slot_rids = [r.rid if r is not None else None for r in eng._slots]
    table = torch.from_numpy(ad.cache.page_table(slot_rids, ad.max_pages)).cuda()
    lens = torch.from_numpy(eng._lens.copy()).cuda()
    toks = torch.from_numpy(eng._tokens.copy()).cuda()
    return table, lens, toks


def _kernel_rows(prof, steps):
    """(ms per step, name, calls per step) of every device kernel, copy
    and set in a profile, longest first. A device-side annotation named
    after its op ("aten::mm") spans that op's kernels and would count
    their time twice, so those rows are left out."""
    per_name = {}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        if getattr(e, "is_user_annotation", False) or e.name.startswith("aten::"):
            continue
        ms, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return sorted(((ms / steps, name, n // steps) for name, (ms, n) in per_name.items()),
                  reverse=True)


def _profile_step(eng, paged_decode_step, steps=5):
    """Where one full-batch decode step's time goes: host wall per step
    (no profiler), device kernel time per step and the paged-decode
    kernel's share (torch.profiler, CUPTI), on a copy of the pools."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ad = eng.adapter
    table, lens, toks = _step_inputs(eng)
    pools = {n: p.clone() for n, p in ad.cache.pools.items()}

    def one():
        paged_decode_step(
            eng.params, pools, table, lens, toks, eng.model_cfg,
            page_size=ad.page_size, compute_dtype=eng.compute_dtype,
            quant=eng.serve_cfg.kv_quant, attn_impl="kernel",
            block_kv=ad.block_kv, rope=ad.rope,
        )

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, steps)
    device_ms = sum(r[0] for r in rows)
    attn_ms = sum(r[0] for r in rows if "paged_decode_kernel" in r[1])
    del pools
    return {
        "active_rows": int(sum(r is not None for r in eng._slots)),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if rows else None,
        "device_busy_share": device_ms / wall_ms if rows else None,
        "paged_decode_ms_per_step": attn_ms if rows else None,
        "top_device_ms_per_step": [
            {"name": name[:80], "ms": ms, "calls": calls} for ms, name, calls in rows[:8]
        ],
    }


def _compare_step(eng, paged_decode_step):
    """One decode step on the same pool state three ways: bf16 through
    the kernel, bf16 through the reference attention, and an fp32 step
    (the same weights widened, reference attention). The bf16 tolerance
    is the reference bf16 step's own distance from the fp32 step,
    measured here: the kernel step must lie within twice that distance
    of the reference step, and no further than that from the fp32 step.
    """
    import torch

    ad = eng.adapter
    table, lens, toks = _step_inputs(eng)
    quant = eng.serve_cfg.kv_quant

    def step(params, dtype, impl):
        pools = {n: p.to(dtype if quant == "none" else p.dtype, copy=True)
                 for n, p in ad.cache.pools.items()}
        out, _, _ = paged_decode_step(
            params, pools, table, lens, toks, eng.model_cfg,
            page_size=ad.page_size, compute_dtype=dtype, quant=quant,
            attn_impl=impl, block_kv=ad.block_kv, rope=ad.rope,
        )
        return out.float()

    kernel = step(eng.params, eng.compute_dtype, "kernel")
    ref = step(eng.params, eng.compute_dtype, "reference")
    params32 = {
        n: ({k: w.float() for k, w in v.items()} if isinstance(v, dict) else v.float())
        for n, v in eng.params.items()
    }
    fp32 = step(params32, torch.float32, "reference")
    del params32
    torch.cuda.empty_cache()

    def dmax(a, b):
        return (a - b).abs().max().item()

    tol = 2 * dmax(ref, fp32)
    out = {
        "kernel_vs_reference": dmax(kernel, ref),
        "reference_vs_fp32": dmax(ref, fp32),
        "kernel_vs_fp32": dmax(kernel, fp32),
        "tolerance": tol,
        "argmax_kernel_vs_reference": (kernel.argmax(-1) == ref.argmax(-1)).float().mean().item(),
        "argmax_kernel_vs_fp32": (kernel.argmax(-1) == fp32.argmax(-1)).float().mean().item(),
        "argmax_reference_vs_fp32": (ref.argmax(-1) == fp32.argmax(-1)).float().mean().item(),
        "logit_absmax": fp32.abs().max().item(),
    }
    out["ok"] = out["kernel_vs_reference"] <= tol and out["kernel_vs_fp32"] <= tol
    return out


def phase_serve(state):
    _serve(state, "serve", "none", n_requests=16, max_prompt=1024,
           max_new=64, seed=0)


def phase_serve_int8(state):
    _serve(state, "serve-int8", "int8", n_requests=8, max_prompt=512,
           max_new=32, seed=1)


# ---------------------------------------------------------------------------
# training: the flash kernels and the trainer
# ---------------------------------------------------------------------------

# (name, B, Sq, Sk, Nq, Nkv), causal; the first two are timed
FLASH_CASES = (
    ("train", 2, 4096, 4096, 32, 8),
    ("kvgrid", 1, 16384, 16384, 32, 8),
    ("cross", 1, 2048, 4096, 32, 8),
    ("group1", 1, 4096, 4096, 8, 8),
)
FLASH_TIMED = ("train", "kvgrid")
# fp32: sums in another order over up to 16384 keys and a GQA group of 4
FLASH_FP32_REL_TOL = 1e-4
# the products of each kernel (fwd: QK^T, PV; dq: QK^T, dP, dQ; dk/dv:
# QK^T, dP, dK, dV)
FLASH_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}
TRAIN_KW = {
    "model_variant": "llama3_8b_4k", "LlamaConfig.nlayers": 8, "seq_length": 4096,
    "batch_size": 2, "vocab_size": 128256, "fsdp_activation_checkpointing": True,
    "selective_checkpointing": 0.5, "use_dummy_dataset": True, "num_steps": 12,
    "report_interval": 4, "checkpoint_interval": 1000,
}


def _flash_all(fa, q, k, v, do, kernel):
    """[o, lse, dq, dk, dv] through the kernels or the plain versions,
    delta from that path's own o."""
    fwd, dq_fn, dkv_fn = ((fa.flash_fwd, fa.flash_dq, fa.flash_dkv) if kernel else
                          (fa.flash_fwd_plain, fa.flash_dq_plain, fa.flash_dkv_plain))
    o, lse = fwd(q, k, v, causal=True)
    delta = _delta(o, do)
    dq = dq_fn(q, k, v, do, lse, delta, causal=True)
    dk, dv = dkv_fn(q, k, v, do, lse, delta, causal=True)
    return [o, lse, dq, dk, dv]


def _flash_control(fa, q, k, v, do):
    """The plain versions with their scores rounded to bf16 before exp2: a
    fault of the kind a loose tolerance lets through, which the bf16
    check must catch."""
    import torch

    scores = fa._scores2
    fa._scores2 = lambda *a: scores(*a).to(torch.bfloat16).float()
    try:
        return _flash_all(fa, q, k, v, do, kernel=False)
    finally:
        fa._scores2 = scores


def _rel_err(a, r) -> float:
    """||a - r|| / ||r|| over the whole tensor, in fp32."""
    r = r.float()
    return ((a.float() - r).norm() / r.norm()).item()


def _delta(o, do):
    import torch

    return torch.einsum("bsnh,bsnh->bns", o.float(), do.float()).contiguous()


def _timed_ms(fn, budget_ms=400.0, max_reps=20):
    """CUDA-event mean over as many calls as fit the budget (2 at least)."""
    first = cuda_time_ms(fn, reps=1, warmup=1)
    reps = int(max(2, min(max_reps, budget_ms / max(first, 1e-3))))
    return cuda_time_ms(fn, reps=reps, warmup=0)


def _attention_flops(b, sq, sk, nq, h, products):
    """Operations of ``products`` (query x key x head) products over the
    causally attended (query, key) pairs (top-left diagonal), 2 flops a
    multiply-add."""
    n = min(sq, sk)
    pairs = n * (n + 1) // 2 + (sq - n) * sk
    return float(2 * products * b * nq * h * pairs)


def _flash_bound(kind, shape, products, nbytes):
    b, sq, sk, nq, _ = shape
    ops = _attention_flops(b, sq, sk, nq, 128, products)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[kind] * 1e3
    return (bytes_ms, "bytes", ops) if bytes_ms >= ops_ms else (ops_ms, "operations", ops)


def _flash_times(fa, kind, dtype, shape, gen):
    """Kernel, plain and SDPA times of the three kernels at one shape,
    rotating over two input sets."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, sq, sk, nq, nkv = shape
    sets = []
    for _ in range(2):
        q = torch.randn((b, sq, nq, 128), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, sk, nkv, 128), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, sk, nkv, 128), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, sq, nq, 128), generator=gen, device="cuda").to(dtype)
        o, lse = fa.flash_fwd(q, k, v)
        sets.append((q, k, v, do, o, lse, _delta(o, do)))

    def pick(i):
        return sets[i % len(sets)]

    out = {}
    out["fwd"] = _timed_ms(lambda i: fa.flash_fwd(*pick(i)[:3]))
    out["dq"] = _timed_ms(lambda i: fa.flash_dq(*pick(i)[:4], *pick(i)[5:]))
    out["dkv"] = _timed_ms(lambda i: fa.flash_dkv(*pick(i)[:4], *pick(i)[5:]))
    plain = {
        "fwd": _timed_ms(lambda i: fa.flash_fwd_plain(*pick(i)[:3]), 0, 2),
        "dq": _timed_ms(lambda i: fa.flash_dq_plain(*pick(i)[:4], *pick(i)[5:]), 0, 2),
        "dkv": _timed_ms(lambda i: fa.flash_dkv_plain(*pick(i)[:4], *pick(i)[5:]), 0, 2),
    }
    # yardstick only (the port never calls it): SDPA, flash backend for
    # 16-bit inputs; forward, the backward of a retained graph (one
    # autograd call that gives dq, dk and dv together), and both
    backends = ([SDPBackend.FLASH_ATTENTION] if dtype != torch.float32
                else [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH])
    lib = {"backend": [str(x) for x in backends]}
    try:
        graphs = []
        for q, k, v, do, *_ in sets:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            with sdpa_kernel(backends):
                ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                    enable_gqa=True)
            graphs.append((qt, kt, vt, ot, do.transpose(1, 2)))

        def lib_fwd(i):
            qt, kt, vt, _, _ = graphs[i % 2]
            with sdpa_kernel(backends), torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        def lib_bwd(i):
            qt, kt, vt, ot, dot = graphs[i % 2]
            torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

        def lib_fwd_bwd(i):
            qt, kt, vt, _, dot = graphs[i % 2]
            with sdpa_kernel(backends):
                ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                    enable_gqa=True)
            torch.autograd.grad(ot, (qt, kt, vt), dot)

        lib["fwd_ms"] = _timed_ms(lib_fwd)
        lib["bwd_ms"] = _timed_ms(lib_bwd)
        lib["fwd_bwd_ms"] = _timed_ms(lib_fwd_bwd)
        del graphs
    except RuntimeError as e:  # no SDPA kernel for this dtype/shape
        lib.update(fwd_ms=None, bwd_ms=None, fwd_bwd_ms=None, error=str(e)[:200])
    elem = 4 if dtype == torch.float32 else 2
    qb, kvb, stat = b * sq * nq * 128 * elem, b * sk * nkv * 128 * elem, b * nq * sq * 4
    nbytes = {"fwd": qb + 2 * kvb + qb + stat,
              "dq": 2 * qb + 2 * kvb + 2 * stat + qb,
              "dkv": 2 * qb + 2 * kvb + 2 * stat + 2 * (kvb // elem) * 4}
    for name in ("fwd", "dq", "dkv"):
        bound_ms, bound_by, ops = _flash_bound(kind, shape, FLASH_PRODUCTS[name], nbytes[name])
        out[name] = {"ms": out[name], "plain_ms": plain[name], "bound_ms": bound_ms,
                     "bound_by": bound_by, "ops": ops, "bytes": nbytes[name],
                     "achieved_tflops": ops / out[name] / 1e9,
                     "library_ms": lib["fwd_ms"] if name == "fwd" else lib["bwd_ms"]}
    out["sdpa"] = lib
    del sets
    return out


def phase_flash(state):
    import torch

    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    state.pop("params", None)  # the serve phases' weights
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(2)
    results, bad = {}, []
    for kind, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        for name, b, sq, sk, nq, nkv in FLASH_CASES:
            q = torch.randn((b, sq, nq, 128), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, sk, nkv, 128), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, sk, nkv, 128), generator=gen, device="cuda").to(dtype)
            do = torch.randn((b, sq, nq, 128), generator=gen, device="cuda").to(dtype)
            fa.reset_launches()
            got = _flash_all(fa, q, k, v, do, kernel=True)
            torch.cuda.synchronize()
            kv = "_kvgrid" if fa._use_kvgrid(sk) else ""
            launched = dict(fa.LAUNCHES)
            ref = _flash_all(fa, q, k, v, do, kernel=False)
            names = ("o", "lse", "dq", "dk", "dv")
            rel_ok = True
            if kind == "fp32":
                tols = [FLASH_FP32_REL_TOL * max(1.0, r.abs().max().item()) for r in ref]
                dist = rel = None
            else:
                wide = _flash_all(fa, q.float(), k.float(), v.float(), do.float(), kernel=False)
                dist = [(r.float() - w).abs().max().item() for r, w in zip(ref, wide)]
                tols = [2 * d for d in dist]
                del wide
                control = _flash_control(fa, q, k, v, do)
                rel = {n: {"kernel": _rel_err(a, r_), "control": _rel_err(c, r_),
                           "tol": fa.BF16_REL_TOL[n]}
                       for n, a, c, r_ in zip(names, got, control, ref)}
                del control
                rel_ok = all(x["kernel"] <= x["tol"] < x["control"] for x in rel.values())
            errs = [(a.float() - r.float()).abs().max().item() for a, r in zip(got, ref)]
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            zero_tail = (sk <= sq or (torch.count_nonzero(got[3][:, sq:]) == 0
                                      and torch.count_nonzero(got[4][:, sq:]) == 0))
            r = {
                "shape": {"B": b, "Sq": sq, "Sk": sk, "Nq": nq, "Nkv": nkv, "H": 128},
                "contract": "kvgrid" if kv else "resident",
                "launches": launched,
                "max_abs_err": dict(zip(names, errs)), "tol": dict(zip(names, tols)),
                "plain_bf16_vs_fp32": dict(zip(names, dist)) if dist else None,
                "rel_err_vs_plain_bf16": rel,
                "finite": finite, "zero_dkv_past_last_query": bool(zero_tail),
            }
            r["ok"] = (finite and bool(zero_tail) and rel_ok
                       and all(e <= t for e, t in zip(errs, tols))
                       and launched["fwd" + kv] == 1 and launched["dq" + kv] == 1
                       and launched["dkv"] == 1)
            del q, k, v, do, got, ref
            torch.cuda.empty_cache()
            if name in FLASH_TIMED:
                r["times"] = _flash_times(fa, kind, dtype, (b, sq, sk, nq, nkv), gen)
                torch.cuda.empty_cache()
            emit("flash", dtype=kind, case=name, **r)
            results[(kind, name)] = r
            if not r["ok"]:
                bad.append(f"{kind}/{name}")
    state["flash"] = results
    if bad:
        raise AssertionError(f"flash kernels disagree with their plain versions: {bad}")


def _train_step_profile(res, steps=2):
    """Host wall per step (no profiler) and device time per step by
    kernel (torch.profiler) of the trained state's next steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
    from fms_fsdp_tpu_torch.data.loader import get_dummy_loader
    from fms_fsdp_tpu_torch.train.step import make_train_step

    cfg, state = res["cfg"], res["state"]
    step_fn = make_train_step(res["model_cfg"], cfg)
    batch = next(iter(DeviceFeed(get_dummy_loader(cfg, 0, 1), "cuda")))
    step_fn(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_fn(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step_fn(state, batch)
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, steps)
    device_ms = sum(r[0] for r in rows)
    flash = {key: sum(r[0] for r in rows if f"flash_{key}_kernel" in r[1])
             for key in ("fwd", "dq", "dkv")}
    return {
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if rows else None,
        "device_busy_share": device_ms / wall_ms if rows else None,
        "flash_ms_per_step": flash if rows else None,
        "top_device_ms_per_step": [
            {"name": name[:80], "ms": ms, "calls": calls} for ms, name, calls in rows[:10]
        ],
    }


def _train(state, phase, overrides, expect):
    """Run the trainer through its entry point and check its launches:
    ``expect(model_cfg, cfg, steps)`` gives the expected LAUNCHES."""
    import torch

    from fms_fsdp_tpu_torch.main_training_llama import main
    from fms_fsdp_tpu_torch.ops import flash_attention as fa

    kw = dict(TRAIN_KW, **overrides)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    res = main(**kw)
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reports = res["reports"]
    want = expect(res["model_cfg"], res["cfg"], res["steps"])
    losses = [r["loss"] for r in reports]
    last = reports[-1]
    result = dict(
        config={k: kw[k] for k in sorted(kw)},
        params=res["model_cfg"].n_params(), steps=res["steps"], wall_s=wall,
        losses=losses, gnorms=[r["gnorm"] for r in reports],
        lrs=[r["lr"] for r in reports],
        step_time_s=[r["step_time_s"] for r in reports],
        tokens_per_card_per_s=last["tokens_per_card_per_s"],
        mfu=last["mfu"], hfu=last["hfu"], peak_flops=989e12,
        skipped_batches=res["skipped_batches"], launches=launches,
        expected_launches=want, max_memory_allocated=peak,
        nvidia_smi=state["smi"],
    )
    problems = []
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"non-finite loss {losses}")
    if phase == "train" and not losses[-1] < losses[0]:
        problems.append(f"loss did not decrease: {losses}")
    if res["skipped_batches"]:
        problems.append(f"{res['skipped_batches']} skipped batches")
    if launches != want:
        problems.append(f"launches {launches} != expected {want}")
    if phase == "train":
        result["step_profile"] = _train_step_profile(res)
    emit(phase, **result)
    state[phase] = result
    del res
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"{phase}: " + "; ".join(problems))


def _n_remat(model_cfg, cfg):
    from fms_fsdp_tpu_torch.parallel.ac import selective_ac_mask

    if not cfg.fsdp_activation_checkpointing:
        return 0
    return sum(selective_ac_mask(model_cfg.nlayers, cfg.selective_checkpointing))


def phase_train(state):
    def expect(m, cfg, steps):
        n = m.nlayers
        return {"fwd": steps * (n + _n_remat(m, cfg)), "fwd_kvgrid": 0,
                "dq": steps * n, "dq_kvgrid": 0, "dkv": steps * n}

    _train(state, "train", {}, expect)


def phase_train_kvgrid(state):
    def expect(m, cfg, steps):
        n = m.nlayers
        return {"fwd": 0, "fwd_kvgrid": steps * (n + _n_remat(m, cfg)),
                "dq": 0, "dq_kvgrid": steps * n, "dkv": steps * n}

    # one step: the kernels are those of the train phase, and the flash
    # phase holds them against their plain versions at S=16384; this run
    # only counts the kv-streamed contracts' launches on the main path
    _train(state, "train-kvgrid",
           {"flash_kernel_variant": "kvgrid", "num_steps": 1, "report_interval": 1},
           expect)


def kernels_line(state):
    k, s, s8 = state["kernels"], state["serve"], state["serve-int8"]
    entries = []
    for name, key, kind, launches in (
        ("paged_decode_v1", "v1", "bf16", s["kernel_launches"]),
        ("paged_decode_v2", "v2", "int8", s8["kernel_launches"]),
    ):
        r = k[kind]
        entries.append({
            "name": name, "route": "cuda",
            "source": "fms_fsdp_tpu_torch/csrc/paged_decode.cu",
            "replaces": REPLACES[key], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    # bf16 readings: the training shape for the resident contracts, the
    # 16384-token shape for the kvgrid ones; launches from the trainer
    for contract, kernel, case, phase, outs in (
        ("fwd", "fwd", "train", "train", ("o", "lse")),
        ("fwd_kvgrid", "fwd", "kvgrid", "train-kvgrid", ("o", "lse")),
        ("dq", "dq", "train", "train", ("dq",)),
        ("dq_kvgrid", "dq", "kvgrid", "train-kvgrid", ("dq",)),
        ("dkv", "dkv", "train", "train", ("dk", "dv")),
    ):
        r = state["flash"][("bf16", case)]
        t = r["times"][kernel]
        entries.append({
            "name": f"flash_{contract}", "route": "cuda",
            "source": "fms_fsdp_tpu_torch/csrc/flash_attention.cu",
            "replaces": REPLACES[contract],
            "launches": state[phase]["launches"][contract],
            "max_abs_err": max(r["max_abs_err"][o] for o in outs),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    return {"kernels": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # the port must be importable beside this script; no fallback
    import fms_fsdp_tpu_torch.serve  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = {}
    run = {
        "device": phase_device, "build": phase_build,
        "kernels": phase_kernels, "serve": phase_serve,
        "serve-int8": phase_serve_int8, "flash": phase_flash,
        "train": phase_train, "train-kvgrid": phase_train_kvgrid,
    }
    if "device" not in phases:
        phases.insert(0, "device")
    for p in PHASES:
        if p in phases:
            run[p](state)
    if all(p in phases for p in PHASES):
        print(json.dumps(kernels_line(state)), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"], "count": state["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
