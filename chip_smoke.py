#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

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

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "serve", "serve-int8")

# llama3_8b decode shapes of the kernel phase
B, NQ, NKV, H, PAGE, MAXP = 8, 32, 8, 128, 64, 32
# copies of the pools the timed loops rotate through, as the layers of a
# decode step do, so K/V reads are not served from a warm L2 (50 MB)
POOL_COPIES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}  # dense bf16 tensor / fp32 SIMT
TOL = {"bf16": 2e-2, "fp32": 1e-5, "int8": 2e-2, "e4m3": 2e-2}
# Pallas kernels this port's kernel replaces
REPLACES = {
    "v1": "fms_fsdp_tpu/ops/paged_attention.py:129",
    "v2": "fms_fsdp_tpu/ops/paged_attention.py:195",
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
    per_name = {}
    for e in prof.events():
        # device activity only (kernels, copies, sets); a device-side
        # annotation named after its op ("aten::mm") spans that op's
        # kernels and would count their time twice
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        if getattr(e, "is_user_annotation", False) or e.name.startswith("aten::"):
            continue
        ms, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((ms / steps, name, n // steps) for name, (ms, n) in per_name.items()),
                  reverse=True)
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
        "serve-int8": phase_serve_int8,
    }
    if "device" not in phases:
        phases.insert(0, "device")
    for p in PHASES:
        if p in phases:
            run[p](state)
    if all(p in phases for p in ("kernels", "serve", "serve-int8")):
        print(json.dumps(kernels_line(state)), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"], "count": state["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
