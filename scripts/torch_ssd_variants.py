#!/usr/bin/env python3
"""Build variants of the port's bf16/fp16 SSD scan kernel
(``fms_fsdp_tpu_torch/csrc/ssd_sm90.cu``), each the source with a few text
substitutions, check each against the plain version and time them in turns
at the Mamba training shape on one NVIDIA card.

    python scripts/torch_ssd_variants.py            # the design ablations below
    python scripts/torch_ssd_variants.py spec.json  # {name: [[old, new], ...]}

Per variant: ptxas registers and spills, the whole-tensor relative error
and ``ssd.chunk_check`` against the plain version at B=2, S=4096, H=128,
G=1, L=256 (bf16), and the CUDA-event time per call, measured in turns
(each variant twice, in order and then reversed). A variant that drops
work (the ``no_*`` ones) gives a wrong output on purpose: its time says
what that work costs. One JSON line at the end.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name -> substitutions applied to ssd_sm90.cu
ABLATIONS = {
    "as_committed": [],
    # one exponential a weight on every tile, not only on the diagonal one
    "exp_per_weight": [["            if (diag) {\n", "            if (true) {\n"]],
    # the diagonal tiles' exponentials left out (wrong output)
    "no_diag_exp": [["expf(ci0 - cj0)", "(ci0 - cj0)"], ["expf(ci0 - cj1)", "(ci0 - cj1)"],
                    ["expf(ci1 - cj0)", "(ci1 - cj0)"], ["expf(ci1 - cj1)", "(ci1 - cj1)"]],
    # the state update left out (wrong output)
    "no_state": [["        mma_state<T>(st, b_ring_u", "        if (false) mma_state<T>(st, b_ring_u"]],
    # the inter-chunk term C . s_prev left out (wrong output)
    "no_inter": [["if (chunk > 0) {\n        mma_rows_cols", "if (false) {\n        mma_rows_cols"]],
}


def build(variants, out_dir):
    from fms_fsdp_tpu_torch.ops import cuda_build

    text = open(os.path.join(cuda_build.CSRC_DIR, "ssd_sm90.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise ValueError(f"variant {name}: {old!r} is not in ssd_sm90.cu")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR,
             "-o", os.path.join(out_dir, f"lib{name}.so"), path],
            stderr=subprocess.PIPE, text=True)
    built, ptxas = {}, {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build of variant {name} failed:\n{err}")
        ptxas[name] = {}
        for kernel, report in cuda_build.ptxas_summary(err).items():
            # by the mangled name's type and heads per block
            dtype = "bf16" if "bfloat16" in kernel else "fp16"
            hb = re.search(r"Li(\d)E", kernel).group(1)
            ptxas[name][f"{dtype}, HB={hb}"] = report
        fn = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")).ssd_fused_sm90
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 6 + [i] * 8 + [ll] * 6 + [p]
        fn.restype = ctypes.c_int
        built[name] = fn
    return built, ptxas


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import torch

    if not torch.cuda.is_available():
        print("torch_ssd_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fms_fsdp_tpu_torch.ops import ssd

    variants = ABLATIONS
    if argv:
        with open(argv[0]) as f:
            variants = json.load(f)
    fns, ptxas = build(variants, os.path.join(REPO, "build", "ssd_variants"))
    shape = (2, 4096, 128, 1, 256)
    gen = torch.Generator(device="cuda").manual_seed(3)
    sets = [cs._ssd_inputs(gen, torch.bfloat16, *shape[:4])[:5] for _ in range(2)]
    L = shape[-1]
    entry = ssd._entry
    out = {name: {"ptxas": ptxas[name], "ms": []} for name in fns}
    try:
        ref = ssd.ssd_core_plain(*sets[0], L)
        for name, fn in fns.items():
            ssd._entry = lambda dtype, fn=fn: (fn, "ssd_fused_sm90")
            got = ssd.ssd_fused(*sets[0], L)
            torch.cuda.synchronize()
            chk = ssd.chunk_check(got, ref, *sets[0], L)
            out[name].update(rel_err=cs._rel_err(got, ref), chunk_max=chk["kernel_max"],
                             checks_pass=chk["ok"])
        del ref
        for name in list(fns) + list(fns)[::-1]:
            ssd._entry = lambda dtype, fn=fns[name]: (fn, "ssd_fused_sm90")
            out[name]["ms"].append(
                cs.cuda_time_ms(lambda i: ssd.ssd_fused(*sets[i % 2], L), reps=50, warmup=5))
    finally:
        ssd._entry = entry
    print(json.dumps({"shape": dict(zip("BSHGL", shape)), "variants": out,
                      "nvidia_smi": cs.nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
