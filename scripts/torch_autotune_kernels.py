#!/usr/bin/env python3
"""On-card kernel tuning sweep -> fms_fsdp_tpu_torch/tune/kernel_tuning_h100.json.

For every (kernel, shape signature, dtype) of the suite below (the shapes
``chip_smoke.py``'s phases run), enumerate the legal tile candidates
(``fms_fsdp_tpu_torch/tune/candidates.py``: the kernels' tiles, the
shared-memory budget, no device), time each on the card and write the
winner into the port's tuning table, which ``tune/lookup.py`` reads.

The parent never imports torch. Every candidate is timed in its own
``--measure`` child under a watchdog (``AUTOTUNE_CANDIDATE_TIMEOUT_S``), so
a fault or a hang yields an error entry instead of ending the sweep; a
failed candidate never wins. Times are CUDA events after warmup, the best
of ``AUTOTUNE_ROUNDS`` rounds: flash attention, the SSD scan and the fused
CE forward + backward through autograd, the paged decode through CUDA-graph
replay over pool copies that span three times the L2, at the row lengths of
``decode_lens``.

The winner is the candidate closest to the default configuration (what
``kernel_tuning="off"`` runs: the fewest knobs that differ from it, then
the fastest) among those within ``SWEEP_MARGIN`` of the fastest, so
timing noise flips no knob: the default stays unless a candidate beats it
by more than the margin, and a knob that does not matter (a page size at
a given split) keeps its default. Every candidate's time goes to the
report (``--report``); only the winner goes to the table, as a measured
entry, and the table names the card and its power limit
(``nvidia-smi``). ``--rechoose REPORT`` applies the rule again to a
report's times and writes their winners, without timing.

    python scripts/torch_autotune_kernels.py --table T --report R  # the sweep, one card
    python scripts/torch_autotune_kernels.py --dry-run    # candidates and pruning only:
        # host arithmetic, no torch; runs anywhere
    python scripts/torch_autotune_kernels.py --lookup-only [--chip h100]
        # resolve the suite through the table (exact / nearest / default)
    python scripts/torch_autotune_kernels.py --seed-cost-model [--chip h100]
        # cost-model picks for entries without a measured one (never
        # overwrites a measured entry)
    python scripts/torch_autotune_kernels.py --only paged_decode --match batch=8 ...
        # sweep some kernels (and signatures) only, merged into the table
    python scripts/torch_autotune_kernels.py --rechoose R --table T
        # the winners of report R's times into table T (no card)
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fms_fsdp_tpu_torch.tune import candidates as cand  # noqa: E402  (host code)
from fms_fsdp_tpu_torch.tune.table import (  # noqa: E402
    TuningTable,
    default_table_path,
    validate_table,
)

CANDIDATE_TIMEOUT_S = int(os.environ.get("AUTOTUNE_CANDIDATE_TIMEOUT_S", "300"))
ROUNDS = int(os.environ.get("AUTOTUNE_ROUNDS", "3"))
# candidates within this fraction of the fastest count as equally fast
SWEEP_MARGIN = 0.03

_LLAMA_FLASH = {"nq": 32, "nkv": 8, "head": 128}
_DECODE = {"nq": 32, "nkv": 8, "head": 128}
# The suite: the shapes chip_smoke.py's phases run, keyed exactly as the
# lookup keys them, so a sweep win is an exact hit there.
SUITE = [
    # train (llama3_8b_4k, B=2, S=4096) and the kvgrid contract (B=1, S=16384)
    ("flash_attention", dict(_LLAMA_FLASH, batch=2, seq_q=4096, seq_k=4096), "bfloat16"),
    ("flash_attention", dict(_LLAMA_FLASH, batch=1, seq_q=16384, seq_k=16384), "bfloat16"),
    # train-mamba (mamba_9.8b: 128 heads of 64, one group of state 128)
    ("ssd", {"batch": 2, "seq": 4096, "heads": 128, "headdim": 64, "groups": 1,
             "dstate": 128}, "bfloat16"),
    # the fused lm-head + CE of llama3 (width 4096, vocab 128256)
    ("fused_ce", {"d_model": 4096, "vocab": 128256}, "bfloat16"),
] + [
    # serving llama3_8b: 8 rows of 2048 keys (serve, serve-int8), and one row
    # of 16,384 (the kernels phase's long row), per pool type
    ("paged_decode", dict(_DECODE, batch=b, max_seq=s), dtype)
    for b, s in ((8, 2048), (1, 16384))
    for dtype in ("bfloat16", "int8", "float8_e4m3fn")
]


def suite_candidates(chip: str, only=None, match=None):
    """[(kernel, sig, dtype, [candidate, ...]), ...]: host work only;
    ``only`` keeps those kernels, ``match`` ({key: value}) the signatures
    and dtypes that carry every one of its items."""
    match = match or {}
    return [(kernel, sig, dtype, cand.CANDIDATES[kernel](sig, dtype, chip))
            for kernel, sig, dtype in SUITE if (not only or kernel in only)
            and all(str(dict(sig, dtype=dtype).get(k)) == v for k, v in match.items())]


def default_config(kernel: str, sig: dict, dtype: str) -> dict:
    """What kernel_tuning="off" runs for this signature."""
    if kernel == "flash_attention":
        fam = "kvgrid" if sig["seq_k"] > cand.MAX_KERNEL_SEQ else "resident"
        if dtype == "float32":
            return {"family": fam, "block_q": cand.FLASH_FP32_BLOCK,
                    "block_k": cand.FLASH_FP32_BLOCK}
        return {"family": fam, "block_q": cand.FLASH_DEFAULT_BLOCK_Q,
                "block_k": cand.FLASH_DEFAULT_BLOCK_K}
    if kernel == "ssd":
        return {"chunk": min(cand.SSD_DEFAULT_CHUNK, sig["seq"])}
    if kernel == "paged_decode":
        return {"page_size": cand.PAGED_DEFAULT_PAGE_SIZE,
                "block_kv": cand.PAGED_DEFAULT_BLOCK_KV}
    if kernel == "dcn_bucket":
        return {"bucket_mb": cand.DCN_BUCKET_DEFAULT_MB}
    return {"chunk": cand.CE_DEFAULT_CHUNK}


def strip(config: dict) -> dict:
    return {k: v for k, v in config.items()
            if k not in ("smem_bytes", "working_set_bytes", "cost_us")}


def cost_model_pick(kernel: str, sig: dict, cands: list, dtype: str) -> dict:
    """A pick without the card: the cheapest modeled dcn bucket; else the
    default configuration where it is legal (the tiles the kernels were
    written and checked around), else the legal candidate with the most
    shared memory (the largest tile)."""
    if kernel == "dcn_bucket":
        return strip(min(cands, key=lambda c: c["cost_us"])) if cands else default_config(
            kernel, sig, dtype)
    default = default_config(kernel, sig, dtype)
    if any(strip(c) == default for c in cands):
        return default
    if not cands:
        return default
    return strip(max(cands, key=lambda c: c.get("smem_bytes") or c.get("working_set_bytes")
                     or c.get("block_kv", 0)))


def pick_winner(timed: list, default: dict):
    """Among the candidates within SWEEP_MARGIN of the fastest, the one
    with the fewest knobs that differ from ``default``, then the fastest;
    None when no candidate ran."""
    ok = [t for t in timed if t["ms"] is not None]
    if not ok:
        return None
    best = min(t["ms"] for t in ok)
    near = [t for t in ok if t["ms"] <= best * (1 + SWEEP_MARGIN)]

    def distance(t):
        keys = set(t["config"]) | set(default)
        return sum(t["config"].get(k) != default.get(k) for k in keys)

    return min(near, key=lambda t: (distance(t), t["ms"]))


# -- child: time one candidate on the card -----------------------------------


def _events_ms(fn, torch):
    """Best of ROUNDS rounds of CUDA-event mean time per call, after a
    warmup; each round as many calls as fit ~200 ms (2 at least)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn(0)
    end.record()
    torch.cuda.synchronize()
    reps = int(max(2, min(50, 200.0 / max(start.elapsed_time(end), 1e-3))))
    best = float("inf")
    for _ in range(ROUNDS):
        start.record()
        for i in range(reps):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _graph_ms(fn, torch, reps=64):
    """Best of ROUNDS replays of ``reps`` calls captured in one CUDA graph
    (device time per call: the replay does not wait for the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = float("inf")
    for _ in range(ROUNDS):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _measure_flash(torch, sig, dtype, config):
    from fms_fsdp_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, sq, sk = sig["batch"], sig["seq_q"], sig["seq_k"]
    nq, nkv, h = sig["nq"], sig["nkv"], sig["head"]
    q, do = (torch.randn((b, sq, nq, h), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, sk, nkv, h), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    leaves = [x.requires_grad_() for x in (q, k, v)]

    def step(i):
        o = flash_attention(*leaves, causal=True, block_q=config["block_q"],
                            block_k=config["block_k"], variant=config.get("family"),
                            quant=config.get("quant"))
        torch.autograd.grad(o, leaves, do)

    return _events_ms(step, torch)


def _measure_ssd(torch, sig, dtype, config):
    from fms_fsdp_tpu_torch.ops.ssd import ssd_scan

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, hh, p, g, n = (sig[k] for k in ("batch", "seq", "heads", "headdim", "groups",
                                         "dstate"))
    x = torch.randn((b, s, hh, p), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, hh), generator=gen, device="cuda") - 4.0)
    a_neg = -torch.exp(torch.rand((hh,), generator=gen, device="cuda") * 2.7)
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    leaves = [t.requires_grad_() for t in (x, dt, bm, cm)]
    cot = torch.randn((b, s, hh, p), generator=gen, device="cuda").to(dtype)

    def step(i):
        y = ssd_scan(leaves[0], leaves[1], a_neg, leaves[2], leaves[3],
                     chunk_size=config["chunk"], kernel="auto")
        torch.autograd.grad(y, leaves, cot)

    return _events_ms(step, torch)


def _measure_ce(torch, sig, dtype, config):
    from fms_fsdp_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, v = sig["d_model"], sig["vocab"]
    tokens = 2 * 4096  # one step of the train phase (batch 2, seq 4096)
    x = (torch.randn((1, tokens, d), generator=gen, device="cuda") * 0.5).to(dtype)
    w = (torch.randn((d, v), generator=gen, device="cuda") * d**-0.5).to(dtype)
    labels = torch.randint(0, v, (1, tokens), generator=gen, device="cuda")
    leaves = [x.requires_grad_(), w.requires_grad_()]

    def step(i):
        loss = fused_linear_cross_entropy(leaves[0], leaves[1], labels, config["chunk"])
        torch.autograd.grad(loss, leaves)

    return _events_ms(step, torch)


def _measure_paged(torch, sig, dtype, config):
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.ops.quant import kv_quantize

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, nq, nkv, h, cap = (sig[k] for k in ("batch", "nq", "nkv", "head", "max_seq"))
    ps, bkv = config["page_size"], config["block_kv"]
    maxp = cap // ps
    lens = decode_lens(b, cap)  # each row on its own pages
    elem = 1 if dtype in ("int8", "float8_e4m3fn") else 2
    live = 2 * sum(n + 1 for n in lens) * nkv * h * elem
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    copies = max(2, -(-3 * l2 // live))
    num_pages = b * maxp + 2
    shape = (copies, num_pages, ps, nkv, h)
    q = torch.randn((b, nq, h), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if elem == 1:
        wire = "int8" if dtype == "int8" else "fp8"
        (k, ks), (v, vs) = kv_quantize(k, wire), kv_quantize(v, wire)
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    table = (torch.arange(2, num_pages, dtype=torch.int32, device="cuda")
             .reshape(b, maxp))
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def call(i):
        c = i % copies
        pa.paged_attention_kernel(q, k[c], v[c], table, seq_lens,
                                  k_scales=None if ks is None else ks[c],
                                  v_scales=None if vs is None else vs[c], block_kv=bkv)

    return _graph_ms(call, torch)


def decode_lens(batch: int, cap: int) -> list:
    """The positions a paged-decode signature is timed at. The signature
    holds no row lengths, so these are the rows the table's answer will
    serve: for one row, one of cap - 2 keys (the kernels phase's long
    row); for a batch, the serve phases' rows, prompts of 64 to cap / 2
    tokens drawn as ``chip_smoke.py``'s serve phase draws them (numpy
    seed 0), each halfway through its 64 new tokens."""
    if batch == 1:
        return [cap - 2]
    import numpy as np

    prompts = np.random.RandomState(0).randint(64, cap // 2 + 1, size=batch)
    return [int(n) + 32 for n in prompts]


def _measure_child(spec_json: str):
    spec = json.loads(spec_json)
    import torch

    from fms_fsdp_tpu_torch.tune.lookup import configure_kernel_tuning

    if not torch.cuda.is_available():
        raise SystemExit("the sweep times candidates on a CUDA card; none is visible")
    # the candidate under test is exactly what runs, never a table's answer
    configure_kernel_tuning("off")
    kernel, sig, config = spec["kernel"], spec["sig"], spec["config"]
    dtype = getattr(torch, spec["dtype"]) if kernel != "paged_decode" else spec["dtype"]
    measure = {"flash_attention": _measure_flash, "ssd": _measure_ssd,
               "fused_ce": _measure_ce, "paged_decode": _measure_paged}[kernel]
    ms = measure(torch, sig, dtype, config)
    print("AUTOTUNE_JSON:" + json.dumps({"ms": ms}), flush=True)


# -- parent -------------------------------------------------------------------


def _run(code: str, timeout: int):
    return subprocess.run([sys.executable, "-c", code], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, timeout=timeout, text=True, cwd=REPO)


def _detect_chip() -> str:
    """Chip key through a probe child (the parent never imports torch)."""
    try:
        proc = _run("from fms_fsdp_tpu_torch.tune.lookup import chip_kind;"
                    "print('CHIP:' + chip_kind())", 240)
    except subprocess.TimeoutExpired:
        return "unknown"
    for line in (proc.stdout or "").splitlines():
        if line.startswith("CHIP:"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def _build_kernels():
    """Compile the kernels the suite runs, one nvcc each, all at once, so
    no candidate's watchdog pays for a build."""
    names = ("flash_fwd_sm90", "flash_bwd_sm90", "ssd_sm90", "paged_decode")
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from fms_fsdp_tpu_torch.ops import cuda_build; "
         "cuda_build.compile_source(sys.argv[1])", name],
        cwd=REPO, stderr=subprocess.PIPE, text=True) for name in names]
    for name, proc in zip(names, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{err}")


def time_candidate(kernel, sig, dtype, config):
    spec = json.dumps({"kernel": kernel, "sig": sig, "dtype": dtype, "config": config})
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", spec],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            timeout=CANDIDATE_TIMEOUT_S, text=True, cwd=REPO,
        )
    except subprocess.TimeoutExpired:
        return None, f"timeout after {CANDIDATE_TIMEOUT_S}s"
    for line in (proc.stdout or "").splitlines():
        if line.startswith("AUTOTUNE_JSON:"):
            return json.loads(line[len("AUTOTUNE_JSON:"):])["ms"], None
    tail = " | ".join((proc.stdout or "").strip().splitlines()[-3:])
    return None, f"rc={proc.returncode}: {tail}"[:400]


def lookup_suite(table_path: str, chip: str):
    """Resolve every suite shape through the table: [{kernel, signature,
    dtype, resolved}, ...] with each resolver's ``how``."""
    from fms_fsdp_tpu_torch.tune import lookup

    lookup.configure_kernel_tuning("auto", table_path, chip=chip)
    out = []
    for kernel, sig, dtype in SUITE:
        if kernel == "flash_attention":
            bq, bk, fam, qnt, how = lookup.resolve_flash(
                (sig["batch"], sig["seq_q"], sig["nq"], sig["head"]),
                (sig["batch"], sig["seq_k"], sig["nkv"], sig["head"]), dtype, chip=chip)
            r = {"block_q": bq, "block_k": bk, "family": fam, "quant": qnt, "how": how}
        elif kernel == "ssd":
            L = lookup.resolve_ssd_chunk(
                (sig["batch"], sig["seq"], sig["heads"], sig["headdim"]), sig["groups"],
                sig["dstate"], dtype, requested=min(cand.SSD_DEFAULT_CHUNK, sig["seq"]),
                chip=chip)
            r = {"chunk": L, "how": lookup.choices()["ssd"]["how"]}
        elif kernel == "paged_decode":
            ps, bkv, how = lookup.resolve_paged_decode(
                sig["batch"], sig["nq"], sig["nkv"], sig["head"], sig["max_seq"], dtype,
                chip=chip)
            r = {"page_size": ps, "block_kv": bkv, "how": how}
        else:
            c = lookup.resolve_ce_chunk(sig["d_model"], sig["vocab"], dtype,
                                        requested=cand.CE_DEFAULT_CHUNK, chip=chip)
            r = {"chunk": c, "how": lookup.choices()["ce"]["how"]}
        out.append({"kernel": kernel, "signature": sig, "dtype": dtype, "resolved": r})
    lookup.configure_kernel_tuning(None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="candidate generation and pruning only")
    ap.add_argument("--lookup-only", action="store_true",
                    help="resolve the suite through the table, no timing")
    ap.add_argument("--seed-cost-model", action="store_true",
                    help="write cost-model picks for entries lacking a measured one")
    ap.add_argument("--chip", default=os.environ.get("FMS_TUNE_CHIP", ""),
                    help="chip key for the table (default: detect; h100 for --dry-run)")
    ap.add_argument("--table", default=default_table_path())
    ap.add_argument("--report", default="",
                    help="the sweep's JSON report: every candidate's time")
    ap.add_argument("--only", nargs="*", default=None,
                    help=f"sweep these kernels only ({sorted(cand.CANDIDATES)})")
    ap.add_argument("--match", nargs="*", default=[], metavar="KEY=VALUE",
                    help="sweep the suite's shapes whose signature (or dtype) has these")
    ap.add_argument("--rechoose", default="",
                    help="a sweep report: write its winners into --table, no timing")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.measure:
        _measure_child(args.measure)
        return 0

    chip = args.chip or ("h100" if args.dry_run else _detect_chip())
    match = dict(m.split("=", 1) for m in args.match)

    if args.dry_run:
        report = [{"kernel": kernel, "signature": sig, "dtype": dtype, "chip": chip,
                   "legal_candidates": len(cands), "candidates": cands,
                   "default": default_config(kernel, sig, dtype),
                   "cost_model_pick": cost_model_pick(kernel, sig, cands, dtype)}
                  for kernel, sig, dtype, cands in suite_candidates(chip, args.only, match)]
        doc = {"mode": "dry_run", "chip": chip, "suite": report}
        if os.path.exists(args.table):
            with open(args.table) as f:
                doc["table_violations"] = validate_table(json.load(f))
        print(json.dumps(doc, indent=1))
        return 0

    if args.lookup_only:
        print(json.dumps({"mode": "lookup_only", "chip": chip, "table": args.table,
                          "resolved": lookup_suite(args.table, chip)}, indent=1))
        return 0

    try:
        table = TuningTable.load(args.table)
    except (OSError, ValueError):
        table = TuningTable(path=args.table)

    if args.rechoose:
        with open(args.rechoose) as f:
            report = json.load(f)
        table.doc["card"] = report["card"]
        for r in report["results"]:
            win = pick_winner(r["timed"], r["default"])
            if win is not None:
                table.add(r["kernel"], report["chip"], r["dtype"], r["signature"],
                          win["config"], source="measured", measured_ms=round(win["ms"], 4))
        table.save(args.table)
        print(json.dumps({"mode": "rechoose", "report": args.rechoose, "table": args.table,
                          "entries": len(table.doc["entries"])}))
        return 0

    if args.seed_cost_model:
        for kernel, sig, dtype, cands in suite_candidates(chip, args.only, match):
            table.add(kernel, chip, dtype, sig, cost_model_pick(kernel, sig, cands, dtype),
                      source="cost_model")
        table.save(args.table)
        print(json.dumps({"mode": "seed_cost_model", "chip": chip,
                          "entries": len(table.doc["entries"])}))
        return 0

    # the sweep
    t0 = time.time()
    card = _card()
    table.doc["card"] = card
    _build_kernels()
    results = []

    def write_report():
        if args.report:
            with open(args.report, "w") as f:
                json.dump({"mode": "sweep", "chip": chip, "card": card,
                           "margin": SWEEP_MARGIN, "seconds": time.time() - t0,
                           "results": results}, f, indent=1)

    for kernel, sig, dtype, cands in suite_candidates(chip, args.only, match):
        default = default_config(kernel, sig, dtype)
        timed = []
        for config in cands:
            config = strip(config)
            ms, err = time_candidate(kernel, sig, dtype, config)
            status = f"{ms:.4f} ms" if ms is not None else f"ERR {err}"
            print(f"[tune] {kernel} {dtype} {sig} {config}: {status}", flush=True)
            timed.append({"config": config, "ms": ms, "error": err})
        win = pick_winner(timed, default)
        if win is not None:
            table.add(kernel, chip, dtype, sig, win["config"], source="measured",
                      measured_ms=round(win["ms"], 4))
            table.save(args.table)
        results.append({"kernel": kernel, "signature": sig, "dtype": dtype,
                        "default": default, "timed": timed,
                        "winner": win["config"] if win else None,
                        "winner_ms": win["ms"] if win else None})
        write_report()
    print(json.dumps({"mode": "sweep", "chip": chip, "card": card, "table": args.table,
                      "swept": len(results),
                      "winners": sum(1 for r in results if r["winner"]),
                      "errors": sum(t["ms"] is None for r in results for t in r["timed"]),
                      "seconds": time.time() - t0}), flush=True)
    return 0 if all(r["winner"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
