#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card
and check them.

    python chip_smoke.py                 # every phase, one card
    python chip_smoke.py --phases device,build,kernels

Phases, one JSON line each; any failure exits non-zero:

1. device  — card name and count, ``nvidia-smi`` name and power limit.
2. build   — compiles ``fms_fsdp_tpu_torch/csrc/*.cu`` (one nvcc per
   source, all started together) and reports each kernel's registers,
   shared memory and spills from ``-Xptxas -v``, and the compiler's
   warnings; a wgmma kernel (``*_sm90.cu``) that spills fails the phase.
3. kernels — the paged-decode kernel against its plain PyTorch version at
   llama3_8b decode shapes (B=8, Nq=32, Nkv=8, H=128, page 64, 32 pages
   per row, seeded ragged lengths with 0 and page-boundary values), for
   bf16, fp32, int8 and e4m3 pools, and at one bf16 row of 16,383 keys:
   within ``TOL`` (max abs) and, row by row, within the relative error
   ``paged_attention.REL_TOL``, which a control (the plain version with
   each row's first split of keys left out) must exceed on every row it
   changes; device times (CUDA events around CUDA-graph replay over pool
   copies that span three times the L2; eager event times beside them)
   of the kernel and of SDPA, the planned splits and blocks, achieved
   GB/s and the share of the bytes bound.
4. serve   — ``ServingEngine`` on llama3_8b at full width (32 layers,
   vocab 128256, random bf16 weights from a seeded generator), 16
   requests of 64-1024 prompt tokens and 64 new tokens each, through
   the CUDA kernel. Checks completions, finite logits and launches ==
   decode steps x 32 on that wave; then refills the 8 slots and holds
   one decode step through the kernel against the same step through
   the reference attention and an fp32 step, and profiles one step.
5. serve-int8 — the same engine with int8 pools on a shorter wave, so
   the quantized (v2) contract runs end to end.
6. train-speculator — ``speculator.train_speculator.main`` (the port's
   entry) on the serve phases' random bf16 llama3_8b as the frozen base,
   at full width and depth (8.03B parameters), with JAX's default
   speculator (3 heads, width 4096, tied, scale_input: 1.084B
   parameters, fp32 with AdamW): seq 4096 (+4), batch 2, dummy data
   (``SteadyCounter`` modulo 4096: each token the previous plus one, the
   same 4096 transitions every batch), 6 stage-1 steps
   through the flash forward, then 2 stage-2 steps (``stage2_batch_size``
   32 and ``stage2_seq_length`` 64, cut from JAX's 96 and 256; prompts of
   64), reports every step, no save of the train state (its 13 GB is cut
   for time; the CPU tests save and resume it). Checks: flash forward
   launches == stage-1 steps x layers and no dq, dk/dv or paged-decode
   launch; every loss and gradient norm finite; head 1's loss at the
   last stage-1 step below its first; the first stage-1 step's per-head
   losses through the kernel and through the plain attention within
   ``TOL["bf16"]`` (relative). Prints tokens/s per stage, the peak
   bytes, each step's per-head losses, gradient norm and LR, and a
   device profile of a stage-1 step (flash, the base's 16-bit GEMMs, the
   speculator's GEMMs, CE, optimizer, other). ``save_speculator`` writes
   the trained speculator (4.3 GB) into the run's in-memory directory.
7. serve-spec — ``ServingEngine`` on the same llama3_8b (bf16,
   ``max_batch=8``, page 64) with ``speculator_path`` set to that file
   and ``spec_draft_tokens=3``: 8 requests of 64-512 prompt tokens and 64
   new tokens, then the same requests on a plain engine. Checks: every
   request finishes; the verify steps launch no attention kernel (they
   gather, as JAX's) and the plain decode launches the paged kernel.
   Prints decode tokens/s, tokens committed per verify step, the accept
   rate, host wall against device ms per step of both engines, and how
   many requests' bf16 tokens agree (not asserted: the gather path and
   the kernel may split near-ties apart). Then fp32 at 8 of 32 layers
   with the reference attention: the speculative tokens equal plain
   greedy for every request, and an oracle drafter (the plain stream's
   own continuation) commits every draft (accept rate 1.0) with the same
   tokens. Needs the train-speculator phase.
8. flash   — the flash-attention kernels (wgmma + TMA for bf16: forward,
   dq, dk/dv; scalar for fp32) against their plain versions for bf16 and
   fp32: the training shape
   (B=2, Nq=32, Nkv=8, S=4096, H=128, causal, group 4), the kvgrid
   contract (B=1, S=16384), a causal cross-length case (Sq=2048,
   Sk=4096) and group 1; o, lse, dq, dk and dv each within tolerance:
   fp32 within 1e-4 x max(1, |value|); bf16 within twice the plain bf16
   version's distance from fp32, and within the relative error
   ``flash_attention.BF16_REL_TOL`` of the plain bf16 version, which a
   control (the plain version with its scores rounded to bf16) must
   exceed; bf16 dq per 128-row block and dk/dv per 128-key block within
   ``flash_attention.BF16_BLOCK_REL_TOL`` (relative error against the
   plain backward on the same lse and delta), which a control (that
   plain backward with one 64-row query tile left out of one key block's
   walk) must exceed on every block it changes; CUDA-event times of the
   first two shapes beside the plain versions, the bound, and SDPA (flash
   backend) forward and backward; achieved TF/s and share of the bound of
   each kernel, the pair dq + dk/dv and the whole autograd backward
   beside SDPA's backward.
9. train   — ``fms_fsdp_tpu_torch.main_training_llama.main`` at
   llama3_8b_4k width (4096 wide, 32/8 heads, hidden 14336, vocab
   128256) and 8 layers, seq 4096, batch 2, selective AC 1/2, dummy
   data, 12 steps: finite and decreasing loss, no skipped batch, launches
   == steps x (layers + rematerialised layers) forward and steps x layers
   dq and dk/dv; tokens per card per second, MFU/HFU, peak memory and a
   profile of one step. It saves nothing (its 33.5 GB final save was
   cut for the Mixtral phases' time), and neither do train-kvgrid (its
   17.8 GB, ~21 s, cut for the speculator phases: the resume phase checks
   the final save of the same 2-layer model through the same entry),
   train-mamba (its 31.9 GB, ~32 s, cut for hf-eval: hf-eval's Mamba run
   writes the final save of the same entry at 3 layers, reads it back
   through ``eval_ppl`` and exports it) and train-mixtral. A phase that
   saves (hf-eval's Mamba run) prints its blocking snapshot (ms), its
   background commit, payload write and manifest hashing (s), its bytes
   and GB/s; every root is in memory (see ``_ckpt_dir``) and deleted
   when the phase is done. Every trainer phase runs through the mesh
   (``parallel/mesh.py``) and an NCCL process group of one, with no
   sharded state (checked and printed as ``process_group``).
10. loader — the streaming loader alone, host plus the copy to the card
   (no model): a corpus of two 8-shard corpora (about 100M llama3 token
   ids, document lengths log-uniform over 64-16,384) written into the
   run's in-memory directory with ``meta/combined_counts.csv``;
   ``get_data_loader`` at seq 4096, batch 2, 1024 logical shards, weights
   3:1 and the default shuffle window. Setup seconds, first batch and
   tokens/s of the pipeline alone with 1 and 2 thread workers and with 2
   forked process workers (after ``torch.cuda.init()``, with a tensor
   live on the card; their first batches must equal the thread workers'
   and shutdown must reap them); the reservoir filled to 10,000 rows (or
   the largest window the measured rate fills in 30 s, flagged
   ``reduced``), the mix's corpus_a share within 0.02 of 0.75, then the
   loader state's bytes and the ms of ``save_to_path`` and of
   ``load_from_path`` on a fresh loader, whose continuation must equal
   the saved loader's; ms per batch through ``DeviceFeed`` to the card
   (its batches equal to the host's), the consumer's wait and the
   staging alone.
11. resume — checkpoint and resume through the Llama entry point at
   llama3_8b_4k width, 2 layers, seq 4096, batch 2, AC 1/2, bf16 params
   and moments, streaming the loader phase's corpus (one loader worker, the feed two
   batches ahead): a first run of 6 steps saves on the local tier (the
   checkout's disk) at 2 and the durable tier (memory) at 4 and 6
   (retention 1 each), each save with the loader's state; its batches
   are the first six of a host-only straight walk of the same loader
   config, and the states saved at 2 and 6 put the stream within the
   feed's depth past their step. A second run of 8 steps resumes at 6
   with the loaded state's per-key digests (float64 sum and int64 sum of
   the bits) equal to step 6's, tokens_seen 6 x 2 x 4096, its first LR
   that of step 7 of a straight run, finite losses and the flash launches
   of 2 steps; its batches are the walk's from where step 6's loader
   state puts it, and no row of steps 1-6 comes again.
   ``ServingEngine.from_checkpoint`` on the durable root serves 8
   requests through the paged-decode kernel, its params' digests equal
   to the live ones and its first decode step's logits equal to an
   engine's on the live params; then a truncated payload file in the
   newest checkpoint makes the next load fall back to local step 2 with
   the integrity warning, and the loader restores step 2's state from
   step 2's dir. Prints save, load and serving times, the ms the loader
   state adds to each blocking snapshot, the feed's wait per step, GB/s
   and the phase's peak disk use.
12. supervise — ``python -m fms_fsdp_tpu_torch.resilience.supervisor``
   over ``python -m fms_fsdp_tpu_torch.main_training_llama`` on the card
   (``SUPERVISE_KW``: llama3_8b_4k width, 2 layers, seq 4096, batch 2, AC
   1/2, bf16 params and moments, dummy data, 10 steps, reports every 2, saves every 4,
   metrics.jsonl/csv and the heartbeat, the profiler, the watchdog, the
   scrubber every 4 steps), with ``FMS_FAULTS`` poisoning steps 7-8 and
   flipping 4 bytes of the step-4 save. Checks, one line each: the ledger
   (one or more ``anomaly_abort`` restarts, then completed, exit 0); the
   relaunch resumed from the newest committed, unquarantined step; every
   record valid under the strict schema, ``skipped_steps`` at the abort
   equal to the poisoned steps, each record's MFU the printed one against
   the card's peak, ``restarts`` and ``restart_downtime_s`` in the last
   record, the heartbeat's final step and run id; the scrubber's
   verified count and the step-4 quarantine sidecar; the first
   incarnation's trace naming ``flash_fwd_kernel_sm90``,
   ``flash_dq_kernel_sm90``, ``flash_dkv_kernel_sm90`` and the
   ``fwd_bwd`` scope; then each incarnation's wall, steps, tokens per
   card per second, the observer's ms per report and the downtime.
13. shard — the data-parallel entry on one card (``SHARD_KW``:
   llama3_8b_4k at full width, 2 layers, bf16 params and moments, 3
   steps): ``python -m fms_fsdp_tpu_torch.main_training_llama
   --sharding_strategy=hsdp`` as a child under torchrun's environment
   (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT: so
   ``cuda:LOCAL_RANK`` and an NCCL group from ``env://``; the mesh all
   ones), then ``main`` in this process under ddp and under fsdp (these
   two save nothing: on a world of one the three hold the same unsharded
   state, and the hsdp save is the one resumed): the three losses within
   ``SHARD_REL_TOL`` of each other; the hsdp run's DCP checkpoint
   committed (metadata, ``.metadata``, a world of one in its topology);
   this process resumes it to step 9 with the profiler
   on (steps 7-9 recorded): its steps continue at 4 and its trace holds
   no NCCL kernel (a world of one runs no collective on the step), with
   the kernels' and the NCCL kernels' ms per step; the resume saves
   nothing. The hsdp child's checkpoint (step 3) is left for hf-eval,
   which deletes it.
14. hf-eval — HF interop and native eval. (a) ``python -m
   fms_fsdp_tpu_torch.fms_to_hf_llama`` (a child process, beside the
   card work of (b)-(e)) on the shard phase's hsdp checkpoint (llama3_8b_4k, 2 layers,
   bf16; one step of the same config when shard did not run) writes an
   HF directory (fp32 safetensors); ``load_hf_base`` reads it back, equal
   to the saved params bitwise; on one batch of S=4096 the port's forward
   through the flash kernel lies within twice the plain bf16 forward's
   distance from the fp32 forward (of both), transformers'
   ``LlamaForCausalLM`` loaded from the directory in bf16 on the card
   within twice that of the kernel's logits; top-1 agreement printed.
   (b) ``eval_ppl.main`` on that checkpoint over the loader phase's
   corpus (``HF_EVAL_BATCHES`` batches of 2 x 4096): flash forward
   launches == layers x batches, the nll within ``HF_NLL_REL_TOL`` of the
   same entry through the einsum attention; eval tokens/s of the steps.
   (c) ``main_training_mamba.main`` at mamba_9.8b width, 3 layers with
   attention at 1, one step, writes its final save; ``eval_ppl.main`` on
   it: SSD launches == Mamba layers x batches, flash == 1 x batches;
   ``python -m fms_fsdp_tpu_torch.fms_to_hf_mamba`` on it (a child
   process, beside (a), (b), (d) and (e)): mamba_ssm's files, its config, the
   conv, fused attention in_proj and [up; gate] fc1 shapes, and the
   parameter count equal to the checkpoint's. (d) ``fms_to_hf_mixtral``
   at mixtral_8x7b width, 1 layer: transformers' ``MixtralForCausalLM``
   on the card against the port's dense mix through the kernels, in fp32
   within ``HF_FP32_REL_TOL`` (the port's bf16 against its fp32 printed:
   a router near-tie moves a token to another expert there). (e) an HF
   GPTBigCode directory (random weights at ``GPTBigCodeConfig()`` width,
   2 of 24 layers) as ``speculator.train_speculator.main``'s ``model_path``
   (``model_arch=embedllama``, overridden by the directory's arch): 3
   stage-1 steps of JAX's default speculator, no save; the first step's
   base hidden states within four times the bf16-vs-fp32 distance of
   transformers' ``GPTBigCodeModel`` in bf16, and in fp32 within
   ``HF_FP32_REL_TOL``. Prints export and import seconds, the
   directories' bytes and the peak memory.
15. train-kvgrid — the same trainer at 2 layers for one step with
   ``flash_kernel_variant="kvgrid"``, so the launches of the kv-streamed
   contracts are counted on the main path too.

16. ssd    — the fused SSD scan kernels (``ssd_sm90.cu`` for bf16,
   ``ssd.cu`` for fp32) against their plain version at the
   Mamba training shape (B=2, S=4096, H=128, P=64, G=1, N=128, L=256), at
   G=8 and at S=L (one chunk), bf16 and fp32, dt and A in the ranges of
   ``init_mamba_params``: fp32 within 1e-4 x max(1, |value|); bf16 within
   twice the plain bf16 version's distance from an fp32 run and within
   ``ssd.BF16_REL_TOL`` (relative error against the plain bf16 version),
   which a control (the plain version with dt rounded to bf16) must
   exceed; both dtypes per (batch, chunk, head) within
   ``ssd.BF16_CHUNK_REL_TOL`` (``ssd.chunk_check``), which a control (the
   plain version with the last 64-token tile of the next-to-last chunk
   left out of the state it hands on) must exceed on the one chunk it
   changes; CUDA-event times of the kernel, the plain version and the
   whole ``ssd_scan`` through the kernel and through the chunked einsums,
   the bound, and the other pieces of a Mamba layer at that shape (the
   scan's einsum backward, the conv forward and backward).
17. train-mamba — ``fms_fsdp_tpu_torch.main_training_mamba.main`` at
   mamba_9.8b width, 6 layers with attention at layer 3, seq 4096, batch
   2, selective AC 1/2, 16 steps (over the first 8 the loss of this
   model only wobbles, through the kernel and through the einsums alike):
   finite falling loss, no skipped batch,
   SSD launches == steps x (Mamba layers + rematerialised Mamba layers),
   flash launches == the one attention layer's; tokens per card per
   second, MFU/HFU, peak memory and a profile of one step. No save
   (hf-eval checks the entry's final save).
18. serve-mamba — ``ServingEngine`` on mamba_9.8b at full width and depth
   (32 layers, 3 of them attention; random bf16 weights), 8 requests of
   16-128 prompt tokens and 32 new tokens each: all complete, finite
   logits, a constant ``state_bytes_per_stream``, slab slices zero after
   completion, one decode step held against the same step in fp32. This
   path launches no SSD kernel (the prefill is the per-token recurrence),
   and the phase checks that.
19. train-mixtral — ``fms_fsdp_tpu_torch.main_training_mixtral.main`` at
   mixtral_8x7b width (4096 wide, 32/8 heads of 128, 8 experts of hidden
   14336, top-2, vocab 32000) and 2 of 32 layers (3.16B parameters),
   bfSixteen, seq 4096, batch 1, selective AC 1/2, dummy data, 6 steps,
   reports every step, no save (the 51 GB state's save and its pinned
   snapshot would pass the host's 101 GB): finite loss every step and
   lower at the end than at step 1, no skipped batch, flash launches ==
   steps x (layers + rematerialised layers) forward and steps x layers dq
   and dk/dv; ``moe_drop_frac`` per step, tokens per card per second, MFU
   over the active experts, peak memory and a profile of one step that
   sets the expert GEMMs (``aten::bmm``) and the dispatch kernels apart;
   then the first step again from the same weights and batch through the
   plain attention, its loss within ``TOL["bf16"]`` (relative) of the
   kernels'.
20. serve-mixtral — ``ServingEngine`` on mixtral_8x7b at full width, 8 of
   32 layers, random bf16 weights (23.7 GB), ``max_batch=8``, page 64, 8
   requests of 64-512 prompt tokens and 32 new tokens, routed top-2
   experts: all complete, no attention kernel launched (the reference
   attention, as JAX's Mixtral serving), decode tokens/s, one full-batch
   step routed against dense (printed) and each profiled (host wall
   against device ms); then the same requests routed and dense on fp32
   weights: equal greedy tokens and every decode step's logits within
   ``MIXTRAL_FP32_REL_TOL`` of the largest.

Then a ``total`` line (seconds since ``main`` began, and each phase's),
a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "serve", "serve-int8", "train-speculator",
          "serve-spec", "flash", "train",
          "loader", "resume", "supervise", "shard", "hf-eval", "train-kvgrid", "ssd",
          "train-mamba",
          "serve-mamba", "train-mixtral", "serve-mixtral")

# llama3_8b decode shapes of the kernel phase
B, NQ, NKV, H, PAGE, MAXP = 8, 32, 8, 128, 64, 32
# the timed loops rotate through copies of the pools, as the layers of a
# decode step do, enough of them that the live K/V of all copies is at
# least this many times the card's L2: no call reads a warm L2
L2_SPAN = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}  # dense bf16 tensor / fp32 SIMT
TOL = {"bf16": 2e-2, "fp32": 1e-5, "int8": 2e-2, "e4m3": 2e-2}
# the directories this run made for checkpoints ("memory", "disk"), each
# by mkdtemp; main deletes them when the run ends
CKPT_ROOTS = {}
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
    "ssd_fused": "fms_fsdp_tpu/ops/ssd.py:51",
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


def graph_time_ms(fn, reps: int, replays: int = 5) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events. Eager timing of a call
    that is shorter than its host-side launch work measures the host;
    the replay does not wait for it."""
    import torch

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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


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
    spills = []
    for name in sources:
        built = cuda_build.load(name)
        kernels = cuda_build.ptxas_summary(built.ptxas)
        report[name] = {"library": os.path.relpath(built.path, REPO), "kernels": kernels,
                        "warnings": [line for line in built.ptxas.splitlines()
                                     if "warning" in line.lower()]}
        if name.endswith("_sm90"):  # the wgmma kernels
            spills += [k for k, r in kernels.items() if r["spill_stores"] or r["spill_loads"]]
    # dynamic shared memory, which -Xptxas -v does not see
    lib = cuda_build.load("paged_decode").lib
    report["paged_decode"]["dynamic_smem_bytes"] = {
        f"q {q}, pools {kv}": lib.paged_decode_smem_bytes(qc, kc)
        for q, kv, qc, kc in (("bf16", "bf16", 1, 1), ("fp32", "fp32", 0, 0),
                              ("bf16", "int8", 1, 3), ("bf16", "e4m3", 1, 4))
    }
    report["flash_fwd_sm90"]["dynamic_smem_bytes"] = (
        cuda_build.load("flash_fwd_sm90").lib.flash_fwd_sm90_smem_bytes())
    bwd = cuda_build.load("flash_bwd_sm90").lib
    report["flash_bwd_sm90"]["dynamic_smem_bytes"] = {
        "dq": bwd.flash_bwd_sm90_smem_bytes(0), "dkv": bwd.flash_bwd_sm90_smem_bytes(1)}
    scan = cuda_build.load("ssd_sm90").lib
    report["ssd_sm90"]["dynamic_smem_bytes"] = {
        f"{hb} heads a block, L={chunk}": scan.ssd_sm90_smem_bytes(hb, chunk)
        for hb in (1, 2) for chunk in (64, 256)}
    state["build_s"] = wall
    emit("build", seconds=wall, sources=report, spilling_kernels=spills)
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")


def _kernel_lens(gen, batch=B, maxp=MAXP):
    """Seeded ragged positions with 0 and page-boundary values."""
    import torch

    lens = [0, PAGE - 1, PAGE, 2 * PAGE - 1, maxp * PAGE - 1]
    return lens + torch.randint(1, maxp * PAGE, (batch - len(lens),), generator=gen,
                                device="cuda").tolist()


def _kernel_inputs(kind, gen, lens, copies, maxp=MAXP):
    """Seeded decode inputs at positions ``lens``: q, ``copies`` layers of
    pools (+scales), page table, seq_lens."""
    import torch

    from fms_fsdp_tpu_torch.ops.quant import kv_quantize

    dev = "cuda"
    batch = len(lens)
    q_dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    num_pages = batch * maxp + 2
    shape = (copies, num_pages, PAGE, NKV, H)
    q = torch.randn((batch, NQ, H), generator=gen, device=dev).to(q_dtype)
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
    perm = (torch.randperm(num_pages - 2, generator=gen, device=dev) + 2).tolist()
    table = torch.zeros((batch, maxp), dtype=torch.int32)
    for b, pos in enumerate(lens):
        n = pos // PAGE + 1
        table[b, :n] = torch.tensor(perm[b * maxp: b * maxp + n])
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, ks, vs, table.to(dev), seq_lens


def _live_kv_bytes(kind, lens, maxp=MAXP):
    """Bytes of the K/V rows (and row scales) a call's rows attend."""
    elem = {"bf16": 2, "fp32": 4, "int8": 1, "e4m3": 1}[kind]
    keys = sum(min(p + 1, maxp * PAGE) for p in lens)
    return 2 * keys * (NKV * H * elem + (NKV * 4 if kind in ("int8", "e4m3") else 0))


def _bound(kind, lens, maxp=MAXP):
    """Least time for one call: bytes (each live K/V row, q, out, table
    and lens once) over HBM rate vs operations over the peak of their
    type; the larger one bounds."""
    q_elem = 4 if kind == "fp32" else 2
    batch = len(lens)
    keys = sum(min(p + 1, maxp * PAGE) for p in lens)
    nbytes = (_live_kv_bytes(kind, lens, maxp) + 2 * batch * NQ * H * q_elem
              + batch * maxp * 4 + batch * 4)
    ops = 4 * keys * NQ * H  # QK^T and PV, 2 flops per MAC
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS["fp32" if kind == "fp32" else "bf16"] * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes, ops
    return ops_ms, "operations", nbytes, ops


# (label, pool type, pages per row, lengths): the four pool types at the
# llama3_8b decode shape (seeded ragged lengths), and one bf16 row of
# 16,383 keys
KERNEL_CASES = (
    ("bf16", "bf16", MAXP, None),
    ("fp32", "fp32", MAXP, None),
    ("int8", "int8", MAXP, None),
    ("e4m3", "e4m3", MAXP, None),
    ("bf16_b1_16383", "bf16", 256, [16382]),
)


def _row_rel_err(out, ref):
    """Per row: ||out - ref|| / ||ref|| over all its query heads."""
    ref = ref.float().flatten(1)
    return (out.float().flatten(1) - ref).norm(dim=1) / ref.norm(dim=1)


def _drop_split_control(pa, q, kp, vp, table, lens, ksp, vsp, split_keys):
    """The plain version with each row's first split of keys left out,
    and the rows that have keys past that split (the others have none
    left). A kernel that skipped or misread one split of a row would land
    about here."""
    pages = split_keys // kp.shape[1]
    rows = (lens >= split_keys).nonzero().flatten()
    if pages >= table.shape[1] or rows.numel() == 0:
        return None, rows
    out = pa.paged_attention_plain(q[rows].contiguous(), kp, vp,
                                   table[rows, pages:].contiguous(),
                                   lens[rows] - split_keys, ksp, vsp)
    return out, rows


def phase_kernels(state):
    import torch
    import torch.nn.functional as F

    from fms_fsdp_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(0)
    props = torch.cuda.get_device_properties(0)
    sm_count = props.multi_processor_count
    results = {}
    for label, kind, maxp, case_lens in KERNEL_CASES:
        lens_list = case_lens or _kernel_lens(gen, B, maxp)
        batch = len(lens_list)
        copies = max(2, math.ceil(L2_SPAN * props.L2_cache_size
                                  / _live_kv_bytes(kind, lens_list, maxp)))
        q, k, v, ks, vs, table, lens = _kernel_inputs(kind, gen, lens_list, copies, maxp)
        scaled = ks is not None
        layer = lambda i: (k[i % copies], v[i % copies],  # noqa: E731
                           ks[i % copies] if scaled else None,
                           vs[i % copies] if scaled else None)
        kp, vp, ksp, vsp = layer(0)
        split_keys, n_splits = pa.decode_splits(batch, NKV, maxp * PAGE, PAGE, sm_count)
        out = pa.paged_attention_kernel(q, kp, vp, table, lens,
                                        k_scales=ksp, v_scales=vsp)
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(q, kp, vp, table, lens, ksp, vsp)
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        # the relative error per row, and that of the control (the first
        # split of each row left out) on the rows it changes: every one
        # must exceed the tolerance the kernel meets
        rel = _row_rel_err(out, ref)
        control, rows = _drop_split_control(pa, q, kp, vp, table, lens, ksp, vsp, split_keys)
        if control is None:
            raise AssertionError(f"{label}: no row has keys past its first split")
        rel_tol = pa.REL_TOL[q.dtype]
        rel_control = _row_rel_err(control, ref[rows]).min().item()
        ok = (finite and err <= TOL[kind] and rel.max().item() <= rel_tol < rel_control)
        del out, ref, control

        def kernel(i):
            kp, vp, ksp, vsp = layer(i)
            pa.paged_attention_kernel(q, kp, vp, table, lens,
                                      k_scales=ksp, v_scales=vsp)

        def plain(i):
            kp, vp, ksp, vsp = layer(i)
            pa.paged_attention_plain(q, kp, vp, table, lens, ksp, vsp)

        # the kernel and SDPA through graph replay (device time); eager
        # CUDA-event times beside them include the host's launch work
        eager_ms = cuda_time_ms(kernel, reps=200, warmup=10)
        ms = graph_time_ms(kernel, reps=64)
        plain_ms = cuda_time_ms(plain, reps=20, warmup=3)
        # yardstick only (the port never calls it): SDPA over the
        # gathered (and dequantised) cache with a ragged-length mask
        caches = []
        for i in range(copies):
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
        mask = (torch.arange(maxp * PAGE, device="cuda")[None, :]
                <= lens[:, None].long())[:, None, None, :]
        q4 = q[:, :, None, :]

        def library(i):
            kg, vg = caches[i % copies]
            F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask,
                                           enable_gqa=True)

        library_eager_ms = cuda_time_ms(library, reps=50, warmup=5)
        library_ms = graph_time_ms(library, reps=64)
        bound_ms, bound_by, nbytes, ops = _bound(kind, lens_list, maxp)
        live = sum(-(-min(p + 1, maxp * PAGE) // split_keys) for p in lens_list)
        results[label] = dict(
            pools=kind, batch=batch, max_abs_err=err, tol=TOL[kind], finite=finite,
            rel_err_rows=rel.tolist(), rel_tol=rel_tol, rel_err_control_min=rel_control,
            control_rows=rows.tolist(), ok=ok, pool_copies=copies, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
            library_eager_ms=library_eager_ms,
            kernel_over_library=ms / library_ms, bound_ms=bound_ms,
            bound_by=bound_by, bound_share=bound_ms / ms,
            achieved_gbytes_per_s=nbytes / ms / 1e6, bytes=nbytes, ops=ops,
            split_keys=split_keys, splits=n_splits, blocks=batch * NKV * n_splits,
            live_blocks=live * NKV, seq_lens=lens_list,
        )
        emit("kernels", case=label, **results[label])
        del q, k, v, ks, vs, caches
        torch.cuda.empty_cache()
    state["kernels"] = results
    bad = [label for label, r in results.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _llama3_8b_params(state):
    """The serving and speculator phases' random bf16 llama3_8b weights
    (seed 0), made by the first phase that needs them."""
    import torch

    from fms_fsdp_tpu_torch.models.llama import init_llama_params
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config

    if "params" not in state:
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        state["params"] = init_llama_params(gen, get_model_config("llama3_8b"),
                                            dtype=torch.bfloat16)
        torch.cuda.synchronize()
        state["init_s"] = time.perf_counter() - t0
    return state["params"]


def _serve(state, phase, kv_quant, n_requests, max_prompt, max_new, seed):
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
    from fms_fsdp_tpu_torch.serve.decode import paged_decode_step
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config

    cfg = get_model_config("llama3_8b")
    _llama3_8b_params(state)
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
    # the split kernel and the merge kernel of each call
    attn_ms = sum(r[0] for r in rows if "paged_decode_" in r[1])
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
# the speculator pipeline: train on the frozen llama3_8b, serve with it
# ---------------------------------------------------------------------------

# llama3_8b at full width and depth (the serve phase's weights); the
# speculator at JAX's defaults (3 heads, width 4096, tied, scale_input);
# stage 2 cut for time from 96 rows x 256 tokens to 32 x 64. The dummy
# counter runs modulo 4096 (``vocab_size`` is only its modulus here; the
# model's vocabulary stays 128256): every batch holds the same 4096
# transitions, which 6 steps can learn. Modulo 128256 each step brings
# tokens no step has seen, and the loss rises.
SPEC_KW = {
    "model_variant": "llama3_8b", "vocab_size": 4096, "use_dummy_dataset": True,
    "batch_size": 2, "seq_length": 4096, "num_steps": 8, "stage2_start_step": 6,
    "stage2_batch_size": 32, "stage2_prompt_length": 64, "stage2_seq_length": 64,
    "report_interval": 1, "learning_rate": 1e-3, "checkpoint_interval": 1000,
}


def _spec_step_profile(model_cfg, cfg, scfg, base, state, batch, steps=2):
    """Device ms of one stage-1 step by part (torch.profiler): the flash
    forward, the frozen base's 16-bit GEMMs (from a profile of the base
    forward alone on the same batch), the speculator's GEMMs (the step's
    other matrix products), its CE (forward scope and backward node), the
    optimizer (its scope) and the rest; host wall per step beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fms_fsdp_tpu_torch.models import get_base_api
    from fms_fsdp_tpu_torch.train.speculator import make_stage1_step

    step = make_stage1_step(base, model_cfg, scfg, cfg)
    hidden = get_base_api("embedllama").forward_hidden
    inputs = batch[:, :-scfg.n_predict - 1]
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def kinds(rows):
        out = {}
        for ms, name, _ in rows:
            k = _kernel_kind(name)
            out[k] = out.get(k, 0.0) + ms
        return out

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_base:
        with torch.no_grad():
            for _ in range(steps):
                hidden(base, inputs, model_cfg, attn_impl="auto")
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, steps)
    if not rows:
        return {"wall_ms_per_step": wall_ms, "device_ms_per_step": None}
    device_ms = sum(r[0] for r in rows)
    step_kinds, base_kinds = kinds(rows), kinds(_kernel_rows(prof_base, steps))
    gemm = step_kinds.get("gemm_16bit", 0.0) + step_kinds.get("gemm_fp32", 0.0)
    ce = (_op_device_ms(prof, "speculator_ce")
          + sum(_op_device_ms(prof, n) for n in {e.name for e in prof.events()}
                if "CrossEntropyBackward" in n and not n.startswith("autograd::"))) / steps
    opt = _op_device_ms(prof, "optimizer") / steps
    parts = {
        "flash": step_kinds.get("flash", 0.0),
        "base_gemm_16bit": base_kinds.get("gemm_16bit", 0.0),
        "speculator_gemm": gemm - base_kinds.get("gemm_16bit", 0.0),
        "ce": ce, "optimizer": opt,
    }
    parts["other"] = device_ms - sum(parts.values())
    return {
        "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "base_forward_device_ms": sum(r[0] for r in _kernel_rows(prof_base, steps)),
        "device_ms_per_step_by_part": parts,
        "top_device_ms_per_step": [
            {"name": name[:80], "ms": ms, "calls": calls} for ms, name, calls in rows[:12]],
    }




def phase_train_speculator(state):
    """``speculator.train_speculator.main`` on the serve phase's frozen
    llama3_8b (see the module docstring)."""
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
    from fms_fsdp_tpu_torch.data.loader import get_dummy_loader
    from fms_fsdp_tpu_torch.models import get_base_api
    from fms_fsdp_tpu_torch.models.speculator import init_speculator_params, save_speculator
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.speculator import train_speculator as entry
    from fms_fsdp_tpu_torch.train.speculator import stage1_loss

    base = _llama3_8b_params(state)
    ckpt_dir = _ckpt_dir("train-speculator")
    kw = dict(SPEC_KW, ckpt_save_path=ckpt_dir, ckpt_load_path=ckpt_dir)
    load_base = entry.load_base
    entry.load_base = lambda *a, **k: base
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    pa.reset_launches()
    t0 = time.perf_counter()
    try:
        # the 13 GB final save of params and moments is cut for time; the
        # CPU tests save and resume the speculator state
        with _saves_nothing(entry):
            res = entry.main(**kw)
    finally:
        entry.load_base = load_base
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES, **{f"paged_{k}": v for k, v in pa.LAUNCHES.items()})
    peak = torch.cuda.max_memory_allocated()
    model_cfg, cfg, scfg = res["model_cfg"], res["cfg"], res["scfg"]
    reports = res["reports"]
    s1 = [r for r in reports if r["step"] <= cfg.stage2_start_step]
    s2 = [r for r in reports if r["step"] > cfg.stage2_start_step]
    want = {"fwd": len(s1) * model_cfg.nlayers, "fwd_kvgrid": 0, "dq": 0, "dq_kvgrid": 0,
            "dkv": 0, "paged_v1": 0, "paged_v2": 0}
    batch = next(iter(DeviceFeed(get_dummy_loader(cfg, 0, 1), "cuda")))[0]
    result = dict(
        config=dict(kw, seq_length_with_targets=cfg.seq_length),
        base_params=model_cfg.n_params(), speculator_params=scfg.n_params(),
        speculator=dict(n_predict=scfg.n_predict, inner_dim=scfg.inner_dim,
                        tie_weights=scfg.tie_weights, scale_input=scfg.scale_input),
        wall_s=wall, steps=res["steps"],
        per_step=[{"step": r["step"], "stage": 1 if r["step"] <= cfg.stage2_start_step else 2,
                   "loss_per_head": r["per_head"], "gnorm": r["gnorm"], "lr": r["lr"],
                   "step_time_s": r["step_time_s"], "tokens_per_s": r["tokens_per_s"]}
                  for r in reports],
        # the first step of each stage compiles nothing but warms the
        # allocator: the rate is over the later ones
        stage1_tokens_per_s=float(np.mean([r["tokens_per_s"] for r in s1[1:]])),
        stage2_tokens_per_s=float(np.mean([r["tokens_per_s"] for r in s2[1:] or s2])),
        max_memory_allocated=peak, launches=launches, expected_launches=want,
        flash_fwd_per_stage1_step=launches["fwd"] / max(1, len(s1)),
    )
    # the file the serve-spec phase serves: the speculator as the entry
    # left it, written before the profile's steps move the state on
    t0 = time.perf_counter()
    path = os.path.join(ckpt_dir, "speculator.pkl")
    save_speculator(path, res["state"]["params"], scfg)
    result["save_speculator"] = {"path": path, "bytes": os.path.getsize(path),
                                 "seconds": time.perf_counter() - t0}
    result["step_profile"] = _spec_step_profile(model_cfg, cfg, scfg, base, res["state"], batch)
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # the first stage-1 step's frozen forward again: the base's hidden
    # states through the kernel, through the plain attention, and in fp32
    # (plain attention). As in _compare_step, the bf16 tolerance is the
    # plain bf16 forward's own distance from fp32, doubled: the kernel's
    # hidden states lie within it of both. Beside that, the per-head
    # losses of the entry's initial speculator on the kernel's and on the
    # plain hidden states agree within TOL["bf16"] relative
    hidden = get_base_api("embedllama").forward_hidden
    inputs = batch[:, :-scfg.n_predict - 1]
    with torch.no_grad():
        h = {impl: hidden(base, inputs, model_cfg, attn_impl=impl) for impl in ("pallas", "xla")}
        h32 = hidden(base, inputs, model_cfg, attn_impl="xla", compute_dtype=torch.float32)
        dist = {"kernel_vs_plain": (h["pallas"].float() - h["xla"].float()).abs().max().item(),
                "plain_vs_fp32": (h["xla"].float() - h32).abs().max().item(),
                "kernel_vs_fp32": (h["pallas"].float() - h32).abs().max().item(),
                "fp32_absmax": h32.abs().max().item()}
        del h32
        torch.cuda.empty_cache()
        spec0 = init_speculator_params(
            torch.Generator(device="cuda").manual_seed(cfg.seed + 1), scfg)
        first = {impl: stage1_loss(spec0, e, batch, scfg)[1].float().cpu().numpy()
                 for impl, e in h.items()}
    del spec0, h
    gc.collect()
    torch.cuda.empty_cache()
    tol = 2 * dist["plain_vs_fp32"]
    rel = float(np.abs(first["pallas"] - first["xla"]).max() / np.abs(first["xla"]).max())
    result["first_step_kernel_vs_plain"] = {
        "hidden": dict(dist, tolerance=tol,
                       ok=dist["kernel_vs_plain"] <= tol and dist["kernel_vs_fp32"] <= tol),
        "loss_kernel": first["pallas"].tolist(), "loss_plain": first["xla"].tolist(),
        "main_step_1": reports[0]["per_head"], "loss_rel_diff": rel,
        "loss_tolerance": TOL["bf16"]}
    state["spec_file"] = path
    result["nvidia_smi"] = state["smi"]
    emit("train-speculator", **result)
    state["train-speculator"] = result

    problems = []
    if launches != want:
        problems.append(f"launches {launches} != expected {want}")
    losses = [x for r in reports for x in r["per_head"]] + [r["gnorm"] for r in reports]
    if not all(math.isfinite(x) for x in losses):
        problems.append("a non-finite loss or gradient norm")
    if not s1[-1]["per_head"][0] < s1[0]["per_head"][0]:
        problems.append(f"head 1's stage-1 loss did not fall: {[r['per_head'][0] for r in s1]}")
    if not s2:
        problems.append("no stage-2 step ran")
    if not result["first_step_kernel_vs_plain"]["hidden"]["ok"]:
        problems.append(f"first step's base hidden states, kernel vs plain and fp32: "
                        f"{result['first_step_kernel_vs_plain']['hidden']}")
    if not rel <= TOL["bf16"]:
        problems.append(f"first step's losses, kernel vs plain attention {rel} > {TOL['bf16']}")
    if problems:
        raise AssertionError("train-speculator: " + "; ".join(problems))


def _spec_wave(params, cfg, prompts, max_new, propose=None, **serve_kw):
    """One engine over ``prompts``: (engine, requests, wall s, paged-decode
    launches, flash launches)."""
    import torch

    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine

    eng = ServingEngine(params, cfg, ServeConfig(max_batch=8, max_seq_len=2048, **serve_kw))
    if propose is not None:
        eng.adapter.propose = propose(eng)
    reqs = [eng.submit(p, max_new) for p in prompts]
    pa.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        if eng.last_logits is not None and not torch.isfinite(eng.last_logits).all():
            raise AssertionError("serve-spec: non-finite logits")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, wall, dict(pa.LAUNCHES), dict(fa.LAUNCHES)


def _profile_engine_steps(eng, prompts, max_new, steps=3):
    """Host wall against device ms per engine step with all 8 slots
    decoding (verify steps on a speculative engine): the same requests
    again, stepped until every slot decodes, then ``steps`` steps timed
    and ``steps`` profiled; the engine is left mid-wave."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new)
    while eng.has_work() and (sum(r is not None for r in eng._slots) < 8
                              or eng.scheduler.queue):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, steps)
    device_ms = sum(r[0] for r in rows) if rows else None
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if rows else None,
            "top_device_ms_per_step": [{"name": n[:80], "ms": ms, "calls": c}
                                       for ms, n, c in rows[:6]]}


def _compare_verify(eng):
    """The verify step on a speculative engine's current pool state,
    held against decode steps on the same state: its position-0 logits
    against ``paged_decode_step`` through the reference attention (the
    gather path, one query a row) in the engine's dtype and against an
    fp32 decode step (the weights widened); its logits at every position
    against an fp32 verify step. The candidates are the slots' pending
    tokens and the speculator's drafts. The tolerance is _compare_step's:
    twice the reference decode step's own distance from the fp32 one."""
    import torch

    from fms_fsdp_tpu_torch.serve.decode import paged_decode_step, paged_verify_step

    ad = eng.adapter
    table, lens, toks = _step_inputs(eng)
    params32 = {
        n: ({k: w.float() for k, w in v.items()} if isinstance(v, dict) else v.float())
        for n, v in eng.params.items()
    }

    def run(fn, params, dtype, tokens, **kw):
        pools = {n: p.to(dtype, copy=True) for n, p in ad.cache.pools.items()}
        out = fn(params, pools, table, lens, tokens, eng.model_cfg, page_size=ad.page_size,
                 compute_dtype=dtype, rope=ad.rope, **kw)[0]
        return out.float()

    with torch.no_grad():
        cand = torch.cat([toks.long()[:, None], ad.propose(ad._spec_embed, toks.long())], 1)
        verify = run(paged_verify_step, eng.params, eng.compute_dtype, cand)
        decode = run(paged_decode_step, eng.params, eng.compute_dtype, toks,
                     attn_impl="reference", block_kv=ad.block_kv)
        verify32 = run(paged_verify_step, params32, torch.float32, cand)
        decode32 = run(paged_decode_step, params32, torch.float32, toks,
                       attn_impl="reference", block_kv=ad.block_kv)
    del params32
    torch.cuda.empty_cache()

    def dmax(a, b):
        return (a - b).abs().max().item()

    tol = 2 * dmax(decode, decode32)
    out = {
        "rows": int(cand.shape[0]), "positions": int(cand.shape[1]),
        "verify0_vs_decode": dmax(verify[:, 0], decode),
        "verify0_vs_decode_fp32": dmax(verify[:, 0], decode32),
        "verify_vs_verify_fp32": [dmax(verify[:, j], verify32[:, j])
                                  for j in range(cand.shape[1])],
        "decode_vs_decode_fp32": dmax(decode, decode32),
        "verify32_0_vs_decode_fp32": dmax(verify32[:, 0], decode32),
        "tolerance": tol,
        "argmax_verify0_vs_decode": (verify[:, 0].argmax(-1) == decode.argmax(-1))
        .float().mean().item(),
        "argmax_verify_vs_verify_fp32": (verify.argmax(-1) == verify32.argmax(-1))
        .float().mean().item(),
        "logit_absmax": decode32.abs().max().item(),
    }
    out["ok"] = (out["verify0_vs_decode"] <= tol and out["verify0_vs_decode_fp32"] <= tol
                 and max(out["verify_vs_verify_fp32"]) <= tol)
    return out


def _oracle(longer, n):
    """A drafter that proposes each stream's plain greedy continuation
    (``longer``: prompt -> tokens), by slot."""
    import torch

    def make(eng):
        def propose(embed, tokens):
            out = torch.zeros((len(eng._slots), n), dtype=torch.long, device=embed.device)
            for slot, req in enumerate(eng._slots):
                if req is not None:
                    done = len(req.generated)
                    out[slot] = torch.tensor(longer[tuple(req.prompt)][done:done + n])
            return out

        return propose

    return make


def phase_serve_spec(state):
    """``ServingEngine`` with ``speculator_path`` set to the trained file
    of the train-speculator phase (see the module docstring)."""
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.models import speculator as spec_mod
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config

    cfg = get_model_config("llama3_8b")
    path, n, max_new = state["spec_file"], 3, 64
    # the file is read once (4.3 GB): the later engines take the same
    # tensors
    load, loaded = spec_mod.load_speculator, {}

    def load_once(p, device="cpu"):
        if (p, str(device)) not in loaded:
            t0 = time.perf_counter()
            loaded[(p, str(device))] = load(p, device)
            loaded["seconds"] = time.perf_counter() - t0
        return loaded[(p, str(device))]

    spec_mod.load_speculator = load_once
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.src_vocab_size, size=int(k)).tolist()
               for k in rng.randint(64, 513, size=8)]
    spec_kw = dict(speculator_path=path, spec_draft_tokens=n)
    result = {"requests": len(prompts), "max_new_tokens": max_new,
              "prompt_tokens": sum(len(p) for p in prompts)}

    waves = {}
    for name, kw in (("speculative", spec_kw), ("plain", {})):
        eng, reqs, wall, paged, flash = _spec_wave(state["params"], cfg, prompts, max_new, **kw)
        stats = eng.serving_stats()
        steps = eng.decode_steps
        waves[name] = [list(r.generated) for r in reqs]
        result[name] = {
            "finished": sum(r.state == "finished" for r in reqs),
            "all_lengths_ok": all(len(r.generated) == max_new for r in reqs),
            "wall_s": wall, "decode_steps": steps,
            "decode_tokens_per_s": stats["tokens_per_s"],
            "spec_accept_rate": stats["spec_accept_rate"],
            "paged_decode_launches": paged, "flash_launches": flash,
            "step_profile": _profile_engine_steps(eng, prompts, max_new),
        }
        if name == "speculative":
            # on the state the profile left: every slot decoding
            result[name]["verify_compare"] = _compare_verify(eng)
            # tokens each row commits per verify step: the prefill gives
            # each request its first token
            result[name]["tokens_per_verify_step_per_row"] = (
                eng._decode_tokens / max(1, eng._spec_draft_total // n))
        del eng, reqs
        gc.collect()
        torch.cuda.empty_cache()
    result["bf16_requests_equal"] = sum(a == b for a, b in zip(waves["speculative"],
                                                               waves["plain"]))
    result["bf16_same_prefix"] = [
        next((k for k, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
        for x, y in zip(waves["speculative"], waves["plain"])]
    # the witness for those near-ties: a plain bf16 engine through the
    # reference attention, the verify step's own gather path
    eng, ref_reqs, _, _, _ = _spec_wave(state["params"], cfg, prompts, max_new,
                                        attn_impl="reference")
    ref_tokens = [list(r.generated) for r in ref_reqs]
    del eng, ref_reqs
    gc.collect()
    torch.cuda.empty_cache()
    result["bf16_requests_equal_plain_reference"] = sum(
        a == b for a, b in zip(waves["speculative"], ref_tokens))
    result["bf16_same_prefix_plain_reference"] = [
        next((k for k, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
        for x, y in zip(waves["speculative"], ref_tokens)]
    result["load_speculator_s"] = loaded["seconds"]

    # fp32 at 8 of 32 layers, the reference attention in every run:
    # speculative and oracle tokens equal plain greedy
    t0 = time.perf_counter()
    p32 = {k: (v.float() if torch.is_tensor(v) else {m: w[:8].float() for m, w in v.items()})
           for k, v in state["params"].items()}
    cfg8 = dataclasses.replace(cfg, nlayers=8)
    kw32 = dict(compute_dtype="float32", attn_impl="reference")
    _, longer, _, _, _ = _spec_wave(p32, cfg8, prompts, max_new + n, **kw32)
    longer = {tuple(p): list(r.generated) for p, r in zip(prompts, longer)}
    plain32 = [longer[tuple(p)][:max_new] for p in prompts]
    eng, sreqs, _, _, _ = _spec_wave(p32, cfg8, prompts, max_new, **kw32, **spec_kw)
    spec32, rate32 = [list(r.generated) for r in sreqs], eng.serving_stats()["spec_accept_rate"]
    del eng
    eng, oreqs, _, _, _ = _spec_wave(p32, cfg8, prompts, max_new, propose=_oracle(longer, n),
                                     **kw32, **spec_kw)
    oracle32 = [list(r.generated) for r in oreqs]
    ostats = eng.serving_stats()
    result["fp32_8_layers"] = {
        "speculative_equal": spec32 == plain32,
        "speculative_same_prefix": [next((k for k, (a, b) in enumerate(zip(x, y)) if a != b),
                                         len(x)) for x, y in zip(spec32, plain32)],
        "speculative_accept_rate": rate32,
        "oracle_equal": oracle32 == plain32, "oracle_accept_rate": ostats["spec_accept_rate"],
        "oracle_decode_steps": eng.decode_steps,
        "finished": [len(plain32), sum(r.state == "finished" for r in sreqs),
                     sum(r.state == "finished" for r in oreqs)],
        "seconds": time.perf_counter() - t0,
    }
    del eng, p32, loaded
    spec_mod.load_speculator = load
    gc.collect()
    torch.cuda.empty_cache()
    os.remove(path)
    result["nvidia_smi"] = state["smi"]
    emit("serve-spec", **result)
    state["serve-spec"] = result

    problems = []
    for name in ("speculative", "plain"):
        w = result[name]
        if w["finished"] != len(prompts) or not w["all_lengths_ok"]:
            problems.append(f"{name}: not every request finished with max_new_tokens")
    sw = result["speculative"]
    if sw["paged_decode_launches"] != {"v1": 0, "v2": 0} or any(sw["flash_launches"].values()):
        problems.append("the verify step launched an attention kernel (it gathers)")
    if result["plain"]["paged_decode_launches"]["v1"] == 0:
        problems.append("the plain decode launched no paged-decode kernel")
    if not sw["verify_compare"]["ok"]:
        problems.append(f"verify step vs decode steps: {sw['verify_compare']}")
    f = result["fp32_8_layers"]
    if not f["speculative_equal"]:
        problems.append(
            f"fp32 speculative tokens differ from plain: {f['speculative_same_prefix']}")
    if not f["oracle_equal"] or f["oracle_accept_rate"] != 1.0:
        problems.append(f"oracle drafter: equal {f['oracle_equal']}, "
                        f"accept rate {f['oracle_accept_rate']}")
    if problems:
        raise AssertionError("serve-spec: " + "; ".join(problems))


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


def _bwd_block_check(fa, q, k, v, do, got):
    """dq per 128-row block and dk/dv per 128-key block of the backward
    kernels against the plain backward on the same inputs (the kernel
    forward's lse and delta), each within ``BF16_BLOCK_REL_TOL``; and the
    control, that plain backward with the last 64-row query tile of head 0
    (batch 0) left out of key block 0's walk, which must exceed that bound
    on every block it changes (one of each output)."""
    lse, delta = got[1], _delta(got[0], do)
    ref = [fa.flash_dq_plain(q, k, v, do, lse, delta),
           *fa.flash_dkv_plain(q, k, v, do, lse, delta)]
    control = fa.flash_bwd_drop_tile_plain(
        q, k, v, do, lse, delta, *ref, batch=0, head=0,
        q_tile=q.shape[1] // fa.BWD_Q_TILE - 1, k_block=0)
    out = {}
    for name, a, r, c in zip(("dq", "dk", "dv"), got[2:], ref, control):
        rel, ctl = fa.block_rel_err(a, r), fa.block_rel_err(c, r)
        changed = ctl > 0
        tol = fa.BF16_BLOCK_REL_TOL[name]
        ctl_min = ctl[changed].min().item() if changed.any() else None
        out[name] = {"kernel_max": rel.max().item(), "blocks": rel.numel(), "tol": tol,
                     "control_min": ctl_min, "control_blocks": int(changed.sum())}
        out[name]["ok"] = (out[name]["kernel_max"] <= tol and int(changed.sum()) == 1
                           and ctl_min > tol)
    return out


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
    # the whole backward through autograd (delta, q2, both kernels, the
    # dk/dv casts) on retained graphs of the forward
    graphs = []
    for q, k, v, do, *_ in sets:
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        graphs.append((leaves, fa.flash_attention(*leaves), do))

    def autograd_bwd(i):
        leaves, o, do = graphs[i % 2]
        torch.autograd.grad(o, leaves, do, retain_graph=True)

    bwd_ms = _timed_ms(autograd_bwd)
    del graphs
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
        lib_ms = lib["fwd_ms"] if name == "fwd" else lib["bwd_ms"]
        out[name] = {"ms": out[name], "plain_ms": plain[name], "bound_ms": bound_ms,
                     "bound_by": bound_by, "ops": ops, "bytes": nbytes[name],
                     "achieved_tflops": ops / out[name] / 1e9,
                     "bound_share": bound_ms / out[name], "library_ms": lib_ms}
    # the forward beside SDPA's forward (the same operations); the backward
    # pair (dq + dk/dv) beside SDPA's one backward call
    if lib["fwd_ms"]:
        f = out["fwd"]
        f.update(library_tflops=f["ops"] / lib["fwd_ms"] / 1e9,
                 library_bound_share=f["bound_ms"] / lib["fwd_ms"],
                 kernel_over_library=f["ms"] / lib["fwd_ms"])
    pair = out["dq"]["ms"] + out["dkv"]["ms"]
    out["bwd_pair"] = {"ms": pair, "library_ms": lib["bwd_ms"],
                       "achieved_tflops": (out["dq"]["ops"] + out["dkv"]["ops"]) / pair / 1e9,
                       "kernel_over_library": pair / lib["bwd_ms"] if lib["bwd_ms"] else None}
    out["bwd_autograd"] = {"ms": bwd_ms, "library_ms": lib["bwd_ms"],
                           "over_pair_ms": bwd_ms - pair,
                           "kernel_over_library": bwd_ms / lib["bwd_ms"] if lib["bwd_ms"] else None}
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
                dist = rel = per_block = None
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
                per_block = _bwd_block_check(fa, q, k, v, do, got)
                rel_ok = rel_ok and all(x["ok"] for x in per_block.values())
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
                "rel_err_vs_plain_bf16": rel, "per_block_rel_err": per_block,
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


def _train_step_profile(res, steps=2, moe=False):
    """Host wall per step (no profiler) and device time per step by
    kernel (torch.profiler) of the trained state's next steps. With
    ``moe`` the 16-bit GEMMs split into the expert GEMMs (the device time
    of ``aten::bmm``, forward and backward: the port runs no other batched
    product on a Mixtral step) and the rest, and the dispatch kernels
    (index_add, index_select, cumsum, sort, gather, scatter) leave
    "other"."""
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
    flash = _flash_ms(rows)
    by_kind = {}
    for ms, name, _ in rows:
        kind = _kernel_kind(name)
        if moe and kind == "other" and _is_dispatch(name):
            kind = "moe_dispatch"
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    if moe and rows:
        expert = _op_device_ms(prof, "aten::bmm") / steps
        by_kind["gemm_16bit_expert"] = expert
        by_kind["gemm_16bit"] = by_kind.get("gemm_16bit", 0.0) - expert
    return {
        "device_ms_per_step_by_kind": by_kind if rows else None,
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if rows else None,
        "device_busy_share": device_ms / wall_ms if rows else None,
        "flash_ms_per_step": flash if rows else None,
        "top_device_ms_per_step": [
            {"name": name[:80], "ms": ms, "calls": calls} for ms, name, calls in rows[:16]
        ],
    }


def _flash_ms(rows):
    """Device ms of the flash forward, dq and dk/dv kernels among profile
    rows (ms, kernel name, calls), by name: ``flash_dq_kernel`` counts the
    fp32 kernel and ``flash_dq_kernel_sm90`` alike."""
    return {key: sum(r[0] for r in rows if f"flash_{key}_kernel" in r[1])
            for key in ("fwd", "dq", "dkv")}


def _is_dispatch(name: str) -> bool:
    """A MoE dispatch kernel by its name: PyTorch's index_add / index_select
    (``indexFunc*``, ``indexSelect*``), scans (cumsum), sorts (top-k) and
    gather / scatter (take_along_dim, one_hot)."""
    low = name.lower()
    return any(k in low for k in ("index", "scan", "sort", "gather", "scatter"))


def _op_device_ms(prof, op: str) -> float:
    """Device ms of the kernels the host op ``op`` launched (its CPU
    events' device time), over a whole profile."""
    total = 0.0
    for e in prof.events():
        if e.name != op or str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        total += us / 1e3
    return total


def _kernel_kind(name: str) -> str:
    """A device kernel's family by its name: the repo's own kernels, the
    library's matrix products by element type, and the rest."""
    low = name.lower()
    if "ssd_fused" in low and "_kernel" in low:  # ssd_fused_kernel, ssd_fused_sm90_kernel
        return "ssd_fused"
    if "flash_" in low and "_kernel" in low:
        return "flash"
    if "gemm" in low or "nvjet" in low or "cutlass" in low or "xmma" in low:
        fp32 = "sgemm" in low or "f32f32" in low or "s1688" in low or "simt" in low
        return "gemm_fp32" if fp32 else "gemm_16bit"
    return "other"


@contextlib.contextmanager
def _saves_nothing(entry):
    """Within the block the checkpoint managers that ``entry`` builds
    save nothing (their load still runs)."""
    build = entry.build_checkpoint_manager

    def build_no_save(*a, **k):
        manager = build(*a, **k)
        manager.save = lambda *sa, **sk: None
        return manager

    entry.build_checkpoint_manager = build_no_save
    try:
        yield
    finally:
        entry.build_checkpoint_manager = build


def _train(state, phase, overrides, expect, main=None, base=None, profile=False,
           save=True, moe=False, after=None):
    """Run a trainer through its entry point (the Llama one unless
    ``main`` is given) and check its launches: ``expect(model_cfg, cfg,
    steps)`` gives the expected counts of the flash contracts; the SSD
    kernel's count is expected 0 unless it names ``ssd_fused``. With
    ``save=False`` the entry's checkpoint manager saves nothing (its load
    still runs), for a state whose save the host could not hold.
    ``after(model_cfg, cfg, result)`` runs once the run's state is freed
    and returns more fields for the phase's line and a list of problems."""
    import torch

    from fms_fsdp_tpu_torch import main_training_llama as entry
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import ssd
    from fms_fsdp_tpu_torch.parallel.mesh import axis_sizes

    if main is None:
        main = entry.main

    ckpt_dir = _ckpt_dir(phase)
    # the final save is deleted unread: its manifest records sizes, not
    # content hashes (the resume and supervise phases verify content)
    kw = dict(TRAIN_KW if base is None else base, **overrides,
              ckpt_save_path=ckpt_dir, ckpt_load_path=ckpt_dir,
              ckpt_full_checksums=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    ssd.reset_launches()
    t0 = time.perf_counter()
    with _saves_nothing(entry) if not save else contextlib.nullcontext():
        res = main(**kw)
    wall = time.perf_counter() - t0
    saves = res["checkpointer"].save_log
    launches = dict(fa.LAUNCHES, ssd_fused=ssd.LAUNCHES["fused"])
    peak = torch.cuda.max_memory_allocated()
    reports = res["reports"]
    group = {"backend": torch.distributed.get_backend(),
             "world": torch.distributed.get_world_size(),
             "mesh": axis_sizes(res["mesh"]), "sharded": res["state"]["dp"] is not None}
    want = {"ssd_fused": 0, **expect(res["model_cfg"], res["cfg"], res["steps"])}
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
        final_save=_save_rows(saves), process_group=group, nvidia_smi=state["smi"],
    )
    if moe:
        result["moe_drop_frac"] = [r["moe_drop_frac"] for r in reports]
    problems = []
    if group["backend"] != "nccl" or group["world"] != 1 or group["sharded"]:
        problems.append(f"process group {group}: an NCCL world of one, no sharded state")
    want_saves = [(res["steps"], "final", "durable")] if save else []
    if [(r["step"], r["reason"], r["tier"]) for r in saves] != want_saves:
        problems.append(f"saves {_save_rows(saves)}: expected {want_saves}")
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"non-finite loss {losses}")
    if profile and not losses[-1] < losses[0]:
        problems.append(f"loss did not decrease: {losses}")
    if res["skipped_batches"]:
        problems.append(f"{res['skipped_batches']} skipped batches")
    if launches != want:
        problems.append(f"launches {launches} != expected {want}")
    if profile:
        result["step_profile"] = _train_step_profile(res, moe=moe)
    if after is not None:
        cfg_model, cfg_train = res["model_cfg"], res["cfg"]
        del res
        gc.collect()
        torch.cuda.empty_cache()
        more, more_problems = after(cfg_model, cfg_train, result)
        result.update(more)
        problems += more_problems
        res = None
    emit(phase, **result)
    state[phase] = result
    del res
    shutil.rmtree(ckpt_dir)
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"{phase}: " + "; ".join(problems))


def _memory_fs(path) -> bool:
    """Whether ``path`` lies on a file system held in memory (tmpfs or
    ramfs): the type of the longest mount point above it in
    ``/proc/mounts``."""
    path = os.path.realpath(path)
    best, kind = "", ""
    try:
        with open("/proc/mounts") as f:
            for line in f:
                _, mnt, fs = line.split()[:3]
                mnt = mnt.replace("\\040", " ")
                inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
                if inside and len(mnt) >= len(best):
                    best, kind = mnt, fs
    except OSError:
        return False
    return kind in ("tmpfs", "ramfs")


def _ckpt_dir(phase, memory=True) -> str:
    """A new checkpoint root for a phase, inside a directory that this run
    made with ``mkdtemp``; the phase deletes its root when it is done and
    ``main`` deletes the run's directories when the run ends, however it
    ends short of SIGKILL. The phases write about 170 GB of full-width
    checkpoints, more than a disk that meters its writes may take (the
    H100 machines this script was run on take 45 GiB a run), so the
    roots are in memory: in ``TMPDIR`` when that is a memory file system,
    else in ``/dev/shm``. With ``memory=False`` the root is on the
    checkout's disk (``build/``, not committed), for the one tier whose
    saves and load are measured against a disk."""
    key = "memory" if memory else "disk"
    if key not in CKPT_ROOTS:
        if memory:
            base = tempfile.gettempdir()
            if not _memory_fs(base) and _memory_fs("/dev/shm"):
                base = "/dev/shm"
        else:
            base = os.path.join(REPO, "build")
            os.makedirs(base, exist_ok=True)
        CKPT_ROOTS[key] = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base)
    path = os.path.join(CKPT_ROOTS[key], phase)
    os.makedirs(path)
    return path


def _save_rows(saves):
    """The checkpoint manager's records, as printed: the blocking
    snapshot in ms and within it the loader state's, the background commit and within it the payload
    write and the manifest hashing in s, the bytes, and the write's
    GB/s."""
    return [{"step": r["step"], "reason": r["reason"], "tier": r["tier"],
             "snapshot_ms": r["snapshot_s"] * 1e3, "loader_ms": r["loader_s"] * 1e3,
             "background_s": r["bg_s"],
             "payload_write_s": r["write_s"], "manifest_s": r["manifest_s"],
             "bytes": r["bytes"], "write_gb_per_s": r["bytes"] / r["bg_s"] / 1e9}
            for r in saves]


def _n_remat(model_cfg, cfg):
    return sum(_remat_mask(model_cfg, cfg))


def _remat_mask(model_cfg, cfg):
    """The trainer's per-layer rematerialisation mask, for any family."""
    from fms_fsdp_tpu_torch.models import get_model_api
    from fms_fsdp_tpu_torch.parallel.ac import selective_ac_mask

    n_layers = get_model_api(model_cfg)[2]
    if not cfg.fsdp_activation_checkpointing:
        return [False] * n_layers
    return selective_ac_mask(n_layers, cfg.selective_checkpointing)


def phase_train(state):
    def expect(m, cfg, steps):
        n = m.nlayers
        return {"fwd": steps * (n + _n_remat(m, cfg)), "fwd_kvgrid": 0,
                "dq": steps * n, "dq_kvgrid": 0, "dkv": steps * n}

    # no final save (33.5 GB, ~28 s, cut for the Mixtral phases): the
    # trainer phases at 2 layers, resume, supervise and shard save and load
    _train(state, "train", {}, expect, profile=True, save=False)


def phase_train_kvgrid(state):
    def expect(m, cfg, steps):
        n = m.nlayers
        return {"fwd": 0, "fwd_kvgrid": steps * (n + _n_remat(m, cfg)),
                "dq": 0, "dq_kvgrid": steps * n, "dkv": steps * n}

    # one step at 2 layers: the kernels are those of the train phase, and
    # the flash phase holds them against their plain versions at S=16384;
    # this run counts the kv-streamed contracts' launches on the main path.
    # No final save (17.8 GB, ~21 s, cut for the speculator phases): the
    # resume phase checks the final save of the same 2-layer model through
    # the same entry
    _train(state, "train-kvgrid",
           {"flash_kernel_variant": "kvgrid", "num_steps": 1, "report_interval": 1,
            "LlamaConfig.nlayers": 2},
           expect, save=False)

# ---------------------------------------------------------------------------
# the streaming loader: arrow shards -> the seven layers -> the card
# ---------------------------------------------------------------------------

# two corpora of 8 shards each, mixed 3:1; document lengths log-uniform
# over 64-16,384 tokens (a mean near 2,950), so 2,100 documents a shard
# make about 100M tokens: one epoch covers filling a 10,000-row reservoir
# at seq 4096 (about 82M tokens packed while it fills)
CORPUS = {"corpus_a": 8, "corpus_b": 8}
CORPUS_DOCS_PER_SHARD = 2100
LOADER_KW = dict(use_dummy_dataset=False, datasets="corpus_a,corpus_b", weights="3,1",
                 seq_length=4096, batch_size=2, vocab_size=128256, logical_shards=1024,
                 checkpoint_interval=1000)
LOADER_RATE_S = 2.0  # each worker mode's timed window
LOADER_FILL_S = 30.0  # the reservoir is filled to the largest window this allows


def _corpus(state):
    """The run's corpus (llama3 token ids, uint32 in [1, 128256)), written
    once into the in-memory checkpoint directory."""
    from fms_fsdp_tpu_torch.data.synth import build_mixed_corpus

    if "corpus" not in state:
        t0 = time.perf_counter()
        path, tokens = build_mixed_corpus(_ckpt_dir("corpus"), CORPUS,
                                          docs_per_shard=CORPUS_DOCS_PER_SHARD, seed=0)
        state["corpus"] = dict(path=path, tokens=tokens,
                               documents=sum(CORPUS.values()) * CORPUS_DOCS_PER_SHARD,
                               write_s=time.perf_counter() - t0)
    return state["corpus"]


def _loader(corpus, ckpt, **over):
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.data.loader import get_data_loader

    cfg = TrainConfig(**dict(LOADER_KW, data_path=corpus, ckpt_save_path=ckpt,
                             ckpt_load_path=ckpt, **over))
    return get_data_loader(cfg, 0, 1)


def _reservoir(loader):
    from fms_fsdp_tpu_torch.data.buffering import PreloadBufferDataset
    from fms_fsdp_tpu_torch.data.loader import _find_layer

    return _find_layer(loader.pipelines[0], PreloadBufferDataset)


def _pull_for(it, seconds):
    """Batches from ``it`` for ``seconds``: (the first four, the count,
    the seconds taken)."""
    first, n, t0 = [], 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        batch = next(it)
        if len(first) < 4:
            first.append(batch)
        n += 1
    return first, n, time.perf_counter() - t0


def _same_batches(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(p, q))
        for p, q in zip(a, b))


def phase_loader(state):
    """The streaming loader alone, host plus the copy to the card (see the
    module docstring)."""
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
    from fms_fsdp_tpu_torch.data.loader import loader_mix_stats

    corpus = _corpus(state)
    root = _ckpt_dir("loader")
    torch.cuda.init()
    live = torch.ones(1 << 20, device="cuda")  # the parent holds CUDA when workers fork
    tokens_per_batch = LOADER_KW["batch_size"] * LOADER_KW["seq_length"]
    problems = []
    result = {"corpus": dict(corpus), "config": dict(LOADER_KW), "modes": {}}

    # 1. setup and tokens/s of the pipeline alone, per worker mode
    firsts = {}
    keep = None
    for workers, mode in ((1, "thread"), (2, "thread"), (2, "process")):
        name = f"{workers}_{mode}"
        t0 = time.perf_counter()
        loader = _loader(corpus["path"], os.path.join(root, name), num_workers=workers,
                         worker_mode=mode)
        if mode == "thread":
            for p in loader.pipelines:
                p.setup()  # process workers set up in the forked child
        setup_s = time.perf_counter() - t0
        it = iter(loader)
        t0 = time.perf_counter()
        first = next(it)
        first_s = time.perf_counter() - t0
        head, n, secs = _pull_for(it, LOADER_RATE_S)
        firsts[name] = [first] + head[:3]
        result["modes"][name] = dict(
            setup_s=setup_s if mode == "thread" else None, first_batch_s=first_s, batches=n, seconds=secs,
            tokens_per_s=n * tokens_per_batch / secs,
            reservoir_rows=_reservoir(loader).buffer_size if mode == "thread" else None)
        if name == "1_thread":
            keep, keep_it = loader, it
        else:
            loader.shutdown()
    import multiprocessing

    result["children_after_shutdown"] = len(multiprocessing.active_children())
    if result["children_after_shutdown"]:
        problems.append(f"{result['children_after_shutdown']} loader workers not reaped")
    if not _same_batches(firsts["2_thread"], firsts["2_process"]):
        problems.append("process workers' first batches differ from thread workers'")
    x, y = firsts["1_thread"][0]
    result["first_batch"] = dict(shape=list(x.shape), dtype=str(x.dtype),
                                 min=int(x.min()), max=int(x.max()),
                                 masked_labels=int((y == -100).sum()))
    # causal_lm: labels are the inputs shifted by one, the first masked
    if (x.shape != (2, 4096) or x.dtype != np.int32 or x.min() < 0 or x.max() >= 128256
            or not np.array_equal(x[:, 2:], y[:, 1:-1]) or not (y[:, 0] == -100).all()):
        problems.append(f"first batch {result['first_batch']}")

    # 2. fill the reservoir (the 1-worker loader, still live)
    res_layer = _reservoir(keep)
    rows_per_s = result["modes"]["1_thread"]["tokens_per_s"] / LOADER_KW["seq_length"]
    window = 10000
    if (window - res_layer.buffer_size) / rows_per_s > LOADER_FILL_S:
        window = int(rows_per_s * LOADER_FILL_S) // 100 * 100
        keep.shutdown()
        keep = _loader(corpus["path"], os.path.join(root, "fill"), num_workers=1,
                       loader_shuffle_window=window)
        keep_it = iter(keep)
        res_layer = _reservoir(keep)
    t0 = time.perf_counter()
    while res_layer.buffer_size < window:
        next(keep_it)
    fill_s = time.perf_counter() - t0
    _, n, secs = _pull_for(keep_it, LOADER_RATE_S / 2)
    mix = loader_mix_stats(keep)
    share = mix["tokens"]["corpus_a"] / sum(mix["tokens"].values())
    result["reservoir"] = dict(
        window=window, reduced=window < 10000, fill_s=fill_s,
        tokens_per_s_full=n * tokens_per_batch / secs, mix_tokens=mix["tokens"],
        corpus_a_share=share)
    if abs(share - 0.75) > 0.02:
        problems.append(f"corpus_a share {share}, weights 3:1")

    # 3. the loader state with the reservoir full: bytes, save and load
    # (a trainer-resolved step dir of the loader's own root)
    step_dir = os.path.join(root, "1_thread" if window == 10000 else "fill",
                            "checkpoints", "step_1_ckp")
    t0 = time.perf_counter()
    keep.save_to_path(step_dir)
    save_ms = (time.perf_counter() - t0) * 1e3
    state_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
    after = [next(keep_it) for _ in range(3)]
    fresh = _loader(corpus["path"], os.path.dirname(os.path.dirname(step_dir)),
                    num_workers=1, loader_shuffle_window=window)
    t0 = time.perf_counter()
    fresh.load_from_path(step_dir)
    load_ms = (time.perf_counter() - t0) * 1e3
    fresh_it = iter(fresh)
    resumed = [next(fresh_it) for _ in range(3)]
    # load_ms includes the fresh loader's setup (setup_s of 1_thread)
    result["state"] = dict(bytes=state_bytes, save_ms=save_ms, load_ms=load_ms,
                           continuation_equal=_same_batches(after, resumed))
    if not result["state"]["continuation_equal"]:
        problems.append("the loaded loader does not continue the saved one")

    # 4. through DeviceFeed to the card: the fresh loader's batches equal
    # the saved one's on the host; then ms per batch with the feed's
    # thread pulling and staging ahead, and the staging alone
    want = [next(keep_it) for _ in range(3)]
    feed = DeviceFeed(fresh, "cuda", prefetch=2)
    feed_it = iter(feed)
    got = [tuple(t.cpu().numpy() for t in next(feed_it)) for _ in range(3)]
    if not _same_batches(want, got):
        problems.append("feed batches on the card differ from the host batches")
    n_feed = 40
    torch.cuda.synchronize()
    wait0, t0 = feed.wait_s, time.perf_counter()
    for _ in range(n_feed):
        x, y = next(feed_it)
    torch.cuda.synchronize()
    feed_ms = (time.perf_counter() - t0) * 1e3 / n_feed
    feed_wait_ms = (feed.wait_s - wait0) * 1e3 / n_feed
    feed_it.close()
    fresh.shutdown()
    host = [tuple(np.ascontiguousarray(a) for a in b) for b in want] * 10
    t0 = time.perf_counter()
    for x, y in DeviceFeed(host, "cuda", prefetch=0):
        pass
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    result["feed"] = dict(ms_per_batch=feed_ms, consumer_wait_ms_per_batch=feed_wait_ms,
                          stage_only_ms_per_batch=stage_ms, batches=n_feed)
    del live
    result["nvidia_smi"] = state["smi"]
    emit("loader", **result)
    state["loader"] = result
    shutil.rmtree(root)
    if problems:
        raise AssertionError("loader: " + "; ".join(problems))


# llama3_8b_4k at full width, 2 layers, on the loader phase's corpus: one
# loader worker, so the stream is one walk, and the feed two batches ahead.
# bf16 params and moments (``pure_bf16``: 8.9 GB a checkpoint, half of
# bfSixteen's, so the four saves and the two full loads, one of them from
# disk, cost half the time; the checks are bitwise digests, loader
# positions and fallbacks, which do not depend on the bytes). The
# train-kvgrid and train-mamba phases save bfSixteen states on the card
RESUME_KW = {**TRAIN_KW, **LOADER_KW, "num_workers": 1, "feed_prefetch": 2,
             "LlamaConfig.nlayers": 2, "report_interval": 1, "checkpoint_interval": 4,
             "ckpt_local_interval": 2, "ckpt_keep": 1, "ckpt_local_keep": 1,
             "pure_bf16": True}
# batches a saved loader state may run ahead of the trainer: the feed's
# queue and the batch its thread holds
RESUME_SKEW = RESUME_KW["feed_prefetch"] + 1


def _digests(flat):
    """Per key of a checkpoint dict: the float64 sum and the sum of the
    bit pattern as int64, on the tensors' own device."""
    import torch

    out = {}
    for key, t in flat.items():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        out[key] = (float(t.double().sum()),
                    int(t.view(bits).to(torch.int64).sum()) if t.dim() else int(t.view(bits)))
    return out


def _resume_serve(model_cfg, root, live_params, live_digests):
    """Serve 8 requests from the checkpoint root through the paged-decode
    kernel, and hold the first decode step against an engine on the live
    params."""
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.ckpt.state import flatten
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
    from fms_fsdp_tpu_torch.utils.checkpointing import load_params_only

    t0 = time.perf_counter()
    params, nbytes = load_params_only(root, with_bytes=True)
    params_s = time.perf_counter() - t0
    on_card = {k: t.cuda() for k, t in flatten("params", params, {}).items()}
    digests_ok = _digests(on_card) == live_digests
    del on_card
    del params
    scfg = ServeConfig(max_batch=8, max_seq_len=1024)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, model_cfg.src_vocab_size, size=int(n)).tolist()
               for n in rng.randint(64, 513, size=8)]

    def first_step(eng):
        reqs = [eng.submit(p, 16) for p in prompts]
        first = None
        while eng.has_work():
            eng.step()
            if eng.last_logits is not None and first is None:
                first = eng.last_logits.clone()
        return reqs, first

    t0 = time.perf_counter()
    eng = ServingEngine.from_checkpoint(root, model_cfg, scfg, seed=0)
    build_s = time.perf_counter() - t0
    pa.reset_launches()
    reqs, logits = first_step(eng)
    torch.cuda.synchronize()
    launches, steps = pa.LAUNCHES["v1"], eng.decode_steps
    tokens = [list(r.generated) for r in reqs]
    del eng
    live = ServingEngine(live_params, model_cfg, scfg, seed=0)
    live_reqs, live_logits = first_step(live)
    del live
    return dict(
        params_only_load_s=params_s, params_only_bytes=nbytes, engine_build_s=build_s,
        params_digests_equal=digests_ok, finished=sum(r.state == "finished" for r in reqs),
        all_lengths_ok=all(len(r.generated) == 16 for r in reqs),
        decode_steps=steps, paged_launches=launches,
        first_step_logits_equal=bool(torch.equal(logits, live_logits)),
        first_step_max_abs_diff=float((logits.float() - live_logits.float()).abs().max()),
        logits_finite=bool(torch.isfinite(logits).all()),
        tokens_equal=tokens == [list(r.generated) for r in live_reqs],
    )


def _train_cfg(kw):
    """A TrainConfig with the entry's overrides (dotted model keys
    skipped)."""
    from fms_fsdp_tpu_torch.config import TrainConfig

    return TrainConfig(**{k: v for k, v in kw.items() if "." not in k})


def phase_resume(state):
    """Checkpoint and resume through the Llama entry point (see the module
    docstring), then serve from the checkpoint root."""
    import numpy as np
    import torch

    import fms_fsdp_tpu_torch.main_training_llama as entry
    from fms_fsdp_tpu_torch.ckpt import build_checkpoint_manager
    from fms_fsdp_tpu_torch.ckpt.state import checkpoint_state, flatten
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.data.loader import get_data_loader
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.train.step import get_lr_schedule, init_train_state
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config

    gc.collect()
    torch.cuda.empty_cache()
    corpus = _corpus(state)["path"]
    # the durable tier in memory, the local tier on the checkout's disk:
    # one save (step 2) and the fallback load are a disk's
    root, local = _ckpt_dir("resume"), _ckpt_dir("resume-local", memory=False)
    durable = os.path.join(root, "durable")
    kw = dict(RESUME_KW, data_path=corpus, ckpt_save_path=durable, ckpt_load_path=durable,
              ckpt_local_dir=local)
    problems = []
    result = {"config": {k: kw[k] for k in sorted(kw)}}

    def listing(path):
        """The committed step dirs (a loader auto-save dir holds no
        metadata.json), each with the loader state files it holds."""
        top = os.path.join(path, "checkpoints")
        return {d: sorted(f for f in os.listdir(os.path.join(top, d))
                          if f.startswith("loader_state"))
                for d in sorted(os.listdir(top))
                if os.path.exists(os.path.join(top, d, "metadata.json"))}

    # the reference: a host-only straight walk of the same loader config
    walker = get_data_loader(_train_cfg(dict(kw, ckpt_save_path=os.path.join(root, "walk"),
                                             ckpt_load_path=os.path.join(root, "walk"))), 0, 1)
    walk_it = iter(walker)
    walk = [next(walk_it)[0] for _ in range(6 + 2 * RESUME_SKEW + 2)]
    walker.shutdown()

    def walk_index(rows):
        """k where ``rows`` are walk[k], walk[k+1], ...; else None."""
        for k in range(len(walk) - len(rows) + 1):
            if all(np.array_equal(r, walk[k + i]) for i, r in enumerate(rows)):
                return k
        return None

    class RecordingFeed(entry.DeviceFeed):
        """The feed, keeping each batch's input rows as it stages them
        (in the order it serves them)."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.rows = []

        def _stage(self, batch):
            self.rows.append(np.array(batch[0]))
            return super()._stage(batch)

    real_feed = entry.DeviceFeed
    entry.DeviceFeed = RecordingFeed

    def disk_bytes():
        total = 0
        for top in (root, local):
            for d, _, fs in os.walk(top):
                for f in fs:
                    with contextlib.suppress(OSError):  # pruned under the walk
                        total += os.path.getsize(os.path.join(d, f))
        return total

    # the phase's peak disk use, sampled while the writers run
    peak = {"bytes": 0}
    done = threading.Event()

    def sample():
        while not done.wait(0.5):
            peak["bytes"] = max(peak["bytes"], disk_bytes())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()

    # 1. the first run: saves at 2 (local), 4 (durable) and 6 (final),
    # each with the loader's state; the trainer consumes walk[0:6]
    try:
        t0 = time.perf_counter()
        res = entry.main(**dict(kw, num_steps=6))
        result["first_run_s"] = time.perf_counter() - t0
    except BaseException:
        entry.DeviceFeed = real_feed
        raise
    saved = _digests(checkpoint_state(res["state"]))
    model_cfg = res["model_cfg"]
    first_rows = res["feed"].rows[:6]
    result["first_run_saves"] = _save_rows(res["checkpointer"].save_log)
    result["first_run_feed_wait_ms_per_step"] = res["feed"].wait_s * 1e3 / res["feed"].served
    result["first_run_walk_index"] = walk_index(first_rows)
    result["listing_after_first"] = {"local": listing(local), "durable": listing(durable)}
    if [(r["step"], r["tier"]) for r in res["checkpointer"].save_log] != [
            (2, "local"), (4, "durable"), (6, "durable")]:
        problems.append(f"first run saves {result['first_run_saves']}")
    if result["listing_after_first"] != {"local": {"step_2_ckp": ["loader_state_0.pkl"]},
                                         "durable": {"step_6_ckp": ["loader_state_0.pkl"]}}:
        problems.append(f"retention / loader state: {result['listing_after_first']}")
    if result["first_run_walk_index"] != 0:
        problems.append("the first run's batches are not the straight walk's first six")
    # where the saved states put the stream: load each into a host loader
    saved_at = {}
    for step, top in ((6, durable), (2, local)):
        probe_root = os.path.join(root, f"probe_{step}")
        step_dir = os.path.join(probe_root, "checkpoints", f"step_{step}_ckp")
        shutil.copytree(os.path.join(top, "checkpoints", f"step_{step}_ckp"), step_dir,
                        ignore=shutil.ignore_patterns("state"))
        probe = get_data_loader(_train_cfg(dict(kw, ckpt_save_path=probe_root,
                                                ckpt_load_path=probe_root)), 0, 1)
        probe.load_from_path(step_dir)
        saved_at[step] = walk_index([next(iter(probe))[0]])
        probe.shutdown()
    result["saved_state_walk_index"] = saved_at
    for step in (6, 2):
        if saved_at[step] is None or not step <= saved_at[step] <= step + RESUME_SKEW:
            problems.append(f"step {step}'s loader state puts the stream at walk "
                            f"{saved_at[step]}, not in [{step}, {step + RESUME_SKEW}]")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the second run resumes at 6; the loaded state is read as the
    # loop receives it
    seen = {}
    real_train = entry.train

    def train_probe(cfg, st, step_fn, rank, loader, checkpointer, start_step,
                    tokens_seen, **more):
        seen.update(start_step=start_step, tokens_seen=tokens_seen,
                    digests=_digests(checkpoint_state(st)))
        return real_train(cfg, st, step_fn, rank, loader, checkpointer, start_step,
                          tokens_seen, **more)

    fa.reset_launches()
    entry.train = train_probe
    try:
        t0 = time.perf_counter()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res = entry.main(**dict(kw, num_steps=8, resuming_dataset=True))
        result["second_run_s"] = time.perf_counter() - t0
    finally:
        entry.train = real_train
        entry.DeviceFeed = real_feed
    print(text.getvalue(), end="")
    launches = dict(fa.LAUNCHES)
    resumed_rows = res["feed"].rows[:2]
    k = walk_index(resumed_rows)
    seen_rows = {r.tobytes() for b in first_rows for r in b}
    repeated = sum(r.tobytes() in seen_rows for b in resumed_rows for r in b)
    result.update(
        resumed_walk_index=k, repeated_rows_of_steps_1_6=repeated,
        second_run_feed_wait_ms_per_step=res["feed"].wait_s * 1e3 / res["feed"].served,
        dataset_loaded=[ln for ln in text.getvalue().splitlines()
                        if "Dataset checkpoint loaded" in ln])
    if k is None or k != saved_at[6]:
        problems.append(f"resumed batches at walk {k}, the saved state's at {saved_at[6]}")
    if repeated:
        problems.append(f"{repeated} rows of steps 1-6 came again after the resume")
    if not any("step_6_ckp" in ln for ln in result["dataset_loaded"]):
        problems.append(f"no loader load from step_6_ckp: {result['dataset_loaded']}")
    n, remat = model_cfg.nlayers, _n_remat(model_cfg, res["cfg"])
    want = {"fwd": 2 * (n + remat), "fwd_kvgrid": 0, "dq": 2 * n, "dq_kvgrid": 0,
            "dkv": 2 * n}
    straight_lr = get_lr_schedule(res["cfg"])(6)  # step 7 of a straight 8-step run
    reports = res["reports"]
    result.update(
        resumed_at=res["start_step"], steps=res["steps"],
        tokens_seen_loaded=seen.get("tokens_seen"),
        loaded_digests_equal=seen.get("digests") == saved,
        differing_keys=sorted(k for k in saved if seen.get("digests", {}).get(k) != saved[k]),
        first_lr=reports[0]["lr"], straight_lr_step7=straight_lr,
        losses=[r["loss"] for r in reports], flash_launches=launches,
        expected_flash_launches=want,
        second_run_saves=_save_rows(res["checkpointer"].save_log),
        listing_after_second={"local": listing(local), "durable": listing(durable)},
    )
    if res["start_step"] != 6 or res["steps"] != 2:
        problems.append(f"resumed at {res['start_step']} for {res['steps']} steps")
    if not result["loaded_digests_equal"]:
        problems.append(f"loaded state differs from step 6's: {result['differing_keys'][:8]}")
    if seen.get("tokens_seen") != 6 * 2 * 4096:
        problems.append(f"tokens_seen {seen.get('tokens_seen')} != {6 * 2 * 4096}")
    if reports[0]["lr"] != straight_lr:
        problems.append(f"first lr {reports[0]['lr']} != straight run's {straight_lr}")
    if not all(math.isfinite(x) for x in result["losses"]):
        problems.append(f"non-finite losses {result['losses']}")
    if launches != want:
        problems.append(f"flash launches {launches} != {want}")

    # 3. serve from the durable root (step 8) through the paged kernel
    live = flatten("params", res["state"]["params"], {})
    result["serve"] = _resume_serve(model_cfg, os.path.join(durable, "checkpoints"),
                                    res["state"]["params"], _digests(live))
    srv = result["serve"]
    if srv["finished"] != 8 or not srv["all_lengths_ok"] or not srv["logits_finite"]:
        problems.append(f"serving: {srv}")
    if not srv["params_digests_equal"] or not srv["first_step_logits_equal"]:
        problems.append("serving from the checkpoint differs from the live params")
    if srv["paged_launches"] != srv["decode_steps"] * n:
        problems.append(f"paged launches {srv['paged_launches']} != "
                        f"{srv['decode_steps']} x {n}")
    cfg = res["cfg"]
    del res, live
    gc.collect()
    torch.cuda.empty_cache()

    # 4. damage: truncate a payload file of the newest checkpoint; the
    # next load falls back to the previous committed one (local step 2)
    newest = os.path.join(durable, "checkpoints", "step_8_ckp", "state")
    victim = max((os.path.join(newest, f) for f in os.listdir(newest)), key=os.path.getsize)
    size = os.path.getsize(victim)
    with open(victim, "rb+") as f:
        f.truncate(size // 2)
    fresh_cfg = TrainConfig()
    update_config(fresh_cfg, **dict(kw, num_steps=8))
    fresh = init_train_state(torch.Generator(device="cuda").manual_seed(1), model_cfg,
                             fresh_cfg)
    mgr = build_checkpoint_manager(fresh_cfg, 0)
    loader = get_data_loader(fresh_cfg, 0, 1)
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        _, _, step, ntok, resuming = mgr.load(fresh, loader, path=durable, strict=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loader_it = iter(loader)
    k2 = walk_index([next(loader_it)[0] for _ in range(2)])
    loader.shutdown()
    lines = text.getvalue().splitlines()
    result["fallback"] = dict(
        truncated=os.path.relpath(victim, root), size=size, loaded_step=step,
        tokens_seen=ntok, resuming=resuming, full_load_s=load_s,
        warning=[ln for ln in lines if "WARNING" in ln],
        dataset_loaded=[ln for ln in lines if "Dataset checkpoint loaded" in ln],
        loader_walk_index=k2)
    print(text.getvalue(), end="")
    if (step, ntok, resuming) != (2, 2 * 2 * 4096, True) or not any(
            "failed integrity verification" in ln and "falling back" in ln
            for ln in result["fallback"]["warning"]):
        problems.append(f"fallback: {result['fallback']}")
    if not any("step_2_ckp" in ln for ln in result["fallback"]["dataset_loaded"]) or \
            k2 != saved_at[2]:
        problems.append(f"fallback loader: {result['fallback']['dataset_loaded']}, walk "
                        f"{k2}, step 2's state at {saved_at[2]}")
    del fresh, mgr
    gc.collect()
    torch.cuda.empty_cache()

    rows = result["first_run_saves"] + result["second_run_saves"]
    result["save_summary"] = {
        tier: {"snapshot_ms": [r["snapshot_ms"] for r in rows if r["tier"] == tier],
               "loader_state_ms": [r["loader_ms"] for r in rows if r["tier"] == tier],
               "background_s": [r["background_s"] for r in rows if r["tier"] == tier],
               "write_gb_per_s": [r["write_gb_per_s"] for r in rows if r["tier"] == tier]}
        for tier in ("local", "durable")}
    done.set()
    sampler.join()
    result["peak_disk_bytes"] = peak["bytes"]
    result["nvidia_smi"] = state["smi"]
    result["roots"] = {"durable": durable, "local": local}
    emit("resume", **result)
    state["resume"] = result
    shutil.rmtree(root)
    shutil.rmtree(local)
    if problems:
        raise AssertionError("resume: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# the supervised trainer: observability and resilience end to end
# ---------------------------------------------------------------------------

# llama3_8b_4k at full width and the resume phase's 2 layers, bf16 params
# and moments (``pure_bf16``: 8.9 GB a checkpoint, half of bfSixteen's, so
# the three saves and the load of the relaunch cost half the time; what
# the phase measures, the restart's classes, downtime and the observer's
# cost, does not depend on the bytes), run as `python -m` children of the
# supervisor. Steps 7 and
# 8 are poisoned (state steps 6-7), so the first incarnation aborts at its
# step-8 report after its abort save and the second, resumed at 8, outlives
# the window; the interval save at 4 gets 4 bytes flipped, and the second
# incarnation's scrubber quarantines it. Three checkpoints stay (4, 8, 10).
SUPERVISE_KW = {
    "model_variant": "llama3_8b_4k", "LlamaConfig.nlayers": 2, "seq_length": 4096,
    "batch_size": 2, "vocab_size": 128256, "fsdp_activation_checkpointing": True,
    "selective_checkpointing": 0.5, "use_dummy_dataset": True, "num_steps": 10,
    "report_interval": 2, "checkpoint_interval": 4, "ckpt_keep": 3,
    "anomaly_max_consecutive": 2, "obs_sinks": "jsonl,csv", "obs_strict_schema": True,
    "use_profiler": True, "scrub_interval_steps": 4, "pure_bf16": True,
    # a healthy step is ~0.2 s and the report fetch one step; saves run with
    # the watchdog paused; the profiler's trace export (seconds) lands
    # between two beats: 120 s trips only on a wedged step
    "step_timeout_s": 120.0,
}
SUPERVISE_FAULTS = "nan_loss:step=6:count=2;ckpt_shard_corrupt:step=4"
SUPERVISE_POISONED = (7, 8)  # the loop steps the spec poisons
SUPERVISE_TIMEOUT_S = 420
FLASH_SYMBOLS = ("flash_fwd_kernel_sm90", "flash_dq_kernel_sm90", "flash_dkv_kernel_sm90")


def _run_group(argv, timeout, **kw):
    """Run ``argv`` in a session of its own; on timeout kill the whole
    group (the supervisor and its trainer child) and raise."""
    proc = subprocess.Popen(argv, start_new_session=True, **kw)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _trace_names(path):
    """(device kernel names, user annotation names) of a torch.profiler
    chrome trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    scopes = {e.get("name", "") for e in events if e.get("cat") == "user_annotation"}
    return kernels, scopes


def phase_supervise(state):
    """The supervisor CLI over the Llama entry on the card (see
    ``SUPERVISE_KW``): classified anomaly-abort restart, resume from the
    newest unquarantined checkpoint, schema-valid records with the card's
    MFU, the scrubber's quarantine, the profiler trace of the kernels."""
    from fms_fsdp_tpu_torch.obs.schema import validate_record
    from fms_fsdp_tpu_torch.resilience.scrub import QUARANTINE_NAME, is_quarantined
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config
    from fms_fsdp_tpu_torch.utils.flops import peak_flops_per_card, train_flops_per_token

    import torch

    # this process's pinned host buffers (the earlier phases' snapshots)
    # stay cached by torch's host allocator: hand them back before the
    # children pin their own and three checkpoints fill /dev/shm
    gc.collect()
    torch._C._host_emptyCache()
    root = _ckpt_dir("supervise")
    ckpt, obs, logs = (os.path.join(root, d) for d in ("ckpt", "obs", "logs"))
    ledger_path = os.path.join(root, "ledger.json")
    kw = dict(SUPERVISE_KW, obs_dir=obs, ckpt_save_path=ckpt, ckpt_load_path=ckpt)
    child = [sys.executable, "-u", "-m", "fms_fsdp_tpu_torch.main_training_llama",
             *(f"--{k}={v}" for k, v in kw.items())]
    argv = [sys.executable, "-u", "-m", "fms_fsdp_tpu_torch.resilience.supervisor",
            "--ledger", ledger_path, "--heartbeat", os.path.join(obs, "heartbeat.json"),
            "--target-step", str(kw["num_steps"]), "--max-restarts", "3",
            "--restart-backoff-s", "0.5", "--anomaly-cooldown-s", "1",
            "--log-dir", logs, "--", *child]
    # the children load the kernels the build phase made (build/ of this
    # checkout), so no step carries nvcc under the watchdog
    env = dict(os.environ, PYTHONPATH=REPO, FMS_FAULTS=SUPERVISE_FAULTS)
    t0 = time.perf_counter()
    rc = _run_group(argv, SUPERVISE_TIMEOUT_S, cwd=root, env=env)
    wall = time.perf_counter() - t0
    with open(ledger_path) as f:
        ledger = json.load(f)
    entries = ledger["entries"]
    child_logs = []
    for e in entries:
        with open(os.path.join(logs, f"attempt{e['attempt']}_child0.log")) as f:
            child_logs.append(f.read())
    with open(os.path.join(obs, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(obs, "heartbeat.json")) as f:
        heartbeat = json.load(f)
    steps_dir = os.path.join(ckpt, "checkpoints")
    dirs = {int(d.split("_")[1]): os.path.join(steps_dir, d) for d in os.listdir(steps_dir)
            if os.path.exists(os.path.join(steps_dir, d, "metadata.json"))}
    problems = []

    # 1. the ledger: anomaly_abort restart(s), then completed, exit 0
    classes = [e["classification"] for e in entries]
    result = {"supervisor_rc": rc, "wall_s": wall, "classifications": classes,
              "exit_codes": [e["exit_codes"] for e in entries],
              "restarts": ledger["restarts"],
              "restart_downtime_s": ledger["restart_downtime_s"]}
    emit("supervise", check="ledger", **result)
    if rc != 0 or len(classes) < 2 or classes[-1] != "ok" or any(
            c != "anomaly_abort" for c in classes[:-1]):
        problems.append(f"ledger: rc {rc}, classes {classes}")

    # 2. the relaunch resumed from the newest committed, unquarantined step
    # below its own saves (the abort save of the first incarnation)
    abort_step = entries[0]["step_at_exit"]
    usable = [s for s, d in dirs.items() if s <= abort_step and not is_quarantined(d)]
    resumed = [ln for ln in child_logs[-1].splitlines() if ln.startswith("Prior checkpoint")]
    check = {"abort_step": abort_step, "committed_steps": sorted(dirs),
             "newest_unquarantined_at_relaunch": max(usable) if usable else None,
             "relaunch_log": resumed}
    emit("supervise", check="resume", **check)
    if not usable or resumed != [
            f"Prior checkpoint {os.path.join(steps_dir, f'step_{max(usable)}_ckp')} detected."]:
        problems.append(f"resume: {check}")

    # 3. the records: strict schema, skipped steps, the card's MFU,
    # restart accounting, the heartbeat
    model_cfg = get_model_config(kw["model_variant"])
    update_config(model_cfg, **kw)
    flops = train_flops_per_token(model_cfg, kw["seq_length"])
    peak = peak_flops_per_card(state["kind"])
    printed = [float(ln.split(":", 1)[1]) for log in child_logs for ln in log.splitlines()
               if ln.startswith("MFU:")]
    invalid = {r["step"]: validate_record(r) for r in records if validate_record(r)}
    first_last = [r for r in records if r["step"] == abort_step][0]
    mfu_rel = [abs(r["mfu"] * peak / (r["tokens_per_sec_per_chip"] * flops) - 1)
               for r in records if r["mfu"] is not None]
    check = {"records": len(records), "invalid": invalid,
             "skipped_steps_at_abort": first_last["skipped_steps"],
             "poisoned_steps": list(SUPERVISE_POISONED),
             "mfu_records": [r["mfu"] for r in records], "mfu_printed": printed,
             "mfu_vs_card_peak_max_rel": max(mfu_rel) if mfu_rel else None,
             "last_restarts": records[-1]["restarts"],
             "last_restart_downtime_s": records[-1]["restart_downtime_s"],
             "heartbeat": heartbeat, "last_run_id": entries[-1]["run_id"]}
    emit("supervise", check="records", **check)
    if invalid:
        problems.append(f"records violate the schema: {invalid}")
    if first_last["skipped_steps"] != len(SUPERVISE_POISONED):
        problems.append(f"skipped_steps {first_last['skipped_steps']} at the abort")
    if [r["mfu"] for r in records] != printed or len(mfu_rel) != len(records) or \
            max(mfu_rel) > 1e-9:
        problems.append("records' MFU is not the printed one against the card's peak")
    if records[-1]["restarts"] < 1 or not records[-1]["restart_downtime_s"] > 0:
        problems.append("the last record carries no restart accounting")
    if heartbeat.get("step") != kw["num_steps"] or \
            heartbeat.get("run_id") != entries[-1]["run_id"]:
        problems.append(f"heartbeat {heartbeat}")

    # 4. the scrubber: verified checkpoints, the corrupted one quarantined
    victim = dirs.get(4)
    sidecar = None
    if victim and is_quarantined(victim):
        with open(os.path.join(victim, QUARANTINE_NAME)) as f:
            sidecar = json.load(f)
    check = {"scrub_verified": records[-1]["scrub_verified"],
             "quarantined": sorted(s for s, d in dirs.items() if is_quarantined(d)),
             "sidecar_problems": (sidecar or {}).get("problems"),
             "integrity_verify_s": [r["integrity_verify_s"] for r in records],
             "quarantine_lines": [ln for log in child_logs for ln in log.splitlines()
                                  if ln.startswith("INTEGRITY:")]}
    emit("supervise", check="scrubber", **check)
    if records[-1]["scrub_verified"] < 1 or sidecar is None:
        problems.append(f"scrubber: {check}")

    # 5. the first incarnation's profiler trace names the kernels
    traces = sorted((os.path.join(root, "profile_traces", f)
                     for f in os.listdir(os.path.join(root, "profile_traces"))),
                    key=os.path.getmtime) if os.path.isdir(
                        os.path.join(root, "profile_traces")) else []
    found = {}
    if traces:
        kernels, scopes = _trace_names(traces[0])
        found = {sym: sum(sym in k for k in kernels) > 0 for sym in FLASH_SYMBOLS}
        found["fwd_bwd_scope"] = "fwd_bwd" in scopes
    check = {"traces": [os.path.basename(t) for t in traces],
             "trace_bytes": [os.path.getsize(t) for t in traces], "names": found}
    emit("supervise", check="profiler", **check)
    if not found or not all(found.values()):
        problems.append(f"profiler trace: {check}")

    # 6. timings per incarnation, from the ledger and the records
    incarnations = []
    prev = 0
    for e, log in zip(entries, child_logs):
        recs = [r for r in records if prev < r["step"] <= e["step_at_exit"]]
        prev = e["step_at_exit"]
        incarnations.append({
            "run_id": e["run_id"], "wall_s": e["ended_unix"] - e["started_unix"],
            "steps": e["step_at_exit"] - max(0, e["resumed_step"]),
            "tokens_per_card_per_s": [r["tokens_per_sec_per_chip"] for r in recs],
            "mfu": [r["mfu"] for r in recs],
            "obs_report_ms": [1e3 * r["extra"]["obs.report_s"] for r in recs
                              if "obs.report_s" in r["extra"]],
            "checkpoint_s": [r["checkpoint_s"] for r in recs],
            "checkpoint_bg_s": [r["checkpoint_bg_s"] for r in recs],
            "downtime_after_s": e["downtime_s"]})
    emit("supervise", check="timings", incarnations=incarnations,
         nvidia_smi=state["smi"])
    result.update(incarnations=incarnations, checks_ok=not problems)
    state["supervise"] = result
    shutil.rmtree(root)
    if problems:
        raise AssertionError("supervise: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# the data-parallel entry: ddp, fsdp and hsdp through the mesh on one card
# ---------------------------------------------------------------------------

# llama3_8b_4k at full width, 2 layers, bf16 params and moments
# (``pure_bf16``: 8.9 GB a checkpoint), 3 steps a strategy; the two
# in-process runs skip the manifest's content hashes (their roots are
# deleted unread), so the phase's four saves cost about 40 s
SHARD_KW = {
    "model_variant": "llama3_8b_4k", "LlamaConfig.nlayers": 2, "seq_length": 4096,
    "batch_size": 2, "vocab_size": 128256, "fsdp_activation_checkpointing": True,
    "selective_checkpointing": 0.5, "use_dummy_dataset": True, "num_steps": 3,
    "report_interval": 1, "checkpoint_interval": 1000, "pure_bf16": True,
}
# the resume trains steps 4-9; the profiler's window (wait 1, warmup 2,
# active 3) records steps 7-9
SHARD_RESUME_STEPS = 9
SHARD_REL_TOL = 1e-2  # bf16: the strategies' losses, relative
SHARD_TIMEOUT_S = 300


def _report_values(out, label):
    return [float(ln.split(":", 1)[1]) for ln in out.splitlines() if ln.startswith(label)]


def _torchrun_env():
    """torchrun's environment for rank 0 of a world of one on this host."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return dict(os.environ, PYTHONPATH=REPO, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def phase_shard(state):
    """``python -m fms_fsdp_tpu_torch.main_training_llama
    --sharding_strategy=hsdp`` as a child under torchrun's environment
    (``cuda:LOCAL_RANK``, an NCCL group from ``env://``), the same run in
    this process under ddp and fsdp, the three losses held together;
    then this process resumes the hsdp run's DCP checkpoint, profiled:
    its NCCL kernels per step."""
    import torch

    from fms_fsdp_tpu_torch import main_training_llama as entry
    from fms_fsdp_tpu_torch.main_training_llama import main

    gc.collect()
    torch._C._host_emptyCache()
    result, problems = {"config": SHARD_KW, "nvidia_smi": state["smi"]}, []
    root = _ckpt_dir("shard")
    ckpt = os.path.join(root, "hsdp")
    kw = dict(SHARD_KW, sharding_strategy="hsdp", ckpt_save_path=ckpt, ckpt_load_path=ckpt)
    argv = [sys.executable, "-u", "-m", "fms_fsdp_tpu_torch.main_training_llama",
            *(f"--{k}={v}" for k, v in kw.items())]
    log = os.path.join(root, "child.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = _run_group(argv, SHARD_TIMEOUT_S, cwd=root, stdout=f, stderr=subprocess.STDOUT,
                        env=_torchrun_env())
    with open(log) as f:
        out = f.read()
    losses = {"hsdp": _report_values(out, "loss:")}
    mesh_line = next((ln for ln in out.splitlines() if ln.startswith("Sharding strategy")), "")
    result["hsdp"] = {"exit": rc, "wall_s": time.perf_counter() - t0, "mesh": mesh_line,
                      "tokens_per_card_per_s": _report_values(out, "current token per chip per sec:")}
    if rc != 0 or len(losses["hsdp"]) != SHARD_KW["num_steps"]:
        raise AssertionError(f"shard: the hsdp child exited {rc}:\n{out[-3000:]}")
    if "'replica': 1, 'fsdp': 1" not in mesh_line:
        problems.append(f"hsdp mesh on one card: {mesh_line}")
    # ddp and fsdp save nothing (8.9 GB and ~8 s each, cut for the
    # speculator phases): on a world of one all three hold the same
    # unsharded state, and the hsdp child's save is the one resumed below
    for strategy in ("ddp", "fsdp"):
        d = _ckpt_dir(f"shard-{strategy}")
        t0 = time.perf_counter()
        with _saves_nothing(entry):
            res = main(**dict(SHARD_KW, sharding_strategy=strategy, ckpt_save_path=d,
                              ckpt_load_path=d))
        losses[strategy] = [r["loss"] for r in res["reports"]]
        result[strategy] = {"wall_s": time.perf_counter() - t0,
                            "backend": torch.distributed.get_backend()}
        del res
        shutil.rmtree(d)
        gc.collect()
        torch._C._host_emptyCache()
    ref = losses["hsdp"]
    spread = max(abs(a - b) / abs(b) for name in ("ddp", "fsdp")
                 for a, b in zip(losses[name], ref))
    result.update(losses=losses, max_rel_spread=spread)
    if not all(math.isfinite(x) for v in losses.values() for x in v) or spread > SHARD_REL_TOL:
        problems.append(f"losses across strategies {losses} (spread {spread})")

    step_dir = os.path.join(ckpt, "checkpoints", f"step_{SHARD_KW['num_steps']}_ckp")
    with open(os.path.join(step_dir, "metadata.json")) as f:
        meta = json.load(f)
    payload = sorted(os.listdir(os.path.join(step_dir, "state")))
    result["checkpoint"] = {"step": meta["step"], "topology": meta["topology"],
                            "payload_files": payload}
    if meta["topology"]["process_count"] != 1 or ".metadata" not in payload:
        problems.append(f"the hsdp checkpoint: {result['checkpoint']}")

    # the resume, in this process; the profiler writes profile_traces/
    # under the working directory. It saves nothing (its 8.9 GB final save
    # cut for hf-eval's time; no check read it): hf-eval reads the hsdp
    # child's save
    t0 = time.perf_counter()
    here = os.getcwd()
    os.chdir(root)
    try:
        with _saves_nothing(entry):
            res = main(**dict(kw, num_steps=SHARD_RESUME_STEPS, use_profiler=True))
    finally:
        os.chdir(here)
    steps = [r["step"] for r in res["reports"]]
    result["resume"] = {"wall_s": time.perf_counter() - t0, "start_step": res["start_step"],
                        "steps": steps, "losses": [r["loss"] for r in res["reports"]],
                        "final_save": _save_rows(res["checkpointer"].save_log)}
    del res
    if steps != list(range(SHARD_KW["num_steps"] + 1, SHARD_RESUME_STEPS + 1)):
        problems.append(f"the resume's steps {steps}")
    traces = sorted(os.path.join(root, "profile_traces", f)
                    for f in os.listdir(os.path.join(root, "profile_traces")))
    with open(traces[0]) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    nccl = [e for e in kernels if "nccl" in e.get("name", "").lower()]
    active = 3
    result["resume"].update(
        kernels_per_step=len(kernels) / active,
        device_ms_per_step=sum(e.get("dur", 0) for e in kernels) / 1e3 / active,
        nccl_kernels_per_step=len(nccl) / active,
        nccl_ms_per_step=sum(e.get("dur", 0) for e in nccl) / 1e3 / active)
    if nccl:
        problems.append(f"{len(nccl)} NCCL kernels on a world of one's step")
    if not kernels:
        problems.append("the resume's trace holds no device kernel")
    emit("shard", **result)
    state["shard"] = result
    if "hf-eval" in state["phases"]:
        state["shard-root"] = root  # hf-eval reads the hsdp run's checkpoint, then deletes it
    else:
        shutil.rmtree(root)
    gc.collect()
    torch._C._host_emptyCache()
    if problems:
        raise AssertionError("shard: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# HF interop and native eval: the exporters, the HF base import, eval_ppl
# ---------------------------------------------------------------------------

HF_LLAMA = {"model_variant": "llama3_8b_4k", "LlamaConfig.nlayers": SHARD_KW["LlamaConfig.nlayers"]}
# the Mamba hybrid at full width, 3 of 32 layers, attention at layer 1
HF_MAMBA = {"model_variant": "mamba_9.8b", "MambaConfig.n_layer": 3,
            "MambaConfig.attn_layer_idx": (1,)}
HF_MAMBA_TRAIN_KW = {**HF_MAMBA, "seq_length": 4096, "batch_size": 2, "vocab_size": 128256,
                     "use_dummy_dataset": True, "num_steps": 1, "report_interval": 1,
                     "checkpoint_interval": 1000, "pure_bf16": True,
                     "ckpt_full_checksums": False}
HF_EVAL_BATCHES = 4
HF_MIXTRAL_LAYERS = 1
HF_BIGCODE_LAYERS = 2
HF_SEQ = 4096
# the eval's mean NLL through the kernels against the plain attention,
# relative: a mean over 32,768 tokens of bf16 logits
HF_NLL_REL_TOL = 1e-3
# an fp32 forward of the port against transformers' fp32 forward, of the
# largest logit (or hidden value): summation order only
HF_FP32_REL_TOL = 1e-4
HF_CHILD_TIMEOUT_S = 240


@contextlib.contextmanager
def _timed_eval_steps(eval_ppl, times):
    """Within the block ``eval_ppl.make_eval_step``'s steps record their
    seconds (synchronized) in ``times``."""
    import torch

    make = eval_ppl.make_eval_step

    def timed_make(*a, **k):
        step = make(*a, **k)

        def timed(params, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        return timed

    eval_ppl.make_eval_step = timed_make
    try:
        yield
    finally:
        eval_ppl.make_eval_step = make


def _eval(eval_ppl, kw):
    """``eval_ppl.main(**kw)`` with its launches counted from zero and its
    steps timed: (result, launches, tokens per second of the steps)."""
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import ssd

    times = []
    fa.reset_launches()
    ssd.reset_launches()
    with _timed_eval_steps(eval_ppl, times):
        res = eval_ppl.main(**kw)
    launches = dict(fa.LAUNCHES, ssd_fused=ssd.LAUNCHES["fused"])
    return res, launches, res["tokens"] / sum(times)


def _logit_dist(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _top1(a, b) -> float:
    return (a.argmax(-1) == b.argmax(-1)).float().mean().item()


def _bf16_rule(kernel, plain, fp32, theirs):
    """The rule of ``_compare_step`` with transformers beside: the kernel
    within twice the plain bf16 forward's distance from fp32 of both;
    transformers' bf16 output, rounded its own way, within twice that of
    the kernel's (each of two bf16 forwards within it of fp32)."""
    d = {"kernel_vs_plain": _logit_dist(kernel, plain), "plain_vs_fp32": _logit_dist(plain, fp32),
         "kernel_vs_fp32": _logit_dist(kernel, fp32), "hf_vs_fp32": _logit_dist(theirs, fp32),
         "kernel_vs_hf": _logit_dist(kernel, theirs), "fp32_absmax": fp32.abs().max().item()}
    tol = 2 * d["plain_vs_fp32"]
    d.update(tolerance=tol, hf_tolerance=2 * tol,
             ok=d["kernel_vs_plain"] <= tol and d["kernel_vs_fp32"] <= tol
             and d["kernel_vs_hf"] <= 2 * tol)
    return d


def _cli(kw):
    return [f"--{k}={v}" for k, v in kw.items()]


class _Child:
    """An entry point's CLI (``python -m module args``) run as a child
    process beside this one's work, its output in ``log``; ``join`` waits
    for it (at most ``timeout`` s) and returns its exit code and wall
    seconds. The child runs in a session of its own, and ``kill`` ends
    the whole group."""

    def __init__(self, module, args, log, timeout):
        self.log, self.timeout = log, timeout
        self._out = open(log, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", module, *args], cwd=REPO, stdout=self._out,
            stderr=subprocess.STDOUT, start_new_session=True,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="4"))

    def join(self):
        try:
            rc = self.proc.wait(timeout=self.timeout)
        finally:
            self.kill()
        with open(self.log) as f:
            tail = f.read()[-3000:]
        return rc, time.perf_counter() - self.t0, tail

    def kill(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self._out.close()


def _hf_llama(state, ckpt, root, export):
    """(a): the exporter's child (``fms_to_hf_llama``'s CLI on the
    trainer's checkpoint) joined; load_hf_base reads its directory back
    (bitwise); transformers' model from the directory on the card against
    the port's forward."""
    import torch
    from transformers import LlamaForCausalLM

    from fms_fsdp_tpu_torch.ckpt.manager import _dir_bytes
    from fms_fsdp_tpu_torch.ckpt.state import flatten
    from fms_fsdp_tpu_torch.models.hf_import import load_hf_base
    from fms_fsdp_tpu_torch.models.llama import llama_forward
    from fms_fsdp_tpu_torch.utils.checkpointing import load_params_only
    from fms_fsdp_tpu_torch.utils.tree import tree_map

    out, problems = {}, []
    hf_dir = os.path.join(root, "hf_llama")
    rc, out["export_child_s"], tail = export.join()
    if rc != 0:
        raise AssertionError(f"hf-eval: fms_to_hf_llama exited {rc}:\n{tail}")
    out["hf_dir_bytes"] = _dir_bytes(hf_dir)
    out["hf_files"] = sorted(os.listdir(hf_dir))
    t0 = time.perf_counter()
    arch, cfg, params = load_hf_base(hf_dir)
    out["import_s"] = time.perf_counter() - t0
    saved = flatten("p", load_params_only(os.path.join(ckpt, "checkpoints")), {})
    back = flatten("p", params, {})
    out["round_trip_bitwise"] = (arch == "llama" and sorted(saved) == sorted(back) and all(
        back[k].dtype == saved[k].dtype and torch.equal(back[k], saved[k]) for k in saved))
    if not out["round_trip_bitwise"]:
        problems.append("the HF round trip is not bitwise")
    del saved, back

    params = tree_map(lambda w: w.to("cuda"), params)
    tokens = torch.randint(0, cfg.src_vocab_size, (1, HF_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(7))
    with torch.no_grad():
        kernel = llama_forward(params, tokens, cfg, attn_impl="pallas")
        plain = llama_forward(params, tokens, cfg, attn_impl="xla")
        fp32 = llama_forward(params, tokens, cfg, attn_impl="xla", compute_dtype=torch.float32)
        del params
        torch.cuda.empty_cache()
        # transformers' model loaded from the directory in bf16 (a cast of
        # a loaded model would round its fp32 rotary buffers too)
        t0 = time.perf_counter()
        hf = LlamaForCausalLM.from_pretrained(hf_dir, torch_dtype=torch.bfloat16).to("cuda")
        out["hf_load_s"] = time.perf_counter() - t0
        theirs = hf(tokens).logits
        del hf
        torch.cuda.empty_cache()
        out["logits"] = _bf16_rule(kernel, plain, fp32, theirs)
        out["logits"].update(top1_kernel_vs_hf=_top1(kernel, theirs),
                             top1_kernel_vs_fp32=_top1(kernel, fp32),
                             top1_hf_vs_fp32=_top1(theirs, fp32))
    del kernel, plain, theirs, fp32
    torch.cuda.empty_cache()
    if not out["logits"]["ok"]:
        problems.append(f"logits kernel / plain / fp32 / transformers: {out['logits']}")
    shutil.rmtree(hf_dir)
    return out, problems


def _hf_eval_llama(state, ckpt):
    """(b): eval_ppl.main on the trainer's checkpoint over the loader
    phase's corpus, through the kernels and through the plain attention."""
    from fms_fsdp_tpu_torch import eval_ppl

    corpus = _corpus(state)
    kw = dict(LOADER_KW, **HF_LLAMA, data_path=corpus["path"], ckpt_load_path=ckpt,
              pure_bf16=True, eval_batches=HF_EVAL_BATCHES)
    out, problems = {}, []
    for impl in ("auto", "xla"):
        t0 = time.perf_counter()
        res, launches, rate = _eval(eval_ppl, dict(kw, attention_kernel=impl))
        out[impl] = dict(res, launches=launches, tokens_per_s=rate,
                         wall_s=time.perf_counter() - t0)
    layers = SHARD_KW["LlamaConfig.nlayers"]
    want = {"fwd": layers * HF_EVAL_BATCHES, "fwd_kvgrid": 0, "dq": 0, "dq_kvgrid": 0,
            "dkv": 0, "ssd_fused": 0}
    if out["auto"]["launches"] != want:
        problems.append(f"eval launches {out['auto']['launches']} != {want}")
    if any(out["xla"]["launches"].values()):
        problems.append(f"the plain eval launched {out['xla']['launches']}")
    rel = abs(out["auto"]["nll"] - out["xla"]["nll"]) / abs(out["xla"]["nll"])
    out.update(expected_launches=want, nll_rel_diff=rel, nll_tolerance=HF_NLL_REL_TOL)
    if not (rel <= HF_NLL_REL_TOL and 0 < out["auto"]["tokens"] == out["xla"]["tokens"]
            <= HF_EVAL_BATCHES * LOADER_KW["batch_size"] * LOADER_KW["seq_length"]):
        problems.append(f"eval kernel vs plain: {out}")
    return out, problems


def _hf_mamba(state, root):
    """(c), first half: the Mamba entry writes a checkpoint; eval_ppl.main
    on it through the SSD and flash kernels. Returns the exporter's child
    (``fms_to_hf_mamba``'s CLI on that checkpoint), started last."""
    import torch

    from fms_fsdp_tpu_torch import eval_ppl
    from fms_fsdp_tpu_torch.main_training_mamba import main

    out, problems = {}, []
    ckpt = os.path.join(root, "mamba")
    t0 = time.perf_counter()
    res = main(**HF_MAMBA_TRAIN_KW, ckpt_save_path=ckpt, ckpt_load_path=ckpt)
    model_cfg = res["model_cfg"]
    saves = [(r["step"], r["reason"], r["tier"]) for r in res["checkpointer"].save_log]
    out["train"] = {"wall_s": time.perf_counter() - t0, "loss": res["reports"][-1]["loss"],
                    "params": model_cfg.n_params(),
                    "final_save": _save_rows(res["checkpointer"].save_log)}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    if saves != [(1, "final", "durable")]:
        problems.append(f"the Mamba entry's saves {saves}")

    kw = dict(HF_MAMBA_TRAIN_KW, ckpt_load_path=ckpt, eval_batches=HF_EVAL_BATCHES)
    t0 = time.perf_counter()
    res, launches, rate = _eval(eval_ppl, kw)
    mamba = [i for i in range(model_cfg.n_layer) if i not in model_cfg.attn_layer_idx]
    want = {"fwd": len(model_cfg.attn_layer_idx) * HF_EVAL_BATCHES, "fwd_kvgrid": 0, "dq": 0,
            "dq_kvgrid": 0, "dkv": 0, "ssd_fused": len(mamba) * HF_EVAL_BATCHES}
    out["eval"] = dict(res, launches=launches, expected_launches=want, tokens_per_s=rate,
                       wall_s=time.perf_counter() - t0)
    if launches != want or not math.isfinite(res["nll"]):
        problems.append(f"Mamba eval {out['eval']}")
    export = _Child("fms_fsdp_tpu_torch.fms_to_hf_mamba",
                    _cli(HF_MAMBA) + [f"--load_path={ckpt}/checkpoints",
                                      f"--save_path={root}/mamba_ssm"],
                    os.path.join(root, "fms_to_hf_mamba.log"), HF_CHILD_TIMEOUT_S)
    return out, problems, (model_cfg, ckpt, export)


def _hf_mamba_export(root, model_cfg, ckpt, export):
    """(c), second half: the exporter's child joined; the mamba_ssm
    directory's files, config, shapes and parameter count."""
    import torch

    from fms_fsdp_tpu_torch import fms_to_hf_mamba
    from fms_fsdp_tpu_torch.ckpt.manager import _dir_bytes
    from fms_fsdp_tpu_torch.utils.checkpointing import _payload_tensors

    out, problems = {}, []
    rc, out["export_child_s"], tail = export.join()
    if rc != 0:
        raise AssertionError(f"hf-eval: fms_to_hf_mamba exited {rc}:\n{tail}")
    export_dir = os.path.join(root, "mamba_ssm")
    sd = torch.load(os.path.join(export_dir, "pytorch_model.bin"), mmap=True)
    with open(os.path.join(export_dir, "config.json")) as f:
        config = json.load(f)
    # the checkpoint's params, counted from its metadata
    shapes, _ = _payload_tensors(os.path.join(ckpt, "checkpoints", "step_1_ckp", "state"),
                                 "params")
    n_params = sum(math.prod(shape) for shape, _ in shapes.values())
    n_sd = sum(t.numel() for t in sd.values())
    a = model_cfg.attn_cfg
    structure = {
        "files": sorted(os.listdir(export_dir)), "bytes": _dir_bytes(export_dir),
        "keys": len(sd), "params": n_params, "state_dict_params": n_sd,
        "config_ok": config == fms_to_hf_mamba.mamba_ssm_config_dict(model_cfg),
        "conv1d": list(sd["backbone.layers.0.mixer.conv1d.weight"].shape),
        "attn_in_proj": list(sd["backbone.layers.1.mixer.in_proj.weight"].shape),
        "fc1": list(sd["backbone.layers.0.mlp.fc1.weight"].shape),
    }
    out["mamba_ssm"] = structure
    d = model_cfg.d_model
    if not (n_sd == n_params and structure["config_ok"]
            and structure["conv1d"][1:] == [1, model_cfg.d_conv]
            and structure["attn_in_proj"] == [(a.num_heads + 2 * a.num_heads_kv) * a.head_dim, d]
            and structure["fc1"] == [2 * model_cfg.d_intermediate, d]):
        problems.append(f"the mamba_ssm export {structure}")
    del sd
    shutil.rmtree(export_dir)
    shutil.rmtree(ckpt)
    return out, problems


def _hf_mixtral(state):
    """(d): fms_to_hf_mixtral at mixtral_8x7b width, transformers' model on
    the card against the port's dense mix, in fp32 (the router's choices
    fixed) within HF_FP32_REL_TOL; the port's bf16 forward against its
    fp32 one printed (a router near-tie moves a token to another expert
    in bf16)."""
    import torch

    from fms_fsdp_tpu_torch import fms_to_hf_mixtral
    from fms_fsdp_tpu_torch.models.mixtral import init_mixtral_params, mixtral_forward
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config

    cfg = get_model_config("mixtral_8x7b")
    update_config(cfg, nlayers=HF_MIXTRAL_LAYERS)
    params = init_mixtral_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                 dtype=torch.bfloat16)
    t0 = time.perf_counter()
    hf = fms_to_hf_mixtral.convert_to_hf(params, cfg)
    out = {"layers": cfg.nlayers, "params": cfg.n_params(), "convert_s": time.perf_counter() - t0}
    hf = hf.to("cuda").eval()
    tokens = torch.randint(0, cfg.src_vocab_size, (1, HF_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(8))
    with torch.no_grad():
        theirs32 = hf(tokens).logits
        del hf
        ours32 = mixtral_forward(params, tokens, cfg, compute_dtype=torch.float32,
                                 attn_impl="pallas", moe_impl="dense")
        fp32 = {"kernel_vs_hf": _logit_dist(ours32, theirs32),
                "absmax": theirs32.abs().max().item(), "top1": _top1(ours32, theirs32)}
        fp32["tolerance"] = HF_FP32_REL_TOL * max(1.0, fp32["absmax"])
        del theirs32
        ours = mixtral_forward(params, tokens, cfg, attn_impl="pallas", moe_impl="dense")
        out["bf16"] = {"kernel_vs_fp32": _logit_dist(ours, ours32),
                       "top1_kernel_vs_fp32": _top1(ours, ours32)}
    out["fp32"] = fp32
    del params, ours32, ours
    gc.collect()
    torch.cuda.empty_cache()
    problems = [] if fp32["kernel_vs_hf"] <= fp32["tolerance"] else [f"Mixtral fp32 {fp32}"]
    return out, problems


def _hf_bigcode(state, root):
    """(e): an HF GPTBigCode directory (random weights, GPTBigCodeConfig()
    width) as the speculator entry's base; its first step's base hidden
    states against transformers' GPTBigCodeModel on the card."""
    import torch
    from transformers import GPTBigCodeConfig as HFConfig
    from transformers import GPTBigCodeForCausalLM, GPTBigCodeModel

    from fms_fsdp_tpu_torch.models.gpt_bigcode import GPTBigCodeConfig
    from fms_fsdp_tpu_torch.models.hf_import import load_hf_base
    from fms_fsdp_tpu_torch.speculator import train_speculator as entry
    from fms_fsdp_tpu_torch.utils.tree import tree_map

    width = GPTBigCodeConfig()
    hf_cfg = HFConfig(vocab_size=width.src_vocab_size, n_positions=width.max_expected_seq_len,
                      n_embd=width.emb_dim, n_layer=HF_BIGCODE_LAYERS, n_head=width.nheads,
                      n_inner=width.hidden_dim, multi_query=True, attn_pdrop=0.0,
                      resid_pdrop=0.0, embd_pdrop=0.0, layer_norm_epsilon=width.ln_eps)
    hf_dir = os.path.join(root, "hf_bigcode")
    torch.manual_seed(0)
    with torch.device("cuda"):
        GPTBigCodeForCausalLM(hf_cfg).save_pretrained(hf_dir, safe_serialization=True)
    first = []
    get_api = entry.get_base_api

    def recording_api(arch):
        api = get_api(arch)
        hidden = api.forward_hidden

        def forward_hidden(params, tokens, cfg, **kw):
            h = hidden(params, tokens, cfg, **kw)
            if not first:
                first.append((params, tokens, cfg, h))
            return h

        api.forward_hidden = forward_hidden
        return api

    ckpt = os.path.join(root, "spec_bigcode")
    kw = dict(model_arch="embedllama", model_path=hf_dir, use_dummy_dataset=True,
              vocab_size=4096, batch_size=2, seq_length=width.max_expected_seq_len - 4,
              num_steps=3, stage2_start_step=3, report_interval=1, checkpoint_interval=1000,
              ckpt_save_path=ckpt, ckpt_load_path=ckpt)
    entry.get_base_api = recording_api
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with _saves_nothing(entry), contextlib.redirect_stdout(buf):
            res = entry.main(**kw)
    finally:
        entry.get_base_api = get_api
    printed = buf.getvalue()
    out = {"layers": HF_BIGCODE_LAYERS, "wall_s": time.perf_counter() - t0,
           "arch": res["checkpointer"].fingerprint["model"],
           "override_printed": "overridden by HF checkpoint arch gpt_bigcode" in printed,
           "losses": [r["per_head"] for r in res["reports"]], "steps": res["steps"]}
    del res
    _, tokens, cfg, h = first[0]
    # fp32 weights for the fp32 forwards (the entry's base is bf16)
    params = tree_map(lambda w: w.to("cuda"), load_hf_base(hf_dir, dtype=torch.float32)[2])
    with torch.no_grad():
        h32 = entry.get_base_api("gpt_bigcode").forward_hidden(
            params, tokens, cfg, compute_dtype=torch.float32)
        hf = GPTBigCodeModel.from_pretrained(hf_dir, torch_dtype=torch.float32).to("cuda")
        theirs32 = hf(tokens).last_hidden_state
        hf = hf.to(torch.bfloat16)
        theirs = hf(tokens).last_hidden_state
    dist = {"bf16_vs_hf": _logit_dist(h, theirs), "bf16_vs_fp32": _logit_dist(h, h32),
            "hf_vs_fp32": _logit_dist(theirs, h32), "fp32_vs_hf_fp32": _logit_dist(h32, theirs32),
            "fp32_absmax": h32.abs().max().item()}
    dist.update(tolerance=4 * dist["bf16_vs_fp32"],
                fp32_tolerance=HF_FP32_REL_TOL * max(1.0, dist["fp32_absmax"]))
    out["hidden"] = dist
    del first, params, h, h32, hf, theirs, theirs32
    gc.collect()
    torch.cuda.empty_cache()
    problems = []
    if not (out["arch"] == "speculator:gpt_bigcode" and out["override_printed"]
            and out["steps"] == 3
            and all(math.isfinite(x) for r in out["losses"] for x in r)):
        problems.append(f"the speculator on the GPTBigCode base: {out}")
    if not (dist["bf16_vs_hf"] <= dist["tolerance"]
            and dist["fp32_vs_hf_fp32"] <= dist["fp32_tolerance"]):
        problems.append(f"GPTBigCode hidden states against transformers: {dist}")
    shutil.rmtree(hf_dir)
    return out, problems


def phase_hf_eval(state):
    """HF interop and native eval (see the module docstring): (a) the
    Llama exporter and importer, (b) eval_ppl through the flash forward,
    (c) the Mamba eval through the SSD kernel and its export, (d) the
    Mixtral exporter, (e) the GPTBigCode base from an HF directory. The
    two file exporters run as child processes of their CLIs beside this
    process's card work (host work: no card is touched there)."""
    import torch

    from fms_fsdp_tpu_torch.main_training_llama import main

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result, problems = {"nvidia_smi": state["smi"]}, []
    root = _ckpt_dir("hf-eval")
    # the Llama checkpoint: the shard phase's hsdp run (left for this
    # phase), else one step of the same config
    shard_root = state.pop("shard-root", None)
    if shard_root is not None:
        ckpt = os.path.join(shard_root, "hsdp")
    else:
        ckpt = os.path.join(root, "llama")
        main(**dict(SHARD_KW, num_steps=1, ckpt_save_path=ckpt, ckpt_load_path=ckpt))
    result["llama_checkpoint"] = sorted(os.listdir(os.path.join(ckpt, "checkpoints")))
    children, timings = [], {}
    try:
        children.append(_Child("fms_fsdp_tpu_torch.fms_to_hf_llama",
                               _cli(HF_LLAMA) + [f"--load_path={ckpt}/checkpoints",
                                                 f"--save_path={root}/hf_llama"],
                               os.path.join(root, "fms_to_hf_llama.log"), HF_CHILD_TIMEOUT_S))

        def part(name, fn):
            t0 = time.perf_counter()
            out, more, *rest = fn()
            timings[name] = time.perf_counter() - t0
            result[name] = out
            problems.extend(more)
            gc.collect()
            torch.cuda.empty_cache()
            return rest

        # the Mamba checkpoint first, so its exporter's child starts early
        (mamba_export,) = part("mamba", lambda: _hf_mamba(state, root))
        children.append(mamba_export[2])
        part("llama_eval", lambda: _hf_eval_llama(state, ckpt))
        t0 = time.perf_counter()
        import transformers  # noqa: F401  (its import, timed apart)

        timings["import_transformers"] = time.perf_counter() - t0
        part("mixtral", lambda: _hf_mixtral(state))
        part("gpt_bigcode", lambda: _hf_bigcode(state, root))
        part("llama_hf", lambda: _hf_llama(state, ckpt, root, children[0]))
        part("mamba_ssm", lambda: _hf_mamba_export(root, *mamba_export))
    finally:
        for child in children:
            child.kill()
    if shard_root is not None:
        shutil.rmtree(shard_root)
    result.update(part_seconds=timings, max_memory_allocated=torch.cuda.max_memory_allocated(),
                  launches={"fwd": result["llama_eval"]["auto"]["launches"]["fwd"]
                            + result["mamba"]["eval"]["launches"]["fwd"],
                            "ssd_fused": result["mamba"]["eval"]["launches"]["ssd_fused"]})
    emit("hf-eval", **result)
    state["hf-eval"] = result
    shutil.rmtree(root)
    if problems:
        raise AssertionError("hf-eval: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# the Mamba2 hybrid: the SSD scan kernel, the trainer, the server
# ---------------------------------------------------------------------------

# (name, B, S, H, G, L); P = 64 and N = 128 (mamba_9.8b); the first is timed
SSD_CASES = (
    ("train", 2, 4096, 128, 1, 256),
    ("g8", 2, 1024, 128, 8, 256),
    ("one-chunk", 2, 256, 128, 1, 256),
)
SSD_FP32_REL_TOL = 1e-4  # sums in another order over a 256-token chunk
MAMBA_TRAIN_KW = {
    "MambaConfig.n_layer": 6, "MambaConfig.attn_layer_idx": (3,), "seq_length": 4096,
    "batch_size": 2, "fsdp_activation_checkpointing": True,
    "selective_checkpointing": 0.5, "use_dummy_dataset": True, "num_steps": 16,
    "report_interval": 4, "checkpoint_interval": 1000,
}


def _ssd_inputs(gen, dtype, b, s, h, g, p=64, n=128):
    """x, dt, a = dt * A, Bm, Cm, A on the card; dt ~ LogUniform[1e-3, 1e-1]
    and A ~ -Uniform[1, 16], the ranges of ``init_mamba_params``."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    x, bm, cm = randn(b, s, h, p), randn(b, s, g, n), randn(b, s, g, n)
    dt = torch.exp(rand(b, s, h) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a_neg = -(rand(h) * 15.0 + 1.0)
    return x.to(dtype), dt, dt * a_neg, bm.to(dtype), cm.to(dtype), a_neg


def _ssd_bound(kind, b, s, h, g, chunk, p=64, n=128):
    """Bytes: x, Bm, Cm read once in their type, dt and a in fp32, y written
    fp32. Operations: the chunked algorithm's (``utils/flops.py``)."""
    elem = 4 if kind == "fp32" else 2
    nbytes = b * s * (h * p * elem + 2 * g * n * elem + 2 * h * 4 + h * p * 4)
    ops = float(b * s * (2 * chunk * g * n + 2 * chunk * h * p + 4 * n * h * p))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[kind] * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, nbytes, ops


def _ssd_times(ssd, kind, dtype, shape, gen):
    """Times at one shape, rotating over two input sets: the kernel, its
    plain version, ``ssd_scan`` whole through the kernel and through the
    chunked einsums, the scan's backward (the einsums, for either route)
    and the causal conv forward and backward of the same layer."""
    import torch

    b, s, h, g, chunk = shape
    sets = [_ssd_inputs(gen, dtype, b, s, h, g) for _ in range(2)]
    d_skip = torch.ones(h, device="cuda", dtype=dtype)

    def pick(i):
        return sets[i % 2]

    def scan(i, kernel):
        x, dt, _, bm, cm, a_neg = pick(i)
        return ssd.ssd_scan(x, dt, a_neg, bm, cm, d_skip, chunk_size=chunk, kernel=kernel)

    out = {
        "ms": _timed_ms(lambda i: ssd.ssd_fused(*pick(i)[:5], chunk)),
        "plain_ms": _timed_ms(lambda i: ssd.ssd_core_plain(*pick(i)[:5], chunk), 0, 2),
        "scan_kernel_ms": _timed_ms(lambda i: scan(i, "pallas")),
        "scan_xla_ms": _timed_ms(lambda i: scan(i, "xla"), 0, 2),
    }

    def scan_fwd_bwd(i):
        x, dt, _, bm, cm, a_neg = pick(i)
        leaves = [t.detach().requires_grad_() for t in (x, dt, bm, cm)]
        y = ssd.ssd_scan(leaves[0], leaves[1], a_neg, leaves[2], leaves[3], d_skip,
                         chunk_size=chunk, kernel="pallas")
        torch.autograd.grad(y, leaves, y)

    out["scan_kernel_fwd_bwd_ms"] = _timed_ms(scan_fwd_bwd, 0, 2)
    # the conv of the same layer: (B, S, d_inner + 2 G N) channels, width 4
    conv_dim = h * 64 + 2 * g * 128
    xc = torch.randn((b, s, conv_dim), generator=gen, device="cuda").to(dtype)
    w = torch.randn((conv_dim, 4), generator=gen, device="cuda").to(dtype)
    bias = torch.zeros(conv_dim, device="cuda", dtype=dtype)

    def conv_fwd_bwd(i):
        leaves = [t.detach().requires_grad_() for t in (xc, w, bias)]
        y = ssd.causal_conv1d(*leaves)
        torch.autograd.grad(y, leaves, y)

    out["conv_fwd_ms"] = _timed_ms(lambda i: ssd.causal_conv1d(xc, w, bias))
    out["conv_fwd_bwd_ms"] = _timed_ms(conv_fwd_bwd)
    return out


def phase_ssd(state):
    import torch

    from fms_fsdp_tpu_torch.ops import ssd

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(3)
    results, bad = {}, []
    for kind, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        for name, b, s, h, g, chunk in SSD_CASES:
            x, dt, a, bm, cm, _ = _ssd_inputs(gen, dtype, b, s, h, g)
            ssd.reset_launches()
            got = ssd.ssd_fused(x, dt, a, bm, cm, chunk)
            torch.cuda.synchronize()
            launched = ssd.LAUNCHES["fused"]
            ref = ssd.ssd_core_plain(x, dt, a, bm, cm, chunk)
            err = (got - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            rel = rel_ok = dist = None
            # per (batch, chunk, head), with the drop-tile control
            per_chunk = ssd.chunk_check(got, ref, x, dt, a, bm, cm, chunk)
            if kind == "fp32":
                tol = SSD_FP32_REL_TOL * scale
                rel_ok = True
            else:
                wide = ssd.ssd_core_plain(x.float(), dt, a, bm.float(), cm.float(), chunk)
                dist = (ref - wide).abs().max().item()
                tol = 2 * dist
                del wide
                # the control: dt rounded to bf16 before the weights, a
                # fault a loose tolerance lets through
                control = ssd.ssd_core_plain(x, dt.bfloat16().float(), a, bm, cm, chunk)
                rel = {"kernel": _rel_err(got, ref), "control": _rel_err(control, ref),
                       "tol": ssd.BF16_REL_TOL}
                del control
                rel_ok = rel["kernel"] <= rel["tol"] < rel["control"]
            finite = bool(torch.isfinite(got).all())
            r = {
                "shape": {"B": b, "S": s, "H": h, "P": 64, "G": g, "N": 128, "L": chunk},
                "launches": launched, "max_abs_err": err, "tol": tol,
                "value_absmax": scale, "plain_bf16_vs_fp32": dist,
                "rel_err_vs_plain_bf16": rel, "per_chunk": per_chunk, "finite": finite,
                "source": "fms_fsdp_tpu_torch/csrc/%s.cu" % ssd.kernel_source(dtype)[0],
            }
            r["ok"] = (finite and bool(rel_ok) and err <= tol and launched == 1
                       and per_chunk["ok"])
            del x, dt, a, bm, cm, got, ref
            torch.cuda.empty_cache()
            if name == "train":
                t = _ssd_times(ssd, kind, dtype, (b, s, h, g, chunk), gen)
                bound_ms, by, nbytes, ops = _ssd_bound(kind, b, s, h, g, chunk)
                t.update(bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=ops,
                         achieved_tflops=ops / t["ms"] / 1e9,
                         achieved_gbytes_per_s=nbytes / t["ms"] / 1e6, library_ms=None)
                r["times"] = t
                torch.cuda.empty_cache()
            emit("ssd", dtype=kind, case=name, **r)
            results[(kind, name)] = r
            if not r["ok"]:
                bad.append(f"{kind}/{name}")
    state["ssd"] = results
    if bad:
        raise AssertionError(f"the SSD kernel disagrees with its plain version: {bad}")


def phase_train_mamba(state):
    from fms_fsdp_tpu_torch.main_training_mamba import main

    def expect(m, cfg, steps):
        mask = _remat_mask(m, cfg)
        runs = [1 + int(remat) for remat in mask]  # forward passes per layer
        attn = [i for i in range(m.n_layer) if i in m.attn_layer_idx]
        mamba = [i for i in range(m.n_layer) if i not in m.attn_layer_idx]
        return {"fwd": steps * sum(runs[i] for i in attn), "fwd_kvgrid": 0,
                "dq": steps * len(attn), "dq_kvgrid": 0, "dkv": steps * len(attn),
                # the scan's own backward launches no kernel
                "ssd_fused": steps * sum(runs[i] for i in mamba)}

    # no save: hf-eval checks the final save of the same entry (at 3
    # layers), reading it back through eval_ppl and fms_to_hf_mamba
    _train(state, "train-mamba", {}, expect, main=main, base=MAMBA_TRAIN_KW,
           profile=True, save=False)


def _slab_all_zero(adapter) -> bool:
    return not any(
        bool(leaf.any()) for layer in adapter._state for leaf in layer.values()
    )


def phase_serve_mamba(state):
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.models.mamba import init_mamba_params, mamba_decode_step
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.ops import ssd
    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config
    from fms_fsdp_tpu_torch.utils.tree import tree_map

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_model_config("mamba_9.8b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_mamba_params(gen, cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_requests, max_new = 8, 32
    eng = ServingEngine(params, cfg, ServeConfig(max_batch=8, max_seq_len=256), seed=0)
    ad = eng.adapter
    bytes_before = ad.state_bytes_per_stream
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.randint(16, 129, size=n_requests)]
    reqs = [eng.submit(p, max_new) for p in prompts]
    ssd.reset_launches()
    fa.reset_launches()
    pa.reset_launches()
    compare = step_profile = None
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        if eng.last_logits is not None and not torch.isfinite(eng.last_logits).all():
            raise AssertionError("serve-mamba: non-finite decode logits")
        active = sum(r is not None for r in eng._slots)
        if compare is None and active == 8 and eng.decode_steps >= 4:
            compare = _compare_mamba_step(eng, mamba_decode_step, tree_map)
            step_profile = _profile_mamba_step(eng, mamba_decode_step, tree_map)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = eng.serving_stats()
    ttft = sorted(eng.registry.hist("serve.ttft_s").samples)
    result = dict(
        requests=n_requests, max_new_tokens=max_new,
        prompt_tokens=sum(len(p) for p in prompts),
        finished=sum(r.state == "finished" for r in reqs),
        all_lengths_ok=all(len(r.generated) == max_new for r in reqs),
        decode_steps=eng.decode_steps, layers=cfg.n_layer,
        attn_layers=len(cfg.attn_layer_idx), page_size=eng.page_size,
        state_bytes_per_stream=ad.state_bytes_per_stream,
        state_bytes_constant=ad.state_bytes_per_stream == bytes_before
        == int(stats["state_bytes_per_stream"]),
        slab_zero_after_completion=_slab_all_zero(ad),
        pages_in_use_after=ad.pages_in_use,
        # this path launches no kernel of the repo: the prefill is the
        # per-token recurrence and the hybrid layers attend through
        # gather_pages + gqa_attend
        ssd_launches=ssd.LAUNCHES["fused"], flash_launches=sum(fa.LAUNCHES.values()),
        paged_launches=sum(pa.LAUNCHES.values()),
        decode_tokens_per_s=stats["tokens_per_s"],
        ttft_mean_s=float(np.mean(ttft)) if ttft else None,
        wall_s=wall, param_init_s=init_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        weight_bytes=_nbytes(eng.params), compare=compare,
        step_profile=step_profile, nvidia_smi=state["smi"],
    )
    emit("serve-mamba", **result)
    state["serve-mamba"] = result
    problems = []
    if result["finished"] != n_requests or not result["all_lengths_ok"]:
        problems.append("not every request finished with max_new_tokens")
    if not result["state_bytes_constant"]:
        problems.append("state_bytes_per_stream changed")
    if not result["slab_zero_after_completion"] or result["pages_in_use_after"]:
        problems.append("slab or pages not released after completion")
    if result["ssd_launches"] or result["flash_launches"] or result["paged_launches"]:
        problems.append("the Mamba serving path launched a kernel")
    if compare is None or not compare["ok"]:
        problems.append(f"bf16 step vs fp32 step: {compare}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("serve-mamba: " + "; ".join(problems))


def _profile_mamba_step(eng, mamba_decode_step, tree_map, steps=3):
    """Where one full-batch Mamba decode step's time goes: host wall per
    step (no profiler), then device kernel time per step (torch.profiler),
    on copies of the slab and the pages."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ad = eng.adapter
    table, lens, toks = _step_inputs(eng)
    slab = tree_map(lambda s: s.clone(), ad._state)
    pools = {n: p.clone() for n, p in ad.cache.pools.items()}

    def one():
        mamba_decode_step(
            eng.params, slab, pools, table, lens, toks, eng.model_cfg,
            page_size=ad.page_size, compute_dtype=eng.compute_dtype, rope=ad.rope,
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
    return {
        "active_rows": int(sum(r is not None for r in eng._slots)),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if rows else None,
        "device_busy_share": device_ms / wall_ms if rows else None,
        "device_kernels_per_step": sum(r[2] for r in rows),
        "top_device_ms_per_step": [
            {"name": name[:80], "ms": ms, "calls": calls} for ms, name, calls in rows[:6]
        ],
    }


def _compare_mamba_step(eng, mamba_decode_step, tree_map):
    """One decode step on the engine's current state two ways: in the
    engine's bf16, and in fp32 (the same weights, slab and pages widened).
    The step is a chain of 32 layers without a kernel of the repo, so the
    check is that the bf16 logits stay within a tenth of the largest fp32
    logit of the fp32 step's and pick mostly the same tokens."""
    import torch

    ad = eng.adapter
    table, lens, toks = _step_inputs(eng)

    def step(dtype):
        params = tree_map(lambda w: w.to(dtype), eng.params)
        slab = tree_map(lambda s: s.clone() if s.dtype == torch.float32 else s.to(dtype),
                        ad._state)
        pools = {n: p.to(dtype, copy=True) for n, p in ad.cache.pools.items()}
        out, _, _ = mamba_decode_step(
            params, slab, pools, table, lens, toks, eng.model_cfg,
            page_size=ad.page_size, compute_dtype=dtype,
        )
        return out.float()

    low = step(eng.compute_dtype)
    wide = step(torch.float32)
    torch.cuda.empty_cache()
    absmax = wide.abs().max().item()
    diff = (low - wide).abs().max().item()
    out = {
        "bf16_vs_fp32": diff, "logit_absmax": absmax, "tolerance": 0.1 * absmax,
        "argmax_bf16_vs_fp32": (low.argmax(-1) == wide.argmax(-1)).float().mean().item(),
        "active_rows": int(sum(r is not None for r in eng._slots)),
    }
    out["ok"] = bool(torch.isfinite(low).all()) and diff <= out["tolerance"]
    return out


# ---------------------------------------------------------------------------
# Mixtral: capacity-routed training through the flash kernels, routed
# paged serving
# ---------------------------------------------------------------------------

MIXTRAL_TRAIN_KW = {
    "MixtralConfig.nlayers": 2, "seq_length": 4096, "batch_size": 1,
    "fsdp_activation_checkpointing": True, "selective_checkpointing": 0.5,
    "use_dummy_dataset": True, "num_steps": 6, "report_interval": 1,
    "checkpoint_interval": 1000,
}


def _mixtral_plain_first_step(model_cfg, cfg, result):
    """The first step of the trainer's run again, from the same seeded
    weights and the same first dummy batch, through the plain attention
    (``attention_kernel="xla"``): its loss within bf16's ``TOL`` (relative)
    of the step through the kernels, and no flash launch."""
    import dataclasses

    import torch

    from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
    from fms_fsdp_tpu_torch.data.loader import get_dummy_loader
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.train.step import init_train_state, make_train_step

    plain_cfg = dataclasses.replace(cfg, attention_kernel="xla")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_state = init_train_state(
        torch.Generator(device="cuda").manual_seed(plain_cfg.seed), model_cfg, plain_cfg)
    batch = next(iter(DeviceFeed(get_dummy_loader(plain_cfg, 0, 1), "cuda")))
    fa.reset_launches()
    m = make_train_step(model_cfg, plain_cfg)(train_state, batch)
    plain = float(m["loss"])
    kernel = result["losses"][0]
    out = {"first_step_loss_kernels": kernel, "first_step_loss_plain": plain,
           "first_step_rel_diff": abs(kernel - plain) / abs(plain),
           "first_step_rel_tol": TOL["bf16"],
           "plain_step_flash_launches": sum(fa.LAUNCHES.values()),
           "plain_step_s": time.perf_counter() - t0,
           "plain_step_max_memory_allocated": torch.cuda.max_memory_allocated()}
    del train_state, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    problems = []
    if not out["first_step_rel_diff"] <= TOL["bf16"]:
        problems.append(f"first step through the kernels {kernel} vs plain {plain}")
    if out["plain_step_flash_launches"]:
        problems.append("the plain attention step launched a flash kernel")
    return out, problems


def phase_train_mixtral(state):
    """``main_training_mixtral.main`` at mixtral_8x7b width, 2 of 32
    layers, bfSixteen, seq 4096, batch 1, AC 1/2, dummy data, 6 steps,
    without a save: the 51 GB state's save would need as much pinned host
    memory again as the page cache of the memory file system it lands in,
    more than the card machine's host holds."""
    from fms_fsdp_tpu_torch.main_training_mixtral import main

    def expect(m, cfg, steps):
        n = m.nlayers
        return {"fwd": steps * (n + _n_remat(m, cfg)), "fwd_kvgrid": 0,
                "dq": steps * n, "dq_kvgrid": 0, "dkv": steps * n}

    _train(state, "train-mixtral", {}, expect, main=main, base=MIXTRAL_TRAIN_KW,
           profile=True, save=False, moe=True, after=_mixtral_plain_first_step)


def _mixtral_step_fn(eng, moe_impl):
    """One decode step of the engine's current batch on copies of its
    pools, through ``mixtral_paged_decode_step``."""
    from fms_fsdp_tpu_torch.models.mixtral import mixtral_paged_decode_step

    ad = eng.adapter
    table, lens, toks = _step_inputs(eng)
    pools = {n: p.clone() for n, p in ad.cache.pools.items()}

    def one():
        return mixtral_paged_decode_step(
            eng.params, pools, table, lens, toks, eng.model_cfg,
            page_size=ad.page_size, compute_dtype=eng.compute_dtype,
            moe_impl=moe_impl, rope=ad.rope)[0]

    return one


def _profile_mixtral_step(eng, moe_impl, steps=3):
    """Host wall per decode step (no profiler) against its device time
    (torch.profiler), with the expert GEMMs' share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    one = _mixtral_step_fn(eng, moe_impl)
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
    gemm_ms = sum(r[0] for r in rows if _kernel_kind(r[1]).startswith("gemm"))
    return {
        "moe_impl": moe_impl,
        "active_rows": int(sum(r is not None for r in eng._slots)),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if rows else None,
        "device_busy_share": device_ms / wall_ms if rows else None,
        "gemm_ms_per_step": gemm_ms if rows else None,
        "top_device_ms_per_step": [
            {"name": name[:80], "ms": ms, "calls": calls} for ms, name, calls in rows[:8]
        ],
    }


# routed against dense in fp32, per logit: within this times the largest
# logit (the flash phase's fp32 rule; the two sum their experts' products
# in other orders)
MIXTRAL_FP32_REL_TOL = 1e-4


def _mixtral_wave(params, cfg, moe_impl, prompts, max_new, dtype="bfloat16",
                  keep_rows=False, probe=False):
    """Serve ``prompts`` on an engine with ``moe_impl`` in ``dtype``. With
    ``keep_rows`` each decode step's logits row is kept per request, by
    the index of the token it chose; with ``probe`` one full-batch step
    is compared routed against dense and both are profiled."""
    import torch

    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine

    eng = ServingEngine(params, cfg, ServeConfig(max_batch=8, max_seq_len=1024, page_size=64,
                                                 moe_impl=moe_impl, compute_dtype=dtype),
                        seed=0)
    reqs = [eng.submit(p, max_new) for p in prompts]
    by_rid = {r.rid: r for r in reqs}
    rows = {}
    if keep_rows:
        decode = eng.adapter.decode

        def kept(slot_rids, lens, tokens, generator):
            toks, logits = decode(slot_rids, lens, tokens, generator)
            host = logits.float().cpu()
            for slot, rid in enumerate(slot_rids):
                if rid is not None:
                    rows[(rid, len(by_rid[rid].generated))] = host[slot]
            return toks, logits

        eng.adapter.decode = kept
    compare = profiles = None
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        if eng.last_logits is not None and not torch.isfinite(eng.last_logits).all():
            raise AssertionError(f"serve-mixtral ({moe_impl}): non-finite decode logits")
        active = sum(r is not None for r in eng._slots)
        if probe and compare is None and active == 8 and eng.decode_steps >= 4:
            routed = _mixtral_step_fn(eng, "routed")().float()
            dense = _mixtral_step_fn(eng, "dense")().float()
            compare = {"routed_vs_dense_max_abs": (routed - dense).abs().max().item(),
                       "logit_absmax": dense.abs().max().item(),
                       "argmax_agree": (routed.argmax(-1) == dense.argmax(-1))
                       .float().mean().item()}
            profiles = [_profile_mixtral_step(eng, "routed"),
                        _profile_mixtral_step(eng, "dense")]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, rows, wall, compare, profiles


def phase_serve_mixtral(state):
    """``ServingEngine`` on mixtral_8x7b at full width, 8 of 32 layers,
    random bf16 weights, 8 requests of 64-512 prompt tokens and 32 new
    tokens, routed top-2 experts: completions, no attention kernel, the
    decode rate, one full-batch step routed against dense and each
    profiled. Then the same requests routed and dense on the same weights
    in fp32: equal greedy tokens and every decode step's logits within
    ``MIXTRAL_FP32_REL_TOL``. In bf16 the two round apart, and at a
    router's near-tie one rounding moves a row to another expert: the bf16
    step's comparison is printed, not held to a bound."""
    import dataclasses

    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.models.mixtral import init_mixtral_params
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_model_config("mixtral_8x7b"), nlayers=8)
    t0 = time.perf_counter()
    params = init_mixtral_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_requests, max_new = 8, 32
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.src_vocab_size, size=int(n)).tolist()
               for n in rng.randint(64, 513, size=n_requests)]
    pa.reset_launches()
    fa.reset_launches()
    eng, reqs, _, wall, compare, profiles = _mixtral_wave(params, cfg, "routed", prompts,
                                                         max_new, probe=True)
    stats = eng.serving_stats()
    ttft = sorted(eng.registry.hist("serve.ttft_s").samples)
    result = dict(
        requests=n_requests, max_new_tokens=max_new, layers=cfg.nlayers,
        prompt_tokens=sum(len(p) for p in prompts),
        finished=sum(r.state == "finished" for r in reqs),
        all_lengths_ok=all(len(r.generated) == max_new for r in reqs),
        decode_steps=eng.decode_steps, page_size=eng.page_size,
        attn_impl=eng.attn_impl, moe_impl=eng.adapter.moe_impl,
        # Mixtral serving runs the reference attention (as JAX's does)
        paged_launches=sum(pa.LAUNCHES.values()), flash_launches=sum(fa.LAUNCHES.values()),
        decode_tokens_per_s=stats["tokens_per_s"],
        ttft_mean_s=float(np.mean(ttft)) if ttft else None, wall_s=wall,
        param_init_s=init_s, weight_bytes=_nbytes(params),
        pool_bytes=_nbytes(eng.cache.pools), bf16_step_compare=compare,
        step_profile=profiles, max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()

    # routed against dense in fp32 on the same weights (47.5 GB)
    t0 = time.perf_counter()
    params = init_mixtral_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                 dtype=torch.float32)
    waves = {}
    for impl in ("routed", "dense"):
        eng, wreqs, rows, wwall, _, _ = _mixtral_wave(params, cfg, impl, prompts, max_new,
                                                      dtype="float32", keep_rows=True)
        waves[impl] = ([list(r.generated) for r in wreqs],
                       {(i, n): rows[(r.rid, n)] for i, r in enumerate(wreqs)
                        for n in range(1, max_new)},
                       sum(r.state == "finished" for r in wreqs), wwall)
        del eng, rows
    (rt, rrows, rfin, rwall), (dt, drows, dfin, dwall) = waves["routed"], waves["dense"]
    diff = max(float((rrows[k] - drows[k]).abs().max()) for k in rrows)
    absmax = max(float(drows[k].abs().max()) for k in drows)
    result["fp32_routed_vs_dense"] = {
        "tokens_equal": rt == dt, "finished": [rfin, dfin],
        "same_prefix": [next((k for k, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
                        for x, y in zip(rt, dt)],
        "logits_max_abs_diff": diff, "logit_absmax": absmax,
        "tolerance": MIXTRAL_FP32_REL_TOL * max(1.0, absmax),
        "wall_s": [rwall, dwall], "seconds": time.perf_counter() - t0,
    }
    result["nvidia_smi"] = state["smi"]
    emit("serve-mixtral", **result)
    state["serve-mixtral"] = result
    fp32 = result["fp32_routed_vs_dense"]
    problems = []
    if (result["finished"] != n_requests or not result["all_lengths_ok"]
            or fp32["finished"] != [n_requests, n_requests]):
        problems.append("not every request finished with max_new_tokens")
    if result["paged_launches"] or result["flash_launches"]:
        problems.append("the Mixtral serving path launched an attention kernel")
    if compare is None:
        problems.append("no full-batch decode step to compare and profile")
    if not fp32["tokens_equal"]:
        problems.append(f"fp32 routed and dense greedy tokens differ: {fp32['same_prefix']}")
    if not fp32["logits_max_abs_diff"] <= fp32["tolerance"]:
        problems.append(f"fp32 routed vs dense logits {fp32['logits_max_abs_diff']} > "
                        f"{fp32['tolerance']}")
    del params, waves, rrows, drows
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("serve-mixtral: " + "; ".join(problems))


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
        entry = {
            "name": f"flash_{contract}", "route": "cuda",
            "source": f"fms_fsdp_tpu_torch/csrc/flash_{'fwd' if kernel == 'fwd' else 'bwd'}_sm90.cu",
            "replaces": REPLACES[contract],
            "launches": state[phase]["launches"][contract],
            "max_abs_err": max(r["max_abs_err"][o] for o in outs),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }
        if contract in ("fwd", "dq", "dkv"):
            # the same contracts on the Mixtral training path, counted on
            # its own run
            entry["launches_train_mixtral"] = state["train-mixtral"]["launches"][contract]
        if contract == "fwd":
            # the frozen base forward of the speculator's stage 1, and
            # eval_ppl's forwards (Llama and the Mamba hybrid's attention)
            entry["launches_train_speculator"] = state["train-speculator"]["launches"]["fwd"]
            entry["launches_hf_eval"] = state["hf-eval"]["launches"]["fwd"]
        if kernel != "fwd":
            # SDPA's one backward call computes dq, dk and dv together: set
            # it against the pair
            entry["pair_ms"] = r["times"]["bwd_pair"]["ms"]
        entries.append(entry)
    r = state["ssd"][("bf16", "train")]
    t = r["times"]
    entries.append({
        "name": "ssd_fused", "route": "cuda",
        "source": r["source"],
        "replaces": REPLACES["ssd_fused"],
        "launches": state["train-mamba"]["launches"]["ssd_fused"],
        # eval_ppl on the Mamba hybrid
        "launches_hf_eval": state["hf-eval"]["launches"]["ssd_fused"],
        "max_abs_err": r["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        # no single PyTorch call computes the chunked scan
        "library_ms": None,
    })
    return {"kernels": entries}


def main(argv=None) -> int:
    t0 = time.perf_counter()
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
    state = {"phases": phases}
    run = {
        "device": phase_device, "build": phase_build,
        "kernels": phase_kernels, "serve": phase_serve,
        "serve-int8": phase_serve_int8, "train-speculator": phase_train_speculator,
        "serve-spec": phase_serve_spec, "flash": phase_flash,
        "train": phase_train, "loader": phase_loader, "resume": phase_resume,
        "supervise": phase_supervise, "shard": phase_shard, "hf-eval": phase_hf_eval,
        "train-kvgrid": phase_train_kvgrid,
        "ssd": phase_ssd, "train-mamba": phase_train_mamba,
        "serve-mamba": phase_serve_mamba,
        "train-mixtral": phase_train_mixtral, "serve-mixtral": phase_serve_mixtral,
    }
    if "device" not in phases:
        phases.insert(0, "device")

    def on_term(signum, frame):
        raise SystemExit(128 + signum)

    # a run ended by SIGTERM still deletes its checkpoints (below)
    signal.signal(signal.SIGTERM, on_term)
    phase_seconds = {}
    try:
        for p in PHASES:
            if p in phases:
                t_phase = time.perf_counter()
                run[p](state)
                phase_seconds[p] = time.perf_counter() - t_phase
    finally:
        # a failed phase leaves its checkpoints behind: none outlives the run
        for root in CKPT_ROOTS.values():
            shutil.rmtree(root, ignore_errors=True)
    emit("total", phases=phases, seconds=time.perf_counter() - t0,
         phase_seconds=phase_seconds)
    if all(p in phases for p in PHASES):
        print(json.dumps(kernels_line(state)), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"], "count": state["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
