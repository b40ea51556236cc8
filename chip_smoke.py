#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card
and check them.

    python chip_smoke.py                 # every phase, one card
    python chip_smoke.py --phases device,build,kernels

Phases, one JSON line each; any failure exits non-zero:

1. device  — card name and count, ``nvidia-smi`` name and power limit.
2. build   — compiles ``fms_fsdp_tpu_torch/csrc/*.cu`` (one nvcc per
   source, all started together) and reports each kernel's registers,
   shared memory and spills from ``-Xptxas -v`` (the flash forward and dq
   at both key tiles), and the compiler's warnings; a wgmma kernel
   (``*_sm90.cu``) that spills fails the phase.
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
   GB/s and the share of the bytes bound. The row of 16,383 keys runs
   twice: at page 64 and the planner's split, and at the page and split
   the tuning table holds for its signature.
4. serve   — ``ServingEngine`` on llama3_8b at full width (32 layers,
   vocab 128256, random bf16 weights from a seeded generator), 16
   requests of 64-1024 prompt tokens and 64 new tokens each, through
   the CUDA kernel, page size and split from the tuning table. Checks
   completions, finite logits and launches == decode steps x 32 on that
   wave, under the contract the engine's pools and split name (v2 where
   the table set a split); then refills the 8 slots and holds
   one decode step through the kernel against the same step through
   the reference attention and an fp32 step, and profiles one step.
   Chunked prefill: one 1024-token prompt's first-token logits through
   256-token chunks against the whole-prompt path, within twice the
   whole bf16 path's distance from an fp32 prefill; 2 such prompts
   through an engine: 8 chunks, launches == decode steps x 32.
   In-process disaggregation: a ``prefill``-role engine packs 8 requests
   of 64-512 prompt tokens (``pack_handoff`` bytes), a ``decode``-role engine resumes them: the
   prefill side launches nothing, the imported pages equal the shipped
   ones bitwise, the first decode step within ``TOL["bf16"]`` of a
   unified engine's, launches == decode steps x 32; bytes per request,
   pack and scatter seconds. Defrag: with 3 requests finished,
   ``defrag`` moves pages and the next kernel step's logits equal that
   step's before it bitwise, while the same step read through the page
   table cached before it (a missed version bump) on a copy of the moved
   pools does not.
5. serve-int8 — the same engine with int8 pools on a shorter wave, so
   the quantized (v2) contract runs end to end; then one int8 handoff of
   4 requests: 1-byte pages with their fp32 scales, the decode side's v2
   launches == decode steps x 32, its first step within ``TOL["int8"]``
   of the unified int8 engine's.
6. train-speculator — ``speculator.train_speculator.main`` (the port's
   entry) on the serve phases' random bf16 llama3_8b as the frozen base,
   at full width and depth (8.03B parameters), with JAX's default
   speculator (3 heads, width 4096, tied, scale_input: 1.084B
   parameters, fp32 with AdamW): seq 4096 (+4), batch 2, dummy data
   (``SteadyCounter`` modulo 4096: each token the previous plus one, the
   same 4096 transitions every batch), 4 stage-1 steps
   through the flash forward, then 1 stage-2 step (``stage2_batch_size``
   32 and ``stage2_seq_length`` 32, cut from JAX's 96 and 256; prompts of
   64; 6 and 2 steps before the ring phase's Mixtral part), reports every
   step, no save of the train state (its 13 GB is cut
   for time; the CPU tests save and resume it). Checks: flash forward
   launches == stage-1 steps x layers and no dq, dk/dv or paged-decode
   launch; every loss and gradient norm finite; head 1's loss at the
   last stage-1 step below its first; the first stage-1 step's per-head
   losses through the kernel and through the plain attention within
   ``TOL["bf16"]`` (relative). Prints tokens/s per stage, the peak
   bytes, each step's per-head losses, gradient norm and LR, and a
   device profile of one stage-1 step after a warm-up step (flash, the
   base's 16-bit GEMMs, the speculator's GEMMs, CE, optimizer, other). ``save_speculator`` writes
   the trained speculator (4.3 GB) into the run's in-memory directory.
   Then two more stage-1 steps with ``quantized_matmuls="int8"`` on the
   same frozen base: 32 flash forward launches a step, 7 x 32 int8 GEMMs
   a step (forward only), finite losses, tokens/s.
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
8. fleet   — two ``FleetRouter`` fleets of replica children on the card
   (``python -m fms_fsdp_tpu_torch.serve.replica``), ticked in one loop:
   the layout fleet starts first and the one-card fleet once the layout
   replicas are ready, so that the 7 processes' weight draws (7.7 GB of
   model, 9.8 GB at a draw's peak) do not all meet; both llama3_8b at full
   width and 4 of 32 layers in fp32, the chunked transport,
   the same 16 requests of 64-512 prompt and 32 new tokens, held against
   one in-process unified engine on the same seed's weights. The
   one-card fleet: one prefill and two decode replicas. In one run:
   ``replica_kill`` on decode replica 1 after it imported handoffs,
   ``handoff_chunk_corrupt`` on one chunk the router sends to replica 2,
   and once replica 1's relaunch is ready (and the wave's second half is
   in) a ``preempt`` (SIGTERM, drain-and-migrate) of decode replica 2
   while it holds live streams. Checks: every request completes once
   with the reference tokens; a ``replica_loss`` relaunch in the ledger,
   availability below 1, ``chunks_resent`` and ``drain_migrations`` >= 1;
   from each child's stats file its paged-decode launches == its decode
   steps x 4 (decode) or 0 (prefill); the stats map valid under the
   port's schema. The layout fleet (``serve_layout="tp=2"``): a prefill
   and a decode replica, each a leader child and the follower it starts
   (``serve/replica.py``), 4 processes and two gloo worlds. Once the
   decode replica holds live streams of imported handoffs its follower
   (rank 1) is SIGKILLed, and the rest of the wave goes in. Checks: every
   request completes once with the reference tokens; exactly one
   ``replica_loss`` relaunch, of replica 1; no rank of the killed
   incarnation runs when its relaunch is ready; from the stats files of
   the 4 ranks of the live incarnations, each decode rank's paged-decode
   launches == its decode steps x 4, all at 16/4 heads, and the prefill
   ranks' 0; every follower exits 0 after its release; the stats map
   valid. Prints TTFT, latency, handoff bytes, transfer seconds, restart
   downtime, each incarnation's start-up seconds, and for the layout
   fleet (``layout``) the time from the kill to the relaunch's readiness,
   the wave's wall and each rank's figures; the card's peak memory in
   use (all processes) and the children alive then. The serve phases'
   weights are freed first.
9. flash   — the flash-attention kernels (wgmma + TMA for bf16: forward,
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
   walk) must exceed on every block it changes; the bf16 forward and dq
   at both key tiles (128, the default, and 64), each held to these
   bounds and controls; CUDA-event times of the first two shapes (both
   key tiles) beside the plain versions, the bound, and SDPA (flash
   backend) forward and backward; achieved TF/s and share of the bound of
   each kernel, the pair dq + dk/dv and the whole autograd backward
   beside SDPA's backward.
9b. ring   — long context (``ops/ring_attention.py``): (a) the two modes
   the ring adds to the flash kernels, at the flash phase's training shape
   (B=2, S=4096, 32/8 heads, bf16): the non-causal forward, dq and dk/dv
   at both key tiles against their plain versions (max abs within twice
   the plain bf16 version's distance from fp32, relative error within
   ``BF16_REL_TOL``, which the bf16-scores control exceeds, and per block
   within ``BF16_BLOCK_REL_TOL`` with the dropped-tile control), and the
   dq stored fp32 (``out_dtype=torch.float32``) per block against the
   plain fp32-output dq with its control, and rounded to bf16 equal bit
   for bit to the 16-bit dq; CUDA-event times of the four beside the plain
   versions, SDPA's non-causal forward and backward and the bound. (b) The
   ring at llama3_8b's attention widths, B=1, S=32768, cp=4, every chunk
   on the card (``LocalRing``; local length 8192), causal, bf16: the
   launches (10 forward, dq and dk/dv each; 6 of each non-causal; 10 dq
   stored fp32) counted on that run; o, dq, dk and dv within twice the
   full-sequence kernels' (kvgrid) relative distance from the plain fp32
   versions of those kernels, a bound that a ring leaving out one visible
   chunk (``RING_DROP``) exceeds; the ring's forward + backward ms beside
   the full-sequence autograd's. (c) The ring at S=4096 against the same
   ring through the plain versions (within twice the plain bf16 ring's
   distance from the plain fp32 ring). (d) The ring through the Llama
   forward and backward (``llama_forward(..., ring=LocalRing(4))``) at
   llama3_8b's width, 2 layers, S=16384: the hidden states and the
   attention weights' gradients within twice the whole-sequence bf16
   model's relative distance from the whole-sequence fp32 model (a seeded
   cotangent of the hidden states), a bound the ring without one visible
   chunk exceeds; launches 2 x a ring's. (e)
   ``ssd_scan_cp`` at mamba_9.8b's
   SSD widths (B=1, S=16384, H=128, P=64, G=1, N=128, L=256, cp=4, bf16)
   against ``ssd_scan`` through the SSD kernel, within twice the kernel's
   relative distance from the fp32 einsums, which the ranks' scans without
   the carried state exceed; no SSD kernel launched (the cp core is the
   einsums, as JAX's is XLA); both times. (f) The ring through the
   Mixtral forward and backward (``mixtral_forward(..., moe_impl=
   "dispatch", ring=LocalRing(4))``) at mixtral_8x7b's width (4096 wide,
   32/8 heads, 8 experts top-2, hidden 14336), 2 of 32 layers, S=16384,
   bf16, capacity factor 1.0 (so that choices drop): each layer's chunked
   routing (``models/mixtral.py::context_slots``) equal bit for bit to
   ``_priority_slots`` over the run's own choices at the whole sequence's
   capacity, while each chunk routed alone at the capacity of its own
   length differs; the dropped share printed; the hidden states and the
   attention weights' gradients bounded as (d), with the same control;
   launches 2 x a ring's. The exchange across cards (``GroupRing`` over
   NCCL) needs a card a process and is not run.
10. train   — ``fms_fsdp_tpu_torch.main_training_llama.main`` at
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
   writes the final save of the same entry at 2 layers, reads it back
   through ``eval_ppl`` and exports it) and train-mixtral. A phase that
   saves (hf-eval's Mamba run) prints its blocking snapshot (ms), its
   background commit, payload write and manifest hashing (s), its bytes
   and GB/s; every root is in memory (see ``_ckpt_dir``) and deleted
   when the phase is done. Every trainer phase runs through the mesh
   (``parallel/mesh.py``) and an NCCL process group of one, with no
   sharded state (checked and printed as ``process_group``).
11. loader — the streaming loader alone, host plus the copy to the card
   (no model): a corpus of two 8-shard corpora (about 100M llama3 token
   ids, document lengths log-uniform over 64-16,384) written into the
   run's in-memory directory with ``meta/combined_counts.csv``;
   ``get_data_loader`` at seq 4096, batch 2, 1024 logical shards, weights
   3:1 and the default shuffle window. Setup seconds, first batch and
   tokens/s of the pipeline alone with 1 and 2 thread workers and with 2
   forked process workers (after ``torch.cuda.init()``, with a tensor
   live on the card; their first batches must equal the thread workers'
   and shutdown must reap them); the reservoir filled to 10,000 rows (or
   the largest window the measured rate fills in ``LOADER_FILL_S``, 4 s
   since the train-quant phase, flagged ``reduced``), the mix's corpus_a share within 0.02 of 0.75, then the
   loader state's bytes and the ms of ``save_to_path`` and of
   ``load_from_path`` on a fresh loader, whose continuation must equal
   the saved loader's; ms per batch through ``DeviceFeed`` to the card
   (its batches equal to the host's), the consumer's wait and the
   staging alone.
12. resume — checkpoint and resume through the Llama entry point at
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
13. supervise — ``python -m fms_fsdp_tpu_torch.resilience.supervisor``
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
14. shard — the data-parallel entry on one card (``SHARD_KW``:
   llama3_8b_4k at full width, 2 layers, bf16 params and moments, 3
   steps): ``python -m fms_fsdp_tpu_torch.main_training_llama
   --sharding_strategy=hsdp`` as a child under torchrun's environment
   (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT: so
   ``cuda:LOCAL_RANK`` and an NCCL group from ``env://``; the mesh all
   ones; started by the supervise phase, beside its children, since the
   tune phase: its tokens/s are taken beside them), then ``main`` in this process under ddp and under fsdp (these
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
15. hf-eval — HF interop and native eval. (a) ``python -m
   fms_fsdp_tpu_torch.fms_to_hf_llama`` (a child process, started by the
   shard phase once the checkpoint exists and running beside the rest of
   it and the card work of (b)-(e)) on the shard phase's hsdp checkpoint (llama3_8b_4k, 2 layers,
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
   (c) ``main_training_mamba.main`` at mamba_9.8b width, 2 layers with
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
16. train-kvgrid — the same trainer at 2 layers for one step with
   ``flash_kernel_variant="kvgrid"``, so the launches of the kv-streamed
   contracts are counted on the main path too.
16b. tune  — the kernel tuner (``tune/``): each Hopper cost-model byte
   count (``tune/candidates.py``) equals its kernel's ``*_smem_bytes`` C
   function (flash forward and dq at both key tiles, dk/dv, the SSD scan
   at one and two heads a block and L = 64/128/256); every shape of
   ``scripts/torch_autotune_kernels.py``'s suite resolves through the
   committed ``tune/kernel_tuning_h100.json`` by exact hit on chip
   "h100"; then one step of the Llama entry at llama3_8b_4k width, 2
   layers, per ``TUNE_RUNS``: the committed table (``kernel_tuning="auto"``,
   through the fused CE), ``"off"``, a table pinning the 64-key
   tile, and both again under the kvgrid contract. Each prints
   ``choices()`` and the launches by contract and key tile, which must be
   the tile it resolved; together they launch every (contract, key tile).

17. ssd    — the fused SSD scan kernels (``ssd_sm90.cu`` for bf16,
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
18. train-mamba — ``fms_fsdp_tpu_torch.main_training_mamba.main`` at
   mamba_9.8b width, 6 layers with attention at layer 3, seq 4096, batch
   2, selective AC 1/2, 16 steps (over the first 8 the loss of this
   model only wobbles, through the kernel and through the einsums alike):
   finite falling loss, no skipped batch,
   SSD launches == steps x (Mamba layers + rematerialised Mamba layers),
   flash launches == the one attention layer's; tokens per card per
   second, MFU/HFU, peak memory and a profile of one step. No save
   (hf-eval checks the entry's final save).
19. serve-mamba — ``ServingEngine`` on mamba_9.8b at full width,
   ``SERVE_MAMBA_LAYERS`` (6) of 32 layers with the attention layer at 3
   (cut from full depth for the fleet phase's time; random bf16 weights),
   8 requests of 16-128 prompt tokens and 32 new tokens each: all
   complete, finite logits, a constant ``state_bytes_per_stream``, slab
   slices zero after completion, one decode step held against the same
   step in fp32. This path launches no SSD kernel (the prefill is the
   per-token recurrence), and the phase checks that. Then
   drain-and-migrate through the slab codec: two live streams packed
   (``pack_stream``) after 6 steps and resumed on a second engine
   (``submit_handoff``) finish with an uninterrupted engine's tokens, a
   difference accepted only at a near-tie (top-2 gap within
   ``TOL["bf16"]`` of the top logit).
20. train-mixtral — ``fms_fsdp_tpu_torch.main_training_mixtral.main`` at
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
21. serve-mixtral — ``ServingEngine`` on mixtral_8x7b at full width, 8 of
   32 layers, random bf16 weights (23.7 GB), ``max_batch=8``, page 64, 8
   requests of 64-512 prompt tokens and 32 new tokens, routed top-2
   experts: all complete, no attention kernel launched (the reference
   attention, as JAX's Mixtral serving), decode tokens/s, one full-batch
   step routed against dense (printed) and each profiled (host wall
   against device ms); then the same requests routed and dense on fp32
   weights: equal greedy tokens and every decode step's logits within
   ``MIXTRAL_FP32_REL_TOL`` of the largest.
22. train-quant — quantized training (``ops/quant.py``: cuBLASLt
   ``torch._int_mm`` / ``torch._scaled_mm``). A GEMM micro-table at
   M = 8192 against llama3_8b's (K, N): bf16 ``torch.matmul``, the two
   1-byte GEMMs, the whole quantized forward (its passes = whole - GEMM)
   and their bounds, each GEMM against its plain version on the card (the
   exact float64 product of the same 1-byte values: int8 bitwise, fp8
   within ``FP8_GEMM_REL_TOL``), and the control: the plain version fed
   one flipped quantized value fails that check. Then the Llama entry at
   llama3_8b_4k width, 2 layers, seq 4096, batch 2, AC 1/2, bfSixteen, 4
   steps from the same seeded init and batches in bf16 and each of int8,
   int8_dgrad, fp8, fp8_dgrad: finite losses, the first within
   ``QUANT_LOSS_REL_TOL`` of bf16's, the flash launches equal to bf16's,
   1-byte GEMMs == 7 x (layers + rematerialised layers) x steps forward
   plus 7 x layers x steps dgrad under the ``_dgrad`` modes (bf16: none);
   tokens/s (median of steps 2-4), device ms a step by kind, peak memory.
   The reduce wires int8, fp8 and fp8_delayed, 3 steps each (GEMMs
   16-bit): under fp8_delayed each step's row 0 of every amax history
   equals the leaf amax taken on the side from the raw gradients; an
   injected non-finite step under the guard leaves every row as it was,
   and the same step without the guard rolls them (NaN at the head).
   mamba_9.8b at full width, 3 layers with attention at 1, bf16 then
   fp8_dgrad, 3 steps: the same SSD and flash launches, the GEMM counts,
   the first loss within the bound. mixtral_8x7b at full width, 1 layer,
   bf16, fp8_dgrad and int8, 3 steps: one 2-D GEMM an expert (3 x 8 a
   layer and pass, beside attention's 4), ``moe_drop_frac`` beside bf16's.

23. tp — tensor parallelism in training and serving: two children on the one card
   (``python -m chip_smoke --tp-child``, each a rank of a world of 2
   under torchrun's environment; the ranks share the card, so the world
   is gloo, ``utils/dist.py``), each calling the trainers' entry
   (``main_training_mixtral.main``, ``main_training_llama.main``) at
   ``tensor_parallel_size=2``: the train-mixtral configuration for 2
   steps, then llama3_8b_4k at ``SHARD_KW`` (2 layers, seq 4096, batch 2,
   3 steps), neither saving. The loader phase starts them (they run
   beside it and resume, which waits for their Mixtral run's memory);
   this phase joins them. Checks: both exit 0, the mesh line names
   ``'tensor': 2`` and the gloo group, the Llama losses and gradient
   norms within ``SHARD_REL_TOL`` of the shard phase's hsdp run's and
   the Mixtral ones of the train-mixtral phase's first two steps (at
   random init with random labels the loss sits at ln V plus half the
   logits' variance whatever the hidden states are, so the gradient norm
   carries the check), the two ranks' losses equal, the
   flash launches a step at 16 query and 4 KV heads a rank (the forward
   per layer and rematerialised layer, dq and dk/dv per layer) and no
   other head count; each child's peak memory. The control, one Llama
   step whose forward drops the row-parallel reduces (the embedding's,
   wo's and w2's), must fail that check.
   Then the serving layout, in the same world: llama3_8b at full width
   and 4 layers in fp32 (``TP_SERVE_*``; weights from a seed, whole on
   each rank's host), 8 requests of 64-512 prompt tokens and 32 new,
   every one prefilled in the first step. A ``serve_layout="tp=2"``
   engine on both ranks, rank 0 driving it and rank 1 following
   (``serve/layout.py``), the paged-decode kernel at each rank's 16
   query and 4 KV heads; the same wave with the row-parallel reduces
   dropped on both ranks (the control); the same wave on rank 0 through
   a one-rank engine while rank 1 waits. Checks: the tp 2 wave's tokens
   equal the one-rank wave's, its first decode step's logits within
   ``TP_SERVE_REL_TOL`` (relative) of them while the control's are not;
   on each rank paged-decode launches == decode steps x 4, all at 16/4;
   ``serving_stats()["serve_layout"]`` 201. Then, on a refilled state,
   one bf16 decode step at each rank's heads through the kernel, the
   reference attention and fp32, held as the serve phase's
   ``_compare_step`` holds them, and the kernel's first launch against
   its plain version row by row within ``paged_attention.REL_TOL``.
   Then the same three waves of mixtral_8x7b at full width and 2 layers
   in fp32 (``serve_mixtral``; 12.6 GB of weights drawn on each rank):
   tokens equal, first-step logits within ``TP_SERVE_REL_TOL`` and the
   control outside it; Mixtral's serving decodes through the reference
   attention, so no rank launches the kernel.
   Prints each wave's wall and decode tokens/s, the collectives a decode
   step, each rank's peak memory (the weights' draw apart) and each
   model's wall in the children.
   Between the control and the serving runs, multi-slice training in the
   same world (``num_slices=2``, the mesh's dcn axis; each rank a slice
   of one), llama3_8b_4k at ``SHARD_KW``, every rank holding the whole
   model at 32 query and 8 KV heads: ``slices`` (fsdp, ``dcn_overlap``
   auto: the mesh ``{'dcn': 2, 'replica': 1, 'fsdp': 1, ...}``, so every
   gradient crosses the slice boundary, bucket by bucket inside the
   backward), ``slices-off`` (the same, the overlap off), ``ddp`` (one
   slice, replica 2: the same ranks, rows and sum) and
   ``slices-control`` (one step of ``slices`` with
   ``DataParallel.dcn_reduce`` the identity). Checks: each run's mesh
   line; ``slices`` and ``slices-off`` bit-equal losses and gradient
   norms; ``slices`` within ``SHARD_REL_TOL`` of ``ddp`` (0 expected: a
   sum of two is the same either way); the plan's buckets >= 2 and
   ``DCN_REDUCES`` == steps x buckets on ``slices``, 0 on ``slices-off``
   and ``ddp``; the ``slices`` record's ``dcn_collective_s`` > 0 and
   ``dcn_overlap_frac`` in [0, 1]; flash launches a rank == steps x (2 +
   rematerialised layers) forward and steps x 2 dq and dk/dv, all at
   32/8; the control outside ``SHARD_REL_TOL`` of ``ddp``. gloo stages
   each step's ~3 GB of bf16 gradients through the host, so no time of
   the cross-slice reduce here is a DCN figure.
   Right after the Mixtral tp run, expert parallelism in the same world
   at the train-mixtral configuration (mixtral_8x7b, 2 layers, seq 4096,
   batch 1 a rank) with bf16 params and moments (``EP_KW``), 2 steps: ``ep`` (``expert_parallel_size=2``: the mesh
   ``{..., 'expert': 2, ...}``, each rank 4 of the 8 experts, the routed
   tokens moved by the all-to-all of ``parallel/expert.py``), ``ep-ref``
   (fsdp 2 without the expert axis: the same ranks, rows and global
   batch) and ``ep-control`` (one step of ``ep`` with each rank keeping
   its own chunks in place of its peer's). The loader phase waits for the
   control's marker (``TP_MIXTRAL_MARKER``) before resume trains. Checks:
   each run's mesh line; ``ep``'s losses and gradient norms within
   ``SHARD_REL_TOL`` of ``ep-ref``'s, the ranks' losses equal, the
   control outside it; ``EXPERT_A2A`` on ``ep`` == steps x 2 x (2 x
   layers + rematerialised layers), 0 on ``ep-ref``; the first step's
   ``moe_drop_frac`` equal on both and the second within
   ``EP_DROP_ABS_TOL``; flash launches a rank == steps x (2 +
   rematerialised layers) forward and steps x 2 dq and dk/dv at 32/8;
   each run's step time and peak memory a rank. gloo stages the exchange
   through the host: no time of it here is a cross-card figure.

Then a ``total`` line (seconds since ``main`` began, and each phase's),
a ``{"kernels": [...]}`` line (the flash forward and dq by contract and
key tile, and the ring's non-causal and fp32-dq modes; the paged
decode's launches by contract summed over the serving runs), the ``nvidia-smi`` line, and last
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
          "serve-spec", "fleet", "flash", "ring", "train",
          "loader", "resume", "supervise", "shard", "hf-eval", "train-kvgrid", "tune", "ssd",
          "train-mamba",
          "serve-mamba", "train-mixtral", "serve-mixtral", "train-quant", "tp")

# llama3_8b decode shapes of the kernel phase
B, NQ, NKV, H, PAGE, MAXP = 8, 32, 8, 128, 64, 32
# the timed loops rotate through copies of the pools, as the layers of a
# decode step do, enough of them that the live K/V of all copies is at
# least this many times the card's L2: no call reads a warm L2
L2_SPAN = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dense bf16 / int8 / fp8 tensor cores, fp32 SIMT
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp8": 1979e12, "fp32": 67e12}
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
    fwd = cuda_build.load("flash_fwd_sm90").lib
    report["flash_fwd_sm90"]["dynamic_smem_bytes"] = {
        f"block_k={bk}": fwd.flash_fwd_sm90_smem_bytes(bk) for bk in (64, 128)}
    bwd = cuda_build.load("flash_bwd_sm90").lib
    report["flash_bwd_sm90"]["dynamic_smem_bytes"] = {
        **{f"dq block_k={bk}": bwd.flash_bwd_sm90_smem_bytes(0, bk) for bk in (64, 128)},
        "dkv": bwd.flash_bwd_sm90_smem_bytes(1, 128)}
    scan = cuda_build.load("ssd_sm90").lib
    report["ssd_sm90"]["dynamic_smem_bytes"] = {
        f"{hb} heads a block, L={chunk}": scan.ssd_sm90_smem_bytes(hb, chunk)
        for hb in (1, 2) for chunk in (64, 256)}
    state["build_s"] = wall
    emit("build", seconds=wall, sources=report, spilling_kernels=spills)
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")


def _kernel_lens(gen, batch=B, maxp=MAXP, page=PAGE):
    """Seeded ragged positions with 0 and page-boundary values."""
    import torch

    lens = [0, page - 1, page, 2 * page - 1, maxp * page - 1]
    return lens + torch.randint(1, maxp * page, (batch - len(lens),), generator=gen,
                                device="cuda").tolist()


def _kernel_inputs(kind, gen, lens, copies, maxp=MAXP, page=PAGE):
    """Seeded decode inputs at positions ``lens``: q, ``copies`` layers of
    pools of ``page``-key pages (+scales), page table, seq_lens."""
    import torch

    from fms_fsdp_tpu_torch.ops.quant import kv_quantize

    dev = "cuda"
    batch = len(lens)
    q_dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    num_pages = batch * maxp + 2
    shape = (copies, num_pages, page, NKV, H)
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
        n = pos // page + 1
        table[b, :n] = torch.tensor(perm[b * maxp: b * maxp + n])
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, ks, vs, table.to(dev), seq_lens


def _live_kv_bytes(kind, lens, maxp=MAXP, page=PAGE):
    """Bytes of the K/V rows (and row scales) a call's rows attend."""
    elem = {"bf16": 2, "fp32": 4, "int8": 1, "e4m3": 1}[kind]
    keys = sum(min(p + 1, maxp * page) for p in lens)
    return 2 * keys * (NKV * H * elem + (NKV * 4 if kind in ("int8", "e4m3") else 0))


def _bound(kind, lens, maxp=MAXP, page=PAGE):
    """Least time for one call: bytes (each live K/V row, q, out, table
    and lens once) over HBM rate vs operations over the peak of their
    type; the larger one bounds."""
    q_elem = 4 if kind == "fp32" else 2
    batch = len(lens)
    keys = sum(min(p + 1, maxp * page) for p in lens)
    nbytes = (_live_kv_bytes(kind, lens, maxp, page) + 2 * batch * NQ * H * q_elem
              + batch * maxp * 4 + batch * 4)
    ops = 4 * keys * NQ * H  # QK^T and PV, 2 flops per MAC
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS["fp32" if kind == "fp32" else "bf16"] * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes, ops
    return ops_ms, "operations", nbytes, ops


# (label, pool type, keys a row can hold, lengths, tuned): the four pool
# types at the llama3_8b decode shape (seeded ragged lengths) at the page
# and split the tuning table holds for their signature (those the serving
# phases run), and one bf16 row of 16,383 keys at page 64 and the
# planner's split, then at the table's
KERNEL_CASES = (
    ("bf16", "bf16", MAXP * PAGE, None, True),
    ("fp32", "fp32", MAXP * PAGE, None, True),
    ("int8", "int8", MAXP * PAGE, None, True),
    ("e4m3", "e4m3", MAXP * PAGE, None, True),
    ("bf16_b1_16383", "bf16", 16384, [16382], False),
    ("bf16_b1_16383_tuned", "bf16", 16384, [16382], True),
)
# pool types by the dtype names the tuning table keys paged decode on
POOL_DTYPES = {"bf16": "bfloat16", "fp32": "float32", "int8": "int8",
               "e4m3": "float8_e4m3fn"}


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
    from fms_fsdp_tpu_torch.tune.lookup import resolve_paged_decode

    gen = torch.Generator(device="cuda").manual_seed(0)
    props = torch.cuda.get_device_properties(0)
    sm_count = props.multi_processor_count
    results = {}
    for label, kind, cap, case_lens, tuned in KERNEL_CASES:
        page, block_kv, how = PAGE, PAGE, "fixed"
        if tuned:
            page, block_kv, how = resolve_paged_decode(
                len(case_lens or [0] * B), NQ, NKV, H, cap, POOL_DTYPES[kind])
        maxp = cap // page
        lens_list = case_lens or _kernel_lens(gen, B, maxp, page)
        batch = len(lens_list)
        copies = max(2, math.ceil(L2_SPAN * props.L2_cache_size
                                  / _live_kv_bytes(kind, lens_list, maxp, page)))
        q, k, v, ks, vs, table, lens = _kernel_inputs(kind, gen, lens_list, copies, maxp, page)
        scaled = ks is not None
        layer = lambda i: (k[i % copies], v[i % copies],  # noqa: E731
                           ks[i % copies] if scaled else None,
                           vs[i % copies] if scaled else None)
        kp, vp, ksp, vsp = layer(0)
        split_keys, n_splits = pa.decode_splits(batch, NKV, cap, page, sm_count,
                                                None if block_kv == page else block_kv)
        out = pa.paged_attention_kernel(q, kp, vp, table, lens, block_kv=block_kv,
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
            pa.paged_attention_kernel(q, kp, vp, table, lens, block_kv=block_kv,
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
        mask = (torch.arange(cap, device="cuda")[None, :]
                <= lens[:, None].long())[:, None, None, :]
        q4 = q[:, :, None, :]

        def library(i):
            kg, vg = caches[i % copies]
            F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask,
                                           enable_gqa=True)

        library_eager_ms = cuda_time_ms(library, reps=50, warmup=5)
        library_ms = graph_time_ms(library, reps=64)
        bound_ms, bound_by, nbytes, ops = _bound(kind, lens_list, maxp, page)
        live = sum(-(-min(p + 1, cap) // split_keys) for p in lens_list)
        results[label] = dict(
            pools=kind, batch=batch, max_abs_err=err, tol=TOL[kind], finite=finite,
            rel_err_rows=rel.tolist(), rel_tol=rel_tol, rel_err_control_min=rel_control,
            control_rows=rows.tolist(), ok=ok, pool_copies=copies, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
            library_eager_ms=library_eager_ms,
            kernel_over_library=ms / library_ms, bound_ms=bound_ms,
            bound_by=bound_by, bound_share=bound_ms / ms,
            achieved_gbytes_per_s=nbytes / ms / 1e6, bytes=nbytes, ops=ops,
            page_size=page, block_kv=block_kv, tune_how=how,
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


def _contract(eng) -> str:
    """The Pallas contract an engine's paged-decode launches count under:
    "v2" for quantized pools or a split the tuning table set (block_kv
    other than the page size), else "v1"."""
    return "v2" if eng._paged_kernel_impl() == 2 else "v1"


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
    key = _contract(eng)

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
        decode_steps=steps, layers=cfg.nlayers, contract=key,
        page_size=eng.page_size, block_kv=eng.block_kv, tune_how=eng.tune_how,
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
    del eng
    torch.cuda.empty_cache()
    problems = []
    if phase == "serve":
        result["chunked"] = _serve_chunked(state, cfg, result["compare"]["tolerance"], problems)
    result["disagg"] = _serve_disagg(state, cfg, kv_quant, problems,
                                     n=8 if phase == "serve" else 4,
                                     defrag=phase == "serve")
    result["nvidia_smi"] = state["smi"]
    if phase == "serve":
        result["param_init_s"] = state["init_s"]
    emit(phase, **result)
    state[phase] = result
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


# chunked prefill of the serve phase: 1024-token prompts in 256-token chunks
CHUNK_PROMPT, CHUNK_TOKENS = 1024, 256


def _serve_chunked(state, cfg, tol_step, problems):
    """Chunked prefill on the serve phase's llama3_8b: the first-token
    logits of one 1024-token prompt through the 256-token chunks against
    the whole-prompt path, both bf16, held to twice the whole bf16 path's
    distance from an fp32 whole-prompt prefill (the phase's bf16
    tolerance, measured here as ``_compare_step`` measures it for a decode
    step); then 2 such prompts through an engine with 16 new tokens each:
    8 chunks, and paged-decode launches == decode steps x 32."""
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.models.generation import prefill
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
    from fms_fsdp_tpu_torch.utils.tree import tree_map

    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.src_vocab_size, size=CHUNK_PROMPT).tolist()
               for _ in range(2)]
    eng = ServingEngine(state["params"], cfg, ServeConfig(
        max_batch=8, max_seq_len=2048, prefill_chunk_tokens=CHUNK_TOKENS), seed=0)
    ad = eng.adapter
    t0 = time.perf_counter()
    ad.prefill_start(-1, 0, prompts[0])
    row, chunks = None, 0
    while row is None:
        row = ad.prefill_chunk(-1)
        chunks += 1
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    ad.release(-1, 0)
    t0 = time.perf_counter()
    whole = ad.prefill(-2, 0, prompts[0])
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    ad.release(-2, 0)
    params32 = tree_map(lambda w: w.float(), eng.params)
    logits32, _, _ = prefill(params32, torch.tensor([prompts[0]], device="cuda"), cfg,
                             max_seq_len=CHUNK_PROMPT, compute_dtype=torch.float32)
    del params32
    torch.cuda.empty_cache()
    row, whole, row32 = row.float(), whole.float(), logits32[0, 0].float()
    tol = 2 * (whole - row32).abs().max().item()
    out = {
        "prompt_tokens": CHUNK_PROMPT, "chunk_tokens": CHUNK_TOKENS, "chunks": chunks,
        "chunked_vs_whole": (row - whole).abs().max().item(),
        "whole_vs_fp32": tol / 2, "chunked_vs_fp32": (row - row32).abs().max().item(),
        "tolerance": tol, "decode_step_tolerance": tol_step,
        "argmax_chunked_vs_whole": bool(row.argmax() == whole.argmax()),
        "first_token_s": {"chunked": chunked_s, "whole": whole_s},
    }
    reqs = [eng.submit(p, 16) for p in prompts]
    pa.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    key = _contract(eng)
    out.update(
        engine_wall_s=time.perf_counter() - t0, decode_steps=eng.decode_steps,
        prefill_chunks=eng.serving_stats()["prefill_chunks"],
        launches=dict(pa.LAUNCHES), contract=key,
        finished=sum(r.state == "finished" and len(r.generated) == 16 for r in reqs),
    )
    del eng
    torch.cuda.empty_cache()
    if out["chunked_vs_whole"] > tol or not math.isfinite(out["chunked_vs_whole"]):
        problems.append(f"chunked first-token logits off by {out['chunked_vs_whole']} > {tol}")
    if (out["launches"][key] != out["decode_steps"] * cfg.nlayers
            or sum(out["launches"].values()) != out["launches"][key]):
        problems.append(f"chunked engine launches {out['launches']} != "
                        f"{out['decode_steps']} steps x {cfg.nlayers} of {key}")
    if out["finished"] != len(prompts) or out["prefill_chunks"] != len(prompts) * chunks:
        problems.append(f"chunked engine: {out['finished']} finished, "
                        f"{out['prefill_chunks']} chunks")
    return out


def _serve_disagg(state, cfg, kv_quant, problems, n, defrag):
    """In-process disaggregation on the serve phase's weights: a
    ``prefill``-role engine packs ``n`` requests (prompts of 64-512) after
    their first token
    (``pack_handoff`` bytes), a ``decode``-role engine resumes them
    (``submit_handoff``). Checks: the prefill side launches no kernel; the
    imported pages equal the shipped ones bitwise over each stream's
    tokens; the decode engine's first step logits within ``TOL`` of a
    unified engine's on the same requests; the decode side launches its
    contract's kernel exactly decode steps x 32 times; quantized pools
    ship their 1-byte values and fp32 scales. With ``defrag``, once the
    three short requests have finished: ``defrag`` moves at least one
    page, the next kernel step's logits equal that step's before the
    defrag bitwise, and a copy of the moved pools read through the stale
    page table (the version bump undone) must not."""
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
    from fms_fsdp_tpu_torch.serve.decode import paged_decode_step
    from fms_fsdp_tpu_torch.serve.disagg import unpack_handoff

    tol = TOL["int8"] if kv_quant != "none" else TOL["bf16"]
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.src_vocab_size, size=int(m)).tolist()
               for m in rng.randint(64, 513, size=n)]
    max_new = [4, 4, 4] + [24] * (n - 3)

    def engine(**kw):
        return ServingEngine(state["params"], cfg, ServeConfig(
            max_batch=8, max_seq_len=2048, kv_quant=kv_quant, max_prefill_per_step=8, **kw),
            seed=0)

    # the unified engine's first step, the reference for the decode side's
    ue = engine()
    for p, m in zip(prompts, max_new):
        ue.submit(p, m)
    ue.step()
    u_first = ue.last_logits.float()
    del ue
    torch.cuda.empty_cache()
    pe = engine(role="prefill")
    pa.reset_launches()
    preqs = [pe.submit(p, m) for p, m in zip(prompts, max_new)]
    pe.run()
    torch.cuda.synchronize()
    prefill_launches = dict(pa.LAUNCHES)
    frames = [r.handoff_out for r in preqs]
    pack_s = pe.serving_stats()["handoff_s"]
    del pe
    de = engine(role="decode")
    pa.reset_launches()
    dreqs = [de.submit_handoff(b) for b in frames]
    # the first step imports all n and decodes them once
    de.step()
    d_first = de.last_logits.float().clone()
    scatter_s = de.serving_stats()["handoff_s"]
    pages_equal, scales_fp32 = True, True
    for r, b in zip(dreqs, frames):
        header, arrays = unpack_handoff(b)
        got = de.cache.gather_pages(r.rid)
        seq = int(header["seq_len"])
        for name, ship in arrays.items():
            a = got[name].flatten(1, 2)[:, :seq]
            pages_equal &= torch.equal(a.view(torch.uint8), ship.flatten(1, 2)[:, :seq].view(torch.uint8))
            if name.endswith("_scale"):
                scales_fp32 &= ship.dtype == torch.float32
        if kv_quant != "none":
            scales_fp32 &= arrays["k"].dtype == torch.int8 and "k_scale" in arrays
    out = {
        "requests": n, "kv_quant": kv_quant,
        "handoff_bytes": [len(b) for b in frames],
        "handoff_bytes_per_request": sum(len(b) for b in frames) / n,
        "pack_s_per_request": pack_s / n, "scatter_s_per_request": scatter_s / n,
        "prefill_launches": prefill_launches, "pages_equal_shipped": bool(pages_equal),
        "scales_fp32_values_1_byte": bool(scales_fp32) if kv_quant != "none" else None,
        "first_step_vs_unified": (d_first[:n] - u_first[:n]).abs().max().item(),
        "tolerance": tol,
        "argmax_first_step_vs_unified":
            (d_first[:n].argmax(-1) == u_first[:n].argmax(-1)).float().mean().item(),
    }
    if defrag:
        while not all(r.state == "finished" for r in dreqs[:3]):
            de.step()
        out["defrag"] = _defrag_check(de, paged_decode_step, pa, problems)
    de.run()
    torch.cuda.synchronize()
    key = _contract(de)
    out.update(decode_steps=de.decode_steps, launches=dict(pa.LAUNCHES), contract=key,
               finished=sum(r.state == "finished" and len(r.generated) == m
                            for r, m in zip(dreqs, max_new)))
    del de
    torch.cuda.empty_cache()
    other = "v1" if key == "v2" else "v2"
    if any(prefill_launches.values()):
        problems.append(f"the prefill-role engine launched {prefill_launches}")
    if not pages_equal:
        problems.append("imported pages differ from the shipped pages")
    if kv_quant != "none" and not scales_fp32:
        problems.append("quantized pages did not ship as 1-byte values with fp32 scales")
    if not out["first_step_vs_unified"] <= tol:
        problems.append(f"decode-role first step off the unified engine's by "
                        f"{out['first_step_vs_unified']}")
    if out["launches"][key] != out["decode_steps"] * cfg.nlayers or out["launches"][other]:
        problems.append(f"decode-role launches {out['launches']} != "
                        f"{out['decode_steps']} steps x {cfg.nlayers} of {key}")
    if out["finished"] != n:
        problems.append(f"decode-role engine finished {out['finished']} of {n}")
    return out


def _defrag_check(eng, paged_decode_step, pa, problems):
    """``defrag`` under a live decode batch (see ``_serve_disagg``). The
    launches of the comparison steps are taken back out of the counts."""
    import torch

    ad = eng.adapter
    saved = dict(pa.LAUNCHES)
    slot_rids = [r.rid if r is not None else None for r in eng._slots]
    live = [s for s, r in enumerate(slot_rids) if r is not None]
    lens, toks = eng._lens.copy(), eng._tokens.copy()
    _, before = ad.decode(slot_rids, lens, toks, eng.generator)
    before = before.float()
    stale_table = ad._table_dev.clone()
    version = eng.cache.table_version
    t0 = time.perf_counter()
    moves = eng.cache.defrag()
    torch.cuda.synchronize()
    defrag_s = time.perf_counter() - t0
    _, after = ad.decode(slot_rids, lens, toks, eng.generator)
    after = after.float()
    # the control: a copy of the moved pools read through the page table
    # cached before the defrag, as if the version had not been bumped
    pools = {n: p.clone() for n, p in eng.cache.pools.items()}
    stale, _, _ = paged_decode_step(
        eng.params, pools, stale_table, torch.from_numpy(lens).cuda(),
        torch.from_numpy(toks).cuda(), eng.model_cfg, page_size=ad.page_size,
        compute_dtype=eng.compute_dtype, quant=eng.serve_cfg.kv_quant,
        attn_impl=ad.attn_impl, block_kv=ad.block_kv, rope=ad.rope)
    del pools
    torch.cuda.empty_cache()
    pa.LAUNCHES.update(saved)
    out = {
        "live_rows": len(live), "pages_moved": moves, "defrag_s": defrag_s,
        "version_bumped": eng.cache.table_version == version + 1,
        "bitwise_equal_after": bool(torch.equal(after[live], before[live])),
        "stale_table_max_diff": (stale.float()[live] - before[live]).abs().max().item(),
    }
    if moves < 1 or not out["version_bumped"] or not out["bitwise_equal_after"]:
        problems.append(f"defrag: {out}")
    if not out["stale_table_max_diff"] > 0:
        problems.append("defrag control: the stale page table read the right pages")
    return out


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
# stage 2 cut for time from 96 rows x 256 tokens to 32 x 32 (32 x 64
# before the train-quant phase's cuts). The dummy
# counter runs modulo 4096 (``vocab_size`` is only its modulus here; the
# model's vocabulary stays 128256): every batch holds the same 4096
# transitions, which 4 steps can learn (head 1 from 12.10 to 7.69 on an
# H100). Modulo 128256 each step brings tokens no step has seen, and the
# loss rises. Stage 1 cut from 6 steps and stage 2 from 2 to pay
# for the ring phase's Mixtral part.
SPEC_KW = {
    "model_variant": "llama3_8b", "vocab_size": 4096, "use_dummy_dataset": True,
    "batch_size": 2, "seq_length": 4096, "num_steps": 5, "stage2_start_step": 4,
    "stage2_batch_size": 32, "stage2_prompt_length": 64, "stage2_seq_length": 32,
    "report_interval": 1, "learning_rate": 1e-3, "checkpoint_interval": 1000,
}


def _spec_step_profile(model_cfg, cfg, scfg, base, state, batch, steps=1):
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




def _spec_int8_steps(model_cfg, cfg, scfg, base, spec_state, batch, steps=2):
    """Stage-1 steps with ``quantized_matmuls="int8"``: the frozen base's
    seven projections a layer through ``torch._int_mm``, forward only;
    tokens/s as the entry counts them (the batch's tokens)."""
    import torch

    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import quant
    from fms_fsdp_tpu_torch.train.speculator import make_stage1_step

    step = make_stage1_step(base, model_cfg, scfg,
                            dataclasses.replace(cfg, quantized_matmuls="int8"))
    fa.reset_launches()
    quant.reset_gemms()
    rows = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spec_state, m = step(spec_state, batch)
        per_head = m["per_head"].float().cpu().tolist()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows.append({"loss_per_head": per_head, "gnorm": float(m["gnorm"]), "step_s": dt,
                     "tokens_per_s": batch.numel() / dt})
    return {"per_step": rows, "tokens_per_s": rows[-1]["tokens_per_s"],
            "flash_fwd_per_step": fa.LAUNCHES["fwd"] / steps, "gemms": dict(quant.GEMMS),
            "expected_gemms": {"fwd": 7 * model_cfg.nlayers * steps, "dgrad": 0}}


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
    result["int8_base"] = _spec_int8_steps(model_cfg, cfg, scfg, base, res["state"], batch)
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
    q8 = result["int8_base"]
    if q8["flash_fwd_per_step"] != model_cfg.nlayers or q8["gemms"] != q8["expected_gemms"]:
        problems.append(f"the int8 base's steps: {q8}")
    losses = [x for r in reports for x in r["per_head"]] + [r["gnorm"] for r in reports]
    losses += [x for r in q8["per_step"] for x in r["loss_per_head"]]
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
    if not any(result["plain"]["paged_decode_launches"].values()):
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


def _flash_all(fa, q, k, v, do, kernel, block_k=None, causal=True):
    """[o, lse, dq, dk, dv] through the kernels (the forward and dq at key
    tile ``block_k``, None for the default) or the plain versions, delta
    from that path's own o."""
    fwd, dq_fn, dkv_fn = ((fa.flash_fwd, fa.flash_dq, fa.flash_dkv) if kernel else
                          (fa.flash_fwd_plain, fa.flash_dq_plain, fa.flash_dkv_plain))
    tile = {"block_k": block_k} if kernel and block_k else {}
    o, lse = fwd(q, k, v, causal=causal, **tile)
    delta = _delta(o, do)
    dq = dq_fn(q, k, v, do, lse, delta, causal=causal, **tile)
    dk, dv = dkv_fn(q, k, v, do, lse, delta, causal=causal)
    return [o, lse, dq, dk, dv]


def _flash_control(fa, q, k, v, do, causal=True):
    """The plain versions with their scores rounded to bf16 before exp2: a
    fault of the kind a loose tolerance lets through, which the bf16
    check must catch."""
    import torch

    scores = fa._scores2
    fa._scores2 = lambda *a: scores(*a).to(torch.bfloat16).float()
    try:
        return _flash_all(fa, q, k, v, do, kernel=False, causal=causal)
    finally:
        fa._scores2 = scores


def _bwd_block_check(fa, q, k, v, do, got, causal=True, lse_delta=None):
    """dq per 128-row block and dk/dv per 128-key block of the backward
    kernels against the plain backward on the same inputs (the kernel
    forward's lse and delta), each within ``BF16_BLOCK_REL_TOL``; and the
    control, that plain backward with the last 64-row query tile of head 0
    (batch 0) left out of key block 0's walk, which must exceed that bound
    on every block it changes (one of each output)."""
    lse, delta = lse_delta or (got[1], _delta(got[0], do))
    ref = [fa.flash_dq_plain(q, k, v, do, lse, delta, causal=causal),
           *fa.flash_dkv_plain(q, k, v, do, lse, delta, causal=causal)]
    control = fa.flash_bwd_drop_tile_plain(
        q, k, v, do, lse, delta, *ref, batch=0, head=0,
        q_tile=q.shape[1] // fa.BWD_Q_TILE - 1, k_block=0, causal=causal)
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


def _plain_ms(fn):
    """One timed call after a warm-up call: the plain versions take 30-500
    ms a call (two timed calls each before the ring phase's Mixtral part)."""
    return cuda_time_ms(fn, reps=1, warmup=1)


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


def _flash_times(fa, kind, dtype, shape, gen, block_k=None, base=None):
    """Kernel, plain and SDPA times of the three kernels at one shape,
    rotating over two input sets. With ``block_k`` the forward and dq
    kernels run at that key tile; with ``base`` (the default tile's
    result) only they are timed, beside base's dk/dv, plain and SDPA
    times."""
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

    tile = {"block_k": block_k} if block_k else {}
    out = {}
    out["fwd"] = _timed_ms(lambda i: fa.flash_fwd(*pick(i)[:3], **tile))
    out["dq"] = _timed_ms(lambda i: fa.flash_dq(*pick(i)[:4], *pick(i)[5:], **tile))
    out["dkv"] = (base["dkv"]["ms"] if base else
                  _timed_ms(lambda i: fa.flash_dkv(*pick(i)[:4], *pick(i)[5:])))
    # the whole backward through autograd (delta, q2, both kernels, the
    # dk/dv casts) on retained graphs of the forward
    graphs = []
    for q, k, v, do, *_ in sets:
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        graphs.append((leaves, fa.flash_attention(*leaves, **tile), do))

    def autograd_bwd(i):
        leaves, o, do = graphs[i % 2]
        torch.autograd.grad(o, leaves, do, retain_graph=True)

    bwd_ms = _timed_ms(autograd_bwd)
    del graphs
    if base:
        return _flash_rows(kind, shape, dtype, out, {n: base[n]["plain_ms"] for n in out},
                           base["sdpa"], bwd_ms)
    plain = {
        "fwd": _plain_ms(lambda i: fa.flash_fwd_plain(*pick(i)[:3])),
        "dq": _plain_ms(lambda i: fa.flash_dq_plain(*pick(i)[:4], *pick(i)[5:])),
        "dkv": _plain_ms(lambda i: fa.flash_dkv_plain(*pick(i)[:4], *pick(i)[5:])),
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
    del sets
    return _flash_rows(kind, shape, dtype, out, plain, lib, bwd_ms)


def _flash_rows(kind, shape, dtype, out, plain, lib, bwd_ms):
    """The timed kernels' rows: ms beside the plain version, the bound
    and SDPA; the backward pair and the autograd backward beside SDPA's
    backward."""
    import torch

    b, sq, sk, nq, nkv = shape
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
    return out


# ---------------------------------------------------------------------------
# the fleet: a router over replica children on the one card
# ---------------------------------------------------------------------------

# llama3_8b at full width, 4 of 32 layers, fp32 (7.7 GB of weights a child)
FLEET_LAYERS, FLEET_SEED = 4, 21
FLEET_REQUESTS, FLEET_PROMPT, FLEET_NEW = 16, (64, 512), 32
# decode replica 1 dies at this engine iteration of its first incarnation
# (its warmup is iteration 1: it has imported handoffs by then)
FLEET_KILL_STEP = 5
# 1 MiB chunks, 4 MiB unacknowledged at most: a chunk's retransmit timer
# starts when it is queued, so the bytes queued ahead of it should drain
# inside the first backoff (0.25 s)
FLEET_CHUNK_BYTES, FLEET_INFLIGHT_BYTES = 1 << 20, 4 << 20
# in both directions a chunk waits out ~6.75 s of a busy peer (a child
# pumps its channel once an engine step, the router once a poll) before
# its sender gives up; JAX's default window is ~1.5 s
FLEET_RETRIES, FLEET_BACKOFF_S = 8, 0.25
# the layout fleet beside it: a prefill and a decode replica of 2 ranks
# each, 4 processes on the card in two gloo worlds
FLEET_LAYOUT = "tp=2"


def _fleet_record(stats):
    """A minimal metrics record around the fleet's stats map, for the
    port's schema check."""
    from fms_fsdp_tpu_torch.obs.schema import SCHEMA_FIELDS, SCHEMA_VERSION

    rec = {name: (0 if tag == "int" else 0.0)
           for name, (tag, required) in SCHEMA_FIELDS.items() if required}
    rec.update(schema_version=SCHEMA_VERSION, serving_fleet=stats)
    return rec


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def _fleet_dump(router, workdir, log):
    """What a failed fleet phase leaves to read, on stderr: the router's
    log, every in-flight record and transfer, each child's stderr tail."""
    print("\n".join(log[-60:]), file=sys.stderr)
    for rid, rec in router.journal.records.items():
        if rec.state in ("queued", "assigned"):
            print(f"rid {rid}: {rec.state} on {rec.run_id or '-'} handoff="
                  f"{rec.handoff is not None} requeues={rec.requeues}", file=sys.stderr)
    for tid, (idx, sender, rid) in router._tx.items():
        print(f"tx {tid} -> replica {idx} rid {rid}: {len(sender.acked)}/{sender.total} "
              f"acked, resent {sender.chunks_resent}", file=sys.stderr)
    for (idx, tid), (receiver, meta) in router._rx.items():
        print(f"rx {tid} <- replica {idx}: {len(receiver.chunks)}/{receiver.total}, "
              f"control {meta is not None}", file=sys.stderr)
    print(f"journal transfers: {router.journal.transfers}", file=sys.stderr)
    print(f"slots: {[(s.index, s.state, s.run_id) for s in router.supervisor.slots]}",
          file=sys.stderr)
    for name in sorted(os.listdir(workdir)):
        if name.endswith(".stderr"):
            with open(os.path.join(workdir, name), errors="replace") as f:
                print(f"--- {name} ---\n{f.read()[-3000:]}", file=sys.stderr)


def _proc_children(pid):
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(p) for p in f.read().split()]
    except OSError:
        return []


def _proc_alive(pid) -> bool:
    """Whether ``pid`` runs (a zombie waiting for its reaper does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except OSError:
        return False


class _FleetRun:
    """One fleet of the fleet phase: a router over replica children of
    llama3_8b at ``FLEET_LAYERS`` layers, replica 0 the prefill replica,
    the phase's transport settings; the start-up seconds and the ranks'
    pids of each incarnation (read at its readiness), its timeline, the
    router's stats once its wave is done."""

    def __init__(self, name, cfg, scfg, n_replicas, faults=""):
        from fms_fsdp_tpu_torch.serve.fleet import FleetConfig, FleetRouter, make_subprocess_spawn

        self.workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        self.log = []
        spawn = make_subprocess_spawn(
            self.workdir, dataclasses.asdict(cfg), scfg, init_seed=FLEET_SEED,
            prefill_replicas=1, faults=faults, env_extra={"OMP_NUM_THREADS": "2"},
            chunk_bytes=FLEET_CHUNK_BYTES,
            inflight_bytes=FLEET_INFLIGHT_BYTES, retries=FLEET_RETRIES,
            backoff_s=FLEET_BACKOFF_S,
        )
        self.router = FleetRouter(spawn, FleetConfig(
            n_replicas=n_replicas, prefill_replicas=1, max_seq_len=scfg["max_seq_len"],
            max_inflight_per_replica=8, startup_timeout_s=300.0, stall_timeout_s=60.0,
            restart_backoff_s=0.1, journal_path=os.path.join(self.workdir, "journal.jsonl"),
            ledger_path=os.path.join(self.workdir, "ledger.json"),
            transport_chunk_bytes=FLEET_CHUNK_BYTES,
            transport_inflight_bytes=FLEET_INFLIGHT_BYTES,
            transport_retries=FLEET_RETRIES, transport_backoff_s=FLEET_BACKOFF_S,
        ), log=self.log.append)
        self.sup = self.router.supervisor
        self.ready_at, self.pids, self.events, self.rids = {}, {}, {}, []
        self.stats = None
        self.started = False
        self.live = True  # shut down once its script ends

    def start(self):
        self.router.start()
        self.started = True

    def tick(self):
        if not self.started:
            return
        self.router.poll()
        now = time.monotonic()
        for idx in self.sup.live_indices():
            run = self.sup.run_id(idx)
            if self.router._ready.get(idx) and run not in self.ready_at:
                self.ready_at[run] = now - self.sup.slots[idx].started
                leader = self.sup.handle(idx).proc.pid
                self.pids[run] = [leader] + _proc_children(leader)

    def holds_streams(self, idx) -> bool:
        router = self.router
        return bool(router._ready.get(idx) and router.journal.inflight(self.sup.run_id(idx))
                    and router._hb_stats.get(idx, {}).get("slots_busy", 0) > 0)

    def drain(self, timeout_s):
        """``FleetRouter.drain`` as steps of a script: the live replicas
        told to drain, then polled (by the phase's loop) until every ready
        one has exited or ``timeout_s`` passes; a relaunch still starting
        is stopped by the shutdown."""
        for idx in self.sup.live_indices():
            handle = self.sup.handle(idx)
            if handle is not None:
                handle.send({"type": "drain"})
        deadline = time.monotonic() + timeout_s
        while (any(self.router._ready.get(i) for i in self.sup.live_indices())
               and time.monotonic() < deadline):
            yield

    def shutdown(self):
        if self.live:
            self.live = False
            self.router.shutdown()

    def reports(self):
        """Each child's stats file (a layout follower's too), by run id."""
        out = {}
        for name in sorted(os.listdir(self.workdir)):
            if name.endswith(".stats.json"):
                with open(os.path.join(self.workdir, name)) as f:
                    out[name[:-len(".stats.json")]] = json.load(f)
        return out

    def read(self, ref_tokens):
        """(ledger, reports, the figures every fleet prints)."""
        from fms_fsdp_tpu_torch.obs.schema import validate_record

        recs = self.router.journal.records
        tokens = [recs[r].tokens for r in self.rids]
        with open(os.path.join(self.workdir, "ledger.json")) as f:
            ledger = json.load(f)
        ttft = [recs[r].engine_ttft for r in self.rids if recs[r].engine_ttft is not None]
        latency = [recs[r].latency for r in self.rids]
        return ledger, self.reports(), {
            "completed_once": (sorted(r.rid for r in self.router.completed)
                               == sorted(self.rids)),
            "tokens_equal_reference": sum(t == r for t, r in zip(tokens, ref_tokens)),
            "first_mismatch": next(({"request": i, "fleet": t, "reference": r}
                                    for i, (t, r) in enumerate(zip(tokens, ref_tokens))
                                    if t != r), None),
            "stats": self.stats, "schema_errors": validate_record(_fleet_record(self.stats)),
            "restarts": [{k: e[k] for k in ("replica", "incarnation", "classification",
                                            "exit_code", "downtime_s")}
                         for e in ledger["entries"]],
            "restart_downtime_s": ledger["replica_downtime_s"],
            "ttft_s": {"p50": _pct(ttft, 0.5), "p99": _pct(ttft, 0.99)},
            "latency_s": {"p50": _pct(latency, 0.5), "p99": _pct(latency, 0.99)},
            "startup_s": self.ready_at, "timeline_s": self.events,
        }


def _one_card_fleet(f, prompts, t_start, after):
    """The one-card fleet's schedule (module docstring, phase 8), begun
    once the ``after`` fleet's replicas are ready: its children draw
    their weights (9.8 GB a process at the peak) when the layout ranks
    have kept their halves."""
    router, sup = f.router, f.sup
    half = FLEET_REQUESTS // 2
    while len(after.ready_at) < after.router.cfg.n_replicas:
        yield
    f.start()
    f.events["start_s"] = time.monotonic() - t_start
    while len(f.ready_at) < 3:
        yield
    f.events["all_ready_s"] = time.monotonic() - t_start
    f.rids += [router.submit(p, FLEET_NEW) for p in prompts[:half]]
    # the kill, then its relaunch ready
    while not (sup.slots[1].incarnation >= 1 and "replica1-i1" in f.ready_at):
        yield
    f.events["replica1_relaunch_ready_s"] = time.monotonic() - t_start
    f.rids += [router.submit(p, FLEET_NEW) for p in prompts[half:]]
    # preempt decode replica 2 while it holds live streams
    while not f.holds_streams(2):
        if router.journal.outstanding() == 0:
            raise AssertionError("the wave finished before replica 2 held a stream")
        yield
    f.events["preempt_s"] = time.monotonic() - t_start
    router.preempt(2)
    while router.journal.outstanding():
        yield
    f.events["wave_done_s"] = time.monotonic() - t_start
    f.stats = router.stats()
    # replicas 0 and 1 drain and write their stats at once; replica 2's
    # relaunch, still starting, is stopped by the shutdown
    yield from f.drain(30.0)
    f.events["drained_s"] = time.monotonic() - t_start


def _layout_fleet(f, prompts, t_start):
    """The layout fleet's schedule (module docstring, phase 8), its
    router already started: once decode replica 1 holds live streams of
    imported handoffs, its follower (rank 1) is SIGKILLed and the rest of
    the wave goes in."""
    router = f.router
    half = FLEET_REQUESTS // 2
    while len(f.ready_at) < 2:
        yield
    f.events["all_ready_s"] = t_wave = time.monotonic() - t_start
    f.rids += [router.submit(p, FLEET_NEW) for p in prompts[:half]]
    while not f.holds_streams(1):
        yield
    dead = f.pids["replica1-i0"]
    t_kill = time.monotonic()
    f.events["kill_s"] = t_kill - t_start
    f.events["killed_with_streams"] = router.journal.inflight("replica1-i0")
    os.kill(dead[1], signal.SIGKILL)
    f.rids += [router.submit(p, FLEET_NEW) for p in prompts[half:]]
    while "replica1-i1" not in f.ready_at:
        yield
    f.events["kill_to_ready_s"] = time.monotonic() - t_kill
    # the killed incarnation's ranks, leader included, still running at
    # its relaunch's readiness (none expected)
    f.events["dead_ranks_alive_at_ready"] = [p for p in dead if _proc_alive(p)]
    while router.journal.outstanding():
        yield
    f.events["wave_done_s"] = time.monotonic() - t_start
    f.events["wave_wall_s"] = f.events["wave_done_s"] - t_wave
    f.stats = router.stats()
    yield from f.drain(60.0)
    f.events["drained_s"] = time.monotonic() - t_start


def _layout_rank_checks(reports, problems):
    """The layout fleet's ranks, from their stats files: the 4 ranks of
    each live incarnation (the prefill replica's and the decode
    relaunch's); each decode rank's paged-decode launches == its decode
    steps x layers, all at ``TP_HEADS``, a follower's decode calls the
    leader's decode steps (the warmup's included); the prefill ranks
    launch none; every follower exited 0 after its release."""
    want_runs = {"replica0-i0", "replica0-i0.rank1", "replica1-i1", "replica1-i1.rank1"}
    if not want_runs <= set(reports):
        problems.append(f"layout: missing rank stats {sorted(want_runs - set(reports))}")
        return
    for run in sorted(want_runs):
        rep = reports[run]
        steps = rep["decode_steps"]
        launched = sum(rep["launches"].values())
        if rep["role"] == "prefill":
            ok = launched == 0 and steps == 0
        else:
            want = steps * FLEET_LAYERS
            ok = steps > 0 and launched == want and rep["head_launches"] == {TP_HEADS: want}
        if not ok:
            problems.append(f"layout {run}: launches {rep['launches']} by heads "
                            f"{rep['head_launches']} for {steps} decode steps ({rep['role']})")
    for leader in ("replica0-i0", "replica1-i1"):
        lead, rank = reports[leader], reports[f"{leader}.rank1"]
        if lead["follower_exits"] != [0]:
            problems.append(f"layout {leader}: follower exits {lead['follower_exits']}")
        if rank["decode_steps"] != lead["decode_steps"] + lead["warmup_decode_steps"]:
            problems.append(f"layout {leader}: rank 1 ran {rank['decode_steps']} decode steps, "
                            f"the leader {lead['decode_steps']} + "
                            f"{lead['warmup_decode_steps']} warmup")


def phase_fleet(state):
    """Two fleets on the one card, ticked in one loop (module docstring,
    phase 8): the layout fleet (two replicas of ``serve_layout="tp=2"``:
    four processes, two gloo worlds), then the one-card fleet (three
    ``SubprocessReplica`` children), the same wave against one in-process
    reference."""
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.models.llama import init_llama_params
    from fms_fsdp_tpu_torch.resilience.faults import configure_faults
    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config

    state.pop("params", None)  # the serve phases' 16 GB of bf16 weights
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_model_config("llama3_8b"), nlayers=FLEET_LAYERS)
    scfg = {"max_batch": 8, "max_seq_len": 1024, "compute_dtype": "float32"}
    rng = np.random.RandomState(FLEET_SEED)
    prompts = [rng.randint(0, cfg.src_vocab_size, size=int(m)).tolist()
               for m in rng.randint(FLEET_PROMPT[0], FLEET_PROMPT[1] + 1, size=FLEET_REQUESTS)]

    one = _FleetRun("fleet", cfg, scfg, 3, faults=f"replica_kill:replica=1:step={FLEET_KILL_STEP}")
    lay = _FleetRun("fleet_layout", cfg, dict(scfg, serve_layout=FLEET_LAYOUT), 2)
    fleets = (one, lay)
    total = torch.cuda.mem_get_info()[1]
    peak, t_mem = {"used_bytes": 0}, 0.0
    try:
        # the layout fleet starts first; its children import torch while
        # the reference runs here
        t_start = time.monotonic()
        lay.start()
        # the reference: one unified engine in this process, the same weights
        t0 = time.perf_counter()
        params = init_llama_params(torch.Generator(device="cuda").manual_seed(FLEET_SEED), cfg)
        ref = ServingEngine(params, cfg, ServeConfig(**scfg), seed=0)
        rreqs = [ref.submit(p, FLEET_NEW) for p in prompts]
        ref.run()
        ref_tokens = [list(r.generated) for r in rreqs]
        ref_s = time.perf_counter() - t0
        del ref, params, rreqs
        gc.collect()
        torch.cuda.empty_cache()
        # the router's own sender corrupts one chunk on its way to a replica
        # (replica 2: the one-card fleet's only)
        configure_faults("handoff_chunk_corrupt:transport=rtr2:times=1")
        scripts = {lay: _layout_fleet(lay, prompts, t_start),
                   one: _one_card_fleet(one, prompts, t_start, after=lay)}
        while scripts:
            for f, script in list(scripts.items()):
                f.tick()
                try:
                    next(script)
                except StopIteration:
                    del scripts[f]
                    f.shutdown()  # its children's memory back for the other
            now = time.monotonic()
            if now - t_mem > 0.1:
                t_mem = now
                used = total - torch.cuda.mem_get_info()[0]
                if used > peak["used_bytes"]:
                    peak = {"used_bytes": used, "total_bytes": total,
                            "this_process_reserved_bytes": torch.cuda.memory_reserved(),
                            "at_s": now - t_start,
                            "children": len(one.sup.live_indices())
                            + TP_SIZE * len(lay.sup.live_indices())}
            if now - t_start > 420:
                raise TimeoutError(f"fleet phase stuck: {one.events} {lay.events}")
            time.sleep(0.001)
    except BaseException:
        for f in fleets:
            _fleet_dump(f.router, f.workdir, f.log)
        raise
    finally:
        configure_faults(None)
        for f in fleets:
            f.shutdown()

    ledger, reports, figures = one.read(ref_tokens)
    journal = [json.loads(line) for line in open(os.path.join(one.workdir, "journal.jsonl"))]
    begun = {e["transfer_id"]: e["t"] for e in journal if e["event"] == "transfer_begin"}
    transfer_s = [e["t"] - begun[e["transfer_id"]] for e in journal
                  if e["event"] == "transfer_complete" and e["transfer_id"] in begun]
    lay_ledger, lay_reports, lay_figures = lay.read(ref_tokens)
    stats = one.stats
    result = {
        "model": "llama3_8b", "layers": FLEET_LAYERS, "dtype": "float32",
        "replicas": {"prefill": 1, "decode": 2}, "transport": "chunked",
        "requests": FLEET_REQUESTS, "max_new_tokens": FLEET_NEW, **figures,
        "handoff_bytes": stats["handoff_bytes"],
        "transfer_s": {"count": len(transfer_s), "p50": _pct(transfer_s, 0.5),
                       "max": max(transfer_s) if transfer_s else None},
        "reference_s": ref_s,
        "children": {run: {k: rep[k] for k in ("role", "decode_steps", "launches",
                                                "startup_s", "startup_parts", "loop_s",
                                                "iterations", "layers")}
                     for run, rep in reports.items()},
        "layout": {
            "serve_layout": FLEET_LAYOUT, "replicas": {"prefill": 1, "decode": 1},
            "processes": TP_SIZE * 2, **lay_figures,
            "kill_to_ready_s": lay.events.get("kill_to_ready_s"),
            "wave_wall_s": lay.events.get("wave_wall_s"),
            "ranks": {run: {k: rep.get(k) for k in ("role", "decode_steps", "launches",
                                                     "head_launches", "startup_s",
                                                     "startup_parts", "loop_s", "iterations",
                                                     "follower_exits")}
                      for run, rep in lay_reports.items()},
        },
        "peak_card_bytes": peak, "phase_s": time.perf_counter() - t_phase,
        "nvidia_smi": state["smi"],
    }
    emit("fleet", **result)
    state["fleet"] = result
    problems = []
    if not result["completed_once"] or result["tokens_equal_reference"] != FLEET_REQUESTS:
        problems.append("a request did not complete once with the reference tokens")
    if not any(e["replica"] == 1 and e["classification"] == "replica_loss"
               for e in ledger["entries"]):
        problems.append("no replica_loss relaunch in the ledger")
    if not stats["availability"] < 1.0:
        problems.append(f"availability {stats['availability']}")
    if stats["chunks_resent"] < 1 or stats["drain_migrations"] < 1:
        problems.append(f"chunks_resent {stats['chunks_resent']}, "
                        f"drain_migrations {stats['drain_migrations']}")
    if result["schema_errors"]:
        problems.append(f"fleet stats: {result['schema_errors']}")
    decode_steps = 0
    for run, rep in reports.items():
        if rep["role"] == "prefill":
            ok = rep["launches"] == {"v1": 0, "v2": 0} and rep["decode_steps"] == 0
        else:
            decode_steps += rep["decode_steps"]
            ok = (rep["launches"]["v1"] == rep["decode_steps"] * FLEET_LAYERS
                  and rep["launches"]["v2"] == 0)
        if not ok:
            problems.append(f"{run}: launches {rep['launches']} for "
                            f"{rep['decode_steps']} decode steps ({rep['role']})")
    if "replica0-i0" not in reports or "replica2-i0" not in reports or not decode_steps:
        problems.append(f"missing child stats: {sorted(reports)}")
    # the layout fleet
    lay_result = result["layout"]
    if (not lay_result["completed_once"]
            or lay_result["tokens_equal_reference"] != FLEET_REQUESTS):
        problems.append("layout: a request did not complete once with the reference tokens")
    losses = [(e["replica"], e["incarnation"]) for e in lay_ledger["entries"]
              if e["classification"] == "replica_loss"]
    if losses != [(1, 0)] or len(lay_ledger["entries"]) != 3:
        problems.append(f"layout: ledger {lay_result['restarts']}, expected one replica_loss "
                        f"relaunch of replica 1 and two clean exits")
    if not lay.events.get("killed_with_streams") or lay.events["dead_ranks_alive_at_ready"]:
        problems.append(f"layout: the kill {lay.events}")
    if lay_result["schema_errors"]:
        problems.append(f"layout stats: {lay_result['schema_errors']}")
    _layout_rank_checks(lay_reports, problems)
    state["fleet_launches_v1"] = sum(r["launches"]["v1"] for r in reports.values())
    state["fleet_layout_launches"] = {key: sum(r["launches"][key] for r in lay_reports.values())
                                      for key in ("v1", "v2")}
    if problems:
        for f in fleets:
            _fleet_dump(f.router, f.workdir, f.log)
    for f in fleets:
        shutil.rmtree(f.workdir, ignore_errors=True)
    if problems:
        raise AssertionError("fleet: " + "; ".join(problems))


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
            # the 16-bit forward and dq kernels at both key tiles (128 the
            # default, 64), each held to the same bounds and controls; fp32
            # has one tile
            tiles = (128, 64) if kind == "bf16" else (None,)
            runs = {}
            for tile in tiles:
                fa.reset_launches()
                got = _flash_all(fa, q, k, v, do, kernel=True, block_k=tile)
                torch.cuda.synchronize()
                runs[tile] = (got, dict(fa.LAUNCHES),
                              {op: dict(t) for op, t in fa.TILE_LAUNCHES.items()})
            kv = "_kvgrid" if fa._use_kvgrid(sk) else ""
            ref = _flash_all(fa, q, k, v, do, kernel=False)
            names = ("o", "lse", "dq", "dk", "dv")
            if kind == "fp32":
                tols = [FLASH_FP32_REL_TOL * max(1.0, r.abs().max().item()) for r in ref]
                dist = control = None
            else:
                wide = _flash_all(fa, q.float(), k.float(), v.float(), do.float(), kernel=False)
                dist = [(r.float() - w).abs().max().item() for r, w in zip(ref, wide)]
                tols = [2 * d for d in dist]
                del wide
                control = _flash_control(fa, q, k, v, do)
            checked = {}
            for tile, (got, launched, by_tile) in runs.items():
                rel = per_block = None
                rel_ok = True
                if control is not None:
                    rel = {n: {"kernel": _rel_err(a, r_), "control": _rel_err(c, r_),
                               "tol": fa.BF16_REL_TOL[n]}
                           for n, a, c, r_ in zip(names, got, control, ref)}
                    rel_ok = all(x["kernel"] <= x["tol"] < x["control"] for x in rel.values())
                    per_block = _bwd_block_check(fa, q, k, v, do, got)
                    rel_ok = rel_ok and all(x["ok"] for x in per_block.values())
                errs = [(a.float() - r.float()).abs().max().item() for a, r in zip(got, ref)]
                finite = all(bool(torch.isfinite(a).all()) for a in got)
                zero_tail = (sk <= sq or (torch.count_nonzero(got[3][:, sq:]) == 0
                                          and torch.count_nonzero(got[4][:, sq:]) == 0))
                tile_ok = tile is None or all(
                    by_tile[c] == {t: int(t == tile and c in ("fwd" + kv, "dq" + kv))
                                   for t in by_tile[c]} for c in by_tile)
                checked[tile] = {
                    "block_k": tile, "launches": launched, "launches_by_block_k": by_tile,
                    "max_abs_err": dict(zip(names, errs)),
                    "rel_err_vs_plain_bf16": rel, "per_block_rel_err": per_block,
                    "finite": finite, "zero_dkv_past_last_query": bool(zero_tail),
                    "ok": (finite and bool(zero_tail) and rel_ok and tile_ok
                           and all(e <= t for e, t in zip(errs, tols))
                           and launched["fwd" + kv] == 1 and launched["dq" + kv] == 1
                           and launched["dkv"] == 1),
                }
            first = checked[tiles[0]]
            r = {
                "shape": {"B": b, "Sq": sq, "Sk": sk, "Nq": nq, "Nkv": nkv, "H": 128},
                "contract": "kvgrid" if kv else "resident",
                "tol": dict(zip(names, tols)),
                "plain_bf16_vs_fp32": dict(zip(names, dist)) if dist else None,
                **{key: first[key] for key in (
                    "launches", "max_abs_err", "rel_err_vs_plain_bf16", "per_block_rel_err",
                    "finite", "zero_dkv_past_last_query")},
            }
            if 64 in checked:
                r["block_k_64"] = checked[64]
            r["ok"] = all(c["ok"] for c in checked.values())
            del q, k, v, do, got, ref, runs, control
            torch.cuda.empty_cache()
            if name in FLASH_TIMED:
                shape = (b, sq, sk, nq, nkv)
                r["times"] = _flash_times(fa, kind, dtype, shape, gen, block_k=tiles[0])
                if kind == "bf16":
                    r["times_block_k_64"] = _flash_times(fa, kind, dtype, shape, gen,
                                                         block_k=64, base=r["times"])
                torch.cuda.empty_cache()
            emit("flash", dtype=kind, case=name, **r)
            results[(kind, name)] = r
            if not r["ok"]:
                bad.append(f"{kind}/{name}")
    state["flash"] = results
    if bad:
        raise AssertionError(f"flash kernels disagree with their plain versions: {bad}")


# ---------------------------------------------------------------------------
# the ring: long context (ops/ring_attention.py, ops/ssd.py::ssd_scan_cp)
# ---------------------------------------------------------------------------

# the non-causal and fp32-dq contracts at the flash phase's training shape
# (B, S, Nq, Nkv)
RING_CONTRACT_SHAPE = (2, 4096, 32, 8)
# the ring at llama3_8b's attention widths: (B, S, Nq, Nkv, cp), every
# chunk on the one card (LocalRing); S / cp = 8192, the resident contract
RING_FULL = (1, 32768, 32, 8, 4)
RING_SMALL = (1, 4096, 32, 8, 4)
# the control ring leaves out one visible chunk: context rank 3's view of
# chunk 1
RING_DROP = (3, 1)
# the ring through the Llama model: llama3_8b at (layers, S, cp)
RING_MODEL = (2, 16384, 4)
# ssd_scan_cp at mamba_9.8b's SSD widths: (B, S, H, G, L, cp)
RING_SSD = (1, 16384, 128, 1, 256, 4)
# the ring through the Mixtral model: mixtral_8x7b at (layers, S, cp,
# capacity factor); at the default 2.0 random weights drop nothing, so
# the whole sequence's routing would go untested
RING_MOE = (2, 16384, 4, 1.0)


def _noncausal_times(fa, q, k, v, do, lse, delta):
    """CUDA-event ms of the non-causal forward, dq, dk/dv and the fp32-output
    dq (key tile 128) beside their plain versions, SDPA's non-causal
    forward and backward, and each bound."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, nq, _ = q.shape
    nkv = k.shape[2]
    f32 = torch.float32
    kernel = {
        "fwd": lambda i: fa.flash_fwd(q, k, v, causal=False),
        "dq": lambda i: fa.flash_dq(q, k, v, do, lse, delta, causal=False),
        "dkv": lambda i: fa.flash_dkv(q, k, v, do, lse, delta, causal=False),
        "dq_f32": lambda i: fa.flash_dq(q, k, v, do, lse, delta, causal=False, out_dtype=f32),
    }
    plain = {
        "fwd": lambda i: fa.flash_fwd_plain(q, k, v, causal=False),
        "dq": lambda i: fa.flash_dq_plain(q, k, v, do, lse, delta, causal=False),
        "dkv": lambda i: fa.flash_dkv_plain(q, k, v, do, lse, delta, causal=False),
        "dq_f32": lambda i: fa.flash_dq_plain(q, k, v, do, lse, delta, causal=False,
                                              out_dtype=f32),
    }
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        ot = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
    dot = do.transpose(1, 2)

    def lib_fwd(i):
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]), torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)

    lib_fwd_ms = _timed_ms(lib_fwd)
    lib_bwd_ms = _timed_ms(lambda i: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                         retain_graph=True))
    qb, kvb, stat = b * s * nq * 128 * 2, b * s * nkv * 128 * 2, b * nq * s * 4
    nbytes = {"fwd": 2 * qb + 2 * kvb + stat, "dq": 3 * qb + 2 * kvb + 2 * stat,
              "dkv": 2 * qb + 2 * kvb + 2 * stat + 4 * kvb, "dq_f32": 4 * qb + 2 * kvb + 2 * stat}
    products = {"fwd": 2, "dq": 3, "dkv": 4, "dq_f32": 3}
    out = {}
    for name in kernel:
        ops = float(2 * products[name] * b * nq * 128 * s * s)  # every (query, key) pair
        bytes_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS["bf16"] * 1e3
        ms = _timed_ms(kernel[name])
        out[name] = {"ms": ms, "plain_ms": _plain_ms(plain[name]),
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "achieved_tflops": ops / ms / 1e9,
                     "library_ms": lib_fwd_ms if name == "fwd" else lib_bwd_ms}
    return out


def _ring_contracts(fa, gen, problems):
    """The non-causal forward, dq and dk/dv at both key tiles and the
    fp32-output dq, each against its plain version (see the phase)."""
    import torch

    b, s, nq, nkv = RING_CONTRACT_SHAPE
    q, do = (torch.randn((b, s, nq, 128), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((b, s, nkv, 128), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    names = ("o", "lse", "dq", "dk", "dv")
    ref = _flash_all(fa, q, k, v, do, kernel=False, causal=False)
    wide = _flash_all(fa, q.float(), k.float(), v.float(), do.float(), kernel=False,
                      causal=False)
    tols = [2 * (r.float() - w).abs().max().item() for r, w in zip(ref, wide)]
    del wide
    control = _flash_control(fa, q, k, v, do, causal=False)
    out = {"shape": {"B": b, "S": s, "Nq": nq, "Nkv": nkv, "H": 128},
           "tol": dict(zip(names, tols))}
    for tile in (128, 64):
        fa.reset_launches()
        got = _flash_all(fa, q, k, v, do, kernel=True, block_k=tile, causal=False)
        lse, delta = got[1], _delta(got[0], do)
        dq32 = fa.flash_dq(q, k, v, do, lse, delta, causal=False, block_k=tile,
                           out_dtype=torch.float32)
        torch.cuda.synchronize()
        launched = dict(fa.MODE_LAUNCHES)
        rel = {n: {"kernel": _rel_err(a, r_), "control": _rel_err(c, r_),
                   "tol": fa.BF16_REL_TOL[n]}
               for n, a, c, r_ in zip(names, got, control, ref)}
        per_block = _bwd_block_check(fa, q, k, v, do, got, causal=False)
        errs = [(a.float() - r_.float()).abs().max().item() for a, r_ in zip(got, ref)]
        # the fp32-output dq: per 128-row block against the plain fp32-output
        # dq on the same stats, with the dropped-tile control; rounded to
        # bf16 it is the 16-bit kernel's dq bit for bit
        ref32 = fa.flash_dq_plain(q, k, v, do, lse, delta, causal=False,
                                  out_dtype=torch.float32)
        ctl32 = fa.flash_bwd_drop_tile_plain(
            q, k, v, do, lse, delta, ref32, *ref[3:], batch=0, head=0,
            q_tile=s // fa.BWD_Q_TILE - 1, k_block=0, causal=False)[0]
        blk, blk_ctl = fa.block_rel_err(dq32, ref32), fa.block_rel_err(ctl32, ref32)
        changed = blk_ctl > 0
        tol = fa.BF16_BLOCK_REL_TOL["dq"]
        dq_f32 = {"dtype": str(dq32.dtype), "max_abs_err": (dq32 - ref32).abs().max().item(),
                  "per_block_max": blk.max().item(), "tol": tol,
                  "control_min": blk_ctl[changed].min().item() if changed.any() else None,
                  "control_blocks": int(changed.sum()),
                  "rounded_equals_16bit_dq": bool(torch.equal(dq32.to(q.dtype), got[2]))}
        dq_f32["ok"] = (dq32.dtype == torch.float32 and dq_f32["per_block_max"] <= tol
                        and dq_f32["control_blocks"] == 1 and dq_f32["control_min"] > tol
                        and dq_f32["rounded_equals_16bit_dq"])
        want = {"fwd_noncausal": 1, "dq_noncausal": 2, "dkv_noncausal": 1, "dq_f32": 1}
        r = {"block_k": tile, "launches": launched, "max_abs_err": dict(zip(names, errs)),
             "rel_err_vs_plain_bf16": rel, "per_block_rel_err": per_block, "dq_f32": dq_f32,
             "finite": all(bool(torch.isfinite(a).all()) for a in got)}
        r["ok"] = (r["finite"] and launched == want and dq_f32["ok"]
                   and all(e <= t for e, t in zip(errs, tols))
                   and all(x["kernel"] <= x["tol"] < x["control"] for x in rel.values())
                   and all(x["ok"] for x in per_block.values()))
        out[f"block_k_{tile}"] = r
        if not r["ok"]:
            problems.append(f"non-causal / fp32-dq contracts at block_k={tile}")
        if tile == 128:
            out["times"] = _noncausal_times(fa, q, k, v, do, lse, delta)
        del got, dq32, ref32, ctl32
    return out


@contextlib.contextmanager
def _dropped_chunk(ring_mod, drop):
    """Rings that leave out the visible chunk ``drop`` (context rank,
    chunk): the control of the ring's checks. None leaves them whole."""
    relation = ring_mod._relation
    if drop is not None:
        ring_mod._relation = lambda idx, src, causal: (
            None if (idx, src) == drop else relation(idx, src, causal))
    try:
        yield
    finally:
        ring_mod._relation = relation


def _ring_run(ring_mod, q, k, v, do, cp, drop=None):
    """[o, dq, dk, dv] of ring attention over a LocalRing of ``cp``; with
    ``drop`` (context rank, chunk) that visible chunk is left out."""
    import torch

    with _dropped_chunk(ring_mod, drop):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = ring_mod.ring_attention(*leaves, ring_mod.LocalRing(cp), causal=True)
        grads = torch.autograd.grad(o, leaves, do)
        return [o.detach(), *grads]


@contextlib.contextmanager
def _plain_partials(fa):
    """The ring's partials through the plain versions (on card tensors)."""
    saved = fa.flash_fwd, fa.flash_dq, fa.flash_dkv
    fa.flash_fwd = lambda q, k, v, causal, scale, block_k=None: fa.flash_fwd_plain(
        q, k, v, causal=causal, scale=scale)
    fa.flash_dq = lambda *a, causal, scale, block_k=None, out_dtype=None: fa.flash_dq_plain(
        *a, causal=causal, scale=scale, out_dtype=out_dtype)
    fa.flash_dkv = lambda *a, causal, scale, q2=None: fa.flash_dkv_plain(
        *a, causal=causal, scale=scale)
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_dq, fa.flash_dkv = saved


def _ring_full(fa, ring_mod, gen, problems):
    """The ring at S=32768, cp=4 against the full-sequence kernels."""
    import torch

    b, s, nq, nkv, cp = RING_FULL
    q, do = (torch.randn((b, s, nq, 128), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((b, s, nkv, 128), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    # the main path of the phase: counts zeroed just before, read just after
    fa.reset_launches()
    got = _ring_run(ring_mod, q, k, v, do, cp)
    torch.cuda.synchronize()
    launched = {"by_contract": dict(fa.LAUNCHES), "by_mode": dict(fa.MODE_LAUNCHES),
                "by_block_k": {c: dict(t) for c, t in fa.TILE_LAUNCHES.items()}}
    n_diag, n_vis = cp, cp * (cp - 1) // 2
    want = {"fwd": n_diag + n_vis, "fwd_kvgrid": 0, "dq": n_diag + n_vis, "dq_kvgrid": 0,
            "dkv": n_diag + n_vis}
    want_mode = {"fwd_noncausal": n_vis, "dq_noncausal": n_vis, "dkv_noncausal": n_vis,
                 "dq_f32": n_diag + n_vis}
    # the full-sequence kernels (the kvgrid contracts at this length), their
    # dk/dv rounded to bf16 as autograd returns them; and the plain versions
    # on the inputs widened to fp32
    full = _flash_all(fa, q, k, v, do, kernel=True)
    full = [full[0], full[2], full[3].to(k.dtype), full[4].to(v.dtype)]
    wide = _flash_all(fa, q.float(), k.float(), v.float(), do.float(), kernel=False)
    wide = [wide[0], wide[2], wide[3], wide[4]]
    names = ("o", "dq", "dk", "dv")
    tols = {n: 2 * _rel_err(f, w) for n, f, w in zip(names, full, wide)}
    del wide
    control = _ring_run(ring_mod, q, k, v, do, cp, drop=RING_DROP)
    rel = {n: {"ring": _rel_err(a, f), "control": _rel_err(c, f), "tol": tols[n],
               "max_abs_err": (a.float() - f.float()).abs().max().item()}
           for n, a, c, f in zip(names, got, control, full)}
    del control
    res = {"shape": {"B": b, "S": s, "Nq": nq, "Nkv": nkv, "H": 128, "cp": cp,
                     "S_local": s // cp},
           "exchange": "LocalRing (every chunk on this card)",
           "bytes": {"q": q.numel() * 2, "k": k.numel() * 2, "v": v.numel() * 2},
           "launches": launched, "expected_launches": {"by_contract": want,
                                                         "by_mode": want_mode},
           "rel_err_vs_full_sequence_kernels": rel,
           "finite": all(bool(torch.isfinite(a).all()) for a in got)}
    res["ok"] = (res["finite"] and launched["by_contract"] == want
                 and launched["by_mode"] == want_mode
                 and all(x["ring"] <= x["tol"] < x["control"] for x in rel.values()))
    if not res["ok"]:
        problems.append("the S=32768 ring against the full-sequence kernels")

    def full_autograd(i):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        torch.autograd.grad(fa.flash_attention(*leaves), leaves, do)

    res["ring_fwd_bwd_ms"] = _timed_ms(lambda i: _ring_run(ring_mod, q, k, v, do, cp), 2000, 5)
    res["full_sequence_fwd_bwd_ms"] = _timed_ms(full_autograd, 2000, 5)
    res["ring_over_full"] = res["ring_fwd_bwd_ms"] / res["full_sequence_fwd_bwd_ms"]
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    del got, full
    return res


def _ring_small(fa, ring_mod, gen, problems):
    """The ring at S=4096, cp=4 against the ring through the plain versions,
    within twice the plain bf16 ring's distance from the plain fp32 ring."""
    import torch

    b, s, nq, nkv, cp = RING_SMALL
    q, do = (torch.randn((b, s, nq, 128), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((b, s, nkv, 128), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    got = _ring_run(ring_mod, q, k, v, do, cp)
    with _plain_partials(fa):
        plain = _ring_run(ring_mod, q, k, v, do, cp)
        wide = _ring_run(ring_mod, q.float(), k.float(), v.float(), do.float(), cp)
    names = ("o", "dq", "dk", "dv")
    rel = {n: {"ring": _rel_err(a, p_), "tol": 2 * _rel_err(p_, w)}
           for n, a, p_, w in zip(names, got, plain, wide)}
    res = {"shape": {"B": b, "S": s, "Nq": nq, "Nkv": nkv, "cp": cp},
           "rel_err_vs_plain_ring": rel}
    res["ok"] = all(x["ring"] <= x["tol"] for x in rel.values())
    if not res["ok"]:
        problems.append("the S=4096 ring against the plain ring")
    return res


def _ring_ssd(gen, problems):
    """ssd_scan_cp (LocalRing) against ssd_scan through the SSD kernel."""
    import torch

    from fms_fsdp_tpu_torch.ops import ssd
    from fms_fsdp_tpu_torch.ops.ring_attention import LocalRing

    b, s, h, g, chunk, cp = RING_SSD
    x, dt, _, bm, cm, a_neg = _ssd_inputs(gen, torch.bfloat16, b, s, h, g)
    with torch.no_grad():
        ssd.reset_launches()
        y = ssd.ssd_scan(x, dt, a_neg, bm, cm, chunk_size=chunk, kernel="pallas")
        torch.cuda.synchronize()
        kernel_launches = dict(ssd.LAUNCHES)
        ssd.reset_launches()
        ycp = ssd.ssd_scan_cp(x, dt, a_neg, bm, cm, ring=LocalRing(cp), chunk_size=chunk)
        torch.cuda.synchronize()
        cp_launches = dict(ssd.LAUNCHES)
        y32 = ssd.ssd_scan(x.float(), dt, a_neg, bm.float(), cm.float(), chunk_size=chunk,
                           kernel="xla")
        # the control: each rank's scan from a zero state, no carried state
        alone = torch.cat([ssd.ssd_scan(*(t[:, i * s // cp:(i + 1) * s // cp]
                                          for t in (x, dt)), a_neg,
                                        *(t[:, i * s // cp:(i + 1) * s // cp]
                                          for t in (bm, cm)),
                                        chunk_size=chunk, kernel="pallas")
                           for i in range(cp)], dim=1)
        tol = 2 * _rel_err(y, y32)
        res = {"shape": {"B": b, "S": s, "H": h, "P": 64, "G": g, "N": 128, "L": chunk,
                         "cp": cp},
               "rel_err_vs_kernel": _rel_err(ycp, y), "rel_err_vs_fp32": _rel_err(ycp, y32),
               "kernel_rel_err_vs_fp32": _rel_err(y, y32), "tol": tol,
               "control_rel_err_vs_kernel": _rel_err(alone, y),
               "max_abs_err_vs_kernel": (ycp.float() - y.float()).abs().max().item(),
               "kernel_launches": kernel_launches, "cp_launches": cp_launches}
        del y32, alone
        res["ssd_scan_cp_ms"] = _timed_ms(lambda i: ssd.ssd_scan_cp(
            x, dt, a_neg, bm, cm, ring=LocalRing(cp), chunk_size=chunk), 1000, 5)
        res["ssd_scan_kernel_ms"] = _timed_ms(lambda i: ssd.ssd_scan(
            x, dt, a_neg, bm, cm, chunk_size=chunk, kernel="pallas"), 1000, 10)
    res["ok"] = (res["rel_err_vs_kernel"] <= tol and res["rel_err_vs_fp32"] <= tol
                 < res["control_rel_err_vs_kernel"] and kernel_launches["fused"] == 1
                 and cp_launches["fused"] == 0 and bool(torch.isfinite(ycp).all()))
    if not res["ok"]:
        problems.append("ssd_scan_cp against ssd_scan")
    return res


def _ring_model(fa, ring_mod, problems):
    """The ring through the Llama forward and backward (``llama_forward``
    with ``ring``): llama3_8b at full width, ``RING_MODEL`` layers and
    tokens, against the same model on the whole sequence (the flash
    kernels), each against the whole-sequence model in fp32."""
    import torch

    from fms_fsdp_tpu_torch.models.llama import init_llama_params, llama_forward
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config
    from fms_fsdp_tpu_torch.utils.tree import tree_map

    n, s, cp = RING_MODEL
    cfg = dataclasses.replace(get_model_config("llama3_8b"), nlayers=n)
    gen = torch.Generator(device="cuda").manual_seed(19)
    params = init_llama_params(gen, cfg, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.src_vocab_size, (1, s), generator=gen, device="cuda")
    # a seeded cotangent of the hidden states (their squares' mean is ~1
    # whatever the weights: the final RMSNorm, so its gradient is noise)
    cot = torch.randn((1, s, cfg.emb_dim), generator=gen, device="cuda")
    names = ("wq", "wk", "wv", "wo")

    def run(p, ring=None, drop=None, dtype=torch.bfloat16):
        for w in p["layers"].values():
            w.requires_grad_(True)
        with _dropped_chunk(ring_mod, drop):
            hidden = llama_forward(p, tokens, cfg, compute_dtype=dtype, return_hidden=True,
                                   ring=ring)
            grads = torch.autograd.grad(hidden, [p["layers"][k] for k in names],
                                        cot.to(hidden.dtype))
            return [hidden.detach(), *grads]

    fa.reset_launches()
    got = run(params, ring_mod.LocalRing(cp))
    torch.cuda.synchronize()
    launched = {"by_contract": dict(fa.LAUNCHES), "by_mode": dict(fa.MODE_LAUNCHES)}
    per_layer, vis = cp + cp * (cp - 1) // 2, cp * (cp - 1) // 2
    want = {"by_contract": {"fwd": n * per_layer, "fwd_kvgrid": 0, "dq": n * per_layer,
                            "dq_kvgrid": 0, "dkv": n * per_layer},
            "by_mode": {"fwd_noncausal": n * vis, "dq_noncausal": n * vis,
                        "dkv_noncausal": n * vis, "dq_f32": n * per_layer}}
    whole = run(params)
    control = run(params, ring_mod.LocalRing(cp), drop=RING_DROP)
    wide = run(tree_map(lambda w: w.detach().float(), params), dtype=torch.float32)
    rel = {}
    for name, a, w, c, f in zip(("hidden",) + names, got, whole, control, wide):
        tol = 2 * _rel_err(w, f)
        rel[name] = {"ring": _rel_err(a, f), "whole": _rel_err(w, f), "tol": tol,
                     "control": _rel_err(c, f), "ring_vs_whole": _rel_err(a, w)}
    res = {"model": "llama3_8b", "layers": n, "tokens": s, "cp": cp,
           "launches": launched, "expected_launches": want,
           "rel_err_vs_fp32_whole_sequence": rel,
           "finite": all(bool(torch.isfinite(a).all()) for a in got)}
    res["ok"] = (res["finite"] and launched == want
                 and all(x["ring"] <= x["tol"] < x["control"] for x in rel.values()))
    if not res["ok"]:
        problems.append("the ring through the Llama forward and backward")
    del params, got, whole, control, wide
    return res


def _ring_moe(fa, ring_mod, problems):
    """The ring through the Mixtral forward and backward (``mixtral_forward``
    with ``ring``, the capacity dispatch): mixtral_8x7b at full width,
    ``RING_MOE`` layers and tokens, bf16, against the same model on the
    whole sequence, each against the whole-sequence model in fp32; the
    chunks' routing against ``_priority_slots`` of the whole sequence."""
    import torch

    from fms_fsdp_tpu_torch.models import mixtral as tm
    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config
    from fms_fsdp_tpu_torch.utils.tree import tree_map

    n, s, cp, cf = RING_MOE
    cfg = dataclasses.replace(get_model_config("mixtral_8x7b"), nlayers=n,
                              capacity_factor=cf)
    gen = torch.Generator(device="cuda").manual_seed(29)
    params = tm.init_mixtral_params(gen, cfg, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.src_vocab_size, (1, s), generator=gen, device="cuda")
    cot = torch.randn((1, s, cfg.emb_dim), generator=gen, device="cuda")
    names = ("wq", "wk", "wv", "wo")
    routed = []
    context_slots = tm.context_slots

    def recording(top_idx, ring, E, C):
        out = context_slots(top_idx, ring, E, C)
        routed.append(([t.clone() for t in top_idx], [(a.clone(), b.clone()) for a, b in out],
                       C))
        return out

    def run(p, ring=None, drop=None, dtype=torch.bfloat16):
        leaves = [p["layers"][k].requires_grad_(True) for k in names]
        with _dropped_chunk(ring_mod, drop):
            hidden, aux = tm.mixtral_forward(p, tokens, cfg, compute_dtype=dtype,
                                             moe_impl="dispatch", return_hidden=True,
                                             return_aux=True, ring=ring)
            grads = torch.autograd.grad(hidden, leaves, cot.to(hidden.dtype))
        return [hidden.detach(), *grads], float(aux["drop_frac"])

    def timed(*a, **k):
        """run(), and its wall ms ended by a synchronize (one call)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(*a, **k)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    tm.context_slots = recording
    try:
        (got, drop_frac), ring_ms = timed(params, ring_mod.LocalRing(cp))
    finally:
        tm.context_slots = context_slots
    launched = {"by_contract": dict(fa.LAUNCHES), "by_mode": dict(fa.MODE_LAUNCHES)}
    per_layer, vis = cp + cp * (cp - 1) // 2, cp * (cp - 1) // 2
    want = {"by_contract": {"fwd": n * per_layer, "fwd_kvgrid": 0, "dq": n * per_layer,
                            "dq_kvgrid": 0, "dkv": n * per_layer},
            "by_mode": {"fwd_noncausal": n * vis, "dq_noncausal": n * vis,
                        "dkv_noncausal": n * vis, "dq_f32": n * per_layer}}
    # the routing: bit for bit the whole sequence's priority slots over the
    # run's own choices at the whole length's capacity; the control, each
    # chunk routed alone at the capacity of its own length, differs
    routing = []
    for top_idx, out, C in routed:
        slot, keep = tm._priority_slots(torch.cat(top_idx, 1), cfg.num_experts, C)
        local = [tm._priority_slots(t, cfg.num_experts, tm.moe_capacity(cfg, s // cp))
                 for t in top_idx]
        routing.append({
            "capacity": C, "capacity_chunk_local": tm.moe_capacity(cfg, s // cp),
            "slot_equal": bool(torch.equal(torch.cat([a for a, _ in out], 1), slot)),
            "keep_equal": bool(torch.equal(torch.cat([b for _, b in out], 1), keep)),
            "dropped_share": 1.0 - float(keep.float().mean()),
            "control_keep_differs": not torch.equal(torch.cat([b for _, b in local], 1), keep),
            "control_slot_differs": not torch.equal(torch.cat([a for a, _ in local], 1), slot),
        })
    del routed
    (whole, whole_drop), whole_ms = timed(params)
    control, _ = run(params, ring_mod.LocalRing(cp), drop=RING_DROP)
    wide, wide_drop = run(tree_map(lambda w: w.detach().float(), params), dtype=torch.float32)
    rel = {}
    for name, a, w, c, f in zip(("hidden",) + names, got, whole, control, wide):
        tol = 2 * _rel_err(w, f)
        rel[name] = {"ring": _rel_err(a, f), "whole": _rel_err(w, f), "tol": tol,
                     "control": _rel_err(c, f), "ring_vs_whole": _rel_err(a, w)}
    res = {"model": "mixtral_8x7b", "layers": n, "tokens": s, "cp": cp,
           "capacity_factor": cf, "moe_impl": "dispatch",
           "reduced": {"layers": f"{n} of 32"},
           "moe_drop_frac": {"ring": drop_frac, "whole": whole_drop, "fp32_whole": wide_drop},
           "routing": routing, "launches": launched, "expected_launches": want,
           "rel_err_vs_fp32_whole_sequence": rel,
           # one call each, the ring's with its routing recorded
           "fwd_bwd_wall_ms": {"ring": ring_ms, "whole": whole_ms},
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "finite": all(bool(torch.isfinite(a).all()) for a in got)}
    res["ok"] = (res["finite"] and launched == want and len(routing) == n
                 and all(r["slot_equal"] and r["keep_equal"] and r["control_keep_differs"]
                         and r["dropped_share"] > 0 for r in routing)
                 and all(x["ring"] <= x["tol"] < x["control"] for x in rel.values()))
    if not res["ok"]:
        problems.append("the ring through the Mixtral forward and backward")
    del params, got, whole, control, wide
    return res


def phase_ring(state):
    """Long context on the card (see the module docstring)."""
    import torch

    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import ring_attention as ring_mod

    t0 = time.perf_counter()
    state.pop("params", None)  # the serve phases' weights
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(18)
    problems = []
    result = {"nvidia_smi": state["smi"],
              "contracts": _ring_contracts(fa, gen, problems)}
    torch.cuda.empty_cache()
    result["ring"] = _ring_full(fa, ring_mod, gen, problems)
    torch.cuda.empty_cache()
    result["ring_small"] = _ring_small(fa, ring_mod, gen, problems)
    torch.cuda.empty_cache()
    result["ring_model"] = _ring_model(fa, ring_mod, problems)
    torch.cuda.empty_cache()
    t_moe = time.perf_counter()
    result["ring_moe"] = _ring_moe(fa, ring_mod, problems)
    result["ring_moe"]["seconds"] = time.perf_counter() - t_moe
    torch.cuda.empty_cache()
    result["ssd_scan_cp"] = _ring_ssd(gen, problems)
    torch.cuda.empty_cache()
    result["exchange_across_cards"] = ("not verified: one card (GroupRing over NCCL needs "
                                       "one process a card)")
    result["seconds"] = time.perf_counter() - t0
    emit("ring", **result)
    state["ring"] = result
    if problems:
        raise AssertionError("ring: " + "; ".join(problems))


def _train_step_profile(res, steps=1, moe=False):
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
    from fms_fsdp_tpu_torch.tune import lookup

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
    by_tile = {c: dict(t) for c, t in fa.TILE_LAUNCHES.items()}
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
        launches_by_block_k=by_tile, tuning=lookup.choices(), expected_launches=want,
        max_memory_allocated=peak,
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
# the kernel tuner: cost model, committed table, tiles on the main path
# ---------------------------------------------------------------------------

# one step of the Llama entry at llama3_8b_4k width, 2 layers
TUNE_KW = {"LlamaConfig.nlayers": 2, "num_steps": 1, "report_interval": 1}
# (label, TrainConfig overrides, key tile of a table written for the run or
# None): the committed table (through the fused CE, so its CE chunk
# engages too), tuning off, and a table pinning the 64-key tile, each
# contract: every (contract, key tile) launches on the main path
TUNE_RUNS = (
    ("auto", {"fused_loss": True}, None),
    ("off", {"kernel_tuning": "off"}, None),
    ("table_64", {}, 64),
    ("off_kvgrid", {"kernel_tuning": "off", "flash_kernel_variant": "kvgrid"}, None),
    ("table_64_kvgrid", {"flash_kernel_variant": "kvgrid"}, 64),
)


def _autotune_script():
    """scripts/torch_autotune_kernels.py as a module (its suite and
    ``lookup_suite``)."""
    import importlib.util

    path = os.path.join(REPO, "scripts", "torch_autotune_kernels.py")
    spec = importlib.util.spec_from_file_location("torch_autotune_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smem_model_check():
    """{kernel and tile: (C function's bytes, the cost model's)}."""
    from fms_fsdp_tpu_torch.ops import cuda_build
    from fms_fsdp_tpu_torch.tune import candidates as cand

    fwd = cuda_build.load("flash_fwd_sm90").lib
    bwd = cuda_build.load("flash_bwd_sm90").lib
    scan = cuda_build.load("ssd_sm90").lib
    out = {}
    for bk in cand.FLASH_BLOCK_K_CHOICES:
        out[f"flash_fwd_sm90 block_k={bk}"] = (fwd.flash_fwd_sm90_smem_bytes(bk),
                                               cand.flash_fwd_smem_bytes(bk))
        out[f"flash_dq_sm90 block_k={bk}"] = (bwd.flash_bwd_sm90_smem_bytes(0, bk),
                                              cand.flash_dq_smem_bytes(bk))
    out["flash_dkv_sm90"] = (bwd.flash_bwd_sm90_smem_bytes(1, 128), cand.flash_dkv_smem_bytes())
    for heads in (128, 3):  # two heads a block, one
        sig = cand.ssd_sig((2, 4096, heads, 64), 1, 128)
        hb = cand.ssd_heads_per_block(sig)
        for chunk in (64, 128, 256):
            out[f"ssd_sm90 {hb} heads a block, L={chunk}"] = (
                scan.ssd_sm90_smem_bytes(hb, chunk), cand.ssd_smem_bytes(sig, "bfloat16", chunk))
    return out


def phase_tune(state):
    """The tuner on the card: the Hopper cost model's shared-memory bytes
    against each kernel's C function; every shape of the sweep's suite
    resolved through the committed table by exact hit; one Llama step a
    run (``TUNE_RUNS``) through the entry at full width, printing
    ``choices()`` and the launches by contract and key tile, each run's
    tile the one it asked for."""
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.tune import candidates as cand
    from fms_fsdp_tpu_torch.tune import lookup
    from fms_fsdp_tpu_torch.tune.table import TuningTable, default_table_path

    problems = []
    smem = _smem_model_check()
    bad = {k: v for k, v in smem.items() if v[0] != v[1]}
    if bad:
        problems.append(f"cost model != the kernels' shared memory: {bad}")
    chip = lookup.chip_kind()
    resolved = _autotune_script().lookup_suite(default_table_path(), chip)
    misses = [r for r in resolved if r["resolved"]["how"] != "exact"]
    if chip != "h100" or misses:
        problems.append(f"chip {chip!r}; suite shapes without an exact hit: {misses}")
    table = TuningTable.load(default_table_path())
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, over, pin in TUNE_RUNS:
            if pin is not None:
                t = TuningTable(json.loads(json.dumps(table.doc)), path=os.path.join(
                    tmp, f"{label}.json"))
                config, _ = table.lookup("flash_attention", "h100", "bfloat16",
                                         resolved[0]["signature"])
                t.add("flash_attention", "h100", "bfloat16", resolved[0]["signature"],
                      dict(config, block_k=pin), source="measured", measured_ms=1.0)
                over = dict(over, kernel_tuning_table=t.save())

            def expect(m, cfg, steps):
                n, rec = m.nlayers, lookup.choices()["flash"]
                kv = "_kvgrid" if rec["kvgrid"] else ""
                want = {"fwd": 0, "fwd_kvgrid": 0, "dq": 0, "dq_kvgrid": 0, "dkv": steps * n}
                want["fwd" + kv] = steps * (n + _n_remat(m, cfg))
                want["dq" + kv] = steps * n
                return want

            _train(state, f"tune-{label}", dict(TUNE_KW, **over), expect, save=False)
            res = state.pop(f"tune-{label}")
            rec = res["tuning"]["flash"]
            kv = "_kvgrid" if rec["kvgrid"] else ""
            ran = {c: {t: n for t, n in tiles.items() if n}
                   for c, tiles in res["launches_by_block_k"].items() if any(tiles.values())}
            want_tile = (pin or (cand.FLASH_DEFAULT_BLOCK_K if "off" in label
                                 else resolved[0]["resolved"]["block_k"]))
            runs[label] = {"tuning": res["tuning"], "launches_by_block_k": ran,
                           "loss": res["losses"][0], "overrides": over}
            if rec["block_k"] != want_tile or set(ran) != {"fwd" + kv, "dq" + kv} or any(
                    set(t) != {want_tile} for t in ran.values()):
                problems.append(f"{label}: ran {ran}, choices {rec}, expected key tile "
                                f"{want_tile}")
            if ("off" in label) != (rec["how"] == "off"):
                problems.append(f"{label}: how {rec['how']}")
    covered = {(c, t) for r in runs.values() for c, tiles in r["launches_by_block_k"].items()
               for t in tiles}
    missing = {(c, t) for c in fa.TILE_LAUNCHES for t in (64, 128)} - covered
    if missing:
        problems.append(f"(contract, key tile) never launched: {sorted(missing)}")
    result = {"smem_bytes": {k: {"kernel": c, "cost_model": m} for k, (c, m) in smem.items()},
              "chip": chip, "table": os.path.relpath(default_table_path(), REPO),
              "card": table.doc.get("card"), "suite": resolved, "runs": runs,
              "nvidia_smi": state["smi"]}
    emit("tune", **result)
    state["tune"] = result
    if problems:
        raise AssertionError("tune: " + "; ".join(problems))


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
LOADER_RATE_S = 1.0  # each worker mode's timed window (2 s before the tune phase)
# the reservoir is filled to the largest window this allows (a full
# 10,000-row window takes ~30 s; cut to pay for later phases)
LOADER_FILL_S = 4.0


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

    if "tp" in state["phases"] and "tp-children" not in state:
        # the tp phase's two ranks run beside this host-bound phase (their
        # Mixtral run, 32 GB each, finishes before resume trains: below)
        # and resume's first minutes (their Llama runs, 9 GB each)
        state["tp-children"] = _start_tp_children()
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
    if "tp-children" in state:
        # the card holds the tp ranks' Mixtral run and resume's training
        # together only after that run is done
        result["tp_mixtral_wait_s"] = _wait_tp_marker(state["tp-children"], TP_MIXTRAL_MARKER)
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
    launches, steps = pa.LAUNCHES[_contract(eng)], eng.decode_steps
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
    # the shard phase's hsdp child runs beside this phase's children (the
    # parent idles in both; ~37 s of the run), joined by that phase
    if "shard" in state["phases"]:
        state["shard-child"] = _start_shard_child()
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


def _start_shard_child():
    """The shard phase's hsdp run, started: ``python -m
    fms_fsdp_tpu_torch.main_training_llama --sharding_strategy=hsdp``
    under torchrun's environment, in a new shard root (the child's
    ``root``, ``ckpt`` and ``kw`` ride on it)."""
    root = _ckpt_dir("shard")
    ckpt = os.path.join(root, "hsdp")
    kw = dict(SHARD_KW, sharding_strategy="hsdp", ckpt_save_path=ckpt, ckpt_load_path=ckpt)
    child = _Child("fms_fsdp_tpu_torch.main_training_llama",
                   [f"--{k}={v}" for k, v in kw.items()], os.path.join(root, "child.log"),
                   SHARD_TIMEOUT_S, cwd=root, env=_torchrun_env())
    child.root, child.ckpt, child.kw = root, ckpt, kw
    return child


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
    # the hsdp child, started by the supervise phase (it ran beside that
    # phase's children), else now
    hsdp = state.pop("shard-child", None) or _start_shard_child()
    root, ckpt, kw = hsdp.root, hsdp.ckpt, hsdp.kw
    rc, wall, _ = hsdp.join()
    with open(hsdp.log) as f:
        out = f.read()
    losses = {"hsdp": _report_values(out, "loss:")}
    mesh_line = next((ln for ln in out.splitlines() if ln.startswith("Sharding strategy")), "")
    # the hsdp run's gradient norms: the tp phase's reference beside the losses
    result["gnorms"] = {"hsdp": _report_values(out, "gradient norm:")}
    result["hsdp"] = {"exit": rc, "wall_s": wall, "mesh": mesh_line,
                      "beside_supervise": "supervise" in state["phases"],
                      "tokens_per_card_per_s": _report_values(out, "current token per chip per sec:")}
    if rc != 0 or len(losses["hsdp"]) != SHARD_KW["num_steps"]:
        raise AssertionError(f"shard: the hsdp child exited {rc}:\n{out[-3000:]}")
    if "hf-eval" in state["phases"]:
        # hf-eval's Llama exporter reads this checkpoint: it starts now and
        # runs beside the rest of this phase (host work)
        state["hf-llama-child"] = _start_hf_llama_child(ckpt)
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
# the Mamba hybrid at full width, 2 of 32 layers: one Mamba layer and the
# attention layer, the fewest that run both kernels (the exporter child on
# this checkpoint is the phase's longest pole)
HF_MAMBA = {"model_variant": "mamba_9.8b", "MambaConfig.n_layer": 2,
            "MambaConfig.attn_layer_idx": (1,)}
HF_MAMBA_TRAIN_KW = {**HF_MAMBA, "seq_length": 4096, "batch_size": 2, "vocab_size": 128256,
                     "use_dummy_dataset": True, "num_steps": 1, "report_interval": 1,
                     "checkpoint_interval": 1000, "pure_bf16": True,
                     "ckpt_full_checksums": False}
HF_EVAL_BATCHES = 2  # 4 before the train-quant phase's cuts
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


def _start_hf_llama_child(ckpt):
    """hf-eval's Llama exporter (``fms_to_hf_llama``'s CLI) on the
    trainer checkpoint ``ckpt``, as a child; its directory is hf-eval's
    root (``.root``)."""
    root = _ckpt_dir("hf-eval")
    child = _Child("fms_fsdp_tpu_torch.fms_to_hf_llama",
                   _cli(HF_LLAMA) + [f"--load_path={ckpt}/checkpoints",
                                     f"--save_path={root}/hf_llama"],
                   os.path.join(root, "fms_to_hf_llama.log"), HF_CHILD_TIMEOUT_S)
    child.root = root
    return child


class _Child:
    """An entry point's CLI (``python -m module args``) run as a child
    process beside this one's work, its output in ``log``; ``join`` waits
    for it (at most ``timeout`` s from the join) and returns its exit
    code, its own wall seconds (start to exit) and its output's tail. The
    child runs in a session of its own, and ``kill`` ends the whole
    group."""

    def __init__(self, module, args, log, timeout, cwd=REPO, env=None):
        self.log, self.timeout = log, timeout
        self._out = open(log, "w")
        self.t0 = self.t_end = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", module, *args], cwd=cwd, stdout=self._out,
            stderr=subprocess.STDOUT, start_new_session=True,
            env=env or dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="4"))
        self._reaper = threading.Thread(target=self._reap, daemon=True)
        self._reaper.start()

    def _reap(self):
        self.proc.wait()
        self.t_end = time.perf_counter()

    def join(self):
        self._reaper.join(self.timeout)
        try:
            if self._reaper.is_alive():
                raise subprocess.TimeoutExpired(self.proc.args, self.timeout)
            rc = self.proc.returncode
        finally:
            self.kill()
        with open(self.log) as f:
            tail = f.read()[-3000:]
        return rc, self.t_end - self.t0, tail

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


def _hf_mamba(state, root, children):
    """(c), first half: the Mamba entry writes a checkpoint; the
    exporter's child (``fms_to_hf_mamba``'s CLI on it) starts, and
    eval_ppl.main runs on it beside the child through the SSD and flash
    kernels. The child joins ``children`` (killed with them) and is
    returned."""
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
    # the exporter reads the checkpoint beside the eval: its child is the
    # phase's longest pole
    export = _Child("fms_fsdp_tpu_torch.fms_to_hf_mamba",
                    _cli(HF_MAMBA) + [f"--load_path={ckpt}/checkpoints",
                                      f"--save_path={root}/mamba_ssm"],
                    os.path.join(root, "fms_to_hf_mamba.log"), HF_CHILD_TIMEOUT_S)
    children.append(export)

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
    process's card work (host work: no card is touched there); the Llama
    one from the shard phase on, which wrote its checkpoint."""
    import torch

    from fms_fsdp_tpu_torch.main_training_llama import main

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result, problems = {"nvidia_smi": state["smi"]}, []
    # the Llama checkpoint: the shard phase's hsdp run (left for this
    # phase, its exporter child started there), else one step of the
    # same config
    shard_root = state.pop("shard-root", None)
    children, timings = [], {}
    if shard_root is not None:
        ckpt = os.path.join(shard_root, "hsdp")
        children.append(state.pop("hf-llama-child"))
        root = children[0].root
    else:
        root = _ckpt_dir("hf-eval")
        ckpt = os.path.join(root, "llama")
        main(**dict(SHARD_KW, num_steps=1, ckpt_save_path=ckpt, ckpt_load_path=ckpt))
    result["llama_checkpoint"] = sorted(os.listdir(os.path.join(ckpt, "checkpoints")))
    try:
        if not children:
            children.append(_start_hf_llama_child(ckpt))

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
        (mamba_export,) = part("mamba", lambda: _hf_mamba(state, root, children))
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


SERVE_MAMBA_LAYERS = 6


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
    # full width, SERVE_MAMBA_LAYERS of 32 layers with the attention layer
    # at 3 (train-mamba's cut), for the fleet phase's time
    cfg = dataclasses.replace(get_model_config("mamba_9.8b"), n_layer=SERVE_MAMBA_LAYERS,
                              attn_layer_idx=(3,))
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
    del eng
    result["migrate"] = _mamba_migrate(params, cfg, problems)
    emit("serve-mamba-migrate", **result["migrate"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("serve-mamba: " + "; ".join(problems))


def _mamba_migrate(params, cfg, problems, steps=6, max_new=24):
    """Drain-and-migrate through the slab codec: two live streams packed
    mid-decode (``pack_stream``: conv windows, fp32 SSD states, the
    attention layer's pages) after ``steps`` steps and resumed on a second
    engine (``submit_handoff``) finish with the tokens of the same two
    requests on an uninterrupted engine. A difference is accepted only at
    a near-tie of the uninterrupted engine's logits: a top-2 gap at the
    first differing token within ``TOL["bf16"]`` of the top logit."""
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine

    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, size=m).tolist() for m in (40, 97)]

    def engine():
        return ServingEngine(params, cfg, ServeConfig(max_batch=8, max_seq_len=256,
                                                      max_prefill_per_step=2), seed=0)

    ref = engine()
    rreqs = [ref.submit(p, max_new) for p in prompts]
    gaps, slot_of = {}, {}
    while ref.has_work():
        n_before = [len(r.generated) for r in rreqs]
        steps_before = ref.decode_steps
        ref.step()
        for slot, r in enumerate(ref._slots):
            if r is not None:
                slot_of[id(r)] = slot
        if ref.decode_steps == steps_before:
            continue
        top2 = ref.last_logits.float().topk(2, dim=-1).values
        for i, r in enumerate(rreqs):
            if len(r.generated) > n_before[i]:
                a, b = top2[slot_of[id(r)]].tolist()
                gaps[(i, len(r.generated) - 1)] = (a - b, abs(a))
    src = engine()
    sreqs = [src.submit(p, max_new) for p in prompts]
    for _ in range(steps):
        src.step()
    live = src.live_requests()
    t0 = time.perf_counter()
    frames = [src.pack_stream(r) for r in sreqs]
    pack_s = time.perf_counter() - t0
    mid = [len(r.generated) for r in sreqs]
    dst = engine()
    t0 = time.perf_counter()
    dreqs = [dst.submit_handoff(f) for f in frames]
    dst.run()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    out = {"streams": len(prompts), "packed_at_tokens": mid,
           "frame_bytes": [len(f) for f in frames], "pack_s": pack_s,
           "resume_and_finish_s": resume_s, "same_tokens": [], "first_difference": []}
    for i, (r, d) in enumerate(zip(rreqs, dreqs)):
        same = r.generated == d.generated
        out["same_tokens"].append(same)
        if not same:
            j = next(k for k, (a, b) in enumerate(zip(r.generated, d.generated)) if a != b)
            gap, top = gaps.get((i, j), (None, None))
            near = gap is not None and gap <= TOL["bf16"] * max(1.0, top)
            out["first_difference"].append({"stream": i, "token": j, "top2_gap": gap,
                                            "top_logit": top, "near_tie": near})
            if not near:
                problems.append(f"migrated mamba stream {i} differs at token {j} "
                                f"(top-2 gap {gap}, not a near-tie)")
    if len(live) != 2 or any(f is None for f in frames) or not all(0 < m < max_new for m in mid):
        problems.append(f"migrate: {len(live)} live streams, packed at {mid}")
    if not all(d.state == "finished" and len(d.generated) == max_new for d in dreqs):
        problems.append("a migrated mamba stream did not finish")
    del ref, src, dst
    return out


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
    The step is a chain of layers without a kernel of the repo, so the
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


# ---------------------------------------------------------------------------
# quantized training
# ---------------------------------------------------------------------------

QUANT_MODES = ("int8", "int8_dgrad", "fp8", "fp8_dgrad")
# llama3_8b_4k at full width, 2 of 32 layers, AC 1/2 as ``train``
QUANT_LLAMA_KW = {**TRAIN_KW, "LlamaConfig.nlayers": 2, "num_steps": 4, "report_interval": 1}
QUANT_MAMBA_KW = {**MAMBA_TRAIN_KW, "MambaConfig.n_layer": 3,
                  "MambaConfig.attn_layer_idx": (1,), "num_steps": 3, "report_interval": 1}
QUANT_MIXTRAL_KW = {**MIXTRAL_TRAIN_KW, "MixtralConfig.nlayers": 1, "num_steps": 3}
# a quantized mode's first loss against the bf16 run's, relative: 25x the
# largest gap between a mode's first loss and the unquantized one over the
# CPU tests' twelve family x mode runs (4.1e-5, tests/test_torch_quant_training.py),
# for the 16-bit baseline's own rounding at full width
QUANT_LOSS_REL_TOL = 1e-3
# the micro-table's GEMMs: M rows against (K, N), llama3_8b's widths
QUANT_GEMM_M = 8192
QUANT_GEMM_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# _scaled_mm (e4m3 x e4m3, fp32 out, use_fast_accum=False) against the
# exact product of the same fp8 values, over the largest |product|: Hopper's
# fp8 tensor cores do not accumulate in exact fp32
FP8_GEMM_REL_TOL = 1e-3


def _quant_profile(res):
    """Device ms of one step by kind (torch.profiler, after a warm step):
    the 1-byte GEMMs (``aten::_int_mm`` / ``aten::_scaled_mm``), the
    quantize passes and dequant (the ``quant_matmul`` scope less its
    GEMMs), the 16-bit GEMMs (``aten::mm``/``bmm``/``addmm``), the flash
    kernels and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
    from fms_fsdp_tpu_torch.data.loader import get_dummy_loader
    from fms_fsdp_tpu_torch.train.step import make_train_step

    cfg, st = res["cfg"], res["state"]
    step_fn = make_train_step(res["model_cfg"], cfg)
    batch = next(iter(DeviceFeed(get_dummy_loader(cfg, 0, 1), "cuda")))
    step_fn(st, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(st, batch)
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, 1)
    if not rows:
        return None
    total = sum(r[0] for r in rows)
    q_gemm = _op_device_ms(prof, "aten::_int_mm") + _op_device_ms(prof, "aten::_scaled_mm")
    kinds = {
        "quantized_gemm": q_gemm,
        "quantize_passes": _op_device_ms(prof, "quant_matmul") - q_gemm,
        "gemm_16bit": sum(_op_device_ms(prof, op) for op in ("aten::mm", "aten::bmm",
                                                             "aten::addmm")),
        "flash": sum(r[0] for r in rows if _kernel_kind(r[1]) == "flash"),
    }
    kinds["other"] = total - sum(kinds.values())
    return {"device_ms_per_step": total, "device_ms_per_step_by_kind": kinds}


def _quant_run(tag, main, kw, profile=False, watch=None):
    """One trainer run through its entry, without a save: losses, tokens
    per card per second (median of the steps after the first), the flash,
    SSD and 1-byte GEMM counts of the run, peak memory, and with
    ``profile`` one more step's device ms by kind. ``watch(state, m)``
    sees every step. Returns (the fields, the entry's result)."""
    import statistics

    import torch

    from fms_fsdp_tpu_torch import main_training_llama as entry
    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.ops import quant, ssd

    ckpt = _ckpt_dir(f"train-quant-{tag}")
    make = entry.make_train_step
    if watch is not None:
        def make_watched(*a, **k):
            step = make(*a, **k)

            def watched(st, batch):
                m = step(st, batch)
                watch(st, m)
                return m

            return watched

        entry.make_train_step = make_watched
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    ssd.reset_launches()
    quant.reset_gemms()
    try:
        with _saves_nothing(entry):
            res = main(**kw, ckpt_save_path=ckpt, ckpt_load_path=ckpt,
                       ckpt_full_checksums=False)
    finally:
        entry.make_train_step = make
    reports = res["reports"]
    out = {
        "steps": res["steps"], "losses": [r["loss"] for r in reports],
        "tokens_per_card_per_s": statistics.median(
            r["tokens_per_card_per_s"] for r in reports[1:]),
        "launches": dict(fa.LAUNCHES, ssd_fused=ssd.LAUNCHES["fused"]),
        "gemms": dict(quant.GEMMS), "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    if "moe_drop_frac" in reports[0]:
        out["moe_drop_frac"] = [r["moe_drop_frac"] for r in reports]
    if profile:
        out["step_profile"] = _quant_profile(res)
    shutil.rmtree(ckpt)
    return out, res


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _quant_gemm_table(gen):
    """The 1-byte GEMMs alone at M = 8192 against llama3_8b's (K, N): bf16
    ``torch.matmul``, ``_int_mm`` and ``_scaled_mm`` on quantized operands,
    the whole quantized forward (passes = whole - GEMM), and each GEMM
    against its plain version on the card (the exact float64 product of
    the same 1-byte values): int8 bitwise, fp8 within
    ``FP8_GEMM_REL_TOL``; control: a plain version fed one flipped
    quantized value fails the same check."""
    import torch

    from fms_fsdp_tpu_torch.ops import quant

    one = torch.ones((), dtype=torch.float32, device="cuda")
    rows, problems = [], []
    m = QUANT_GEMM_M
    for k, n in QUANT_GEMM_SHAPES:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        w = (0.02 * torch.randn(k, n, generator=gen, device="cuda")).bfloat16()
        qx, sx = quant._quant(x, torch.int8)
        qwt = quant._quant(w.t(), torch.int8)[0].contiguous()
        fx, _ = quant._quant(x, quant.FP8_E4M3)
        fwt = quant._quant(w.t(), quant.FP8_E4M3)[0].contiguous()

        def int_mm(a=qx):
            return torch._int_mm(a, qwt.t())

        def fp8_mm(a=fx):
            return torch._scaled_mm(a, fwt.t(), scale_a=one, scale_b=one,
                                    out_dtype=torch.float32, use_fast_accum=False)

        row = {"m": m, "k": k, "n": n,
               "bf16_ms": _timed_ms(lambda i: x @ w, budget_ms=100),
               "int_mm_ms": _timed_ms(lambda i: int_mm(), budget_ms=100),
               "scaled_mm_ms": _timed_ms(lambda i: fp8_mm(), budget_ms=100),
               "int8_forward_ms": _timed_ms(lambda i: quant.int8_matmul_raw(x, w), budget_ms=100),
               "fp8_forward_ms": _timed_ms(lambda i: quant.fp8_matmul_raw(x, w), budget_ms=100)}
        row["int8_passes_ms"] = row["int8_forward_ms"] - row["int_mm_ms"]
        row["fp8_passes_ms"] = row["fp8_forward_ms"] - row["scaled_mm_ms"]
        row["bound_ms"] = {
            "bf16": max(2 * m * k * n / PEAK_OPS["bf16"], (2 * (m * k + k * n + m * n)) / HBM_BYTES_PER_S) * 1e3,
            "int8": max(2 * m * k * n / PEAK_OPS["int8"], (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S) * 1e3,
            "fp8": max(2 * m * k * n / PEAK_OPS["fp8"], (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S) * 1e3}

        def int_err(a):
            plain = (a.double() @ qwt.double().t()).round().to(torch.int32)
            return int((int_mm() - plain).abs().max())

        def fp8_rel(a):
            plain = a.double() @ fwt.double().t()
            return float((fp8_mm().double() - plain).abs().max() / plain.abs().max())

        row["int_mm_max_abs_err"] = int_err(qx)
        row["scaled_mm_max_rel_err"] = fp8_rel(fx)
        # the dequantized int8 output against the plain one, bitwise
        plain_acc = (qx.double() @ qwt.double().t()).round().to(torch.int32)
        sw = quant._quant(w.t(), torch.int8)[1].t()
        row["int8_dequant_bitwise"] = bool(torch.equal(
            (int_mm().float() * sx * sw).bfloat16(), (plain_acc.float() * sx * sw).bfloat16()))
        # control: one quantized value flipped in the plain version's input
        bad_q = qx.clone()
        bad_q[0, int(qx[0].abs().argmax())] *= -1
        bad_f = fx.clone()
        bad_f.view(torch.uint8)[0, int(fx[0].float().abs().argmax())] ^= 0x80  # the sign bit
        row["control_int_mm_max_abs_err"] = int_err(bad_q)
        row["control_scaled_mm_max_rel_err"] = fp8_rel(bad_f)
        rows.append(row)
        if row["int_mm_max_abs_err"] or not row["int8_dequant_bitwise"]:
            problems.append(f"_int_mm at {(m, k, n)} is not its plain version bitwise")
        if not row["scaled_mm_max_rel_err"] <= FP8_GEMM_REL_TOL:
            problems.append(f"_scaled_mm at {(m, k, n)}: {row['scaled_mm_max_rel_err']}")
        if not row["control_int_mm_max_abs_err"] or not (
                row["control_scaled_mm_max_rel_err"] > FP8_GEMM_REL_TOL):
            problems.append(f"the flipped-value control passed at {(m, k, n)}")
        del x, w, qx, qwt, fx, fwt, bad_q, bad_f
        _free()
    return rows, problems


def _quant_llama(state, problems):
    """bf16 and the four GEMM modes on the same seeded init and batches."""
    from fms_fsdp_tpu_torch.main_training_llama import main

    runs = {}
    for mode in ("none",) + QUANT_MODES:
        runs[mode], res = _quant_run(f"llama-{mode}", main,
                                     dict(QUANT_LLAMA_KW, quantized_matmuls=mode), profile=True)
        model_cfg, cfg = res["model_cfg"], res["cfg"]
        del res
        _free()
    n, remat = model_cfg.nlayers, _n_remat(model_cfg, cfg)
    base = runs["none"]
    for mode, r in runs.items():
        steps = r["steps"]
        want = {"fwd": 7 * (n + remat) * steps if mode != "none" else 0,
                "dgrad": 7 * n * steps if mode.endswith("_dgrad") else 0}
        r["expected_gemms"] = want
        r["first_loss_rel_to_bf16"] = abs(r["losses"][0] - base["losses"][0]) / abs(base["losses"][0])
        r["tokens_per_s_vs_bf16"] = r["tokens_per_card_per_s"] / base["tokens_per_card_per_s"]
        if not all(math.isfinite(x) for x in r["losses"]):
            problems.append(f"llama {mode}: non-finite loss {r['losses']}")
        if r["first_loss_rel_to_bf16"] > QUANT_LOSS_REL_TOL:
            problems.append(f"llama {mode}: first loss {r['first_loss_rel_to_bf16']} from bf16's")
        if r["gemms"] != want:
            problems.append(f"llama {mode}: 1-byte GEMMs {r['gemms']} != {want}")
        flash = {k: v for k, v in r["launches"].items() if k != "ssd_fused"}
        if flash != {k: v for k, v in base["launches"].items() if k != "ssd_fused"}:
            problems.append(f"llama {mode}: flash launches {flash} differ from bf16's")
    return runs


def _quant_reduce(state, problems):
    """The three reduce wires at the Llama shape, GEMMs unquantized; under
    fp8_delayed each step's row 0 against the leaf amax taken on the side
    from the raw reduced gradients, then the injected non-finite step with
    the guard (rows unchanged) and without it (rows rolled)."""
    import torch

    from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
    from fms_fsdp_tpu_torch.data.loader import get_dummy_loader
    from fms_fsdp_tpu_torch.main_training_llama import main
    from fms_fsdp_tpu_torch.parallel import overlap
    from fms_fsdp_tpu_torch.resilience.faults import configure_faults
    from fms_fsdp_tpu_torch.train import step as step_mod

    runs = {}
    for mode in ("int8", "fp8", "fp8_delayed"):
        side, heads = [], []
        # the step's wire (bucket by bucket with a DCN plan; one slice here)
        real = overlap.bucketed_quantized_grad_reduce

        def spy(grads, wire, quant_state, plan, leaves, dp=None):
            amax = {}
            for g, leaf in zip(grads, leaves):
                a = g.detach().float().abs().max()
                amax[leaf.key] = a if leaf.key not in amax else torch.maximum(amax[leaf.key], a)
            side.append({k: float(v) for k, v in amax.items()})
            return real(grads, wire, quant_state, plan, leaves, dp)

        def watch(st, m):
            if "quant" in st:
                heads.append({k: float(v[0]) for k, v in st["quant"]["amax_history"].items()})

        overlap.bucketed_quantized_grad_reduce = spy
        try:
            runs[mode], res = _quant_run(f"reduce-{mode}", main,
                                         dict(QUANT_LLAMA_KW, num_steps=3, quantized_reduce=mode),
                                         watch=watch)
        finally:
            overlap.bucketed_quantized_grad_reduce = real
        r = runs[mode]
        if not all(math.isfinite(x) for x in r["losses"]):
            problems.append(f"reduce {mode}: non-finite loss {r['losses']}")
        if len(side) != r["steps"]:
            problems.append(f"reduce {mode}: the wire ran {len(side)} times in {r['steps']} steps")
        if mode == "fp8_delayed":
            r["amax_rows"] = len(heads[0])
            r["row0_equals_side_amax"] = heads == side
            if heads != side:
                problems.append("fp8_delayed: a history's row 0 is not that step's leaf amax")
            st, cfg = res["state"], res["cfg"]
            batch = next(iter(DeviceFeed(get_dummy_loader(cfg, 0, 1), "cuda")))
            before = {k: v.clone() for k, v in st["quant"]["amax_history"].items()}
            guard = {}
            for name, c in (("guarded", cfg),
                            ("unguarded", dataclasses.replace(cfg, anomaly_skip_updates=False))):
                configure_faults(f"nan_loss:step={st['step']}:count=1")
                try:
                    m = step_mod.make_train_step(res["model_cfg"], c)(st, batch)
                finally:
                    configure_faults("")
                rows_now = st["quant"]["amax_history"]
                guard[name] = {
                    "nonfinite": m["nonfinite"],
                    "rows_unchanged": all(torch.equal(rows_now[k], v) for k, v in before.items()),
                    "rows_rolled": all(bool(torch.isnan(rows_now[k][0]))
                                       and torch.equal(rows_now[k][1:], v[:-1])
                                       for k, v in before.items())}
                if name == "guarded":
                    before = {k: v.clone() for k, v in rows_now.items()}
            r["poisoned_step"] = guard
            if not (guard["guarded"]["nonfinite"] == 1.0 and guard["guarded"]["rows_unchanged"]):
                problems.append(f"fp8_delayed: the guarded poisoned step moved the rows {guard}")
            if not (guard["unguarded"]["nonfinite"] == 1.0 and guard["unguarded"]["rows_rolled"]):
                problems.append(f"fp8_delayed control: the unguarded step did not roll {guard}")
            del st, batch, before
        del res
        _free()
    return runs


def _quant_mamba(state, problems):
    """mamba_9.8b at full width, 3 layers (attention at 1), bf16 then
    fp8_dgrad: the same SSD and flash launches, the GEMMs of every
    projection quantized."""
    from fms_fsdp_tpu_torch.main_training_mamba import main

    runs = {}
    for mode in ("none", "fp8_dgrad"):
        runs[mode], res = _quant_run(f"mamba-{mode}", main,
                                     dict(QUANT_MAMBA_KW, quantized_matmuls=mode))
        model_cfg, cfg = res["model_cfg"], res["cfg"]
        del res
        _free()
    mask = _remat_mask(model_cfg, cfg)
    attn = set(model_cfg.attn_layer_idx)
    # in_proj and out_proj a Mamba layer, wq/wk/wv/wo an attention layer,
    # w1/w3/w2 every layer's MLP
    per_layer = [(4 if i in attn else 2) + 3 for i in range(model_cfg.n_layer)]
    steps = runs["fp8_dgrad"]["steps"]
    want = {"fwd": steps * sum(g * (1 + int(r)) for g, r in zip(per_layer, mask)),
            "dgrad": steps * sum(per_layer)}
    r = runs["fp8_dgrad"]
    r["expected_gemms"] = want
    r["first_loss_rel_to_bf16"] = abs(r["losses"][0] - runs["none"]["losses"][0]) / abs(
        runs["none"]["losses"][0])
    r["tokens_per_s_vs_bf16"] = r["tokens_per_card_per_s"] / runs["none"]["tokens_per_card_per_s"]
    if r["launches"] != runs["none"]["launches"] or not r["launches"]["ssd_fused"]:
        problems.append(f"mamba fp8_dgrad launches {r['launches']} != bf16's "
                        f"{runs['none']['launches']}")
    if r["gemms"] != want:
        problems.append(f"mamba fp8_dgrad 1-byte GEMMs {r['gemms']} != {want}")
    if not all(math.isfinite(x) for x in r["losses"]) or (
            r["first_loss_rel_to_bf16"] > QUANT_LOSS_REL_TOL):
        problems.append(f"mamba fp8_dgrad losses {r['losses']} vs bf16 {runs['none']['losses']}")
    return runs


def _quant_mixtral(state, problems):
    """mixtral_8x7b at full width, 1 layer: bf16, fp8_dgrad and int8; the
    expert GEMMs one 2-D call an expert."""
    from fms_fsdp_tpu_torch.main_training_mixtral import main

    runs = {}
    for mode in ("none", "fp8_dgrad", "int8"):
        runs[mode], res = _quant_run(f"mixtral-{mode}", main,
                                     dict(QUANT_MIXTRAL_KW, quantized_matmuls=mode))
        model_cfg, cfg = res["model_cfg"], res["cfg"]
        del res
        _free()
    n, remat = model_cfg.nlayers, _n_remat(model_cfg, cfg)
    experts = 3 * model_cfg.num_experts  # w1, w3, w2 per expert
    for mode in ("fp8_dgrad", "int8"):
        r = runs[mode]
        steps = r["steps"]
        want = {"fwd": steps * (4 + experts) * (n + remat),
                "dgrad": steps * (4 + experts) * n if mode.endswith("_dgrad") else 0}
        r["expected_gemms"] = want
        r["expert_gemms_per_step_fwd"] = (r["gemms"]["fwd"] / steps / (n + remat)) - 4
        r["first_loss_rel_to_bf16"] = abs(r["losses"][0] - runs["none"]["losses"][0]) / abs(
            runs["none"]["losses"][0])
        r["tokens_per_s_vs_bf16"] = (r["tokens_per_card_per_s"]
                                     / runs["none"]["tokens_per_card_per_s"])
        r["moe_drop_frac_bf16"] = runs["none"]["moe_drop_frac"]
        if r["gemms"] != want:
            problems.append(f"mixtral {mode}: 1-byte GEMMs {r['gemms']} != {want}")
        if not all(math.isfinite(x) for x in r["losses"]) or (
                r["first_loss_rel_to_bf16"] > QUANT_LOSS_REL_TOL):
            problems.append(f"mixtral {mode} losses {r['losses']} vs bf16 "
                            f"{runs['none']['losses']}")
    return runs


def phase_train_quant(state):
    """Quantized training (see the module docstring)."""
    import torch

    problems = []
    t0 = time.perf_counter()
    result = {"nvidia_smi": state["smi"]}
    gen = torch.Generator(device="cuda").manual_seed(16)
    result["gemm_table"], more = _quant_gemm_table(gen)
    problems += more
    result["llama"] = _quant_llama(state, problems)
    result["reduce"] = _quant_reduce(state, problems)
    result["mamba"] = _quant_mamba(state, problems)
    result["mixtral"] = _quant_mixtral(state, problems)
    # the repo's kernels under the quantized GEMMs: every quantized run's
    # launches together (the bf16 and reduce-only runs left out)
    result["launches"] = {}
    for fam in ("llama", "mamba", "mixtral"):
        for mode, r in result[fam].items():
            if mode != "none":
                for k, v in r["launches"].items():
                    result["launches"][k] = result["launches"].get(k, 0) + v
    result["seconds"] = time.perf_counter() - t0
    emit("train-quant", **result)
    state["train-quant"] = result
    if problems:
        raise AssertionError("train-quant: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# tensor parallelism: two ranks on the one card
# ---------------------------------------------------------------------------

TP_SIZE = 2
# the expert-parallel runs: the train-mixtral configuration with bf16
# params and moments. Under bfSixteen ep-ref (fsdp 2) peaks at ~38 GB a
# rank (its layer's whole bf16 gradients and their reduce-scatter buffer
# beside 19 GB of fp32 params and moments): two ranks pass the card's 79 GB
EP_KW = dict(MIXTRAL_TRAIN_KW, sharding_strategy="fsdp", pure_bf16=True)
TP_HEADS = "16/4"  # llama3_8b's and mixtral_8x7b's 32/8 heads over 2 ranks
SLICE_HEADS = "32/8"  # a slice of one rank holds the whole model
TP_RUNS = (
    # (name, entry module, the entry's keyword arguments); Mixtral first,
    # the largest (32 GB a rank), so that it runs beside the loader phase
    ("mixtral", "main_training_mixtral",
     dict(MIXTRAL_TRAIN_KW, sharding_strategy="fsdp", tensor_parallel_size=TP_SIZE,
          num_steps=2)),
    # expert parallelism at the same width (each rank 4 of the 8 experts),
    # its reference on the same ranks, rows and global batch without the
    # expert axis (fsdp 2), and the control with the exchange broken; bf16
    # params and moments (``EP_KW``)
    ("ep", "main_training_mixtral",
     dict(EP_KW, expert_parallel_size=TP_SIZE, num_steps=2)),
    ("ep-ref", "main_training_mixtral", dict(EP_KW, num_steps=2)),
    ("ep-control", "main_training_mixtral",
     dict(EP_KW, expert_parallel_size=TP_SIZE, num_steps=1)),
    ("llama", "main_training_llama",
     dict(SHARD_KW, sharding_strategy="fsdp", tensor_parallel_size=TP_SIZE)),
    ("control", "main_training_llama",
     dict(SHARD_KW, sharding_strategy="fsdp", tensor_parallel_size=TP_SIZE, num_steps=1)),
    # two slices of one rank each, the overlap on and off; one slice of
    # two replicas, the reference; the control without the cross-slice sum
    ("slices", "main_training_llama",
     dict(SHARD_KW, sharding_strategy="fsdp", num_slices=TP_SIZE, dcn_overlap="auto")),
    ("slices-off", "main_training_llama",
     dict(SHARD_KW, sharding_strategy="fsdp", num_slices=TP_SIZE, dcn_overlap="off")),
    ("ddp", "main_training_llama", dict(SHARD_KW, sharding_strategy="ddp")),
    ("slices-control", "main_training_llama",
     dict(SHARD_KW, sharding_strategy="fsdp", num_slices=TP_SIZE, num_steps=1)),
)
TP_CONTROLS = ("control", "slices-control", "ep-control")
SLICE_RUNS = ("slices", "slices-off", "slices-control")
EP_RUNS = ("ep", "ep-control")
# the dropped share of a later step, ep against ep-ref: 16 of a layer's
# 16,384 choices
EP_DROP_ABS_TOL = 1e-3
# the last run at Mixtral's width (32 GB a rank): the loader phase waits
# for it before resume trains
TP_MIXTRAL_MARKER = "ep-control"


def _tp_expected_mesh(name):
    """The mesh a ``TP_RUNS`` run builds on the world of 2, and the heads
    its ranks run attention at."""
    mesh = dict(dcn=1, replica=1, fsdp=1, expert=1, context=1, tensor=1)
    if name in SLICE_RUNS:
        return dict(mesh, dcn=TP_SIZE), SLICE_HEADS
    if name == "ddp":
        return dict(mesh, replica=TP_SIZE), SLICE_HEADS
    if name in EP_RUNS:
        return dict(mesh, expert=TP_SIZE), SLICE_HEADS
    if name == "ep-ref":
        return dict(mesh, fsdp=TP_SIZE), SLICE_HEADS
    return dict(mesh, tensor=TP_SIZE), TP_HEADS
# with the expert-parallel runs the children take ~220 s alone on an H100,
# and gloo stages their collectives through a host the other phases share
TP_TIMEOUT_S = 600
# the phases whose runs the tp phase's runs are held against
TP_REFERENCES = ("shard", "train-mixtral")
TP_MARKER_TIMEOUT_S = 300
# the serving runs after TP_RUNS, in the same world: llama3_8b at full
# width and the fleet phase's 4 layers, fp32, the kernel on the card; then
# mixtral_8x7b at full width and 2 layers, fp32 (12.6 GB of weights drawn
# on each rank), whose decode runs the reference attention (no kernel)
TP_SERVE_LAYERS = 4
TP_SERVE_MIXTRAL_LAYERS = 2
TP_SERVE_WAVE = {"requests": 8, "min_prompt": 64, "max_prompt": 512, "max_new": 32, "seed": 21}
# every request prefilled in the first step, so each decode step runs 8 rows
TP_SERVE_KW = {"max_batch": 8, "max_seq_len": 1024, "compute_dtype": "float32",
               "max_prefill_per_step": 8}
# fp32: the first decode step's logits of the tp 2 wave against the
# one-rank wave's, max |difference| over max |one-rank| (the row-split
# products sum in another order: ~1e-6 expected); the control's must exceed it
TP_SERVE_REL_TOL = 1e-4
# decode steps the bf16 check's state is advanced past the refill
TP_SERVE_BF16_STEPS = 4


def _tp_child(spec):
    """One rank of the tp phase's world: each run of ``TP_RUNS`` through
    its entry (no save), its losses, launches and peak memory, then the
    serving runs (``_tp_serve``), into ``<root>/tp_rank<R>.json``. The
    control run drops the forward's row-parallel reduces
    (``TensorParallel.reduce`` the identity), the slices' control the
    cross-slice sum (``DataParallel.dcn_reduce`` does nothing), the expert
    control breaks the all-to-all (``ExpertParallel.exchange`` keeps each
    rank's own chunks in place of its peer's)."""
    import importlib
    import resource

    import torch

    from fms_fsdp_tpu_torch.ops import flash_attention as fa
    from fms_fsdp_tpu_torch.parallel import expert, overlap, tensor
    from fms_fsdp_tpu_torch.parallel.mesh import axis_sizes
    from fms_fsdp_tpu_torch.parallel.sharding import DataParallel

    # every entry trains through the Llama entry's main: its checkpoint
    # manager saves nothing here
    shared = importlib.import_module("fms_fsdp_tpu_torch.main_training_llama")
    rank = int(os.environ["RANK"])
    out = {"rank": rank, "device": torch.cuda.get_device_name(0)}
    for name, module, kw in TP_RUNS:
        entry = importlib.import_module(f"fms_fsdp_tpu_torch.{module}")
        ckpt = os.path.join(spec["root"], f"{name}_ck")
        kw = dict(kw, **spec.get("overrides", {}), ckpt_save_path=ckpt, ckpt_load_path=ckpt)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        tensor.reset_collectives()
        overlap.reset_dcn_reduces()
        expert.reset_exchanges()
        reduce, dcn_reduce = tensor.TensorParallel.reduce, DataParallel.dcn_reduce
        exchange = expert.ExpertParallel.exchange
        if name == "control":
            tensor.TensorParallel.reduce = lambda self, x: x
        if name == "slices-control":
            DataParallel.dcn_reduce = lambda self, flat, async_op=False: None
        if name == "ep-control":
            expert.ExpertParallel.exchange = lambda self, t: t.contiguous().clone()
        t0 = time.perf_counter()
        try:
            with _saves_nothing(shared):
                res = entry.main(**kw)
        finally:
            tensor.TensorParallel.reduce = reduce
            DataParallel.dcn_reduce = dcn_reduce
            expert.ExpertParallel.exchange = exchange
        torch.cuda.synchronize()
        reports = res["reports"]
        record = res["observer"].last_record
        out[name] = {
            "wall_s": time.perf_counter() - t0, "steps": res["steps"],
            "losses": [r["loss"] for r in reports], "gnorms": [r["gnorm"] for r in reports],
            "step_time_s": [r["step_time_s"] for r in reports],
            "tokens_per_card_per_s": reports[-1]["tokens_per_card_per_s"],
            "mfu": reports[-1]["mfu"], "launches": dict(fa.LAUNCHES),
            "head_launches": {k: dict(v) for k, v in fa.HEAD_LAUNCHES.items()},
            "collectives": dict(tensor.COLLECTIVES),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "backend": torch.distributed.get_backend(), "mesh": axis_sizes(res["mesh"]),
            "remat": _n_remat(res["model_cfg"], res["cfg"]),
            "layers": res["model_cfg"].nlayers,
            "plan": overlap.plan_summary(), "dcn_reduces": overlap.DCN_REDUCES["bucket"],
            "expert_a2a": expert.EXPERT_A2A["all_to_all"],
            "drop_frac": [r.get("moe_drop_frac") for r in reports],
            "collective_split": {k: record[k] for k in (
                "ici_collective_s", "dcn_collective_s", "dcn_overlap_frac", "compute_s")},
        }
        del res, reports, record
        gc.collect()
        torch.cuda.empty_cache()
        _empty_host_cache(torch)
        out[name]["host_rss_bytes"] = _host_rss_bytes()
        # the process's peak so far (Linux reports it in KiB)
        out[name]["host_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        # the run's memory is back: a marker for the parent
        open(os.path.join(spec["root"], f"{name}_done_rank{rank}"), "w").close()
    out["serve"] = _tp_serve("cuda", _tp_serve_cfg("llama3_8b", TP_SERVE_LAYERS), rank)
    gc.collect()
    torch.cuda.empty_cache()
    out["serve_mixtral"] = _tp_serve(
        "cuda", _tp_serve_cfg("mixtral_8x7b", TP_SERVE_MIXTRAL_LAYERS), rank)
    with open(os.path.join(spec["root"], f"tp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _empty_host_cache(torch):
    """Give the pinned host blocks that torch's caching host allocator
    keeps back to the system: gloo stages each collective of card tensors
    through such blocks, and after ep-ref's layer gathers (GBs each) a
    rank's cache would hold them beside the phases that run meanwhile."""
    empty = getattr(torch.accelerator, "empty_host_cache", None)
    (empty or torch._C._host_emptyCache)()


def _host_rss_bytes():
    """This process's resident host memory (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def _tp_serve_cfg(variant, layers):
    import dataclasses as dc

    from fms_fsdp_tpu_torch.utils.config_utils import get_model_config

    return dc.replace(get_model_config(variant), nlayers=layers)


def _tp_wave(eng, prompts, max_new):
    """The leader's wave: every request to its end. Returns its figures
    and the first decode step's logits (8 rows, fp32, kept off the
    JSON)."""
    import torch

    from fms_fsdp_tpu_torch.parallel import tensor

    reqs = [eng.submit(p, max_new) for p in prompts]
    first, per_step = None, None
    t0 = time.perf_counter()
    while eng.has_work():
        before, steps = dict(tensor.COLLECTIVES), eng.decode_steps
        eng.step()
        if eng.decode_steps > steps:
            if first is None:
                first = eng.last_logits.float().clone()
            else:  # decode only: every prompt was prefilled in the first step
                per_step = {k: tensor.COLLECTIVES[k] - before[k] for k in before}
    if first is not None and first.is_cuda:
        torch.cuda.synchronize()
    stats = eng.serving_stats()
    return {
        "wall_s": time.perf_counter() - t0, "decode_steps": eng.decode_steps,
        "tokens": [list(map(int, r.generated)) for r in reqs],
        "finished": all(r.state == "finished" and len(r.generated) == max_new for r in reqs),
        "decode_tokens_per_s": stats["tokens_per_s"], "serve_layout": stats["serve_layout"],
        "collectives_per_decode_step": per_step,
    }, first


def _tp_bf16_step(eng, device):
    """One bf16 decode step at this rank's heads (both ranks, after the
    leader released them; the state the leader's refill left): through
    the kernel, through the reference attention, and fp32 (reference),
    held as ``_compare_step`` holds them; and the kernel's first launch
    (layer 0, this rank's 16 query and 4 KV heads) against its plain
    version row by row within ``paged_attention.REL_TOL``."""
    import torch

    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.serve import decode as sd
    from fms_fsdp_tpu_torch.utils.dist import broadcast_obj
    from fms_fsdp_tpu_torch.utils.tree import tree_map

    ad = eng.adapter
    slot_rids, lens, toks = broadcast_obj(
        ([r.rid if r is not None else None for r in eng._slots], eng._lens.copy(),
         eng._tokens.copy()) if eng.is_leader else None)
    table = torch.from_numpy(ad.cache.page_table(slot_rids, ad.max_pages)).to(device)
    lens, toks = torch.from_numpy(lens).to(device), torch.from_numpy(toks).to(device)
    params16 = tree_map(lambda w: w.to(torch.bfloat16), eng.params)
    first = []
    real = sd.paged_attention_kernel

    def spy(q, k, v, t, sl, **kw):
        if not first:
            first.append((q, k, v, t, sl, kw))
        return real(q, k, v, t, sl, **kw)

    def step(params, dtype, impl):
        pools = {n: p.to(dtype, copy=True) for n, p in ad.cache.pools.items()}
        out, _, _ = sd.paged_decode_step(
            params, pools, table, lens, toks, eng.model_cfg, page_size=ad.page_size,
            compute_dtype=dtype, attn_impl=impl, block_kv=ad.block_kv, rope=ad.rope, tp=ad.tp)
        return out.float()

    sd.paged_attention_kernel = spy
    try:
        kernel = step(params16, torch.bfloat16, "kernel")
    finally:
        sd.paged_attention_kernel = real
    ref = step(params16, torch.bfloat16, "reference")
    fp32 = step(eng.params, torch.float32, "reference")
    q, k, v, t, sl, kw = first[0]
    got, want = real(q, k, v, t, sl, **kw).float(), pa.paged_attention_plain(q, k, v, t, sl).float()
    rows = [i for i, r in enumerate(slot_rids) if r is not None]
    rel = [((got[i] - want[i]).norm() / want[i].norm()).item() for i in rows]
    del params16

    def dmax(a, b):
        return (a - b).abs().max().item()

    tol = 2 * dmax(ref, fp32)
    out = {"heads": f"{q.shape[1]}/{k.shape[2]}", "rows": len(rows),
           "kernel_vs_reference": dmax(kernel, ref), "reference_vs_fp32": dmax(ref, fp32),
           "kernel_vs_fp32": dmax(kernel, fp32), "tolerance": tol,
           "kernel_rel_max": max(rel), "rel_tol": pa.REL_TOL[torch.bfloat16]}
    out["ok"] = (out["kernel_vs_reference"] <= tol and out["kernel_vs_fp32"] <= tol
                 and out["kernel_rel_max"] <= out["rel_tol"])
    return out


def _tp_serve(device, cfg, rank):
    """The tp phase's serving runs of one model on this rank of the world
    of 2 (module docstring, phase 23): the tp 2 wave
    (``serve_layout="tp=2"``: rank 0 drives the engine, rank 1 follows),
    for Llama the bf16 step at the ranks' heads, the control wave
    (``TensorParallel.reduce`` the identity on both ranks), then rank 0's
    one-rank wave while rank 1 waits. Rank 0's result holds the
    comparisons."""
    import numpy as np
    import torch

    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.parallel import tensor
    from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine, layout
    from fms_fsdp_tpu_torch.serve.families import family_of, init_params_for
    from fms_fsdp_tpu_torch.utils.dist import barrier
    from fms_fsdp_tpu_torch.utils.tree import tree_map

    cuda = device == "cuda"
    llama = family_of(cfg) == "llama"  # Mixtral decodes without the kernel
    wave = TP_SERVE_WAVE
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # the whole fp32 weights on the host (every rank, as a user's engine
    # gets them); drawn on the card from the seed
    gen = torch.Generator(device=device).manual_seed(wave["seed"])
    params = tree_map(lambda w: w.cpu(), init_params_for(cfg)(gen))
    rng = np.random.RandomState(wave["seed"])
    prompts = [rng.randint(0, cfg.src_vocab_size, size=int(n)).tolist() for n in
               rng.randint(wave["min_prompt"], wave["max_prompt"] + 1, size=wave["requests"])]
    out = {"init_s": time.perf_counter() - t0, "layers": cfg.nlayers}
    if cuda:
        out["draw_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    firsts = {}

    def engine(serve_layout):
        return ServingEngine(params, cfg, ServeConfig(**TP_SERVE_KW, serve_layout=serve_layout),
                             device=device)

    # the tp 2 wave: its launches counted on each rank; then a refill for
    # the bf16 step
    pa.reset_launches()
    tensor.reset_collectives()
    layout.reset_messages()
    t0 = time.perf_counter()
    eng = engine("tp=2")
    out["build_s"] = time.perf_counter() - t0
    if eng.is_leader:
        out["tp"], firsts["tp"] = _tp_wave(eng, prompts, wave["max_new"])
        out["tp"]["messages"] = dict(layout.MESSAGES)
        eng.release_followers()
    else:
        out["follower_calls"] = eng.follow()
    out["launches"] = dict(pa.LAUNCHES)
    out["head_launches"] = dict(pa.HEAD_LAUNCHES)
    out["pool_shape"] = list(eng.cache.pools["k"].shape)
    if llama:
        if eng.is_leader:
            for p in prompts:
                eng.submit(p, wave["max_new"])
            steps = eng.decode_steps
            while eng.decode_steps < steps + TP_SERVE_BF16_STEPS:
                eng.step()
            eng.release_followers()
        else:
            eng.follow()
        out["bf16_step"] = _tp_bf16_step(eng, device)
    pa.reset_launches()
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the control: the row-parallel reduces dropped on both ranks
    reduce = tensor.TensorParallel.reduce
    tensor.TensorParallel.reduce = lambda self, x: x
    try:
        eng = engine("tp=2")
        if eng.is_leader:
            out["control"], firsts["control"] = _tp_wave(eng, prompts, wave["max_new"])
            eng.release_followers()
        else:
            eng.follow()
    finally:
        tensor.TensorParallel.reduce = reduce
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # one rank: rank 0's engine over no group, rank 1 waiting
    if rank == 0:
        eng = engine("")
        out["one_rank"], firsts["one_rank"] = _tp_wave(eng, prompts, wave["max_new"])
        del eng
        one = firsts["one_rank"]

        def rel(name):
            return ((firsts[name] - one).abs().max() / one.abs().max()).item()

        out["tokens_equal"] = out["tp"]["tokens"] == out["one_rank"]["tokens"]
        out["control_tokens_equal"] = out["control"]["tokens"] == out["one_rank"]["tokens"]
        out["first_logits_rel"] = rel("tp")
        out["control_first_logits_rel"] = rel("control")
        out["rel_tol"] = TP_SERVE_REL_TOL
        for name in ("control", "one_rank"):
            out[name].pop("tokens")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    barrier()
    if cuda:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["wall_s"] = time.perf_counter() - t0
    return out


def _wait_tp_marker(children, name):
    """Seconds waited until every tp rank has finished run ``name`` and
    released its memory (its marker file), or one has exited (the tp
    phase reports why); raises after ``TP_MARKER_TIMEOUT_S``."""
    t0 = time.perf_counter()
    root = children[0].root
    while not all(os.path.exists(os.path.join(root, f"{name}_done_rank{r}"))
                  for r in range(len(children))):
        if any(c.proc.poll() is not None for c in children):
            break
        if time.perf_counter() - t0 > TP_MARKER_TIMEOUT_S:
            raise AssertionError(f"tp: the ranks' {name} run took over {TP_MARKER_TIMEOUT_S} s")
        time.sleep(0.2)
    return time.perf_counter() - t0


def _start_tp_children():
    """The tp phase's two ranks, started on the one card: torchrun's
    environment for a world of 2 on this host (``LOCAL_WORLD_SIZE`` 2
    over one card: the ranks share it, a gloo world)."""
    import socket

    import torch

    # the card's memory for the two ranks' Mixtral-width runs (ep-ref peaks
    # at ~36 GB a rank): nothing cached here, and the children's
    # allocators grow their segments rather than keep unused blocks
    gc.collect()
    torch.cuda.empty_cache()
    root = _ckpt_dir("tp")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    spec = json.dumps({"root": root})
    children = []
    for r in range(TP_SIZE):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(r), WORLD_SIZE=str(TP_SIZE),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(TP_SIZE),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        child = _Child("chip_smoke", ["--tp-child", spec], os.path.join(root, f"rank{r}.log"),
                       TP_TIMEOUT_S, cwd=root, env=env)
        child.root = root
        children.append(child)
    return children


def phase_tp(state):
    """Tensor parallelism on the card (docstring, phase 23): the two
    children (started by an earlier phase to run beside it, else now)
    joined and checked."""
    children = state.pop("tp-children", None) or _start_tp_children()
    root = children[0].root
    t_join = time.perf_counter()
    joins = [c.join() for c in children]
    join_wait_s = time.perf_counter() - t_join
    logs = []
    for c in children:
        with open(c.log) as f:
            logs.append(f.read())
    result = {"config": {name: kw for name, _, kw in TP_RUNS}, "nvidia_smi": state["smi"],
              "exits": [j[0] for j in joins], "child_wall_s": [j[1] for j in joins],
              "join_wait_s": join_wait_s}
    if any(j[0] != 0 for j in joins):
        raise AssertionError("tp: a child exited "
                             + "; ".join(f"{j[0]}:\n{log[-3000:]}" for j, log in zip(joins, logs)))
    ranks = []
    for r in range(TP_SIZE):
        with open(os.path.join(root, f"tp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    problems = []
    mesh_lines = [ln for ln in logs[0].splitlines() if ln.startswith("Sharding strategy")]
    result["mesh_lines"] = mesh_lines
    if len(mesh_lines) != len(TP_RUNS):
        problems.append(f"mesh lines {mesh_lines}: expected one a run of {len(TP_RUNS)}")
    for (name, _, _), line in zip(TP_RUNS, mesh_lines):
        # each run's own mesh, on the gloo group
        if f"mesh = {_tp_expected_mesh(name)[0]}" not in line or "process group = gloo" not in line:
            problems.append(f"{name}: mesh line {line!r}: expected {_tp_expected_mesh(name)[0]} "
                            f"and a gloo group")
    for name, _, _ in TP_RUNS:
        runs = [rk[name] for rk in ranks]
        result[name] = {k: [run[k] for run in runs] for k in runs[0]}
        mesh, heads_at = _tp_expected_mesh(name)
        if any(run["backend"] != "gloo" or run["mesh"] != mesh for run in runs):
            problems.append(f"{name}: process group / mesh {[(r['backend'], r['mesh']) for r in runs]}")
        if name not in TP_CONTROLS and runs[0]["losses"] != runs[1]["losses"]:
            problems.append(f"{name}: the ranks' losses differ {[r['losses'] for r in runs]}")
        if not all(math.isfinite(x) for run in runs for x in run["losses"]):
            problems.append(f"{name}: non-finite losses")
        for run in runs:
            n, steps = run["layers"], run["steps"]
            want = {"fwd": steps * (n + run["remat"]), "dq": steps * n, "dkv": steps * n}
            got = {k: run["launches"][k] for k in want}
            heads = {k: run["head_launches"][k] for k in want}
            if got != want or heads != {k: {heads_at: v} for k, v in want.items()}:
                problems.append(f"{name}: launches {got}, by heads {heads}; expected {want} "
                                f"at {heads_at}")
    _tp_slice_checks(ranks, result, problems)
    _tp_expert_checks(ranks, result, problems)
    # the references (``TP_REFERENCES``, which main makes run too): the
    # shard phase's hsdp run, train-mixtral's first two steps (losses and
    # gradient norms)
    shard, mix = state["shard"], state["train-mixtral"]
    refs = {"llama": {"losses": shard["losses"]["hsdp"], "gnorms": shard["gnorms"]["hsdp"]},
            "mixtral": {"losses": mix["losses"][:2], "gnorms": mix["gnorms"][:2]}}
    result["references"] = refs

    def rel_diff(run, ref):
        return max(abs(a - b) / abs(b) for key in ("losses", "gnorms")
                   for a, b in zip(run[key], ref[key]))

    for name in ("llama", "mixtral"):
        result[f"{name}_max_rel_diff"] = rel_diff(ranks[0][name], refs[name])
        if not result[f"{name}_max_rel_diff"] <= SHARD_REL_TOL:
            problems.append(f"{name} losses / gradient norms {ranks[0][name]['losses']} / "
                            f"{ranks[0][name]['gnorms']} vs {refs[name]}")
    # the control's one step against the reference's first
    result["control_rel_diff"] = rel_diff(ranks[0]["control"], refs["llama"])
    if result["control_rel_diff"] <= SHARD_REL_TOL:
        problems.append(f"the control passes the check: {ranks[0]['control']['losses']} / "
                        f"{ranks[0]['control']['gnorms']}")
    result["peak_bytes_per_child"] = [max(rk[n]["max_memory_allocated"] for n, _, _ in TP_RUNS)
                                      for rk in ranks]
    result["peak_bytes_by_run"] = {n: [rk[n]["max_memory_allocated"] for rk in ranks]
                                   for n, _, _ in TP_RUNS}
    result["serve"] = _tp_serve_checks([rk["serve"] for rk in ranks], problems)
    result["serve_mixtral"] = _tp_serve_checks([rk["serve_mixtral"] for rk in ranks], problems,
                                               "mixtral")
    emit("tp", **result)
    state["tp"] = result
    shutil.rmtree(root)
    if problems:
        raise AssertionError("tp: " + "; ".join(problems))


def _tp_slice_checks(ranks, result, problems):
    """The multi-slice runs' checks (module docstring, phase 23) on both
    ranks' results; what the tp line prints of them goes into
    ``result["slices_checks"]``."""
    def rel_diff(run, ref):
        return max(abs(a - b) / abs(b) for key in ("losses", "gnorms")
                   for a, b in zip(run[key], ref[key]))

    out = {}
    for r, rk in enumerate(ranks):
        on, off, ddp, control = (rk[n] for n in ("slices", "slices-off", "ddp",
                                                 "slices-control"))
        if (on["losses"], on["gnorms"]) != (off["losses"], off["gnorms"]):
            problems.append(f"slices: rank {r}'s overlap on {on['losses']} / {on['gnorms']} "
                            f"and off {off['losses']} / {off['gnorms']} are not bit-equal")
        out[f"rank{r}_slices_vs_ddp_max_rel_diff"] = d = rel_diff(on, ddp)
        if not d <= SHARD_REL_TOL:
            problems.append(f"slices: rank {r} {d} from ddp, over {SHARD_REL_TOL}")
        out[f"rank{r}_control_vs_ddp_rel_diff"] = c = rel_diff(control, ddp)
        if c <= SHARD_REL_TOL:
            problems.append(f"slices-control: rank {r} passes the check ({c})")
        plan = on["plan"] or {}
        if plan.get("buckets", 0) < 2 or on["dcn_reduces"] != on["steps"] * plan["buckets"]:
            problems.append(f"slices: rank {r} plan {plan}, {on['dcn_reduces']} cross-slice "
                            f"reduces over {on['steps']} steps")
        if off["plan"] is not None or off["dcn_reduces"] or ddp["dcn_reduces"]:
            problems.append(f"slices-off / ddp: rank {r} plan {off['plan']}, reduces "
                            f"{off['dcn_reduces']} / {ddp['dcn_reduces']}")
        split = on["collective_split"]
        if not (split["dcn_collective_s"] > 0 and 0.0 <= split["dcn_overlap_frac"] <= 1.0):
            problems.append(f"slices: rank {r}'s record {split}")
    out["buckets"] = ranks[0]["slices"]["plan"]
    result["slices_checks"] = out


def _tp_expert_checks(ranks, result, problems):
    """The expert-parallel runs' checks (module docstring, phase 23) on
    both ranks' results, into ``result["ep_checks"]``: ``ep`` within
    ``SHARD_REL_TOL`` of ``ep-ref`` (losses and gradient norms), the
    control outside it at its one step, the exchanges a step (two a layer
    in the forward, in the rematerialised forward and in the backward:
    ``EXPERT_A2A``) on ``ep`` and none on ``ep-ref``, the dropped share
    of the first step equal on both (the routing is each rank's rows'
    under the same weights) and of each later step within
    ``EP_DROP_ABS_TOL`` (the weights equal up to the gradients'
    rounding: a router near-tie may flip)."""
    def rel_diff(run, ref):
        return max(abs(a - b) / abs(b) for key in ("losses", "gnorms")
                   for a, b in zip(run[key], ref[key]))

    out = {}
    for r, rk in enumerate(ranks):
        ep, ref, control = (rk[n] for n in ("ep", "ep-ref", "ep-control"))
        out[f"rank{r}_ep_vs_ref_max_rel_diff"] = d = rel_diff(ep, ref)
        if not d <= SHARD_REL_TOL:
            problems.append(f"ep: rank {r} {d} from ep-ref, over {SHARD_REL_TOL}")
        out[f"rank{r}_control_vs_ref_rel_diff"] = c = rel_diff(control, ref)
        if c <= SHARD_REL_TOL:
            problems.append(f"ep-control: rank {r} passes the check ({c})")
        want = ep["steps"] * 2 * (2 * ep["layers"] + ep["remat"])
        out[f"rank{r}_expert_a2a"] = [ep["expert_a2a"], ref["expert_a2a"]]
        if ep["expert_a2a"] != want or ref["expert_a2a"] != 0:
            problems.append(f"ep: rank {r} exchanges {ep['expert_a2a']} (expected {want}), "
                            f"ep-ref {ref['expert_a2a']} (expected 0)")
        out[f"rank{r}_drop_frac"] = [ep["drop_frac"], ref["drop_frac"]]
        drops = list(zip(ep["drop_frac"], ref["drop_frac"]))
        if drops[0][0] != drops[0][1] or any(abs(a - b) > EP_DROP_ABS_TOL for a, b in drops):
            problems.append(f"ep: rank {r} dropped shares {ep['drop_frac']} vs ep-ref "
                            f"{ref['drop_frac']}")
    result["ep_checks"] = out


def _tp_serve_checks(serve, problems, model="llama"):
    """The serving runs' checks of one model (module docstring, phase
    23): rank 0's comparisons, each rank's launches (Llama: decode steps
    x layers at ``TP_HEADS``; Mixtral: none) and Llama's bf16 step.
    Returns what the tp line prints of them."""
    lead = serve[0]
    layers = lead["layers"]
    steps = lead["tp"]["decode_steps"]
    want = steps * layers if model == "llama" else 0
    tag = "serve" if model == "llama" else f"serve {model}"
    for name in ("tp", "control", "one_rank"):
        if not lead[name]["finished"]:
            problems.append(f"{tag} {name}: not every request finished with max_new_tokens")
    if not lead["tokens_equal"]:
        problems.append(f"{tag}: the tp 2 wave's tokens differ from the one-rank wave's")
    if not lead["first_logits_rel"] <= TP_SERVE_REL_TOL:
        problems.append(f"{tag}: first-step logits {lead['first_logits_rel']} from the "
                        f"one-rank wave's, over {TP_SERVE_REL_TOL}")
    if lead["control_first_logits_rel"] <= TP_SERVE_REL_TOL:
        problems.append(f"{tag}: the control passes the logits check "
                        f"({lead['control_first_logits_rel']})")
    if lead["tp"]["serve_layout"] != 201.0:
        problems.append(f"{tag}: serving_stats serve_layout {lead['tp']['serve_layout']}")
    for r, rank in enumerate(serve):
        heads = {TP_HEADS: want} if want else {}
        if sum(rank["launches"].values()) != want or rank["head_launches"] != heads:
            problems.append(f"{tag} rank {r}: paged-decode launches {rank['launches']}, by "
                            f"heads {rank['head_launches']}; expected {want} ({steps} "
                            f"decode steps) at {TP_HEADS}")
        if model == "llama" and (not rank["bf16_step"]["ok"]
                                 or rank["bf16_step"]["heads"] != TP_HEADS):
            problems.append(f"{tag} rank {r}: bf16 step {rank['bf16_step']}")
    out = {k: v for k, v in lead.items() if k not in ("tp", "control", "one_rank")}
    out.update({f"{name}_{k}": lead[name][k] for name in ("tp", "control", "one_rank")
                for k in ("wall_s", "decode_steps", "decode_tokens_per_s",
                          "collectives_per_decode_step")})
    out["tp_tokens_first_request"] = lead["tp"]["tokens"][0]
    out["tp_messages"] = lead["tp"]["messages"]
    out["config"] = {"layers": layers, "wave": TP_SERVE_WAVE, "serve": TP_SERVE_KW}
    out["ranks"] = [{k: rank.get(k) for k in ("launches", "head_launches", "pool_shape",
                                              "bf16_step", "max_memory_allocated",
                                              "draw_peak_bytes", "follower_calls", "init_s",
                                              "build_s", "wall_s")}
                    for rank in serve]
    out["launches"] = {key: sum(rank["launches"][key] for rank in serve)
                       for key in serve[0]["launches"]}
    return out


def kernels_line(state):
    k, s, s8 = state["kernels"], state["serve"], state["serve-int8"]
    entries = []

    def by_contract(r):
        if "launches" in r:
            return r["launches"]
        other = "v1" if r["contract"] == "v2" else "v2"
        return {r["contract"]: r["kernel_launches"], other: r["other_contract_launches"]}

    # launches of each contract on the serving main paths (the contract of
    # an engine's launches follows its pools and the split the tuning table
    # set): the serve waves, chunked prefill, the decode-role engines, and
    # the fleets' decode children and ranks (their own counts, from their
    # stats files)
    runs = {"serve": s, "chunked": s["chunked"], "disagg": s["disagg"], "serve-int8": s8,
            "disagg-int8": s8["disagg"]}
    for name, key, kind in (("paged_decode_v1", "v1", "bf16"), ("paged_decode_v2", "v2", "int8")):
        r = k[kind]
        per_run = {run: by_contract(x)[key] for run, x in runs.items()}
        per_run["fleet"] = state["fleet_launches_v1"] if key == "v1" else 0
        # the layout fleet's ranks at 16 / 4 heads (a follower counts from
        # its start, its warmup's decode steps included)
        per_run["fleet_layout"] = state["fleet_layout_launches"][key]
        # the tp phase's fp32 wave at the ranks' 16 / 4 heads, both ranks
        per_run["tp"] = state["tp"]["serve"]["launches"][key]
        entries.append({
            "name": name, "route": "cuda",
            "source": "fms_fsdp_tpu_torch/csrc/paged_decode.cu",
            "replaces": REPLACES[key], "launches": sum(per_run.values()),
            "launches_by_run": per_run,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    # bf16 readings: the training shape for the resident contracts, the
    # 16384-token shape for the kvgrid ones; the forward and dq at each key
    # tile (``*_bk64`` the 64-key instantiations), their launches those of
    # that tile on the trainers' main paths (train, train-kvgrid and the
    # tune phase's runs); dk/dv has one tile
    main_runs = [state[p]["launches_by_block_k"] for p in ("train", "train-kvgrid")]
    main_runs += [r["launches_by_block_k"] for r in state["tune"]["runs"].values()]
    for contract, kernel, case, phase, outs, tile in (
        ("fwd", "fwd", "train", "train", ("o", "lse"), 128),
        ("fwd_kvgrid", "fwd", "kvgrid", "train-kvgrid", ("o", "lse"), 128),
        ("dq", "dq", "train", "train", ("dq",), 128),
        ("dq_kvgrid", "dq", "kvgrid", "train-kvgrid", ("dq",), 128),
        ("fwd", "fwd", "train", "train", ("o", "lse"), 64),
        ("fwd_kvgrid", "fwd", "kvgrid", "train-kvgrid", ("o", "lse"), 64),
        ("dq", "dq", "train", "train", ("dq",), 64),
        ("dq_kvgrid", "dq", "kvgrid", "train-kvgrid", ("dq",), 64),
        ("dkv", "dkv", "train", "train", ("dk", "dv"), None),
    ):
        r = state["flash"][("bf16", case)]
        t = r["times" if tile != 64 else "times_block_k_64"][kernel]
        errs = (r if tile != 64 else r["block_k_64"])["max_abs_err"]
        launches = (state[phase]["launches"][contract] if tile is None else
                    sum(run.get(contract, {}).get(tile, 0) for run in main_runs))
        entry = {
            "name": f"flash_{contract}" + ("_bk64" if tile == 64 else ""), "route": "cuda",
            "source": f"fms_fsdp_tpu_torch/csrc/flash_{'fwd' if kernel == 'fwd' else 'bwd'}_sm90.cu",
            "replaces": REPLACES[contract], "block_k": tile or 128,
            "launches": launches,
            "max_abs_err": max(errs[o] for o in outs),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }
        if contract in ("fwd", "dq", "dkv") and tile != 64:
            # the same contracts on the Mixtral training path, counted on
            # its own run, and under the quantized GEMMs (train-quant's
            # quantized runs of the three trainers together)
            entry["launches_train_mixtral"] = state["train-mixtral"]["launches"][contract]
            entry["launches_train_quant"] = state["train-quant"]["launches"][contract]
            # and on the ring through the Mixtral model (the ring phase)
            entry["launches_ring_mixtral"] = (
                state["ring"]["ring_moe"]["launches"]["by_contract"][contract])
            # and on the tp phase's two ranks (Llama and Mixtral, the
            # control left out), every one at a rank's 16 / 4 heads
            entry["launches_tp"] = sum(l[contract] for name in ("llama", "mixtral")
                                       for l in state["tp"][name]["launches"])
            entry["launches_tp_heads"] = TP_HEADS
            # and on its multi-slice runs (the controls left out), both
            # ranks, every one at the whole model's 32 / 8 heads
            entry["launches_slices"] = sum(l[contract] for name in ("slices", "slices-off")
                                           for l in state["tp"][name]["launches"])
            entry["launches_slices_heads"] = SLICE_HEADS
            # and on its expert-parallel runs and their reference (the
            # control left out), both ranks, at the whole 32 / 8 heads
            entry["launches_ep"] = sum(l[contract] for name in ("ep", "ep-ref")
                                       for l in state["tp"][name]["launches"])
            entry["launches_ep_heads"] = SLICE_HEADS
        if contract == "fwd" and tile != 64:
            # the frozen base forward of the speculator's stage 1, and
            # eval_ppl's forwards (Llama and the Mamba hybrid's attention)
            entry["launches_train_speculator"] = state["train-speculator"]["launches"]["fwd"]
            entry["launches_train_speculator_int8"] = (
                state["train-speculator"]["int8_base"]["flash_fwd_per_step"]
                * len(state["train-speculator"]["int8_base"]["per_step"]))
            entry["launches_hf_eval"] = state["hf-eval"]["launches"]["fwd"]
        if kernel != "fwd":
            # SDPA's one backward call computes dq, dk and dv together: set
            # it against the pair
            entry["pair_ms"] = r["times" if tile != 64 else "times_block_k_64"]["bwd_pair"]["ms"]
        entries.append(entry)
    # the two modes ring attention adds (non-causal, dq stored fp32), timed
    # at the flash phase's training shape at key tile 128; their launches
    # those of the ring phase's S=32768 ring, and beside them those of its
    # ring through the Mixtral model
    ring = state["ring"]
    c128 = ring["contracts"]["block_k_128"]
    by_mode = ring["ring"]["launches"]["by_mode"]
    moe_by_mode = ring["ring_moe"]["launches"]["by_mode"]
    for name, kernel, mode, replaces, err in (
        ("flash_fwd_noncausal", "fwd", "fwd_noncausal", "fwd",
         max(c128["max_abs_err"]["o"], c128["max_abs_err"]["lse"])),
        ("flash_dq_noncausal", "dq", "dq_noncausal", "dq", c128["max_abs_err"]["dq"]),
        ("flash_dkv_noncausal", "dkv", "dkv_noncausal", "dkv",
         max(c128["max_abs_err"]["dk"], c128["max_abs_err"]["dv"])),
        ("flash_dq_f32", "dq_f32", "dq_f32", "dq", c128["dq_f32"]["max_abs_err"]),
    ):
        t = ring["contracts"]["times"][kernel]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"fms_fsdp_tpu_torch/csrc/flash_{'fwd' if kernel == 'fwd' else 'bwd'}_sm90.cu",
            "replaces": REPLACES[replaces], "block_k": 128, "launches": by_mode[mode],
            "launches_ring_mixtral": moe_by_mode[mode], "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    r = state["ssd"][("bf16", "train")]
    t = r["times"]
    entries.append({
        "name": "ssd_fused", "route": "cuda",
        "source": r["source"],
        "replaces": REPLACES["ssd_fused"],
        "launches": state["train-mamba"]["launches"]["ssd_fused"],
        # eval_ppl on the Mamba hybrid; the fp8_dgrad Mamba trainer
        "launches_hf_eval": state["hf-eval"]["launches"]["ssd_fused"],
        "launches_train_quant": state["train-quant"]["launches"]["ssd_fused"],
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
    ap.add_argument("--tp-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    missing = [p for p in TP_REFERENCES if "tp" in phases and p not in phases]
    if missing:
        ap.error(f"the tp phase checks its runs against the {missing} phases' runs: "
                 "run them too")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # the port must be importable beside this script; no fallback
    import fms_fsdp_tpu_torch.serve  # noqa: F401

    if args.tp_child is not None:
        return _tp_child(json.loads(args.tp_child))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = {"phases": phases}
    run = {
        "device": phase_device, "build": phase_build,
        "kernels": phase_kernels, "serve": phase_serve,
        "serve-int8": phase_serve_int8, "train-speculator": phase_train_speculator,
        "serve-spec": phase_serve_spec, "fleet": phase_fleet, "flash": phase_flash,
        "ring": phase_ring,
        "train": phase_train, "loader": phase_loader, "resume": phase_resume,
        "supervise": phase_supervise, "shard": phase_shard, "hf-eval": phase_hf_eval,
        "train-kvgrid": phase_train_kvgrid, "tune": phase_tune,
        "ssd": phase_ssd, "train-mamba": phase_train_mamba,
        "serve-mamba": phase_serve_mamba,
        "train-mixtral": phase_train_mixtral, "serve-mixtral": phase_serve_mixtral,
        "train-quant": phase_train_quant, "tp": phase_tp,
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
        # a child a failed phase started for a later one outlives no run
        for child in ("shard-child", "hf-llama-child"):
            if child in state:
                state.pop(child).kill()
        for child in state.pop("tp-children", []):
            child.kill()
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
