"""Run configuration.

A copy of ``fms_fsdp_tpu/config/training.py::TrainConfig`` with the same
fields and defaults, so one command line runs both packages. The port's
trainer (``main_training_llama.py``) reads the fields of the Llama
training path and checks them (``train/step.py::check_supported``), and
fields that only shape a JAX compile have no effect in eager PyTorch:

- ``scan_layers``: the layer stack is a Python loop either way;
- ``low_cpu_fsdp``: parameters are made on the card directly;
- ``kernel_tuning`` / ``kernel_tuning_table`` read the port's own table
  (``tune/kernel_tuning_h100.json``, written on the card by
  ``scripts/torch_autotune_kernels.py``), never JAX's
  ``KERNEL_TUNING.json``: its tiles are the Hopper kernels';
- ``flash_kernel_variant``: one CUDA kernel fulfils both the resident
  and the kv-streamed (kvgrid) contract of the Pallas kernels; the field
  only picks which contract a launch is counted under
  (``ops/flash_attention.py::LAUNCHES``, set by ``make_train_step``), and
  "resident" caps the eligible sequence at 8192 as in JAX. None means
  "auto": the port reads no ``FLASH_KERNEL_VARIANT`` environment value.

``attention_kernel`` keeps JAX's values, with one difference: on the card
"auto" runs the flash kernels or raises where they cannot run, as
"pallas" does, and never falls to the einsum path
(``ops/attention.py::use_kernel``).
"""

from dataclasses import dataclass, field
from typing import Optional, Union


@dataclass
class TrainConfig:
    # model
    model_variant: str = "llama2_7b"
    ckpt_load_path: str = "/tmp/output/ckpt"
    ckpt_save_path: str = "/tmp/output/ckpt"

    # dataset and dataloader (ref:fms_fsdp/config/training.py:12-28)
    use_dummy_dataset: bool = False
    data_path: str = "/tmp/data"
    file_type: str = "arrow"
    col_name: str = "tokens"
    tokenizer_path: str = "/tmp/tokenizer"
    datasets: str = "dataset=commoncrawl"
    weights: str = "1"
    # Multi-corpus fault isolation (docs/dataloader.md "Multi-corpus
    # mixing"): when every owned shard of one corpus dies, the corpus is
    # quarantined and the mix degrades gracefully (weights renormalized
    # over survivors, survivor epoch boundaries re-probe it) as long as
    # at least this many corpora stay live; dropping below the floor —
    # losing the last corpus always does — exits with the classified
    # ``corpus_loss`` code the run supervisor restarts on.
    min_live_corpora: int = 1
    # Resume-state pairing is by corpus NAME; a changed corpus set
    # (added/removed/renamed vs the checkpoint) is a hard error unless
    # this escape hatch accepts it (removed corpora drop their stream
    # position, new corpora start cold at zero tokens_seen).
    allow_corpus_change: bool = False
    seq_length: int = 4096
    vocab_size: int = 32000
    bos_token: Optional[int] = None
    eos_token: int = 0
    bol_token: Optional[int] = None
    eol_token: Optional[int] = None
    strip_tokens: str = ""
    logical_shards: int = 1024
    num_workers: int = 1
    # reservoir-shuffle window (rows) in the loader pipeline; the
    # reference hardcodes 10000 — configurable so small corpora (tests,
    # debug runs) don't spin the document walk into its second epoch
    # just filling the reservoir (see data/loader.py)
    loader_shuffle_window: int = 10000
    # "thread" workers rely on GIL-releasing rust tokenization; "process"
    # forks workers (the reference's torch DataLoader model) for host
    # parallelism immune to GIL contention in pure-Python pipeline stages
    worker_mode: str = "thread"
    # DeviceFeed host->device prefetch depth (data/device_feed.py).
    # 0 = fully synchronous staging: with num_workers=1 (the workerless
    # zero-skew loader path) the whole data pipeline advances exactly
    # with consumption, so a checkpoint's loader state equals the
    # consumed position and a restart replays nothing AND skips nothing
    # — the mode chaos certification runs under (scripts/chaos_soak.py).
    # Production keeps the default double-buffering.
    feed_prefetch: int = 2

    # sharding. ``sharding_strategy`` keeps the reference vocabulary
    # (ddp | fsdp | hsdp | tp, ref:fms_fsdp/config/training.py:31) but maps to
    # a jax.sharding.Mesh instead of torch FSDP wrapping:
    #   ddp  -> params replicated, batch sharded over the whole mesh
    #   fsdp -> params sharded over one "fsdp" axis (ZeRO-3 analog)
    #   hsdp -> 2-D ("replica", "fsdp") mesh: shard within an ICI-local group,
    #           replicate across groups (DCN axis on multi-slice)
    # plus optional tensor/context axes that the reference lacks.
    sharding_strategy: str = "hsdp"
    sharding_group_size: Optional[int] = None  # fsdp-axis size for hsdp; None = one group per host/slice
    tensor_parallel_size: int = 1  # "tensor" mesh axis (megatron-style TP)
    context_parallel_size: int = 1  # "context" mesh axis (ring/blockwise attention)
    expert_parallel_size: int = 1  # "expert" mesh axis (MoE expert parallelism)
    # Multi-slice (docs/train_details.md "Multi-slice"): the outermost
    # "dcn" data-parallel mesh axis spans TPU slices — shard/compute
    # within a slice over ICI, all-reduce gradients across slices over
    # DCN, with the slice as the elastic-resume fault domain. 0 =
    # auto-detect (device slice metadata, MEGASCALE env, or the
    # FMS_SIM_SLICES gloo-simulation knob); explicit values override the
    # env detection (real device slice metadata, when present, stays
    # authoritative — it reflects the physical DCN topology).
    num_slices: int = 0
    fsdp_activation_checkpointing: bool = False
    selective_checkpointing: Union[float, str] = 1  # fraction of blocks to remat
    mixed_precision: bool = True  # bf16 compute/reduce, fp32 params (bfSixteen analog)
    pure_bf16: bool = False  # keep params in bf16 too (bfSixteen_working analog)
    low_cpu_fsdp: bool = False  # init params directly sharded on device (abstract eval + per-shard init)

    # TPU/XLA-specific compilation & kernel knobs
    scan_layers: bool = True  # lax.scan over the layer stack (fast compiles)
    attention_kernel: str = "auto"  # "auto" | "pallas" | "xla"
    # flash kernel family: "resident" | "kvgrid" force one; "auto" forces
    # by-sequence-length dispatch (resident under the 8k VMEM cap,
    # kv-streamed past it); None = auto. Resolved at every step build.
    flash_kernel_variant: Optional[str] = None
    # the SSD scan of the Mamba mixers (ops/ssd.py): "pallas" and "auto"
    # run the fused CUDA kernel for CUDA tensors (its plain version on the
    # CPU), "xla" the chunked einsums, "reference" the per-token recurrence
    mamba_kernel: str = "auto"
    # Chunked lm-head+CE (never materializes (B,S,V) logits). Costs one
    # extra lm-head pass (~+33% of lm-head FLOPs): a win for models where
    # the head is a small fraction (7B+ at 32k vocab) or when logits memory
    # forces remat; a loss for small embedding-heavy models.
    fused_loss: bool = False
    loss_chunk_size: int = 4096  # tokens per fused-loss logits tile
    # "none" | "int8" (fwd GEMMs on the MXU int8 path, ~2x bf16 rate on
    # v5e+, bf16 backward) | "int8_dgrad" (additionally int8 dx; wgrad
    # stays bf16) | "fp8" / "fp8_dgrad" (e4m3 forward, optionally
    # e5m2-gradient dx; v5p/v6e fp8 MXU path) — see ops/quant.py.
    # TPU-native win with no reference counterpart.
    quantized_matmuls: str = "none"
    # Gradient-reduction wire format (docs/performance.md "Quantized
    # training"): "none" (bit-identical to the unquantized step) |
    # "int8" / "fp8" (scale-carrying reduce, dynamic per-row scales) |
    # "fp8_delayed" (per-leaf scales from an amax history threaded
    # through the train state — checkpoints and elastic-reshards like
    # optimizer state). FSDP throughput is bandwidth-bound, so the
    # reduce bytes are the lever (PAPERS.md "Memory and Bandwidth ...").
    quantized_reduce: str = "none"
    # amax-history window for quantized_reduce="fp8_delayed" (the
    # TransformerEngine-style delayed-scaling recipe)
    fp8_amax_history_len: int = 16
    # Bucketed DCN-overlapped gradient reduction (docs/performance.md
    # "Hiding the DCN", parallel/overlap.py): "auto" buckets the grad
    # tree and anchors each bucket's cross-slice reduce inside the
    # backward on multi-slice meshes (no-op on dcn=1 meshes — their
    # traced step stays bit-identical); "off" skips the overlap path
    # entirely (traces today's program bit-identically on ANY mesh);
    # "on" forces the anchors even on single-slice meshes (debugging).
    # Value-identical either way: the 2-slice e2e pins the final
    # STATE_HASH bit-for-bit against the unbucketed path.
    dcn_overlap: str = "auto"
    # Bucket size target in MB of wire bytes. 0 = resolve through the
    # dcn_bucket tuning entry (KERNEL_TUNING.json cost model / measured,
    # like the kernel tiles above); nonzero pins the size, winning over
    # the table.
    dcn_bucket_mb: int = 0
    # Kernel autotuning: "auto" reads tile/chunk choices for flash, SSD,
    # and fused-CE from the port's committed per-card tuning table
    # (fms_fsdp_tpu_torch/tune/kernel_tuning_h100.json), falling back
    # nearest-signature -> static defaults; "off" forces the static
    # defaults; a path reads that table instead. Resolved once per step
    # build (like flash_kernel_variant) -- pure table + cost-model lookup,
    # never an on-device sweep. Regenerate the table with
    # scripts/torch_autotune_kernels.py on the card.
    kernel_tuning: str = "auto"
    kernel_tuning_table: str = ""  # explicit table path; "" = committed default

    # training spec (ref:fms_fsdp/config/training.py:37-43)
    batch_size: int = 2
    num_steps: int = 1000000
    training_stage: str = "initial"
    learning_rate: float = 3e-4
    grad_clip_thresh: float = 1.0
    seed: int = 2023

    # continued training spec
    resuming_dataset: bool = False

    # resilience (docs/resilience.md). Defaults are safe for production:
    # skip non-finite updates, abort after a sustained bad streak, retry
    # flaky shard reads, restart crashed loader workers, verify
    # checkpoint manifests; the watchdog and fault injection are off.
    anomaly_skip_updates: bool = True  # skip (don't apply) non-finite updates
    anomaly_max_consecutive: int = 8  # abort after K consecutive bad steps
    # Wall-clock hang watchdog; 0 disables. SIZING: the hot loop only
    # dispatches steps asynchronously and blocks at the once-per-
    # report_interval metric fetch, so a stuck collective is detected
    # there — set this to cover a FULL report window of steps plus the
    # first-step compile (e.g. 3 * report_interval * expected_step_time),
    # NOT a single step's time. Checkpoint saves suspend the deadline
    # (a healthy multi-minute Orbax save must not trip it).
    step_timeout_s: float = 0.0
    # Slice fault domains (docs/resilience.md "Slice fault domains"),
    # multi-slice runs only: every process keeps a liveness heartbeat in
    # this SHARED directory ("" = default to <obs_dir>/slice_health when
    # obs_dir is set, else disabled) and the SliceHealthMonitor declares
    # a slice lost after slice_timeout_s of silence — reporting
    # "slice K lost, restart at world minus one fault domain" on every
    # healthy host instead of hanging in the DCN collective. 0 disables.
    slice_heartbeat_dir: str = ""
    slice_timeout_s: float = 0.0
    # Self-healing run supervisor (docs/resilience.md "Self-healing
    # supervisor"; resilience/supervisor.py reads these via
    # supervise_from_config): cap on auto-relaunches, the base of the
    # doubling relaunch backoff, and how many consecutive restarts may
    # fail to advance the heartbeat step before the supervisor gives up
    # with a post-mortem instead of crash-looping forever.
    max_restarts: int = 8
    restart_backoff_s: float = 5.0
    crash_loop_threshold: int = 3
    shard_read_retries: int = 3  # bounded retries per shard IO call
    shard_read_backoff_s: float = 0.5  # initial backoff (doubles per retry)
    loader_worker_restarts: int = 2  # worker restarts before the error surfaces
    loader_restart_backoff_s: float = 1.0  # initial worker-restart backoff
    checkpoint_verify: bool = True  # verify manifests on load, fall back on corruption
    # State integrity (docs/checkpointing.md "State integrity").
    # ckpt_full_checksums: manifest v2 — chunked content checksums for
    # LARGE array files, computed on the async manager's background
    # writer (blocking snapshot time unchanged); off degrades large
    # files to size-only verification like a version-1 manifest.
    ckpt_full_checksums: bool = True
    # Background checkpoint scrubber cadence (steps; 0 disables): rank 0
    # re-verifies every committed checkpoint across all tiers on a
    # daemon thread, quarantining a corrupt step dir (sidecar + one
    # actionable line) so resume routes around it BEFORE a crash needs
    # it. Verdicts are cached by manifest digest — repeat sweeps hash
    # only new commits. scripts/scrub_checkpoints.py is the fleet CLI.
    scrub_interval_steps: int = 0
    # Cross-replica divergence detection cadence (steps; 0 disables;
    # multi-process runs only): at report boundaries every process
    # fingerprints its window scalars + a whole-state checksum (a
    # single sentinel leaf could not see SDC elsewhere in the tree;
    # see resilience/divergence.py) and
    # compares across processes via one tiny allgather — disagreement
    # means a replicated train state silently diverged (SDC / broken
    # reduce) and exits classified ``state_divergence``; the supervisor
    # then relaunches under the verified-resume rule
    # (docs/resilience.md "Cross-replica divergence detection").
    divergence_check_interval: int = 0
    faults: str = ""  # fault-injection spec (testing only; see resilience/faults.py)

    # checkpointing (docs/checkpointing.md). The async manager snapshots
    # device state at the step boundary (blocking) and commits shards +
    # loader state + manifest + metadata from a background writer thread
    # — at most one save in flight, errors surfacing in the next save or
    # finalize(). The durable tier lives at ckpt_save_path on the
    # checkpoint_interval cadence; the optional fast local tier (local
    # SSD/ramdisk) saves frequently with tight retention so a preempted
    # worker restarts from minutes-old state instead of the last durable
    # save.
    ckpt_async: bool = True  # background commit (False = legacy synchronous save)
    ckpt_keep: int = 1000  # durable-tier retention (rolling, by step number)
    ckpt_local_dir: str = ""  # fast-tier root; "" disables the local tier
    ckpt_local_interval: int = 0  # steps between local-tier saves; 0 disables
    ckpt_local_keep: int = 2  # local-tier retention
    # Transient-FS resilience on the commit path (docs/resilience.md):
    # manifest/metadata writes retry with bounded doubling backoff
    # (resilience/retry.py); a durable tier still failing degrades to
    # the fast-local tier (checkpoint.durable_degraded counter) instead
    # of killing the background writer on the first ENOSPC/EIO.
    ckpt_durable_retries: int = 3
    ckpt_durable_backoff_s: float = 0.5
    # Elastic resume (docs/checkpointing.md "Elastic resume"): restarts
    # on a different topology preserve the checkpoint's GLOBAL batch by
    # recomputing per-rank rows; when the new data-parallel extent
    # cannot divide it (or batch_size/seq_length were changed
    # explicitly), the resume is a hard error unless this escape hatch
    # accepts the shifted tokens-per-step / LR-schedule trajectory.
    allow_batch_change: bool = False

    # profiling
    use_profiler: bool = False
    profiler_rank0_only: bool = True

    # observability (docs/observability.md). The print report and the
    # wandb/aim tracker are unchanged; these knobs add the machine-
    # readable record alongside them. obs_dir="" disables the file
    # sinks and heartbeat; the tracker sink auto-attaches whenever
    # cfg.tracker is set.
    obs_dir: str = ""  # where metrics.jsonl / metrics.csv / heartbeat.json land
    obs_sinks: str = "jsonl"  # comma list of jsonl | csv | tracker
    obs_heartbeat: bool = True  # write heartbeat.json at report cadence
    obs_chip_hint: str = ""  # chip gen for MFU peak ("v5e", ...); "" = env/default
    obs_strict_schema: bool = False  # raise (don't just log) on schema violations

    # logging
    report_interval: int = 100
    checkpoint_interval: int = 10000
    tracker: Optional[str] = None  # None, "wandb", "aim"
    tracker_dir: str = "/tmp/aim_logs/llama"
    tracker_project_name: str = "llama"
    tracker_run_id: Optional[str] = None

    # speculator training (ref:fms_fsdp/config/training.py:63-74)
    tp_size: int = 8
    model_arch: str = "embedllama"
    model_path: str = "/path/to/model/"
    n_speculator_heads: int = 3
    speculator_width: int = 4096
    speculator_tie_weights: bool = True
    speculator_scale_input: bool = True
    stage2_start_step: int = 15000
    stage2_prompt_length: int = 64
    stage2_batch_size: int = 96
    stage2_seq_length: int = 256
