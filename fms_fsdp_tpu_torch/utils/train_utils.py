"""The training hot loop, its profiler, tracker and preemption guard.

Counterpart of ``fms_fsdp_tpu/utils/train_utils.py:124-824``, one card
per process: steps until ``num_steps``, keeps each step's metrics as
device tensors, and at every ``report_interval`` fetches the window,
feeds the non-finite flags to the anomaly guard and prints (rank 0) the
reference's report lines (step, loss, LR, tokens seen, gradient norm,
memory, step times, current and overall tokens per chip per second,
overall tokens per day, in its order and with its values) plus MFU and
HFU against the card's peak, then the model family's metrics (Mixtral's
``moe_drop_frac``), which also go to the record's ``extra`` map. Tokens
seen count the whole world (JAX's ``world_size`` factor: every
data-parallel rank trains ``batch_size`` rows a step); the rates are per
card.

The observability and resilience layer runs in JAX's order: the step
watchdog, the ``slice_kill`` / ``dcn_reduce_stall`` fault sites at each
step boundary, the observer (``data_wait`` around the batch iterator,
``compute`` around the step and the report fetch, ``checkpoint`` inside
saves, one schema-versioned record per report with the loader's
``data_mix``, and the heartbeat), the checkpoint scrubber, the anomaly
abort (save, then raise ``AnomalyAbort``: exit ``anomaly_abort`` under
``classified_exit``), the preemption save on SIGTERM, agreed across the
processes so every rank saves at the same step (then a clean exit), the
``sdc_grad_flip`` site at the step boundary and the cross-replica
divergence compare at report cadence (``resilience/divergence.py``; a
world of one has nothing to compare, as in JAX), and the windowed
``torch.profiler`` trace. The slice health monitor waits for ROADMAP.md
A.6b.
"""

import os
import signal
import time
from contextlib import nullcontext
from dataclasses import asdict
from typing import Dict, List

import torch

from fms_fsdp_tpu_torch.obs import build_observer
from fms_fsdp_tpu_torch.obs.sinks import TrackerSink
from fms_fsdp_tpu_torch.resilience import divergence as _divergence
from fms_fsdp_tpu_torch.resilience import scrub as _scrub
from fms_fsdp_tpu_torch.resilience.exits import EXIT_CODES
from fms_fsdp_tpu_torch.resilience.faults import fire_fault
from fms_fsdp_tpu_torch.resilience.guards import AnomalyGuard, StepWatchdog
from fms_fsdp_tpu_torch.resilience.integrity import drain_integrity_events
from fms_fsdp_tpu_torch.utils.dist import any_flag, world_size


class AnomalyAbort(RuntimeError):
    """The guard saw ``anomaly_max_consecutive`` non-finite steps in a row
    and the loop saved and aborted on purpose (JAX's ``DeliberateAbort``):
    classified ``anomaly_abort`` by the entry wrapper."""


def get_tracker(cfg, rank: int):
    """Optional wandb/aim tracker (ref:train_utils.py:34-73). Returns a
    log_fn(dict, step) or None."""
    if not cfg.tracker:
        return None
    if cfg.tracker not in ["wandb", "aim"]:
        raise ValueError(f"tracker {cfg.tracker} not supported.")
    if rank != 0:
        return None
    if cfg.tracker == "wandb":
        try:
            import wandb
        except ImportError:
            raise ImportError("tracker is set to wandb but wandb is not installed.")
        print("--> wandb is enabled!")
        wandb.init(
            project=cfg.tracker_project_name,
            dir=cfg.tracker_dir,
            resume="allow",
            id=cfg.tracker_run_id,
        )
        wandb.config = asdict(cfg)
        return wandb.log
    try:
        from aim import Run
    except ImportError:
        raise ImportError("tracker is set to aim but aim is not installed.")
    print("--> aim is enabled!")
    run = Run(
        experiment=cfg.tracker_project_name,
        repo=cfg.tracker_dir,
        run_hash=cfg.tracker_run_id,
    )
    run["hparams"] = asdict(cfg)
    return run.track


class WindowedProfiler:
    """``torch.profiler`` trace with the reference's window: skip ``wait``
    steps, ``warmup`` more, record ``active`` steps, once
    (ref:train_utils.py:256-271: wait=1, warmup=2, active=3, repeat=1),
    host and card activity, written as a TensorBoard trace
    (``*.pt.trace.json``) to ``logdir``. ``close()`` writes the trace of a
    window an early exit left open."""

    def __init__(self, logdir="profile_traces", wait=1, warmup=2, active=3,
                 device=None):
        from torch.profiler import (
            ProfilerActivity,
            profile,
            schedule,
            tensorboard_trace_handler,
        )

        activities = [ProfilerActivity.CPU]
        if device is not None and torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(
            activities=activities,
            schedule=schedule(wait=wait, warmup=warmup, active=active, repeat=1),
            on_trace_ready=tensorboard_trace_handler(logdir),
        )
        self._prof.start()
        self._running = True

    def step(self):
        if self._running:
            self._prof.step()

    def close(self):
        if self._running:
            self._running = False
            self._prof.stop()


def get_profiler(cfg, rank: int, device=None):
    if not cfg.use_profiler:
        return None
    if cfg.profiler_rank0_only and rank != 0:
        return None
    return WindowedProfiler(device=device)


class PreemptionGuard:
    """SIGTERM -> checkpoint at the next step boundary, then exit clean.

    Preemptible capacity sends SIGTERM with a grace window before
    teardown; the guard turns that window into an up-to-date checkpoint
    instead of a resume from the last interval save. Across processes
    ``poll`` is a collective OR (a small all-reduce on the gloo group
    beside the step's, every rank at every step boundary), so a signal to
    any one rank saves every rank at the same step; a world of one reads
    its own flag."""

    def __init__(self):
        self.triggered = False
        self._prev = None

    def install(self):
        def handler(signum, frame):
            self.triggered = True
            if self._prev not in (None, signal.SIG_DFL, signal.SIG_IGN):
                self._prev(signum, frame)

        try:
            self._prev = signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread (tests, embedded use): no-op
        return self

    def uninstall(self):
        """Put back the handler ``install`` replaced."""
        if self._prev is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev)
            except ValueError:
                pass
            self._prev = None

    def poll(self) -> bool:
        """Call exactly once per step boundary on every rank: the
        world-agreed flag."""
        return any_flag(self.triggered)


def _mix_record(observer, dataloader):
    """Per-corpus data-mix accounting for the report record (schema
    ``data_mix``): drains the SamplingDataset's lifecycle events into the
    registry (data.corpus_quarantined / corpus_rearmed) and reads
    realized-vs-target token shares from the live loader. None when the
    run has no mixing layer (dummy data, process workers)."""
    from fms_fsdp_tpu_torch.data.loader import loader_mix_stats
    from fms_fsdp_tpu_torch.data.streaming import drain_mix_events

    for name, n in drain_mix_events().items():
        if n:
            observer.registry.counter(f"data.{name}").add(n)
    mix = loader_mix_stats(dataloader) if dataloader is not None else None
    if mix is None:
        return None
    total = sum(mix["tokens"].values())
    record = {}
    for corpus, tokens in mix["tokens"].items():
        observer.registry.gauge(f"data.mix.{corpus}.tokens_seen").set(tokens)
        record[f"{corpus}.tokens_seen"] = tokens
        record[f"{corpus}.target_share"] = round(mix["weights"].get(corpus, 0.0), 6)
        record[f"{corpus}.realized_share"] = (
            round(tokens / total, 6) if total else 0.0
        )
        record[f"{corpus}.quarantined"] = 1 if corpus in mix["quarantined"] else 0
    return record


def _memory_stats(device):
    if device.type != "cuda":
        return 0, 0, 0
    return (torch.cuda.memory_reserved(device), torch.cuda.memory_allocated(device),
            torch.cuda.max_memory_allocated(device))


def state_device(state) -> torch.device:
    """The device of a train state: that of its first parameter tensor."""
    tree = state["params"]
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree))
    return tree.device


def train(cfg, state, step_fn, rank, train_loader, checkpointer=None,
          start_step: int = 0, tokens_seen: int = 0, dataloader=None,
          model_cfg=None, device=None, profiler=None, observer=None) -> Dict:
    """Run the hot loop to ``cfg.num_steps``. Returns {"final_loss",
    "reports": one dict per report window, "skipped_batches", "steps"}.

    ``checkpointer`` (a ``Checkpointer`` or the tiered
    ``AsyncCheckpointManager``; None saves nothing) saves when a tier is
    due (``save_due``, or every ``checkpoint_interval`` steps for a plain
    ``Checkpointer``), at ``num_steps``, on a preemption and on an
    anomaly abort, with ``tokens_seen`` and ``skipped_steps`` in the
    metadata; a save that ends the loop drains the pending report window
    first. ``finalize()`` runs on every exit. ``dataloader`` is the
    stateful loader whose state rides the checkpoint (the dummy stream
    has none).

    ``device`` defaults to the state's (:func:`state_device`): a window's
    clock is read after the card has finished its steps. ``observer``
    (obs/) carries the registry, phase timing, sinks and heartbeat; built
    here from ``cfg`` when the entry passed none, and the wandb/aim
    tracker attaches to it as a sink. MFU counts the model FLOPs of a
    step (PaLM appendix B, no remat); HFU adds the recomputed forward of
    the layers ``selective_checkpointing`` rematerialises. Both are
    against the card's dense bf16 peak, and only on a card; on the CPU
    they are None. ``profiler`` (``get_profiler``) steps after each step
    and is closed on every exit.
    """
    device = torch.device(device) if device is not None else state_device(state)
    tracker_fn = get_tracker(cfg, rank)
    if observer is None:
        observer = build_observer(cfg, rank, model_cfg=model_cfg,
                                  tracker_fn=tracker_fn, device=device)
    elif tracker_fn is not None:
        observer.sinks.append(TrackerSink(tracker_fn))
    try:
        return _train_loop(cfg, state, step_fn, rank, train_loader, checkpointer,
                           start_step, tokens_seen, dataloader, device, profiler,
                           observer)
    finally:
        if profiler:
            profiler.close()
        try:
            if checkpointer is not None:
                # joins the in-flight writer and surfaces its error
                checkpointer.finalize()
        finally:
            observer.close()


def _train_loop(cfg, state, step_fn, rank, train_loader, checkpointer, start_step,
                tokens_seen, dataloader, device, profiler, observer) -> Dict:
    from fms_fsdp_tpu_torch.train.step import wrap_step_fn

    guard = AnomalyGuard(max_consecutive=max(1, cfg.anomaly_max_consecutive))
    preemption = PreemptionGuard().install()
    watchdog = None
    if cfg.step_timeout_s > 0:
        hb = observer.heartbeat.path if observer.heartbeat else None
        # rank is passed in: the watchdog's thread asks no library for it
        watchdog = StepWatchdog(cfg.step_timeout_s, heartbeat_path=hb,
                                process_index=rank).start()

    train_loader = observer.wrap_data_iter(train_loader)
    step_fn = wrap_step_fn(step_fn, observer.timer)
    if checkpointer is not None:
        checkpointer.observer = observer

    # the background scrubber re-verifies every tier's committed
    # checkpoints at its cadence, on rank 0 (the sidecars' one writer)
    scrubber = None
    if cfg.scrub_interval_steps > 0 and rank == 0 and checkpointer is not None:
        roots = _scrub.scrub_roots(checkpointer)
        if roots:
            scrubber = _scrub.CheckpointScrubber(roots, cfg.scrub_interval_steps)

    def _integrity_stats():
        # drained on the main thread at report cadence; detections become
        # registry counters so they land in this record's extras
        ev = drain_integrity_events()
        if ev.get("shard_corrupt_detected"):
            observer.registry.counter("integrity.shard_corrupt_detected").add(
                int(ev["shard_corrupt_detected"]))
        return {"verify_s": float(ev.get("verify_s", 0.0)),
                "scrub_verified": _scrub.total_verified(),
                "divergence_checks": _divergence.total_checks()}

    observer.attach_integrity_stats(_integrity_stats)

    # the divergence compare at report boundaries, every
    # divergence_check_interval steps, across processes only
    world = world_size()
    divergence_interval = int(cfg.divergence_check_interval or 0) if world > 1 else 0
    last_divergence_check = start_step

    # rows a card trains a step, and tokens the whole world trains
    tokens_per_step = cfg.batch_size * cfg.seq_length
    global_tokens_per_step = world * tokens_per_step
    window: List[Dict] = []
    reports: List[Dict] = []
    train_loss = -1.0  # until a window has a clean step, as JAX prints it
    g_norm = -1.0
    loop_start = start = time.time()
    step = start_step

    def flush(step, drain=False):
        nonlocal window, start, train_loss, g_norm
        if not window:
            return
        # the report's one host sync: where a wedged card shows, so the
        # watchdog's timeout must cover a whole report window of steps
        with observer.phase("compute"):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            fetched = [{k: float(v) for k, v in m.items()} for m in window]
        if watchdog:
            watchdog.beat()
        window = []
        flags = [m["nonfinite"] for m in fetched]
        window_skips = guard.observe(flags)
        good = [m for m, f in zip(fetched, flags) if not f]
        poisoned = not good
        if not poisoned:
            train_loss = sum(m["loss"] for m in good) / len(good)
            g_norm = sum(m["gnorm"] for m in good) / len(good)
        now = time.time()
        elapsed = now - loop_start
        new_tokens = (step - start_step) * global_tokens_per_step
        # the record's rates use the window's true step count; the printed
        # current step time keeps JAX's fixed divisor at a report boundary
        step_time = max(1e-9, now - start) / len(fetched)
        printed_step_time = (now - start) / (len(fetched) if drain else cfg.report_interval)
        overall_step_time = elapsed / max(1, step - start_step)
        throughput = tokens_per_step / step_time
        overall_throughput = tokens_per_step / overall_step_time
        reserved, allocated, peak_alloc = _memory_stats(device)
        # the model family's own metrics (Mixtral's moe_drop_frac): the
        # mean over the window's clean steps, printed and in the record's
        # extras, as JAX reports them
        family_metrics = {} if poisoned else {
            k: sum(m[k] for m in good) / len(good)
            for k in good[-1] if k not in ("loss", "gnorm", "lr", "nonfinite")
        }
        extra = {"process_count": world, **family_metrics}
        if poisoned:
            extra["window_poisoned"] = 1
        report_start = time.perf_counter()
        obs_record = observer.report(
            step, len(fetched),
            loss=float("nan") if poisoned else train_loss,
            grad_norm=float("nan") if poisoned else g_norm,
            learning_rate=fetched[-1]["lr"],
            tokens_seen=tokens_seen + new_tokens,
            tokens_per_sec_per_chip=throughput,
            tokens_per_sec_per_chip_overall=int(overall_throughput),
            step_time_s=step_time,
            skipped_steps_total=guard.skipped_batches,
            skipped_steps_window=window_skips,
            memory_reserved_bytes=reserved,
            memory_allocated_bytes=allocated,
            data_mix=_mix_record(observer, dataloader),
            extra=extra,
        )
        # the observer's own host time (record, sinks, heartbeat): in the
        # next record's extras, the layer's cost
        observer.registry.gauge("obs.report_s").set(time.perf_counter() - report_start)
        record = {
            "step": step, "loss": train_loss, "lr": fetched[-1]["lr"],
            "tokens_seen": tokens_seen + new_tokens,
            "gnorm": g_norm, "steps_in_window": len(fetched),
            "step_time_s": step_time, "overall_step_time_s": overall_step_time,
            "tokens_per_card_per_s": throughput,
            "overall_tokens_per_card_per_s": overall_throughput,
            "mfu": obs_record["mfu"], "hfu": obs_record["hfu"],
            "memory_reserved_bytes": reserved,
            "memory_allocated_bytes": allocated,
            "max_memory_allocated_bytes": peak_alloc,
            "skipped_batches": guard.skipped_batches,
            "skipped_window": window_skips,
            **family_metrics,
        }
        reports.append(record)
        if rank == 0:
            if poisoned:
                print(f"report window poisoned: all {len(fetched)} step(s) "
                      f"non-finite; carrying last clean loss")
            print("step:", step)
            print("loss:", train_loss)
            print("LR:", record["lr"])
            print("tokens seen:", record["tokens_seen"])
            print("gradient norm:", g_norm)
            print("reserved memory:", reserved)
            print("allocated memory:", allocated)
            print("current step time:", printed_step_time)
            print("overall step time:", overall_step_time)
            print("current token per chip per sec:", int(tokens_per_step / printed_step_time))
            print("overall token per chip per sec:", int(overall_throughput))
            print("overall token per day:", int(new_tokens / elapsed * 86400))
            if record["mfu"] is not None:
                print("MFU:", record["mfu"])
                print("HFU:", record["hfu"])
            if guard.skipped_batches:
                print("skipped batches:", guard.skipped_batches)
            for k, v in family_metrics.items():
                print(f"{k}:", v)
        start = time.time()

    def save(step, reason):
        # a healthy save must not be judged by a timeout sized for steps
        with watchdog.paused() if watchdog else nullcontext():
            checkpointer.save(step, state, dataloader, reason=reason,
                              tokens_seen=tokens_seen + (step - start_step) * global_tokens_per_step,
                              skipped_steps=guard.skipped_batches)

    try:
        for step, batch in enumerate(train_loader, start=start_step + 1):
            if step > cfg.num_steps:
                step -= 1  # this batch was never trained on
                break
            if watchdog:
                watchdog.beat()
            # step-boundary fault sites: a slice kill ends this process, a
            # wedged reduce parks it for the watchdog (one slice: slice 0)
            kill = fire_fault("slice_kill", step=step, slice=0)
            if kill is not None:
                os._exit(int(kill.get("code", EXIT_CODES["injected_kill"])))
            stall = fire_fault("dcn_reduce_stall", step=step, slice=0)
            if stall is not None:
                time.sleep(float(stall.get("seconds", 3600)))
            sdc = fire_fault("sdc_grad_flip", step=step, proc=rank)
            if sdc is not None:
                # injected silent corruption of THIS rank's replica; nothing
                # reports it: the next compare must discover it
                scale = float(sdc.get("scale", 1.5))
                leaf_key = _divergence.inject_sdc(state, scale)
                print(f"sdc_grad_flip fault: scaled local shards of {leaf_key} "
                      f"by {scale} on proc {rank} at step {step}")
            window.append(step_fn(state, batch))
            if profiler:
                profiler.step()
            if step % cfg.report_interval == 0:
                if _divergence.divergence_due(step, last_divergence_check,
                                              divergence_interval):
                    # before the flush: loss/gnorm are the LAST flushed
                    # window's post-reduce scalars, equal on every rank;
                    # no checkpoint is saved on this path (the live state
                    # is suspect)
                    last_divergence_check = step
                    try:
                        _divergence.check_divergence(state, train_loss, g_norm, step,
                                                     observer.registry)
                    except _divergence.StateDivergenceError:
                        # the window (and the detection counter) reaches
                        # one final record before the classified exit
                        flush(step, drain=True)
                        raise
                flush(step)
                if scrubber is not None:
                    # a cadence check; the sweep runs on its own thread
                    scrubber.maybe_scrub(step)
                if guard.should_abort():
                    # params are the last good ones (flagged updates never
                    # landed): save them, then abort loudly
                    if checkpointer is not None:
                        save(step, "abort")
                    raise AnomalyAbort(
                        f"anomaly guard: {guard.consecutive} consecutive non-finite "
                        f"steps (threshold {guard.max_consecutive}); checkpoint "
                        f"saved at step {step}, aborting"
                    )
            preempt_now = preemption.poll()
            if checkpointer is not None:
                interval_due = (
                    checkpointer.save_due(step)
                    if hasattr(checkpointer, "save_due")
                    else step % cfg.checkpoint_interval == 0
                )
                if interval_due or step == cfg.num_steps or preempt_now:
                    reason = ("preempt" if preempt_now else
                              "final" if step == cfg.num_steps else "interval")
                    if reason != "interval":
                        # the loop is about to exit: the guard's totals
                        # stamped into the metadata must cover the tail
                        flush(step, drain=True)
                    save(step, reason)
            if preempt_now:
                if rank == 0:
                    print(f"preemption signal received: checkpoint saved at "
                          f"step {step}, exiting clean")
                break
        flush(step, drain=True)
    finally:
        preemption.uninstall()
        if watchdog:
            watchdog.stop()
        if scrubber is not None:
            scrubber.stop()
    return {"final_loss": train_loss, "reports": reports,
            "skipped_batches": guard.skipped_batches, "steps": step - start_step}
