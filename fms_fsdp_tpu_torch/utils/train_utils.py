"""The training hot loop.

Counterpart of the loop of ``fms_fsdp_tpu/utils/train_utils.py:307-840``
(``train`` / ``_train_loop``) on one card: steps until ``num_steps``,
keeps each step's metrics as device tensors, and at every
``report_interval`` fetches the window, feeds the non-finite flags to the
anomaly guard and prints the reference's report lines (step, loss, LR,
tokens seen, gradient norm, memory, step times, current and overall
tokens per chip per second, overall tokens per day, in its order and
with its values) plus MFU and HFU against the card's peak. It saves
through the checkpointer at its cadence and at ``num_steps``, and after
``anomaly_max_consecutive`` non-finite steps in a row it saves and
aborts. The obs sinks, watchdog, preemption guard, slice monitor,
scrubber and divergence check wait for ROADMAP.md A.12.
"""

import time
from typing import Dict, List

import torch

from fms_fsdp_tpu_torch.parallel.ac import selective_ac_mask
from fms_fsdp_tpu_torch.resilience.guards import AnomalyGuard
from fms_fsdp_tpu_torch.models import get_model_api
from fms_fsdp_tpu_torch.utils.flops import peak_flops_per_card, train_flops_per_token


class AnomalyAbort(RuntimeError):
    """The guard saw ``anomaly_max_consecutive`` non-finite steps in a row."""


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
          model_cfg=None, device=None) -> Dict:
    """Run the hot loop to ``cfg.num_steps``. Returns {"final_loss",
    "reports": one dict per report window, "skipped_batches", "steps"}.

    ``checkpointer`` (a ``Checkpointer`` or the tiered
    ``AsyncCheckpointManager``; None saves nothing) saves when a tier is
    due (``save_due``, or every ``checkpoint_interval`` steps for a plain
    ``Checkpointer``) and at ``num_steps``, and on an anomaly abort, with
    ``tokens_seen`` and ``skipped_steps`` in the metadata; a save that
    ends the loop drains the pending report window first.
    ``finalize()`` runs on every exit. ``dataloader`` is the stateful
    loader whose state rides the checkpoint (the dummy stream has none).

    ``device`` defaults to the state's (:func:`state_device`): a window's
    clock is read after the card has finished its steps. MFU counts the
    model FLOPs of a step (PaLM appendix B, no remat); HFU adds the
    recomputed forward of the layers ``selective_checkpointing``
    rematerialises. Both are against the card's dense bf16 peak, and only
    where the run is on a card; on the CPU they are None.
    """
    device = torch.device(device) if device is not None else state_device(state)
    guard = AnomalyGuard(max_consecutive=max(1, cfg.anomaly_max_consecutive))
    flops = hflops = peak = None
    if model_cfg is not None and device.type == "cuda":
        ac = 0.0
        if cfg.fsdp_activation_checkpointing:
            n_layers = get_model_api(model_cfg)[2]
            mask = selective_ac_mask(n_layers, cfg.selective_checkpointing)
            ac = sum(mask) / len(mask)
        flops = train_flops_per_token(model_cfg, cfg.seq_length)
        hflops = train_flops_per_token(model_cfg, cfg.seq_length, ac)
        peak = peak_flops_per_card(torch.cuda.get_device_name(device))
    tokens_per_step = cfg.batch_size * cfg.seq_length
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
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        fetched = [{k: float(v) for k, v in m.items()} for m in window]
        window = []
        flags = [m["nonfinite"] for m in fetched]
        window_skips = guard.observe(flags)
        good = [m for m, f in zip(fetched, flags) if not f]
        if good:
            train_loss = sum(m["loss"] for m in good) / len(good)
            g_norm = sum(m["gnorm"] for m in good) / len(good)
        now = time.time()
        elapsed = now - loop_start
        new_tokens = (step - start_step) * tokens_per_step
        # the record's rates use the window's true step count; the printed
        # current step time keeps JAX's fixed divisor at a report boundary
        step_time = (now - start) / len(fetched)
        printed_step_time = (now - start) / (len(fetched) if drain else cfg.report_interval)
        overall_step_time = elapsed / max(1, step - start_step)
        throughput = tokens_per_step / step_time
        overall_throughput = tokens_per_step / overall_step_time
        reserved, allocated, peak_alloc = _memory_stats(device)
        record = {
            "step": step, "loss": train_loss, "lr": fetched[-1]["lr"],
            "tokens_seen": tokens_seen + new_tokens,
            "gnorm": g_norm, "steps_in_window": len(fetched),
            "step_time_s": step_time, "overall_step_time_s": overall_step_time,
            "tokens_per_card_per_s": throughput,
            "overall_tokens_per_card_per_s": overall_throughput,
            "mfu": flops * throughput / peak if flops else None,
            "hfu": hflops * throughput / peak if hflops else None,
            "memory_reserved_bytes": reserved,
            "memory_allocated_bytes": allocated,
            "max_memory_allocated_bytes": peak_alloc,
            "skipped_batches": guard.skipped_batches,
            "skipped_window": window_skips,
        }
        reports.append(record)
        if rank == 0:
            if not good:
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
            if flops:
                print("MFU:", record["mfu"])
                print("HFU:", record["hfu"])
            if guard.skipped_batches:
                print("skipped batches:", guard.skipped_batches)
        start = time.time()

    def global_tokens(step):
        return tokens_seen + (step - start_step) * tokens_per_step

    def save(step, reason):
        checkpointer.save(step, state, dataloader, reason=reason,
                          tokens_seen=global_tokens(step),
                          skipped_steps=guard.skipped_batches)

    try:
        for step, batch in enumerate(train_loader, start=start_step + 1):
            if step > cfg.num_steps:
                step -= 1  # this batch was never trained on
                break
            window.append(step_fn(state, batch))
            if step % cfg.report_interval == 0:
                flush(step)
                if guard.should_abort():
                    # params are the last good ones (flagged updates never
                    # landed): save them, then abort loudly
                    if checkpointer is not None:
                        save(step, "abort")
                    raise AnomalyAbort(
                        f"anomaly guard: {guard.consecutive} consecutive non-finite "
                        f"steps (threshold {guard.max_consecutive}) at step {step}"
                    )
            if checkpointer is None:
                continue
            interval_due = (
                checkpointer.save_due(step)
                if hasattr(checkpointer, "save_due")
                else step % cfg.checkpoint_interval == 0
            )
            if interval_due or step == cfg.num_steps:
                reason = "final" if step == cfg.num_steps else "interval"
                if reason != "interval":
                    # the loop is about to exit: the guard's totals stamped
                    # into the metadata must cover the tail steps
                    flush(step, drain=True)
                save(step, reason)
        flush(step, drain=True)
    finally:
        if checkpointer is not None:
            # joins the in-flight writer and surfaces its error
            checkpointer.finalize()
    return {"final_loss": train_loss, "reports": reports,
            "skipped_batches": guard.skipped_batches, "steps": step - start_step}
