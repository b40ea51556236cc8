"""Speculator training: the stage-1 and stage-2 losses, the two-stage LR
schedule and the host loop.

Counterpart of ``fms_fsdp_tpu/train/speculator.py``
(ref:speculator/train_speculator_utils.py:122-427).

Stage 1 (steps <= stage2_start_step): one frozen-base forward over the
batch gives the hidden states in parallel; each speculator head is
scored with CE against the ground-truth tokens it should predict.
Stage 2: the frozen base generates (kv-cached top-k sampling,
``models/generation.py::generate``) from short prompts carved out of the
batch, and the speculator learns to match the base's own stream.

The base is frozen: it runs under ``torch.no_grad()`` with tensors that
do not require grad, so no graph is built through it (the flash
forward's autograd function saves nothing and each layer's activations
are freed as the next one runs), and only the speculator is
differentiated. JAX closes over the base params and stops the gradient.

The speculator state is the trainers' ``{"params", "optimizer",
"moments", "step", "dp"}`` (``train/step.py``): AdamW(0.9, 0.95, eps
1e-8, weight decay 0.1 on every leaf) with its moments in the params'
layout, so a checkpoint holds it under JAX's tree paths
(``ckpt/state.py``). ``_apply`` clips by the fp32 global norm and sets
the learning rate from the schedule at the state's own step.

Across processes the base stays whole on every rank and the speculator
is replicated; each rank's gradients and per-head losses are averaged
over the world before the clip, so the step is that of the mean over
the global batch, as JAX's loss is. Tensor parallelism of the base
(``sharding_strategy="tp"``) is ROADMAP.md A.6b.
"""

import logging
import math
import os
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from fms_fsdp_tpu_torch.ckpt.state import flatten, unflatten
from fms_fsdp_tpu_torch.models import get_base_api
from fms_fsdp_tpu_torch.models.speculator import SpeculatorConfig, speculator_logits
from fms_fsdp_tpu_torch.ops.fused_ce import cross_entropy_loss
from fms_fsdp_tpu_torch.utils.dist import world_size
from fms_fsdp_tpu_torch.utils.tree import tree_map

logger = logging.getLogger(__name__)

# quantized_matmuls values a step builder had to ignore (a non-Llama
# base runs unquantized). The count is buffered until the loop attaches
# an observer registry (``speculator.quant_ignored``): the builders run
# before the observer exists.
_QUANT_IGNORED_WARNED = set()
_QUANT_IGNORED_PENDING = 0


def _note_quant_ignored(quant: str, arch: str) -> int:
    """One-shot warning and a buffered count for a quantized_matmuls
    request the base arch cannot honor. Returns the pending count."""
    global _QUANT_IGNORED_PENDING
    _QUANT_IGNORED_PENDING += 1
    key = (quant, arch)
    if key not in _QUANT_IGNORED_WARNED:
        _QUANT_IGNORED_WARNED.add(key)
        logger.warning(
            "quantized_matmuls=%r is not supported for the %r speculator "
            "base arch (only llama bases thread quant= through the frozen "
            "forward); training proceeds UNQUANTIZED. Recorded as the "
            "speculator.quant_ignored obs counter.",
            quant, arch,
        )
    return _QUANT_IGNORED_PENDING


def _drain_quant_ignored(registry) -> None:
    """Flush buffered quant-ignored notes into an obs registry."""
    global _QUANT_IGNORED_PENDING
    if _QUANT_IGNORED_PENDING and registry is not None:
        registry.counter("speculator.quant_ignored").add(_QUANT_IGNORED_PENDING)
        _QUANT_IGNORED_PENDING = 0


def _frozen_quant(cfg, arch: str) -> str:
    """The quantization the frozen base forward runs with: a Llama base
    refuses a quantized request (the port has no quantized matmuls yet);
    another arch warns, counts and runs unquantized, as JAX's does."""
    quant = getattr(cfg, "quantized_matmuls", "none") or "none"
    if quant == "none":
        return quant
    if arch == "llama":
        raise NotImplementedError(
            f"quantized_matmuls={quant!r} is not ported yet: ROADMAP.md A.7 "
            f"(quantized training)"
        )
    _note_quant_ignored(quant, arch)
    return "none"


def base_device(base_params) -> torch.device:
    """The device of a base's params (any family's tree)."""
    leaves = list(flatten("params", base_params, {}).values())
    return leaves[0].device


def check_speculator_options(cfg) -> None:
    """Tensor parallelism of the frozen base is ROADMAP.md A.6b. JAX reads
    ``tp_size`` only under ``sharding_strategy="tp"``, and so does this."""
    if cfg.sharding_strategy == "tp" or cfg.tensor_parallel_size > 1:
        raise NotImplementedError(
            f"sharding_strategy={cfg.sharding_strategy!r} (tp_size="
            f"{cfg.tp_size}) shards the frozen base over tensor-parallel "
            f"heads, which is not ported yet: ROADMAP.md A.6b (tensor "
            f"parallelism)"
        )


def get_speculator_lr_schedule(cfg, start_step: int = 0):
    """Two-stage schedule (ref:speculator/train_speculator.py:262-299):
    stage 1 warms up then cosine-anneals to 10%; stage 2 restarts at 10%
    of max, warms up and anneals to 1%. In float32, as JAX computes it
    (the cosine of the float32 argument, rounded to float32)."""
    f32 = np.float32

    def cos32(a):
        return f32(math.cos(float(a)))

    s2_start = cfg.stage2_start_step
    warmup1 = max(1, min(2000, s2_start // 20))
    warmup2 = max(1, min(2000, (cfg.num_steps - s2_start) // 20))
    s2_span = max(1, cfg.num_steps - s2_start)
    pi = f32(np.pi)

    def stage1(x):
        wx = min(x, warmup1)
        warm = f32(1) - (f32(1) - f32(wx) / f32(warmup1)) ** 2
        cos = f32(0.1) + f32(0.5 * (1 - 0.1)) * (
            f32(1) + cos32(f32(x) / f32(s2_start) * pi))
        return min(warm, cos)

    def stage2(x):
        wx = min(x, warmup2)
        warm = f32(0.1) * (f32(1) - (f32(1) - f32(wx) / f32(warmup2)) ** 2)
        cos = f32(0.01) + f32(0.05 * (1 - 0.1)) * (
            f32(1) + cos32(f32(min(x, s2_span)) / f32(s2_span) * pi))
        return min(warm, cos)

    def schedule(count):
        x = int(count) + start_step
        frac = stage1(x) if x <= s2_start else stage2(x - s2_start)
        return float(f32(cfg.learning_rate) * f32(frac))

    return schedule


def make_speculator_optimizer(params, cfg):
    """AdamW(0.9, 0.95, eps 1e-8, wd 0.1) over every leaf
    (ref:speculator/train_speculator.py:234-239); the LR is set each
    step. Returns (optimizer, moments): Adam's moments made here, zero,
    in the params' layout (JAX's ``mu`` / ``nu``), each leaf's
    ``exp_avg`` / ``exp_avg_sq`` a view of them, as
    ``train/step.py::make_optimizer`` does for the trainers."""
    leaves = list(flatten("params", params, {}).values())
    opt = torch.optim.AdamW(leaves, lr=cfg.learning_rate, betas=(0.9, 0.95),
                            eps=1e-8, weight_decay=0.1, foreach=False)
    moments = {name: tree_map(torch.zeros_like, params) for name in ("mu", "nu")}
    mu = flatten("mu", moments["mu"], {}).values()
    nu = flatten("nu", moments["nu"], {}).values()
    for p, m, v in zip(leaves, mu, nu):
        opt.state[p] = {"step": torch.tensor(0.0, dtype=torch.float32),
                        "exp_avg": m, "exp_avg_sq": v}
    return opt, moments


# the hyperparams optax's inject_hyperparams(adamw) records for JAX's
# speculator optimizer: the checkpoint's opt_state.hyperparams.* keys
HYPERPARAMS = ("b1", "b2", "eps", "eps_root", "learning_rate", "weight_decay")


def speculator_state(params, cfg) -> Dict:
    """A fresh speculator train state over ``params``."""
    opt, moments = make_speculator_optimizer(params, cfg)
    return {"params": params, "optimizer": opt, "moments": moments, "step": 0,
            "dp": None, "hyperparams": HYPERPARAMS}


def _per_head_ce(logits: List, targets_fn):
    """logits: n per-head (B, N, V); targets_fn(i) -> (B, N). Returns
    (total, per-head (n,))."""
    with record_function("speculator_ce"):
        losses = [cross_entropy_loss(lg, targets_fn(i)) for i, lg in enumerate(logits)]
        return sum(losses), torch.stack(losses)


def stage1_loss(spec_params, embeds, inputs, scfg: SpeculatorConfig):
    """Ground-truth feed: embeds (B, N, D) over inputs[:, :N], head i
    scored against inputs[:, i+2 : N+i+2]."""
    logits = speculator_logits(spec_params, embeds, inputs[:, 1:], scfg)
    n = embeds.shape[1]
    return _per_head_ce(logits, lambda i: inputs[:, i + 2:n + i + 2])


def stage2_loss(spec_params, targs, embeds, scfg: SpeculatorConfig, s2_seq: int):
    """The speculator matched to a generated stream: targs (B, P+T)
    tokens, embeds (B, T, D) the hidden states that predicted them."""
    targs = targs[:, -s2_seq:]
    embeds = embeds[:, :s2_seq - scfg.n_predict]
    logits = speculator_logits(spec_params, embeds, targs[:, :-1], scfg)
    n = embeds.shape[1]
    return _per_head_ce(logits, lambda i: targs[:, i + 1:n + i + 1])


def _grads(state, loss_fn):
    """(loss, per-head, grads) of ``loss_fn(params)`` over detached
    aliases of the speculator's leaves, averaged over the world."""
    flat = flatten("params", state["params"], {})
    leaves = [t.detach().requires_grad_(True) for t in flat.values()]
    params = unflatten(dict(zip(flat, leaves)), "params")
    loss, per_head = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves)
    per_head = per_head.detach()
    world = world_size()
    if world > 1:
        dist = torch.distributed
        for g in grads:
            dist.all_reduce(g)
            g.div_(world)
        dist.all_reduce(per_head)
        per_head.div_(world)
    return per_head.sum(), per_head, grads


def _apply(state, grads, schedule, loss, per_head, clip_thresh=1.0):
    """Clip by the fp32 global norm, set the LR from the schedule at the
    state's step, take the AdamW step. Returns (state, metrics)."""
    gnorm = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    clip = torch.clamp(clip_thresh / (gnorm + 1e-6), max=1.0)
    lr = schedule(state["step"])
    opt = state["optimizer"]
    with record_function("optimizer"):
        for p, g in zip(opt.param_groups[0]["params"], grads):
            p.grad = (g * clip.to(g.dtype)).to(p.dtype)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        opt.zero_grad(set_to_none=True)
    state["step"] += 1
    return state, {"loss": loss.detach(), "per_head": per_head, "gnorm": gnorm, "lr": lr}


def make_stage1_step(base_params, model_cfg, scfg: SpeculatorConfig, cfg,
                     base_api=None):
    """(spec_state, inputs (B, L)) -> (spec_state, metrics)
    (ref:train_speculator_utils.py:122-171). The base's hidden states
    over inputs[:, :-n-1] come from the frozen forward through
    ``cfg.attention_kernel`` (the flash kernels on the card)."""
    base_api = base_api or get_base_api("embedllama")
    check_speculator_options(cfg)
    quant = _frozen_quant(cfg, base_api.arch)
    schedule = get_speculator_lr_schedule(cfg)
    n_predict = scfg.n_predict

    def step(state, inputs):
        with torch.no_grad(), record_function("frozen_base"):
            embeds = base_api.forward_hidden(
                base_params, inputs[:, :-n_predict - 1], model_cfg,
                attn_impl=cfg.attention_kernel, quant=quant,
            )
        loss, per_head, grads = _grads(
            state, lambda p: stage1_loss(p, embeds, inputs, scfg))
        del embeds
        return _apply(state, grads, schedule, loss, per_head, cfg.grad_clip_thresh)

    return step


def make_stage2_step(base_params, model_cfg, scfg: SpeculatorConfig, cfg,
                     base_api=None):
    """(spec_state, inputs, generator) -> (spec_state, metrics): the base
    generates stage2_seq_length tokens from stage2_prompt_length prompts
    (the batch reshaped to stage2_batch_size rows) and the speculator
    matches the generated stream (ref:train_speculator_utils.py:175-242)."""
    base_api = base_api or get_base_api("embedllama")
    s2_prompt = cfg.stage2_prompt_length
    s2_seq = cfg.stage2_seq_length
    grow = cfg.stage2_batch_size // cfg.batch_size
    assert s2_prompt * grow <= cfg.seq_length, (
        "Error: batch is too small for specified partition"
    )
    schedule = get_speculator_lr_schedule(cfg)

    def step(state, inputs, generator):
        prompts = inputs[:, :s2_prompt * grow].reshape(-1, s2_prompt)
        with torch.no_grad():
            targs, embeds = base_api.generate(
                base_params, prompts, model_cfg, generator=generator,
                max_seq_len=s2_prompt + s2_seq, max_new_tokens=s2_seq,
                do_sample=True, include_embeds=True,
            )
        loss, per_head, grads = _grads(
            state, lambda p: stage2_loss(p, targs, embeds, scfg, s2_seq))
        return _apply(state, grads, schedule, loss, per_head, cfg.grad_clip_thresh)

    return step


def do_ckpt(ckpt_save_path, reset=False):
    """On-demand checkpoint flag: an operator writes '1' to
    <save>/do_ckpt (ref:train_speculator_utils.py:246-260)."""
    ckpt_cmd_file = os.path.join(ckpt_save_path, "do_ckpt")
    if not os.path.exists(ckpt_cmd_file):
        return False
    if reset:
        with open(ckpt_cmd_file, "w") as fd:
            fd.write("0")
        return False
    with open(ckpt_cmd_file) as fd:
        return fd.read().strip() == "1"


def train_speculator(
    cfg,
    base_params,
    model_cfg,
    spec_state,
    scfg: SpeculatorConfig,
    rank,
    train_loader,
    checkpointer,
    start_step=0,
    n_tok=0,
    profiler=None,
    ckpt_loader=None,
    base_api=None,
    observer=None,
    device=None,
) -> Dict:
    """The speculator host loop with the reference's report and
    checkpoint cadence (ref:train_speculator_utils.py:263-427).
    ``train_loader`` yields batches on the device (a ``DeviceFeed``);
    ``ckpt_loader`` is the stateful loader whose state rides each
    checkpoint. The observer's records carry ``loss_head_<i>`` in
    ``extra`` and null MFU/HFU (the wall time is the frozen base's).
    Returns {"state", "reports": one dict per report window, "steps"}."""
    from fms_fsdp_tpu_torch.obs import build_observer
    from fms_fsdp_tpu_torch.utils.train_utils import PreemptionGuard

    base_api = base_api or get_base_api("embedllama")
    device = torch.device(device) if device is not None else base_device(base_params)
    stage1 = make_stage1_step(base_params, model_cfg, scfg, cfg, base_api)
    stage2 = None  # built when stage 2 starts: its batch constraints apply then
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 17)
    if ckpt_loader is None and hasattr(train_loader, "save_to_path"):
        ckpt_loader = train_loader
    world = world_size()

    if observer is None:
        observer = build_observer(cfg, rank, device=device)
    # the builders ran before the observer existed
    _drain_quant_ignored(observer.registry)
    if base_api.arch != "llama" and getattr(observer, "quantized_matmuls", None):
        # the record states the numerics that ran
        observer.quantized_matmuls = "none"
    checkpointer.observer = observer
    train_loader = observer.wrap_data_iter(train_loader)

    window = []
    reports = []
    elapsed_tokens = 0
    start = time.time()
    loop_start = time.time()
    step_tok = 0
    batch_idx = start_step
    preemption = PreemptionGuard().install()

    try:
        for batch_idx, inputs in enumerate(train_loader, start=start_step + 1):
            if batch_idx > cfg.num_steps:
                batch_idx -= 1
                break
            if isinstance(inputs, (tuple, list)):
                inputs = inputs[0]

            with observer.phase("compute"):
                if batch_idx <= cfg.stage2_start_step:
                    spec_state, metrics = stage1(spec_state, inputs)
                    step_tok = inputs.numel() * world
                else:
                    if stage2 is None:
                        stage2 = make_stage2_step(base_params, model_cfg, scfg, cfg,
                                                  base_api)
                    spec_state, metrics = stage2(spec_state, inputs, generator)
                    grow = cfg.stage2_batch_size // cfg.batch_size
                    step_tok = (inputs.shape[0] * world * grow
                                * cfg.stage2_seq_length)
            window.append(metrics)

            if profiler:
                profiler.step()

            if batch_idx % cfg.report_interval == 0:
                with observer.phase("compute"):
                    fetched = [{
                        "loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                        "per_head": m["per_head"].float().cpu().numpy(),
                        "lr": m["lr"],
                    } for m in window]
                window = []
                per_head = np.mean([m["per_head"] for m in fetched], axis=0)
                g_norm = float(np.mean([m["gnorm"] for m in fetched]))
                elapsed_time = time.time() - loop_start
                elapsed_tokens += cfg.report_interval * step_tok
                if rank == 0:
                    print(f"{time.time()}")
                    print("step:", batch_idx)
                    print("tokens seen:", n_tok + elapsed_tokens)
                    for i in range(len(per_head)):
                        print(f"loss {i + 1}:", float(per_head[i]))
                    print("gradient norm:", g_norm)
                    print(
                        f"speed for these {cfg.report_interval} steps:",
                        (time.time() - start) / cfg.report_interval,
                    )
                    print("overall speed:", elapsed_time / (batch_idx - start_step))
                    print("LR:", float(fetched[-1]["lr"]))
                    print(
                        "overall token per chip per sec:",
                        int(elapsed_tokens / world / elapsed_time),
                    )
                    print(
                        "token per day:",
                        int(elapsed_tokens / elapsed_time * 3600 * 24),
                    )
                    print()
                window_wall = max(1e-9, time.time() - start)
                window_steps = max(1, len(fetched))
                loss = float(np.mean([m["loss"] for m in fetched]))
                observer.report(
                    batch_idx,
                    len(fetched),
                    loss=loss,
                    grad_norm=g_norm,
                    learning_rate=float(fetched[-1]["lr"]),
                    tokens_seen=n_tok + elapsed_tokens,
                    tokens_per_sec_per_chip=(
                        window_steps * step_tok / world / window_wall
                    ),
                    tokens_per_sec_per_chip_overall=(
                        elapsed_tokens / world / max(1e-9, elapsed_time)
                    ),
                    step_time_s=window_wall / window_steps,
                    extra={
                        f"loss_head_{i + 1}": float(per_head[i])
                        for i in range(len(per_head))
                    },
                )
                reports.append({
                    "step": batch_idx, "loss": loss, "per_head": per_head.tolist(),
                    "gnorm": g_norm, "lr": float(fetched[-1]["lr"]),
                    "tokens_seen": n_tok + elapsed_tokens,
                    "step_time_s": window_wall / window_steps,
                    "tokens_per_s": window_steps * step_tok / window_wall,
                })
                start = time.time()

            preempt_now = preemption.poll()
            interval_due = (
                checkpointer.save_due(batch_idx)
                if hasattr(checkpointer, "save_due")
                else batch_idx % cfg.checkpoint_interval == 0
            )
            demand_now = do_ckpt(cfg.ckpt_save_path) is True
            if interval_due or batch_idx == cfg.num_steps or demand_now or preempt_now:
                reason = (
                    "preempt" if preempt_now
                    else "final" if batch_idx == cfg.num_steps
                    else "demand" if demand_now
                    else "interval"
                )
                checkpointer.save(
                    batch_idx,
                    spec_state,
                    ckpt_loader,
                    reason=reason,
                    tokens_seen=elapsed_tokens + n_tok,
                )
                do_ckpt(cfg.ckpt_save_path, reset=True)
            if preempt_now:
                if rank == 0:
                    print(
                        f"preemption signal received: checkpoint saved at step "
                        f"{batch_idx}, exiting clean"
                    )
                break
    finally:
        preemption.uninstall()
        try:
            # never return with a save in flight
            checkpointer.finalize()
        finally:
            observer.close()
    return {"state": spec_state, "reports": reports, "steps": batch_idx - start_step}
