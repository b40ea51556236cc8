"""The train step and its pieces.

Counterpart of ``fms_fsdp_tpu/train/step.py``: the reference's hot loop —
forward / CE loss / backward / clip_grad_norm / AdamW step / scheduler
step (ref:fms_fsdp/utils/train_utils.py:87-98) — eager, one card per
process.

- The forward and backward run on a compute-dtype copy of the params
  (``step.py:374`` in JAX), so under bfSixteen the gradients come out
  bf16. The copy is made per layer, and those per-layer tensors are the
  leaves that are differentiated.
- Global-norm clipping at ``grad_clip_thresh`` with the norm summed in
  fp32 (torch ``clip_grad_norm_``); the pre-clip norm is what is logged.
- AdamW(0.9, 0.95, eps 1e-8, weight decay 0.1 on every leaf), the
  decoupled decay and bias correction of optax's ``adamw``; gradients are
  upcast per leaf to the param dtype for the update; the learning rate is
  set every step from the schedule at the trainer's own step counter.
- Non-finite guard (``anomaly_skip_updates``): a batch whose loss or
  gradient norm is not finite applies no update at all — params and Adam
  moments stay bit-identical and Adam's count does not advance — while the
  trainer's step still does. Deciding that takes one host sync per step
  (JAX selects on device inside its jitted step).
- The ``nan_loss`` fault site (resilience/faults.py), read when the step
  is built: the loss and the gradients of steps [``step``,
  ``step + count``) of the state's step counter are multiplied by NaN,
  so one spec poisons the same loop steps as in JAX.

Across processes (``state["dp"]``, a ``parallel/sharding.py::
DataParallel``; None on a world of one, where the step is exactly the
one-card step with no collective): the params and Adam's moments are
each rank's local parts of JAX's layout; under fsdp/hsdp the forward
gathers each layer when it reaches it and again in the backward, the
gradients are reduce-scattered to the parts (and all-reduced over the
replicas), and a replicated leaf's are all-reduced over the world. The
loss is each rank's token-loss sum over the GLOBAL count of labels !=
-100, summed over the world: the mean over the global batch, as JAX's
step computes it on the whole batch, whatever the ranks' shares of
ignored labels. The gradient norm is global (the parts' squares summed
over fsdp). So the non-finite decision is the same on every rank.

Long context (``context_parallel_size``): the ranks of a context group
hold one data index's rows, each S / cp of their sequence; the forward
runs ring attention, the conv halo and ``ssd_scan_cp`` (Mamba) and the
whole sequence's capacity routing (Mixtral) over the group
(``state["dp"].ring``). The loss is each rank's token-loss sum over the
global label count, summed over the world, and the gradients are summed
over the context group before the norm and the clip, as over the data
ranks. Mixtral's routing sums are summed over the world, the context
group included, before the balance term is formed.

Mixtral (``step.py:281-293,347-358`` in JAX) trains through the capacity
dispatch and adds the load-balancing term (already weighted) to the
objective; ``moe_drop_frac`` joins the metrics. Across processes the
term is formed once from the routing sums of the global batch
(``DataParallel.sum_route``), as JAX forms it over the whole batch, and
the loss counts it once.

Tensor parallelism (``tensor_parallel_size``, ``sharding_strategy="tp"``):
``state["dp"].tp`` holds the tensor group, the state holds each rank's
tensor blocks of JAX's Megatron layout (``parallel/sharding.py``), and
the forward runs the Megatron operators of ``parallel/tensor.py``: the
attention on this rank's heads (the flash kernels at the local head
counts), the FFN's and the experts' column and row blocks, the
vocabulary-split embedding, and a loss that reduces the max, the sum of
exponentials and the label's logit over tensor (``ops/fused_ce.py``).
Tensor peers train the same rows, so the label count, the loss, the
route sums and the gradients of a leaf not split over fsdp are summed
over the data group (every axis but tensor), and the gradient norm adds
a tensor-split leaf's squares over tensor.

Quantized training (``TrainConfig.quantized_matmuls``, the forward's
``quant``; ``quantized_reduce``, the policy's ``reduce_quant``): the
gradient norm is taken on the raw reduced gradients, then they go
through the reduce wire (``parallel/sharding.py::quantized_grad_reduce``),
then the clip, as JAX orders its step (``step.py:395-470``). Under
``fp8_delayed`` the amax rows ride in ``state["quant"]``, replicated on
every rank; a non-finite batch skipped by the guard leaves them as they
were, and without the guard they roll as JAX's do. Beside a tensor axis
a quantized product's scales over a split dim, and the wire's amax of a
row or leaf split over tensor, are the whole one's (a MAX over the tensor
group), as JAX's GSPMD program reduces them.

The DCN overlap belongs to ROADMAP.md A.6b.
"""

import math
from contextlib import nullcontext
from typing import Dict

import torch
from torch.profiler import record_function

from fms_fsdp_tpu_torch.models import get_model_api
from fms_fsdp_tpu_torch.models.configs import MambaConfig, MixtralConfig
from fms_fsdp_tpu_torch.models.mixtral import moe_stats
from fms_fsdp_tpu_torch.obs.scopes import scoped
from fms_fsdp_tpu_torch.ops.flash_attention import VARIANTS, set_kernel_variant
from fms_fsdp_tpu_torch.ops.fused_ce import (
    cross_entropy_loss,
    fused_linear_cross_entropy,
)
from fms_fsdp_tpu_torch.ops.quant import check_quant_mode
from fms_fsdp_tpu_torch.parallel.ac import selective_ac_mask
from fms_fsdp_tpu_torch.parallel.mixed_precision import get_dtype_policy
from fms_fsdp_tpu_torch.parallel.sharding import (
    DataParallel,
    GatheredLayers,
    QuantLeaf,
    init_amax_state,
    quantized_grad_reduce,
)
from fms_fsdp_tpu_torch.resilience.faults import check_spec, fault_params
from fms_fsdp_tpu_torch.tune.lookup import configure_kernel_tuning, resolve_ce_chunk
from fms_fsdp_tpu_torch.utils.tree import tree_map

# (TrainConfig field, is it set to something this port does not run yet,
# the ROADMAP.md item that brings it)
_UNPORTED_STEP = (
    ("expert_parallel_size", lambda v: v > 1, "A.4b (MoE expert parallelism)"),
    ("num_slices", lambda v: v > 1, "A.6b (multi-slice)"),
)


def check_step_options(cfg) -> None:
    """The step's options: ``NotImplementedError`` naming the ROADMAP.md
    item for each one this port does not run yet, rather than ignore it."""
    for field, unported, item in _UNPORTED_STEP:
        value = getattr(cfg, field)
        if unported(value):
            raise NotImplementedError(
                f"{field}={value!r} is not ported yet: ROADMAP.md {item}"
            )
    check_quant_mode(cfg.quantized_matmuls)
    if cfg.flash_kernel_variant not in VARIANTS:
        raise ValueError(
            f"flash_kernel_variant={cfg.flash_kernel_variant!r}: expected one "
            f"of {VARIANTS}"
        )


def check_supported(cfg) -> None:
    """Every option of a training run (the entry point's check): the
    step's, and a ``faults`` spec naming a site the port has no call site
    for yet. ``divergence_check_interval`` compares the replicas across
    processes; on one process it is inert, as in JAX."""
    check_step_options(cfg)
    check_spec(cfg.faults)


def get_lr_schedule(cfg, start_step: int = 0):
    """Return the schedule: step -> lr (``step.py:61``).

    initial stage: lr * min(1 - (1 - x/w)^2, 0.1 + 0.45*(1 + cos(pi x/T)))
    with w = min(2000, T/20) (quadratic warmup into cosine with 0.1 floor);
    annealing stage: lr * (1 - x/T). (ref:main_training_llama.py:137-148)
    """
    T = cfg.num_steps
    lr = cfg.learning_rate

    if cfg.training_stage == "annealing":

        def schedule(count):
            x = count + start_step
            return lr * (1 - x / T)

    else:
        warmup = max(1, min(2000, T // 20))

        def schedule(count):
            x = count + start_step
            wx = min(x, warmup)
            warm = 1 - (1 - wx / warmup) ** 2
            cos = 0.1 + 0.5 * (1 - 0.1) * (1 + math.cos(min(x, T) / T * math.pi))
            return lr * min(warm, cos)

    return schedule


_TOP_LEAVES = ("embedding", "norm", "norm_f", "lm_head")


def _per_layer(params: Dict, fn):
    """The forward's param dict with ``fn(leaf, key, stacked)`` applied to
    each leaf, layer by layer, and the leaves in one fixed order: the
    top-level leaves (embedding, the final norm, lm_head), then layer by
    layer. ``key`` is the leaf's checkpoint key (``params.layers.wq``,
    ``params.layers.3.mixer.D``) and ``stacked`` says the leaf is layer
    ``i`` of a stacked (L, ...) tensor: Llama's stacked tensors are taken
    apart into per-layer dicts; a list of per-layer dicts (Mamba's unlike
    layers) is walked as it is nested. The optimizer and the
    differentiated copy share that order."""
    leaves = []

    def take(w, key, stacked=False):
        leaves.append(fn(w, key, stacked))
        return leaves[-1]

    top = {k: take(params[k], f"params.{k}") for k in _TOP_LEAVES if k in params}
    layers = params["layers"]
    if isinstance(layers, dict):
        n_layers = next(iter(layers.values())).shape[0]
        per_layer = [{name: take(w[i], f"params.layers.{name}", True)
                      for name, w in layers.items()}
                     for i in range(n_layers)]
    else:
        per_layer = [_walk(layer, f"params.layers.{i}", take)
                     for i, layer in enumerate(layers)]
    return {**top, "layers": per_layer}, leaves


def _walk(tree, key, take):
    """``take`` over the leaves of nested dicts, keyed by their paths. A
    module-level function: a recursive closure is a reference cycle, which
    would keep the step's compute-dtype copy alive until the next garbage
    collection."""
    if isinstance(tree, dict):
        return {name: _walk(sub, f"{key}.{name}", take) for name, sub in tree.items()}
    return take(tree, key)


def make_optimizer(params: Dict, cfg):
    """AdamW(0.9, 0.95, eps 1e-8, wd 0.1) over every leaf, each Llama
    layer's weights as views of the stacked tensors, so an update writes
    the JAX-layout params in place; the lr is set each step by the train
    step. Returns (optimizer, moments): Adam's moments are made here,
    zero, in the params' layout (JAX's ``mu`` and ``nu``), and each
    leaf's ``exp_avg`` / ``exp_avg_sq`` is a view of them, so a
    checkpoint saves and loads them whole and in place
    (``ckpt/state.py``). AdamW starts from them as from the zeros it
    would make at its first update."""
    _, leaves = _per_layer(params, lambda w, *_: w)
    opt = torch.optim.AdamW(
        leaves, lr=cfg.learning_rate,
        betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1, foreach=False,
    )
    moments = {name: tree_map(torch.zeros_like, params) for name in ("mu", "nu")}
    _, mu = _per_layer(moments["mu"], lambda w, *_: w)
    _, nu = _per_layer(moments["nu"], lambda w, *_: w)
    for p, m, v in zip(leaves, mu, nu):
        opt.state[p] = {"step": torch.tensor(0.0, dtype=torch.float32),
                        "exp_avg": m, "exp_avg_sq": v}
    return opt, moments


def init_train_state(generator: torch.Generator, model_cfg, cfg, mesh=None) -> Dict:
    """{params, optimizer, moments, step, dp} (and ``quant`` under
    fp8_delayed): params made on the generator's device in the policy's
    param dtype (the same draws on every rank: one seed) and placed on
    ``mesh`` (:func:`state_from_params`); Adam moments zero, step 0."""
    policy = get_dtype_policy(cfg)
    init_params, _, _ = get_model_api(model_cfg)
    params = init_params(generator, model_cfg, dtype=policy.param_dtype)
    return state_from_params(params, cfg, mesh, model_cfg)


def state_from_params(params: Dict, cfg, mesh=None, model_cfg=None) -> Dict:
    """A train state over existing whole params (the tests start from
    JAX's). On a ``mesh`` of more than one process ``state["dp"]`` holds
    the run's ``DataParallel`` layout and the state keeps this rank's
    parts of the leaves split over fsdp; else ``state["dp"]`` is None.
    Under ``quantized_reduce="fp8_delayed"`` ``state["quant"]`` holds the
    zero amax rows (``fp8_amax_history_len`` deep), one per JAX leaf, on
    every rank."""
    dp = None
    if mesh is not None and mesh.size() > 1:
        from fms_fsdp_tpu_torch.ckpt.state import flatten, unflatten

        dp = DataParallel.for_params(mesh, params, model_cfg)
        params = unflatten(dp.shard(flatten("params", params, {})), "params")
    opt, moments = make_optimizer(params, cfg)
    state = {"params": params, "optimizer": opt, "moments": moments, "step": 0,
             "dp": dp}
    if get_dtype_policy(cfg).reduce_quant == "fp8_delayed":
        state["quant"] = init_amax_state(params, cfg.fp8_amax_history_len)
    return state


def tensor_flags(params: Dict, dp):
    """Per differentiated leaf, in :func:`_per_layer`'s order: whether it
    is split over tensor."""
    return _per_layer(params, lambda w, key, stacked: dp.tdim_of(key) is not None)[1]


def quant_leaves(params: Dict, dp=None):
    """The reduce wire's view of the step's differentiated leaves, in
    :func:`_per_layer`'s order: each leaf's JAX key (``g.layers.wq``), the
    JAX leaf's rank, and its local fsdp and tensor split dims."""

    def local(d, stacked):
        return None if d is None else d - int(stacked)

    def leaf(w, key, stacked):
        d = dp.dim_of(key) if dp is not None else None
        td = dp.tdim_of(key) if dp is not None else None
        return QuantLeaf("g." + key[len("params."):], w.dim() + int(stacked),
                         local(d, stacked), local(td, stacked))

    return _per_layer(params, leaf)[1]


def _compute_copy(params: Dict, dtype, dp=None):
    """Per-layer compute-dtype leaves that require grad, the forward's
    param dict over them, and per leaf whether it is split over fsdp.
    Under the fp32 policy a leaf is a detached alias of the param, which
    the update writes only after the backward has released the graph.
    Under a sharded ``dp`` the leaves are the local parts: the top-level
    ones are gathered now, each layer when the forward reaches it
    (``parallel/sharding.py::GatheredLayers``)."""
    tree, leaves = _per_layer(
        params, lambda w, *_: w.detach().to(dtype).requires_grad_(True))
    if dp is None or not dp.gathers:
        return tree, leaves, [False] * len(leaves)

    def local_dim(w, key, stacked):
        d = dp.dim_of(key)
        return None if d is None else d - int(stacked)

    dims, split = _per_layer(params, local_dim)
    top = {k: v for k, v in tree.items() if k != "layers"}
    top_dims = {k: v for k, v in dims.items() if k != "layers"}
    tree = dict(dp.gather_tree(top, top_dims, "top"),
                layers=GatheredLayers(dp, tree["layers"], dims["layers"]))
    return tree, leaves, [d is not None for d in split]


def wrap_step_fn(step_fn, timer):
    """Attribute the step's host wall time to the ``compute`` phase
    (obs/timing.py). The eager step ends in its one host sync, so the
    phase holds the step's device time too."""

    def stepped(state, batch):
        with timer.phase("compute"):
            return step_fn(state, batch)

    return stepped


def make_train_step(model_cfg, cfg, start_step: int = 0):
    """Build the step: (state, (inputs, labels)) -> metrics.

    metrics = {loss, gnorm (the pre-clip global gradient norm, fp32), lr,
    nonfinite (1.0 when the batch's loss or gradient norm was not finite;
    its update was skipped when ``anomaly_skip_updates``)}, and for
    Mixtral moe_drop_frac; loss, gnorm and moe_drop_frac stay tensors on
    the device until the loop fetches a report window.
    """
    check_step_options(cfg)
    set_kernel_variant(cfg.flash_kernel_variant)
    configure_kernel_tuning(cfg.kernel_tuning, cfg.kernel_tuning_table or None)
    policy = get_dtype_policy(cfg)
    _, forward_fn, n_layers = get_model_api(model_cfg)
    ac_mask = None
    if cfg.fsdp_activation_checkpointing:
        ac_mask = selective_ac_mask(n_layers, cfg.selective_checkpointing)
    schedule = get_lr_schedule(cfg, start_step)
    fused = cfg.fused_loss
    chunk = cfg.loss_chunk_size
    if fused:
        # the logits-chunk knob is tunable: the table's chunk under
        # kernel_tuning="auto", exactly cfg.loss_chunk_size when "off";
        # at the vocabulary a rank holds (its block under tensor
        # parallelism, when the tensor extent divides it)
        d_model = getattr(model_cfg, "emb_dim", None) or getattr(model_cfg, "d_model", 0)
        vocab = getattr(model_cfg, "src_vocab_size", None) or getattr(
            model_cfg, "vocab_size", 0)
        tp_size = int(cfg.tensor_parallel_size or 1)
        if vocab % tp_size == 0:
            vocab //= tp_size
        chunk = resolve_ce_chunk(d_model, vocab,
                                 str(policy.compute_dtype).replace("torch.", ""),
                                 requested=chunk)
    guard_updates = bool(cfg.anomaly_skip_updates)
    nan_fault = fault_params("nan_loss")
    nan_window = None
    if nan_fault is not None:
        at = int(nan_fault.get("step", 0))
        nan_window = (at, at + int(nan_fault.get("count", 1)))
    extra_kwargs = {}
    moe = isinstance(model_cfg, MixtralConfig)
    cp = int(cfg.context_parallel_size or 1)
    if isinstance(model_cfg, MambaConfig):
        extra_kwargs = {"mamba_kernel": cfg.mamba_kernel}
    elif moe:
        extra_kwargs = {"moe_impl": "dispatch", "return_aux": True}

    def loss_fn(params_c, inputs, labels, n=None, dp=None):
        """(the token loss, the MoE balance term or None, extra metrics)"""
        ring = {}
        if cp > 1:
            if dp is None or dp.ring is None or dp.ring.cp != cp:
                raise ValueError(
                    f"context_parallel_size={cp} needs a train state on a mesh whose "
                    f"context axis has {cp} ranks (state['dp'].ring)"
                )
            ring = {"ring": dp.ring}
        tp = dp.tp if dp is not None else None
        out = forward_fn(
            params_c, inputs, model_cfg, compute_dtype=policy.compute_dtype,
            attn_impl=cfg.attention_kernel, ac_mask=ac_mask,
            return_hidden=fused, quant=cfg.quantized_matmuls, tp=tp, **ring,
            **extra_kwargs,
        )
        aux, stats = None, {}
        if moe:
            out, aux_stats = out
            if dp is not None:
                aux_stats = moe_stats(dp.sum_route(aux_stats["route"]), model_cfg)
            aux = aux_stats["balance"]
            stats["moe_drop_frac"] = aux_stats["drop_frac"].detach()
        # the loss over a vocabulary-split lm_head reduces over tensor
        ce_tp = tp if tp is not None and dp.tdim_of("params.lm_head") is not None else None
        if fused:
            ce = fused_linear_cross_entropy(out, params_c["lm_head"], labels, chunk, n=n,
                                            tp=ce_tp)
        else:
            ce = cross_entropy_loss(out, labels, n=n, tp=ce_tp)
        return ce, aux, stats

    @scoped("fwd_bwd")
    def fwd_bwd(state, inputs, labels):
        dp = state.get("dp")
        params_c, leaves, split = _compute_copy(state["params"], policy.compute_dtype, dp)
        if dp is None:
            loss, aux, stats = loss_fn(params_c, inputs, labels)
        else:
            n = dp.global_count(labels)
            with dp.release_saved() if dp.gathers else nullcontext():
                loss, aux, stats = loss_fn(params_c, inputs, labels, n, dp)
        del params_c
        grads = torch.autograd.grad(loss if aux is None else loss + aux, leaves)
        if dp is not None:
            dp.reduce_grads(grads, split)
            loss = dp.sum_over_world(loss)
        if aux is not None:
            # the global term, once, beside the ranks' summed token loss
            loss = loss.detach() + aux.detach()
        if nan_window is not None and (
            nan_window[0] <= state["step"] + start_step < nan_window[1]
        ):
            # injected non-finite batch: the guard below must absorb it
            loss = loss * float("nan")
            grads = tuple(g * float("nan") for g in grads)
        return loss, grads, split, stats

    reduce_quant = policy.reduce_quant

    def wire(state, grads):
        """The reduced gradients through the reduce wire; the new amax rows
        into the state."""
        dp = state.get("dp")
        with record_function("quant_reduce"):
            grads, new_quant = quantized_grad_reduce(
                grads, reduce_quant, state.get("quant"),
                quant_leaves(state["params"], dp), dp)
        if new_quant is not None:
            state["quant"] = new_quant
        return grads

    def train_step(state, batch):
        inputs, labels = batch
        loss, grads, split, stats = fwd_bwd(state, inputs, labels)
        dp = state.get("dp")
        if dp is not None and dp.sharded:
            gnorm = dp.grad_norm(grads, split, tensor_flags(state["params"], dp))
        else:
            gnorm = torch.linalg.vector_norm(torch.stack([
                torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads
            ]))
        # the one host sync of the step: whether to apply the update
        nonfinite = not bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        lr = schedule(state["step"])
        if not (nonfinite and guard_updates):
            if reduce_quant != "none":
                grads = wire(state, grads)
            with record_function("optimizer"):
                clip = torch.clamp(cfg.grad_clip_thresh / (gnorm + 1e-6), max=1.0)
                opt = state["optimizer"]
                params = opt.param_groups[0]["params"]
                for p, g in zip(params, grads):
                    p.grad = (g * clip.to(g.dtype)).to(p.dtype)
                del grads
                for group in opt.param_groups:
                    group["lr"] = lr
                opt.step()
                opt.zero_grad(set_to_none=True)
        state["step"] += 1
        return {
            "loss": loss.detach(),
            "gnorm": gnorm,
            "lr": lr,
            "nonfinite": float(nonfinite),
            **stats,
        }

    return train_step
