"""The train state as a checkpoint state dict, and back.

The port's train state is ``{"params", "optimizer", "moments", "step"}``
(``train/step.py``). A checkpoint holds it under the tree paths of the
JAX train state ``{"params", "opt_state", "step"}`` with optax's
``inject_hyperparams(adamw)`` state, joined with dots:

- ``params.<path>``: the params as JAX holds them, Llama's layer weights
  stacked (L, ...), Mamba's ``layers`` a list (``params.layers.3.mixer.D``);
- ``opt_state.count`` and ``opt_state.inner_state.0.count``: Adam's
  count (int32 scalars, equal: both advance only with an applied update);
- ``opt_state.hyperparams.{b1,b2,learning_rate,weight_decay}``: fp32
  scalars, the last learning rate the step set (a state's
  ``"hyperparams"`` names another set: the speculator's optax ``adamw``
  also injects ``eps`` and ``eps_root``);
- ``opt_state.inner_state.0.{mu,nu}.<path>``: Adam's moments in the
  params' layout;
- ``step``: the trainer's step (int32 scalar);
- ``quant.amax_history.<key>``: under ``quantized_reduce="fp8_delayed"``
  the (H,) fp32 amax rows, keyed by JAX's flat leaf names
  (``g.layers.wq``), which hold dots themselves, so :func:`unflatten`
  cannot rebuild them: a load reads every key in place into the live
  tensors of :func:`checkpoint_state`, the rows among them.

The moments are the stacked tensors of ``state["moments"]``, whose
per-layer views are the optimizer's ``exp_avg`` / ``exp_avg_sq``, so a
load writes the tensors every later update reads, in place.
"""

from typing import Dict

import torch

_HYPER = ("b1", "b2", "learning_rate", "weight_decay")
COUNT_KEYS = ("opt_state.count", "opt_state.inner_state.0.count")


def flatten(prefix: str, tree, out: Dict[str, torch.Tensor]) -> Dict:
    """Nested dicts and lists of tensors -> ``out[prefix.path] = leaf``."""
    if isinstance(tree, dict):
        for name, sub in tree.items():
            flatten(f"{prefix}.{name}", sub, out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            flatten(f"{prefix}.{i}", sub, out)
    else:
        out[prefix] = tree
    return out


def unflatten(flat: Dict[str, torch.Tensor], prefix: str):
    """The inverse of :func:`flatten` for the keys under ``prefix``: a
    level whose names are all digits is a list."""
    root: Dict = {}
    head = prefix + "."
    for key, leaf in flat.items():
        if not key.startswith(head):
            continue
        *path, last = key[len(head):].split(".")
        node = root
        for name in path:
            node = node.setdefault(name, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def _adam_count(opt: torch.optim.Optimizer) -> int:
    steps = {int(s["step"]) for s in opt.state.values() if "step" in s}
    if len(steps) > 1:
        raise RuntimeError(f"Adam's per-leaf counts disagree: {sorted(steps)}")
    return steps.pop() if steps else 0


def checkpoint_state(state: Dict) -> Dict[str, torch.Tensor]:
    """The flat checkpoint dict of ``state``: the live params and moments
    (no copy) and fresh scalar tensors."""
    opt = state["optimizer"]
    group = opt.param_groups[0]
    flat: Dict[str, torch.Tensor] = {}
    flatten("params", state["params"], flat)
    count = _adam_count(opt)
    for key in COUNT_KEYS:
        flat[key] = torch.tensor(count, dtype=torch.int32)
    hyper = {"b1": group["betas"][0], "b2": group["betas"][1], "eps": group["eps"],
             "eps_root": 0.0, "learning_rate": group["lr"],
             "weight_decay": group["weight_decay"]}
    for name in state.get("hyperparams", _HYPER):
        flat[f"opt_state.hyperparams.{name}"] = torch.tensor(hyper[name], dtype=torch.float32)
    for name in ("mu", "nu"):
        flatten(f"opt_state.inner_state.0.{name}", state["moments"][name], flat)
    flat["step"] = torch.tensor(int(state["step"]), dtype=torch.int32)
    if state.get("quant") is not None:
        flatten("quant", state["quant"], flat)
    return flat


def apply_scalars(state: Dict, flat: Dict[str, torch.Tensor]) -> None:
    """After a load into :func:`checkpoint_state`'s tensors: Adam's count
    back into the optimizer, the last learning rate (the next step sets
    its own from the schedule) and the trainer's step. b1, b2 and the
    weight decay stay the optimizer's own: constants of the config in
    Python floats, which their fp32 copies would round (0.9 ->
    0.89999998) and so change every later update."""
    opt = state["optimizer"]
    count = float(int(flat["opt_state.inner_state.0.count"]))
    for per_leaf in opt.state.values():
        per_leaf["step"] = torch.tensor(count, dtype=per_leaf["step"].dtype,
                                        device=per_leaf["step"].device)
    for group in opt.param_groups:
        group["lr"] = float(flat["opt_state.hyperparams.learning_rate"])
    state["step"] = int(flat["step"])


def snapshot(flat: Dict[str, torch.Tensor], host: Dict[str, torch.Tensor]) -> Dict:
    """Host copies of ``flat``, isolated from every later in-place write:
    a card tensor is copied into a pinned buffer of ``host`` (kept and
    reused across saves while its shape and dtype hold), a CPU tensor is
    cloned (``.to("cpu")`` would return the tensor itself). Returns once
    every copy has landed, so the caller may hand the result to another
    thread that touches only host memory."""
    out = {}
    on_card = False
    for key, t in flat.items():
        t = t.detach()
        if t.device.type == "cpu":
            out[key] = t.clone()
            continue
        on_card = True
        buf = host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host[key] = buf
        buf.copy_(t, non_blocking=True)
        out[key] = buf
    if on_card:
        torch.cuda.synchronize()
    return out
