"""Weight bridge between numpy param trees and the port's torch params.

The JAX params (``fms_fsdp_tpu/models/llama.py::init_llama_params``,
``models/mamba.py::init_mamba_params``) and the port's share names,
nesting and the ``x @ W`` layouts — wq (L, d, nq*hd), wo (nq*hd, d),
w1/w3 (d, h), w2 (h, d), lm_head (d, V); Mamba's ``layers`` a list of
per-layer dicts — so the bridge copies leaves and transposes nothing. A
JAX tree becomes numpy with ``jax.tree.map(np.asarray, params)`` on the
caller's side; this module never imports JAX.

A whole train state crosses the same way, keyed by JAX's tree paths:
``train_state_from_numpy`` takes JAX's ``{"params", "opt_state",
"step"}`` made numpy and gives a port train state that continues it
(params, Adam's moments and count, and the step);
``train_state_to_numpy`` is the inverse. JAX's ``state["quant"]`` (the
fp8_delayed amax rows, ``quant.amax_history.g.layers.wq``) crosses both
ways with it, into a state made for ``quantized_reduce="fp8_delayed"``.
A speculator's state
(``train/speculator.py``: its params are lists under ``emb``, ``proj``,
``ln_w``, ``ln_b`` and ``head``) crosses the same way, with
``state_fn=speculator_state``.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

from fms_fsdp_tpu_torch.utils.tree import tree_map


def params_from_numpy(tree: Any, device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts and lists of numpy arrays -> the same nesting of torch
    tensors on ``device``, copied (the numpy arrays may be read-only),
    cast to ``dtype`` when given."""

    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)

    return tree_map(leaf, tree)


def params_to_numpy(params: Any) -> Any:
    """The inverse: torch tensors -> numpy arrays on the host. fp32 and
    fp16 keep their dtype; bf16, which numpy lacks, widens exactly to
    fp32."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, params)



def train_state_to_numpy(state: Dict) -> Dict[str, np.ndarray]:
    """A port train state -> JAX's train state as numpy arrays keyed by
    their dotted tree paths (the checkpoint's keys, ``ckpt/state.py``):
    params, Adam's count, hyperparams and moments, and the step. bf16
    widens to fp32 as in :func:`params_to_numpy`."""
    from fms_fsdp_tpu_torch.ckpt.state import checkpoint_state

    return params_to_numpy(checkpoint_state(state))


def train_state_from_numpy(flat: Dict[str, Any], cfg, device="cpu",
                           state_fn=None) -> Dict:
    """JAX's train state as numpy arrays keyed by their dotted tree paths
    (``{jax.tree_util.keystr(path, simple=True, separator="."):
    np.asarray(leaf)}`` over ``tree_flatten_with_path(state)``) -> a port
    train state on ``device`` that continues it: the params and Adam's
    moments copied in the params' dtype, Adam's count, the hyperparams
    and the step restored. ``state_fn(params, cfg)`` makes the fresh
    state (default ``train/step.py::state_from_params``; a speculator's:
    ``train/speculator.py::speculator_state``). Raises when the keys are
    not the port's."""
    from fms_fsdp_tpu_torch.ckpt.state import (
        apply_scalars,
        checkpoint_state,
        unflatten,
    )

    if state_fn is None:
        from fms_fsdp_tpu_torch.train.step import state_from_params as state_fn

    state = state_fn(params_from_numpy(unflatten(flat, "params"), device), cfg)
    target = checkpoint_state(state)
    differ = set(target) ^ set(flat)
    if differ:
        raise KeyError(f"train state keys differ: {sorted(differ)}")
    with torch.no_grad():
        for key, t in target.items():
            t.copy_(torch.from_numpy(np.array(flat[key], copy=True)))
    apply_scalars(state, target)
    return state
