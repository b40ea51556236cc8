"""MLPSpeculator: the speculative-decoding head the speculator pipeline
trains.

Counterpart of ``fms_fsdp_tpu/models/speculator.py``: a stack of
``n_predict`` small MLP predictors where head i refines a running state
from the previous state and the embedding of the most recent known or
predicted token,

    state_i = gelu(LN_i(proj_i(state_{i-1}) * w_s + emb_i(tok_i) * w_e))
    logits_i = head_i(state_i)

with w_s = 0.5 ** (0.5 / n_predict) and w_e = sqrt(1 - w_s^2).
``tie_weights`` shares emb/ln/head (and proj for i >= 1) across heads;
``scale_input`` layernorms the incoming base-model embedding (no affine)
scaled by 1/sqrt(2).

The params are lists under ``emb``, ``proj``, ``ln_w``, ``ln_b`` and
``head`` in the ``x @ W`` layout, as JAX's, so ``bridge.py`` copies the
leaves. The head chain runs in the dtype of the state it is given: each
weight is cast to it where it is used (JAX's ``.astype(state.dtype)``),
so under a bf16 base the matmuls and logits are bf16 over fp32 master
weights. The gelu is the tanh approximation, ``jax.nn.gelu``'s default.
"""

import pickle
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fms_fsdp_tpu_torch.utils.tree import tree_map

Params = Dict[str, Any]


@dataclass(frozen=True)
class SpeculatorConfig:
    emb_dim: int
    inner_dim: int
    vocab_size: int
    n_predict: int
    tie_weights: bool = True
    scale_input: bool = True

    @classmethod
    def from_train_config(cls, cfg, emb_dim: int, vocab_size: int):
        return cls(
            emb_dim=emb_dim,
            inner_dim=cfg.speculator_width,
            vocab_size=vocab_size,
            n_predict=cfg.n_speculator_heads,
            tie_weights=cfg.speculator_tie_weights,
            scale_input=cfg.speculator_scale_input,
        )

    def n_params(self) -> int:
        n_unique = 1 if self.tie_weights else self.n_predict
        n_proj = min(2, self.n_predict) if self.tie_weights else self.n_predict
        proj = self.emb_dim * self.inner_dim + (n_proj - 1) * self.inner_dim**2
        per_head = (
            self.vocab_size * self.inner_dim  # emb
            + 2 * self.inner_dim  # ln w, b
            + self.inner_dim * self.vocab_size  # head
        )
        return int(n_unique * per_head + proj)


def _layer_norm(x, weight=None, bias=None, eps=1e-6):
    """LayerNorm over the last dim in fp32, cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def init_speculator_params(generator: torch.Generator, scfg: SpeculatorConfig,
                           dtype=torch.float32) -> Params:
    """Truncated normal (±3 std) with std 0.02 for emb, proj and head, on
    ``generator``'s device, drawn in JAX's key order (proj, emb, head);
    LayerNorm weights one and biases zero. The numbers differ from
    ``jax.random``'s for the same seed."""
    n_unique = 1 if scfg.tie_weights else scfg.n_predict
    n_proj = min(2, scfg.n_predict) if scfg.tie_weights else scfg.n_predict
    device = generator.device
    std = 0.02

    def tn(shape):
        buf = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(buf, std=std, a=-3 * std, b=3 * std,
                                    generator=generator)
        return buf.to(dtype)

    projs = [tn((scfg.emb_dim if i == 0 else scfg.inner_dim, scfg.inner_dim))
             for i in range(n_proj)]
    emb = [tn((scfg.vocab_size, scfg.inner_dim)) for _ in range(n_unique)]
    head = [tn((scfg.inner_dim, scfg.vocab_size)) for _ in range(n_unique)]
    return {
        "emb": emb,
        "proj": projs,
        "ln_w": [torch.ones((scfg.inner_dim,), dtype=dtype, device=device)
                 for _ in range(n_unique)],
        "ln_b": [torch.zeros((scfg.inner_dim,), dtype=dtype, device=device)
                 for _ in range(n_unique)],
        "head": head,
    }


def _pick(params, scfg: SpeculatorConfig, group, i):
    """Head-i parameter lookup honoring the tie_weights sharing rule."""
    if scfg.tie_weights:
        if group == "proj":
            return params["proj"][min(i, len(params["proj"]) - 1)]
        return params[group][0]
    return params[group][i]


def scale_input(state, scfg: SpeculatorConfig):
    """The input normalization applied once before the head chain, shared
    by training and inference."""
    if scfg.scale_input:
        return _layer_norm(state) * (2**-0.5)
    return state


def head_step(params, scfg: SpeculatorConfig, state, tok, i):
    """One speculator head: fold the token embedding into the state with
    the variance-preserving weights, normalize + gelu, project to logits.
    Shared by teacher-forced training (:func:`speculator_forward`) and the
    proposal chain (``models/speculative.py::speculator_propose``)."""
    state_weight = 0.5 ** (0.5 / scfg.n_predict)
    emb_weight = (1 - state_weight**2) ** 0.5
    z = _pick(params, scfg, "emb", i)[tok].to(state.dtype)
    proj = _pick(params, scfg, "proj", i).to(state.dtype)
    state = (state @ proj) * state_weight + z * emb_weight
    state = F.gelu(
        _layer_norm(state, _pick(params, scfg, "ln_w", i), _pick(params, scfg, "ln_b", i)),
        approximate="tanh",
    )
    logits = state @ _pick(params, scfg, "head", i).to(state.dtype)
    return state, logits


def speculator_logits(params: Params, state, inds, scfg: SpeculatorConfig) -> List:
    """Per-head logits as a list of n_predict (B, N, V) tensors (the loss
    reads them head by head, with no stacked copy)."""
    n = state.shape[1]
    state = scale_input(state, scfg)
    out = []
    for i in range(scfg.n_predict):
        state, logits = head_step(params, scfg, state, inds[:, i:i + n], i)
        out.append(logits)
    return out


def speculator_forward(params: Params, state, inds, scfg: SpeculatorConfig):
    """state (B, N, emb_dim): base-model embeddings; inds (B, >= N +
    n_predict - 1): known token indices, inds[:, i:i+N] feeding head i.
    Returns per-head logits (n_predict, B, N, V)."""
    return torch.stack(speculator_logits(params, state, inds, scfg), dim=0)


def save_speculator(path: str, params: Params, scfg: SpeculatorConfig) -> None:
    """Write a serving speculator checkpoint: params (numpy leaves) and
    config in one pickle, the payload JAX's ``save_speculator`` writes.
    Under tie_weights the param tree holds one shared head, so the config
    must ship with the weights."""

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    payload = {
        "model_state": tree_map(leaf, params),
        "speculator_config": asdict(scfg),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_speculator(path: str, device="cpu") -> Tuple[Params, SpeculatorConfig]:
    """Restore a ``save_speculator`` checkpoint (either package's) ->
    (params on ``device``, config)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if "speculator_config" not in payload:
        raise ValueError(
            f"{path!r} is not a serving speculator checkpoint: expected "
            "a save_speculator pickle carrying 'speculator_config' "
            "alongside 'model_state' (n_predict is not inferrable from "
            "tied weights)"
        )
    scfg = SpeculatorConfig(**payload["speculator_config"])
    params = tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device),
        payload["model_state"],
    )
    return params, scfg
