"""Weight bridge between numpy param trees and the port's torch params.

The JAX params (``fms_fsdp_tpu/models/llama.py::init_llama_params``,
``models/mamba.py::init_mamba_params``) and the port's share names,
nesting and the ``x @ W`` layouts — wq (L, d, nq*hd), wo (nq*hd, d),
w1/w3 (d, h), w2 (h, d), lm_head (d, V); Mamba's ``layers`` a list of
per-layer dicts — so the bridge copies leaves and transposes nothing. A
JAX tree becomes numpy with ``jax.tree.map(np.asarray, params)`` on the
caller's side; this module never imports JAX.
"""

from typing import Any, Optional

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
