"""Weight bridge between numpy param trees and the port's torch params.

The JAX params (``fms_fsdp_tpu/models/llama.py::init_llama_params``) and
the port's (``models/llama.py``) share names, nesting and the ``x @ W``
layouts — wq (L, d, nq*hd), wo (nq*hd, d), w1/w3 (d, h), w2 (h, d),
lm_head (d, V) — so the bridge copies leaves and transposes nothing. A
JAX tree becomes numpy with ``jax.tree.map(np.asarray, params)`` on the
caller's side; this module never imports JAX.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch


def params_from_numpy(tree: Dict[str, Any], device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nesting of torch tensors on
    ``device``, copied (the numpy arrays may be read-only), cast to
    ``dtype`` when given."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device, dtype)
        else:
            t = torch.from_numpy(np.array(leaf, copy=True))
            out[name] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: torch tensors -> numpy arrays on the host. fp32 and
    fp16 keep their dtype; bf16, which numpy lacks, widens exactly to
    fp32."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = params_to_numpy(leaf)
        else:
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[name] = t.numpy()
    return out
