"""Named profiler scopes for trace attribution.

Counterpart of ``fms_fsdp_tpu/obs/scopes.py`` (``jax.named_scope``):
``scoped("name")`` runs a function under
``torch.profiler.record_function(name)``, so a ``torch.profiler`` trace
(``utils/train_utils.py::WindowedProfiler``) shows the work it launches
under that name. Outside a profiler the scope costs one small host call
and records nothing. The port applies the JAX package's scopes at the
same places: the train step's ``fwd_bwd`` and ``optimizer``, Llama's
``embed`` / ``attn`` / ``ffn`` / ``lm_head``, Mamba's mixers, the flash
forward and backward, the SSD scan and the causal conv.
"""

import functools

from torch.profiler import record_function


def scoped(name: str):
    """Decorator: run the wrapped function under
    ``torch.profiler.record_function(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
