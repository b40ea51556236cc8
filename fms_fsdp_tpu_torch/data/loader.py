"""The dummy token stream.

Counterpart of ``fms_fsdp_tpu/data/loader.py:811-841``: ``SteadyCounter``
and ``get_dummy_loader``, plus ``parse_data_args``, which the checkpoint
topology fingerprint reads (``ckpt/elastic.py``). The rescalable
streaming loader of the JAX package is not ported yet (ROADMAP.md A.15).
"""

import numpy as np


class SteadyCounter:
    """Dummy stream: incrementing counts of constant length l mod vocab v
    (ref:dataloader_utils.py:41-54). Used for benchmarking / dummy runs."""

    def __init__(self, l: int, v: int):
        self.i = 0
        self.l = l
        self.v = v

    def __iter__(self):
        while True:
            out = np.arange(self.i, self.i + self.l, dtype=np.int32) % self.v
            yield out, out
            self.i += self.l


def _stack(items):
    """Stack a list of (inputs, labels) pairs into a batch."""
    return tuple(np.stack(field) for field in zip(*items))


class _SimpleLoader:
    """Minimal batching loader for non-stateful iterables (dummy data)."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __iter__(self):
        it = iter(self.dataset)
        while True:
            yield _stack([next(it) for _ in range(self.batch_size)])


def get_dummy_loader(cfg, rank, world_size):
    return _SimpleLoader(SteadyCounter(cfg.seq_length, cfg.vocab_size), cfg.batch_size)


def parse_data_args(datas, weights):
    """csv strings -> lists (ref:dataloader_utils.py:149-163)."""

    def splitstrip(x):
        if isinstance(x, str):
            return [item.strip() for item in x.split(",")]
        elif isinstance(x, (list, tuple)):
            return list(x)
        elif isinstance(x, (int, float, complex)):
            return [x]
        else:
            raise ValueError(f"arg input {x} cannot be parsed.")

    datas = splitstrip(datas)
    weights = [float(x) for x in splitstrip(weights)]
    return datas, weights
