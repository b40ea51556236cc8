"""Selective activation checkpointing (remat) policy.

The reference checkpoints a fraction ``p`` of transformer blocks, evenly
spaced, via a stateful counter walk over blocks
(ref:fms_fsdp/policies/ac_handler.py:16-64):

    block_idx += 1
    if block_idx * p >= cut_off: cut_off += 1 -> checkpoint this block

A copy of ``fms_fsdp_tpu/parallel/ac.py``: the same selection becomes a
static boolean mask over layers; ``models/llama.py::llama_forward`` wraps
the masked layers in ``torch.utils.checkpoint`` (non-reentrant), so
their activations are recomputed in the backward pass instead of saved.
"""

from fractions import Fraction
from typing import List, Union


def parse_ac_fraction(p: Union[float, int, str]) -> float:
    """Fraction strings like "1/3" arrive via CLI argv; the reference
    ``eval``s them (ref:ac_handler.py:45-47). We parse safely instead."""
    if isinstance(p, str):
        return float(Fraction(p))
    return float(p)


def selective_ac_mask(nlayers: int, p: Union[float, int, str]) -> List[bool]:
    """Per-layer remat mask replicating the reference's counter walk exactly
    (ref:ac_handler.py:43-58). p=0 -> no remat, p=1 -> full remat, p=1/2 ->
    [T,F,T,F,...], p=1/3 -> [F,T,F, F,T,F, ...], p=2/3 -> [T,F,T, T,F,T, ...].
    """
    p = parse_ac_fraction(p)
    mask = []
    block_idx = 0
    cut_off = 1 / 2
    for _ in range(nlayers):
        block_idx += 1
        if block_idx * p >= cut_off:
            cut_off += 1
            mask.append(True)
        else:
            mask.append(False)
    return mask
