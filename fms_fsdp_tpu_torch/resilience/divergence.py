"""Cross-replica divergence detection: prove the replicated train states
still agree.

Counterpart of ``fms_fsdp_tpu/resilience/divergence.py:62-323``. Every
leaf a rank holds whole (ddp, and every leaf across the replicas of hsdp)
is assumed bit-identical to its copies on the other replicas, and no
collective checks it: silent data corruption (a defective card, a broken
reduce) can walk one replica away while the loss everyone watches reads
the same. At report cadence, every ``divergence_check_interval`` steps:

- each rank computes a **whole-state checksum**: every leaf of the train
  state (params, Adam's moments and count, the step) as its bits, summed
  mod 2^32. The parts split over fsdp or tensor are summed over the
  replica's ranks, the whole leaves counted as the rank holds them, so
  the number is a replica's answer, recomputed by each rank of it;
- the rows ``[rank, replica index, digest of the last window's loss and
  gradient norm, checksum parts]`` cross the world in one fixed-shape
  int64 all-gather on the gloo group beside the step's;
- every value must agree: the scalars are post-reduce replicated values,
  and the checksums nominally replicated ones. Disagreement raises
  :class:`StateDivergenceError` (exit ``state_divergence`` under
  ``classified_exit``), naming the minority replicas. The port has no
  slices yet (ROADMAP.md A.6b), so the replica index stands where JAX
  names the slice.

The ``sdc_grad_flip`` fault site injects exactly this failure at the
loop's step boundary (:func:`inject_sdc`): one rank's local part of the
largest param leaf is scaled, and the next compare must catch it.
"""

import hashlib
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from fms_fsdp_tpu_torch.ckpt.state import checkpoint_state
from fms_fsdp_tpu_torch.utils.dist import all_gather_rows, rank, world_size

_TOTAL_CHECKS = 0
# elements summed at a time (bounds the int64 temporaries on the card)
_CHUNK = 1 << 24


class StateDivergenceError(RuntimeError):
    """Cross-replica fingerprints disagree: a replica's train state has
    silently diverged. Mapped to the ``state_divergence`` exit code by
    ``classified_exit``."""


def total_checks() -> int:
    """Divergence checks this process made (``divergence_checks`` of the
    metrics record)."""
    return _TOTAL_CHECKS


def reset_checks() -> None:
    global _TOTAL_CHECKS
    _TOTAL_CHECKS = 0


def _digest64(payload: bytes) -> int:
    """First 8 bytes of sha256 as a signed int64."""
    return int.from_bytes(hashlib.sha256(payload).digest()[:8], "big", signed=True)


def scalar_digest(loss: float, grad_norm: float) -> int:
    """Bit-pattern digest of the window's post-reduce scalars, equal on
    every rank of a healthy world."""
    return _digest64(struct.pack("<dd", float(loss), float(grad_norm)))


_UNSIGNED = {1: (torch.uint8, 0xFF), 2: (torch.int16, 0xFFFF), 4: (torch.int32, 0xFFFFFFFF)}


def leaf_checksum(t: torch.Tensor) -> int:
    """The bits of ``t`` summed mod 2^32: each element's bytes as an
    unsigned integer (8-byte elements as two 32-bit halves)."""
    t = t.detach().contiguous().reshape(-1)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    size = t.element_size()
    if size == 8:
        t = t.view(torch.int32)
        size = 4
    view, mask = _UNSIGNED[size]
    bits = t.view(view)
    total = 0
    for i in range(0, bits.numel(), _CHUNK):
        part = bits[i:i + _CHUNK].to(torch.int64) & mask
        total = (total + int(part.sum())) & 0xFFFFFFFF
    return total


def state_checksum_parts(state) -> Tuple[int, int]:
    """(sum over the leaves split over fsdp, tensor or expert, sum over the
    whole leaves), each mod 2^32, of this rank's train state."""
    dp = state.get("dp")
    split = whole = 0
    for key, t in checkpoint_state(state).items():
        c = leaf_checksum(t)
        if dp is not None and any(d is not None for d in (
                dp.dim_of(key), dp.tdim_of(key), dp.edim_of(key))):
            split = (split + c) & 0xFFFFFFFF
        else:
            whole = (whole + c) & 0xFFFFFFFF
    return split, whole


def _largest_leaf(state) -> Tuple[str, torch.Tensor]:
    from fms_fsdp_tpu_torch.ckpt.state import flatten

    dp = state.get("dp")
    leaves = flatten("params", state["params"], {})

    def whole_bytes(kv):
        key, t = kv
        shape = dp.shapes[key] if dp is not None else tuple(t.shape)
        return (int(np.prod(shape)) * t.element_size(), key)

    return max(leaves.items(), key=whole_bytes)


def inject_sdc(state, scale: float = 1.5) -> str:
    """The ``sdc_grad_flip`` payload: scale THIS rank's local part of the
    largest param leaf in place (the optimizer's views see it), leaving
    every other rank's copy untouched: the effect of an update computed
    from a corrupted gradient on one replica. Returns the leaf's key."""
    key, leaf = _largest_leaf(state)
    with torch.no_grad():
        leaf.mul_(scale)
    return key


def _minority(labels, values):
    """The minority value's labels (the suspects), or (None, split) on a
    tie, where no side can be blamed."""
    groups: dict = {}
    for lab, val in zip(labels, values):
        groups.setdefault(int(val), set()).add(int(lab))
    sizes = sorted(len(m) for m in groups.values())
    if len(groups) > 1 and sizes.count(sizes[-1]) == 1:
        majority_val = max(groups, key=lambda v: len(groups[v]))
        odd = sorted(lab for val, mem in groups.items() if val != majority_val
                     for lab in mem)
        return odd, None
    return None, {v: sorted(m) for v, m in sorted(groups.items())}


def check_divergence(state, loss: float, grad_norm: float, step: int,
                     registry=None, report=print) -> bool:
    """One compare (at report cadence, every rank at the same step: the
    all-gather is collective). True when every fingerprint agrees; raises
    :class:`StateDivergenceError` (after one line and the
    ``integrity.divergence_detected`` counter) when one does not. A
    world of one is a no-op."""
    global _TOTAL_CHECKS
    if world_size() == 1:
        return True
    dp = state.get("dp")
    replica = dp.replica_rank if dp is not None else rank()
    split, whole = state_checksum_parts(state)
    rows = all_gather_rows(np.array(
        [rank(), replica, scalar_digest(loss, grad_norm), split, whole], np.int64))
    _TOTAL_CHECKS += 1

    # a replica's checksum: its ranks' split parts summed (the fsdp
    # reduction) plus what the rank holds whole
    split_of = {}
    for r in rows:
        split_of[int(r[1])] = (split_of.get(int(r[1]), 0) + int(r[3])) & 0xFFFFFFFF
    checksums = [(split_of[int(r[1])] + int(r[4])) & 0xFFFFFFFF for r in rows]

    problems: List[str] = []
    scal = rows[:, 2]
    if not np.all(scal == scal[0]):
        odd, tied = _minority(rows[:, 0], scal)
        problems.append(
            (f"loss/grad-norm fingerprints disagree across processes (split {tied} "
             f"— no majority)" if odd is None else
             f"loss/grad-norm fingerprints disagree across processes (minority "
             f"processes {odd} differ from the majority)")
            + " — the post-reduce scalars are replicated values and must be "
            "bit-identical")
    if len(set(checksums)) > 1:
        odd, tied = _minority(rows[:, 1], checksums)
        problems.append(
            (f"whole-state checksums disagree (replicas split {tied} — no majority)"
             if odd is None else
             f"whole-state checksums disagree (minority replicas {odd} differ "
             f"from the majority)")
            + " — a replicated train state has silently diverged")
    if not problems:
        return True
    if registry is not None:
        registry.counter("integrity.divergence_detected").add()
    report(
        f"INTEGRITY: cross-replica state divergence detected at step {step}: "
        f"{problems[0]} (integrity.divergence_detected; relaunch will resume "
        f"from the last scrub-verified checkpoint)"
    )
    raise StateDivergenceError(
        f"cross-replica state divergence at step {step}: " + "; ".join(problems)
    )


def divergence_due(step: int, last_checked: Optional[int], interval: int) -> bool:
    """``interval`` steps (``divergence_check_interval``) since the last
    check; 0 disables."""
    if interval <= 0:
        return False
    return last_checked is None or (step - last_checked) >= interval
