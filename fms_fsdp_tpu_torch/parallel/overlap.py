"""The bucketed cross-slice (DCN) gradient reduce, started inside the
backward.

Counterpart of ``fms_fsdp_tpu/parallel/overlap.py``. On more than one
slice every gradient is summed inside its slice and then once across the
slices (``parallel/sharding.py::DataParallel.reduce_grads``). Left as
one pass after the backward, the cross-slice sum is all exposed time;
this module starts it bucket by bucket while the backward still runs:

- :func:`assign_buckets` packs the gradient leaves into size-targeted
  buckets: a deterministic greedy pack over the leaves ordered by
  ``quant_leaf_key``, from names and sizes alone, so every process (and
  every restart) computes the same plan. A bucket holds JAX leaf names:
  the per-layer leaves of one stacked JAX leaf (``g.layers.wq``) go to
  that leaf's bucket, and a bucket's bytes are JAX's;
- :class:`BucketReducer` is the counterpart of JAX's
  ``apply_bucket_anchors``, which pins GSPMD's placement of each
  bucket's reduce inside the backward and has no torch meaning as
  written. Here a hook on each of a bucket's leaves takes the leaf's
  gradient (a tensor hook runs under ``torch.autograd.grad``, where
  ``register_multi_grad_hook`` refuses leaves); the last of them, when
  the bucket's local gradients are all final, sums them
  inside the slice (the order of ``DataParallel.reduce_within_slice``)
  and starts the bucket's cross-slice all-reduce (``async_op=True``)
  under ``record_function("dcn_bucket_reduce_<i>")``; the step waits on
  every handle before the gradient norm and the clip. Each element is
  summed as ``reduce_grads`` sums it: inside the slice, then across, so
  overlap on and off train the same state (bit for bit where each
  group has two ranks; a larger group's collective may order its own
  partial sums by the buffer's layout). :data:`DCN_REDUCES` counts the
  buckets started;
- :func:`bucketed_quantized_grad_reduce` runs the reduce wire
  (``parallel/sharding.py::quantized_grad_reduce``) bucket by bucket,
  each under ``record_function("quant_reduce_bucket_<i>")``: the same
  values, the same amax keying and rolling.

The bucket size comes from the ``dcn_bucket`` tuning entry
(``tune/lookup.py::resolve_dcn_bucket``) unless ``dcn_bucket_mb`` pins
it. The step build publishes the plan it resolved (:func:`plan_summary`)
for the collective probe (``obs/collectives.py``) and the observer's
``dcn_overlap_frac``.
"""

import math
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from fms_fsdp_tpu_torch.parallel.mesh import num_mesh_slices
from fms_fsdp_tpu_torch.parallel.sharding import (
    _paths,
    quant_leaf_key,
    quantized_grad_reduce,
)

MB = 1024 * 1024

# cross-slice bucket reduces started since the last reset (one a bucket a
# step)
DCN_REDUCES = {"bucket": 0}

# the kinds of leaf in a bucket's buffer, in order: (fsdp part, split over
# expert), as ``DataParallel._kinds`` lists them
_KINDS = ((False, False), (False, True), (True, False), (True, True))


def reset_dcn_reduces() -> None:
    DCN_REDUCES["bucket"] = 0


def wire_bytes_per_element(reduce_quant: str) -> int:
    """Bytes per gradient element on the reduce wire: 1 for the fp8/int8
    wire formats, 2 (bf16) otherwise."""
    return 1 if reduce_quant in ("int8", "fp8", "fp8_delayed") else 2


@dataclass(frozen=True)
class BucketPlan:
    """One resolved bucket schedule: ``buckets[i]`` is the tuple of
    ``quant_leaf_key`` leaf names reduced together, ``bucket_bytes[i]``
    their summed wire bytes."""

    buckets: Tuple[Tuple[str, ...], ...]
    bucket_bytes: Tuple[int, ...]
    target_mb: int
    wire_bytes: int
    total_bytes: int

    def summary(self) -> dict:
        return {
            "buckets": len(self.buckets),
            "bytes_per_bucket": list(self.bucket_bytes),
            "target_mb": self.target_mb,
            "wire_bytes": self.wire_bytes,
            "total_bytes": self.total_bytes,
        }


def assign_buckets(params, target_mb: int, wire_bytes: int) -> BucketPlan:
    """Deterministic size-targeted bucket assignment over the whole
    params' tree (nested dicts and lists of anything with a ``shape``:
    tensors, meta tensors, numpy arrays).

    Leaves are ordered by ``quant_leaf_key``, then greedily packed: a
    bucket closes when adding the next leaf would push it past
    ``target_mb`` of wire bytes. A leaf larger than the target is a
    bucket of its own."""
    target_bytes = max(1, int(target_mb)) * MB
    keyed = sorted(
        (quant_leaf_key(path), math.prod(leaf.shape) * wire_bytes)
        for path, leaf in _paths(params)
    )
    buckets, sizes = [], []
    cur, cur_bytes = [], 0
    for key, nbytes in keyed:
        if cur and cur_bytes + nbytes > target_bytes:
            buckets.append(tuple(cur))
            sizes.append(cur_bytes)
            cur, cur_bytes = [], 0
        cur.append(key)
        cur_bytes += nbytes
    if cur:
        buckets.append(tuple(cur))
        sizes.append(cur_bytes)
    return BucketPlan(
        buckets=tuple(buckets),
        bucket_bytes=tuple(sizes),
        target_mb=int(target_mb),
        wire_bytes=int(wire_bytes),
        total_bytes=sum(sizes),
    )


def overlap_enabled(dcn_overlap: str, mesh) -> bool:
    """Resolve the TrainConfig knob against the mesh (a ``DeviceMesh``
    or None): ``"off"`` never, ``"on"`` always, ``"auto"`` only when the
    mesh has a dcn extent above 1, so one slice builds no plan and its
    step is the step without overlap."""
    mode = (dcn_overlap or "auto").lower()
    if mode == "off":
        return False
    if mode == "on":
        return True
    if mode != "auto":
        raise ValueError(
            f"dcn_overlap must be off|auto|on, got {dcn_overlap!r}"
        )
    return num_mesh_slices(mesh) > 1


class BucketReducer:
    """The cross-slice reduce of one step's gradients, bucket by bucket,
    inside the backward.

    ``keys[i]``, ``split[i]`` and ``esplit[i]`` are the JAX leaf name of
    the step's differentiated leaf ``i``, whether its gradient is an fsdp
    part and whether it is split over expert. :meth:`attach` hooks each
    bucket's leaves; when a bucket's gradients are all computed the last
    hook copies them into one flat buffer a dtype, one span a kind of
    leaf (``DataParallel._kinds``' order: whole, whole split over
    expert, parts, parts split over expert), sums each span in the
    slice as ``DataParallel.reduce_within_slice`` sums its kind, then
    starts the all-reduce over the slices (``DataParallel.dcn_reduce``,
    ``async_op=True``). :meth:`finish` waits on every handle and hands
    back the step's gradients with each bucket's leaves replaced by
    views of its reduced buffer."""

    def __init__(self, dp, plan: BucketPlan, keys: Sequence[str], split: Sequence[bool],
                 esplit: Optional[Sequence[bool]] = None):
        self.dp = dp
        self.split = list(split)
        self.esplit = list(esplit) if esplit is not None else [False] * len(self.split)
        bucket_of = {k: bi for bi, bucket in enumerate(plan.buckets) for k in bucket}
        members: Dict[int, List[int]] = {}
        for i, key in enumerate(keys):
            members.setdefault(bucket_of[key], []).append(i)
        self.members = [members.get(bi, []) for bi in range(len(plan.buckets))]
        self._started: Dict[int, list] = {}
        self._arrived: Dict[int, Dict[int, torch.Tensor]] = {}
        self._hooks = []

    def attach(self, leaves: Sequence[torch.Tensor]) -> None:
        for bi, idx in enumerate(self.members):
            for j, i in enumerate(idx):
                self._hooks.append(leaves[i].register_hook(partial(self._hook, bi, j)))

    def _hook(self, bi: int, j: int, grad: torch.Tensor) -> None:
        arrived = self._arrived.setdefault(bi, {})
        arrived[j] = grad
        if len(arrived) == len(self.members[bi]):
            del self._arrived[bi]
            self._start(bi, [arrived[k] for k in range(len(arrived))])

    def _start(self, bi: int, grads: List[torch.Tensor]) -> None:
        idx = self.members[bi]
        with record_function(f"dcn_bucket_reduce_{bi}"):
            by_dtype: Dict[torch.dtype, List[int]] = {}
            for j, g in enumerate(grads):
                by_dtype.setdefault(g.dtype, []).append(j)
            records = []
            for js in by_dtype.values():
                kinds = [[j for j in js if (self.split[idx[j]], self.esplit[idx[j]]) == kind]
                         for kind in _KINDS]
                order = [j for kind in kinds for j in kind]
                with torch.no_grad():
                    flat = torch.cat([grads[j].reshape(-1) for j in order])
                self._within_slice(flat, [sum(grads[j].numel() for j in kind)
                                          for kind in kinds])
                handle = self.dp.dcn_reduce(flat, async_op=True)
                records.append((flat, handle, [(idx[j], tuple(grads[j].shape))
                                               for j in order]))
            self._started[bi] = records
        DCN_REDUCES["bucket"] += 1

    def _within_slice(self, flat: torch.Tensor, sizes: Sequence[int]) -> None:
        """Each kind's span of ``flat`` (``sizes`` elements each, in
        ``_KINDS`` order) summed in the slice as its kind is."""
        dp, off = self.dp, 0
        for (part, expert), n in zip(_KINDS, sizes):
            span = flat[off:off + n]
            off += n
            if not n:
                continue
            groups = dp.part_groups(expert) if part else [dp.slice_whole_group(expert)]
            for group in groups:
                if group is not None:
                    dist.all_reduce(span, group=group)

    def finish(self, grads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        out = list(grads)
        missing = [bi for bi, idx in enumerate(self.members) if idx and bi not in self._started]
        if missing:
            # a gradient left unsummed across slices would train each
            # slice apart, silently
            raise RuntimeError(f"DCN buckets {missing} were never reduced in the backward")
        for hook in self._hooks:
            hook.remove()
        self._hooks = []
        for bi in sorted(self._started):
            for flat, handle, placed in self._started[bi]:
                if handle is not None:
                    handle.wait()
                off = 0
                for i, shape in placed:
                    n = math.prod(shape)
                    out[i] = flat[off:off + n].view(shape)
                    off += n
        self._started = {}
        return tuple(out)


def bucketed_quantized_grad_reduce(grads: Sequence[torch.Tensor], mode: str,
                                   quant_state=None, plan: Optional[BucketPlan] = None,
                                   leaves: Sequence = (), dp=None):
    """``quantized_grad_reduce`` iterated bucket by bucket, each bucket
    under ``record_function("quant_reduce_bucket_<i>")``: the same values
    and the same amax keying and rolling (one draw on the globally
    reduced gradient; a JAX leaf's per-layer leaves share its bucket, so
    its delayed amax is the max over all of them, and each row rolls
    once). ``plan=None`` is ``quantized_grad_reduce`` outright. Leaves
    the plan does not name go through the same path after the buckets."""
    if plan is None:
        return quantized_grad_reduce(grads, mode, quant_state, leaves, dp)
    if mode not in ("int8", "fp8", "fp8_delayed"):
        raise ValueError(f"unknown quantized_reduce mode: {mode!r}")
    bucket_of = {k: bi for bi, bucket in enumerate(plan.buckets) for k in bucket}
    groups: Dict[int, List[int]] = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(bucket_of.get(leaf.key, len(plan.buckets)), []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    state = quant_state
    for bi in sorted(groups):
        idx = groups[bi]
        scope = (f"quant_reduce_bucket_{bi}" if bi < len(plan.buckets)
                 else "quant_reduce_unplanned")
        with record_function(scope):
            done, state = quantized_grad_reduce(
                [grads[i] for i in idx], mode, state, [leaves[i] for i in idx], dp)
        for i, g in zip(idx, done):
            out[i] = g
    return out, state


# ---------------------------------------------------------------------------
# the resolved plan, set at each step build (as tune/lookup.py publishes
# kernel choices) and read by the entry's collective probe and observer
# ---------------------------------------------------------------------------

_PLAN_SUMMARY: Optional[dict] = None


def set_plan_summary(summary: Optional[dict]) -> None:
    global _PLAN_SUMMARY
    _PLAN_SUMMARY = dict(summary) if summary else None


def plan_summary() -> Optional[dict]:
    """The schedule the most recent ``make_train_step`` resolved, or None
    when overlap was off at the last step build."""
    return dict(_PLAN_SUMMARY) if _PLAN_SUMMARY else None
