"""Where each leaf of the train state lives on the mesh, and the
collectives of the data- and tensor-parallel step.

Counterpart of ``fms_fsdp_tpu/parallel/sharding.py:35-215``,
``fms_fsdp_tpu/models/mamba.py:610`` and
``fms_fsdp_tpu/models/mixtral.py:103``. JAX declares a ``PartitionSpec`` per
param and lets GSPMD insert the collectives; here the same spec trees
decide each leaf's placement and :class:`DataParallel` runs the
collectives by hand:

- a leaf whose spec names ``fsdp`` on a dim the fsdp extent divides
  (``resolve_spec``'s rule) is split on that dim over the fsdp axis, and
  one that names ``tensor`` on a dim the tensor extent divides is split
  on that dim over the tensor axis (the Megatron layout: wq, wk, wv, w1
  and w3 by columns, wo and w2 by rows, the embedding and the lm_head by
  vocabulary), and Mixtral's expert weights split their E dim over the
  expert axis; every other dim is whole. Llama's stacked L axis is never
  split, so ``wq`` (L, d, nq*hd) splits dim 1 over fsdp and dim 2 over
  tensor, and ``w1`` (L, E, d, h) dim 1 over expert, dim 2 over fsdp and
  dim 3 over tensor. Adam's moments split as their params
  (``infer_state_specs``);
- the train state holds each rank's *local* tensors in JAX's layout, so
  AdamW's elementwise update on them is exact per shard. For a checkpoint
  :meth:`DataParallel.dcp_view` wraps them, without a copy, as
  ``DTensor``\\s placed on the mesh, and DCP writes per-rank shards and
  reshards on load;
- the forward gathers one layer at a time over fsdp, in the compute
  dtype, when it reaches the layer (:class:`GatheredLayers`): that yields
  the layer's tensor block, which the forward's Megatron operators take
  (``parallel/tensor.py``, :attr:`DataParallel.tp`); a gathered
  weight that autograd saves for the backward is kept as a handle and
  gathered again when the backward needs it
  (:meth:`DataParallel.release_saved`), so no layer's full weights live
  from its forward to its backward, as FSDP's FULL_SHARD reshards after
  the forward. :data:`GATHERS` counts the gathers: 2 x L a step under
  fsdp (a layer under activation checkpointing gathers again in its
  recomputed forward instead), none under ddp;
- gradients are reduce-scattered over fsdp (in the gather's backward),
  all-reduced over ``replica`` under hsdp and over ``context`` (the
  ranks that hold parts of the same rows' sequence), and a leaf not split
  over fsdp has its gradients all-reduced over the data group: the world
  but the tensor axis (tensor peers train the same rows, so a sum over
  them would count each row tp times). Every reduce is a SUM: each rank's loss is its summed token
  loss over the GLOBAL count of labels != -100, counted over the data
  group, and the loss and the MoE route sums are summed over it too.
  The gradient norm adds a leaf's squares over each axis that splits
  it, once. :attr:`DataParallel.ring` is the context exchange the
  forward runs (``ops/ring_attention.py::GroupRing``), None without a
  context axis;
- the expert axis is a data axis: each expert rank trains its own rows,
  and the MoE FFN exchanges the routed tokens with the ranks that hold
  their experts (:attr:`DataParallel.ep`, ``parallel/expert.py``), so an
  expert leaf's gradient comes out of the backward summed over the
  expert peers' rows already. A leaf split over expert is summed over
  every data axis but expert (the whole ones over
  :attr:`DataParallel.data_group_ne`, the fsdp parts over replica and
  context); every other leaf over the expert axis too (the fsdp parts
  then over :attr:`DataParallel.expert_group`). JAX's ``DATA_AXES``
  sums each leaf the same way;
- on more than one slice (the ``dcn`` axis, ``num_slices``) a gradient
  is summed inside its slice first, in the order above (the fsdp
  reduce-scatter, the replica and context all-reduces; a whole leaf's
  over the slice's data group), then once over the slices
  (:attr:`DataParallel.dcn_group`, :meth:`DataParallel.dcn_reduce`),
  as JAX's hierarchical reduce runs ICI inside a slice and one DCN
  all-reduce across slices. No leaf is split over dcn: the gradients,
  and so the params, are the same on every slice. With the DCN overlap
  on, ``parallel/overlap.py`` starts those two steps bucket by bucket
  inside the backward instead.

The quantized gradient reduce (``:215-292``): :func:`quant_leaf_key`,
:func:`init_amax_state` and :func:`quantized_grad_reduce`, on the
reduced gradients of the step's per-layer leaves.

The serving layout (``:296-407``): :func:`parse_serve_layout`,
:func:`serve_layout_code`, :func:`serve_kv_pool_specs`,
:func:`serve_param_specs` and :func:`build_serve_mesh`, whose
:class:`ServeMesh` is JAX's 2-axis ``(fsdp, tensor)`` mesh over the
replica's processes, one rank each. :meth:`ServeMesh.place` keeps this
rank's blocks of the whole params (the training rulebooks through
:func:`resolve_spec` on the mesh's sizes), cast to the compute dtype and
only then moved to the device. Under fsdp the split leaves are gathered
at use, never kept whole between steps: a layer at a time
(:class:`ServeLayers`, through ``models/llama.py::layer_params``) and
the top-level leaves once a step (:func:`serve_top`); both count in
:data:`GATHERS`.
"""

import math
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from fms_fsdp_tpu_torch.parallel.expert import ExpertParallel
from fms_fsdp_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_REPLICA,
    AXIS_TENSOR,
    DATA_AXES,
    MESH_AXES,
    axis_sizes,
    expert_groups,
    slice_data_groups,
)
# JAX keeps it here; the port defines it beside the mesh, which imports
# no torch (a replica child reads its layout before torch)
from fms_fsdp_tpu_torch.parallel.mesh import parse_serve_layout  # noqa: F401

# gathers since the last reset: "layer" (one per layer and pass) and
# "top" (embedding and lm_head together)
GATHERS = {"layer": 0, "top": 0}

_MOMENT_PREFIXES = ("opt_state.inner_state.0.mu.", "opt_state.inner_state.0.nu.")
# elements per bucket of a flattened gradient all-reduce
_BUCKET = 1 << 25


def reset_gathers() -> None:
    for key in GATHERS:
        GATHERS[key] = 0


class P(tuple):
    """A partition spec: one entry per dim, an axis name, a tuple of axis
    names, or None (replicated); JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def batch_pspec() -> P:
    """(B, S) token batches: rows over every data axis, the sequence over
    ``context``. Each process loads its own rows, so the batch is never
    moved between processes."""
    return P(DATA_AXES, AXIS_CONTEXT)


def llama_param_specs(scan: bool = True) -> Dict[str, Any]:
    """The spec tree of the Llama params (stacked layers when ``scan``)."""
    lead = (None,) if scan else ()
    layers = {
        "attn_norm": P(*lead, None),
        "wq": P(*lead, AXIS_FSDP, AXIS_TENSOR),
        "wk": P(*lead, AXIS_FSDP, AXIS_TENSOR),
        "wv": P(*lead, AXIS_FSDP, AXIS_TENSOR),
        "wo": P(*lead, AXIS_TENSOR, AXIS_FSDP),
        "ffn_norm": P(*lead, None),
        "w1": P(*lead, AXIS_FSDP, AXIS_TENSOR),
        "w3": P(*lead, AXIS_FSDP, AXIS_TENSOR),
        "w2": P(*lead, AXIS_TENSOR, AXIS_FSDP),
    }
    return {
        "embedding": P(AXIS_TENSOR, AXIS_FSDP),
        "layers": layers,
        "norm": P(None),
        "lm_head": P(AXIS_FSDP, AXIS_TENSOR),
    }


def mamba_param_specs(cfg) -> Dict[str, Any]:
    """The spec tree of the Mamba2 hybrid params (a list of unlike
    layers)."""

    def mamba_mixer():
        return {
            "in_proj": P(AXIS_FSDP, AXIS_TENSOR),
            "conv_w": P(AXIS_FSDP, None),
            "conv_b": P(AXIS_FSDP),
            "dt_bias": P(None),
            "A_log": P(None),
            "D": P(None),
            "norm": P(None),
            "out_proj": P(AXIS_TENSOR, AXIS_FSDP),
        }

    def attn_mixer():
        return {
            "wq": P(AXIS_FSDP, AXIS_TENSOR),
            "wk": P(AXIS_FSDP, AXIS_TENSOR),
            "wv": P(AXIS_FSDP, AXIS_TENSOR),
            "wo": P(AXIS_TENSOR, AXIS_FSDP),
        }

    layers = []
    for i in range(cfg.n_layer):
        layer = {"norm": P(None),
                 "mixer": attn_mixer() if i in cfg.attn_layer_idx else mamba_mixer()}
        if cfg.d_intermediate > 0:
            layer["norm2"] = P(None)
            layer["mlp"] = {
                "w1": P(AXIS_FSDP, AXIS_TENSOR),
                "w3": P(AXIS_FSDP, AXIS_TENSOR),
                "w2": P(AXIS_TENSOR, AXIS_FSDP),
            }
        layers.append(layer)
    return {
        "embedding": P(AXIS_TENSOR, AXIS_FSDP),
        "layers": layers,
        "norm_f": P(None),
        "lm_head": P(AXIS_FSDP, AXIS_TENSOR),
    }


def mixtral_param_specs(scan: bool = True) -> Dict[str, Any]:
    """The spec tree of the Mixtral params: attention as Llama's; the
    router ``gate`` replicated; each expert's matrices split as Llama's
    FFN, with E over ``expert`` (JAX's ``models/mixtral.py:103-130``:
    expert parallelism composes with fsdp and tensor)."""
    lead = (None,) if scan else ()
    specs = llama_param_specs(scan)
    specs["layers"].update({
        "gate": P(*lead, None, None),
        "w1": P(*lead, AXIS_EXPERT, AXIS_FSDP, AXIS_TENSOR),
        "w3": P(*lead, AXIS_EXPERT, AXIS_FSDP, AXIS_TENSOR),
        "w2": P(*lead, AXIS_EXPERT, AXIS_TENSOR, AXIS_FSDP),
    })
    return specs


def param_specs(model_cfg) -> Dict[str, Any]:
    from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MambaConfig, MixtralConfig

    if isinstance(model_cfg, MixtralConfig):
        return mixtral_param_specs(scan=True)
    if isinstance(model_cfg, LlamaConfig):
        return llama_param_specs(scan=True)
    if isinstance(model_cfg, MambaConfig):
        return mamba_param_specs(model_cfg)
    raise TypeError(f"no sharding specs for {type(model_cfg).__name__}")


def resolve_spec(spec: P, shape, mesh_shape: Dict[str, int]) -> P:
    """Drop the spec entries whose mesh extent does not divide the dim
    (axes the mesh does not carry are dropped first)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        present = tuple(a for a in axes if a in mesh_shape)
        if not present:
            out.append(None)
            continue
        entry = present if isinstance(entry, tuple) else present[0]
        extent = math.prod(mesh_shape[a] for a in present)
        out.append(entry if i < len(shape) and shape[i] % extent == 0 else None)
    return P(*out)


def _paths(tree, prefix=()):
    """(path tuple, leaf) of nested dicts and lists; a ``P`` is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def infer_state_specs(state_paths, specs, params_subtree: str = "params") -> Dict:
    """{path: spec} for the leaves of a train state given as
    {dotted path: leaf}: a leaf takes the spec of the param whose path is
    a suffix of its own (Adam's moments mirror the params), else it is
    replicated (``P()``)."""
    flat = {path: spec for path, spec in _paths(specs)}
    out = {}
    for key in state_paths:
        keys = tuple(key.split("."))
        spec = None
        if keys[0] == "quant":
            pass  # amax rows (``g.layers.wq``): replicated, never a param's
        elif keys and keys[0] == params_subtree and keys[1:] in flat:
            spec = flat[keys[1:]]
        else:
            for i in range(len(keys)):
                if keys[i:] in flat:
                    spec = flat[keys[i:]]
                    break
        out[key] = spec if spec is not None else P()
    return out


def shard_dims(params, specs, mesh_shape: Dict[str, int],
               axis: str = AXIS_FSDP) -> Dict[str, Optional[int]]:
    """{"params.<path>": the dim split over ``axis`` (fsdp, tensor or
    expert), or None (whole over it)} for every param leaf, through
    :func:`resolve_spec`: a dim the axis does not divide stays whole."""
    spec_of = {path: spec for path, spec in _paths(specs)}
    out = {}
    for path, leaf in _paths(params):
        spec = resolve_spec(spec_of[path], tuple(leaf.shape), mesh_shape)
        dim = None
        if mesh_shape.get(axis, 1) > 1:
            for i, entry in enumerate(spec):
                axes = entry if isinstance(entry, tuple) else (entry,)
                if axis in axes:
                    dim = i
        out["params." + ".".join(path)] = dim
    return out


def param_key(key: str) -> str:
    """The params key a checkpoint key follows: Adam's moments are placed
    as their params."""
    for prefix in _MOMENT_PREFIXES:
        if key.startswith(prefix):
            return "params." + key[len(prefix):]
    return key


# ---------------------------------------------------------------------------
# the quantized gradient reduce
# ---------------------------------------------------------------------------


def quant_leaf_key(path: Sequence) -> str:
    """The flat "g."-prefixed name of one JAX gradient leaf, from its
    path: ``g.layers.wq`` for Llama's and Mixtral's stacked (L, ...)
    leaves, ``g.layers.3.mixer.in_proj`` for Mamba's list. The name holds
    dots: a checkpoint keeps it whole under ``quant.amax_history.``, and
    the rows are replicated (:func:`infer_state_specs` matches them to no
    param)."""
    return "g." + ".".join(str(p) for p in path)


def init_amax_state(params, history_len: int) -> Dict:
    """Fresh delayed-scaling state: one (H,) fp32 amax row per JAX leaf of
    ``params`` (whole or this rank's parts), on the leaf's device, zeros,
    newest at index 0 (the first step bootstraps from its own amax:
    ``ops/quant.py::delayed_scale``)."""
    return {"amax_history": {
        quant_leaf_key(path): torch.zeros((int(history_len),), dtype=torch.float32,
                                          device=leaf.device)
        for path, leaf in _paths(params)}}


class QuantLeaf(NamedTuple):
    """One differentiated leaf as the reduce wire sees it: its JAX key,
    the JAX leaf's rank (a stacked leaf's is its own plus one), and the
    dims of this leaf split over fsdp, over tensor and over expert (None
    when whole here)."""

    key: str
    ndim: int
    split: Optional[int]
    tsplit: Optional[int] = None
    esplit: Optional[int] = None


def _all_max(values: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Elementwise max of each tensor over ``group``, in one all-reduce
    (through fp32, which holds every bf16 and fp32 value exactly)."""
    flat = torch.cat([v.reshape(-1).float() for v in values])
    dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=group)
    out, off = [], 0
    for v in values:
        out.append(flat[off:off + v.numel()].view(v.shape).to(v.dtype))
        off += v.numel()
    return out


def quantized_grad_reduce(grads: Sequence[torch.Tensor], mode: str, quant_state=None,
                          leaves: Sequence[QuantLeaf] = (), dp=None):
    """Round-trip each reduced gradient through the reduce wire: "int8" /
    "fp8" (e5m2) with per-row scales (per tensor for a JAX vector leaf),
    or "fp8_delayed" with one scale per JAX leaf from its amax history.
    Returns (the round-tripped grads, the new quant state: the rolled
    history under fp8_delayed, else ``quant_state``).

    JAX's contract is one draw on the globally reduced gradient. The
    leaves here are per layer and, under fsdp, this rank's parts:

    - a stacked JAX leaf (``g.layers.wq``) takes its amax over its L layer
      grads, and its one history row serves all of them; per-row scales
      do not see the stacking;
    - a row split over fsdp (a leaf split on its last dim: wo, w2,
      out_proj, the embedding; or a vector split at all) takes the whole
      row's amax, all-reduced (MAX) over the fsdp group of ``dp``, and a
      row split over tensor (a leaf split on its last dim there: wq, w1,
      the lm_head, in_proj; or a vector) over its tensor group, and one
      split over expert over the expert group (an expert leaf's E dim);
      under fp8_delayed every split leaf's amax is. ``dp=None`` keeps
      each amax local."""
    from fms_fsdp_tpu_torch.ops.quant import (
        absmax,
        delayed_scale,
        leaf_amax,
        roll_amax_history,
        wire_dims,
        wire_roundtrip,
    )

    group = dp.fsdp_group if dp is not None else None
    tp = dp.tp if dp is not None else None
    egroup = dp.expert_group if dp is not None else None
    if mode in ("int8", "fp8"):
        amaxes, need, tneed, eneed = [], [], [], []
        for i, (g, leaf) in enumerate(zip(grads, leaves)):
            dims = wire_dims(g, leaf.ndim)
            amaxes.append(absmax(g, dims))
            # a scale over a dim split across the fsdp, the tensor or the
            # expert group: the whole one's
            spanned = (g.dim() - 1,) if dims == -1 else dims
            if group is not None and leaf.split in spanned:
                need.append(i)
            if tp is not None and leaf.tsplit in spanned:
                tneed.append(i)
            if egroup is not None and leaf.esplit in spanned:
                eneed.append(i)
        if need:
            for i, a in zip(need, _all_max([amaxes[i] for i in need], group)):
                amaxes[i] = a
        if tneed:
            for i, a in zip(tneed, tp.all_max([amaxes[i] for i in tneed])):
                amaxes[i] = a
        if eneed:
            for i, a in zip(eneed, _all_max([amaxes[i] for i in eneed], egroup)):
                amaxes[i] = a
        return [wire_roundtrip(g, mode, amax=a, ndim=leaf.ndim)
                for g, a, leaf in zip(grads, amaxes, leaves)], quant_state
    if mode != "fp8_delayed":
        raise ValueError(f"unknown quantized_reduce mode: {mode!r}")
    history = quant_state["amax_history"]
    current: Dict[str, torch.Tensor] = {}
    split_keys, tsplit_keys, esplit_keys = set(), set(), set()
    for g, leaf in zip(grads, leaves):
        amax = leaf_amax(g)
        current[leaf.key] = amax if leaf.key not in current else torch.maximum(
            current[leaf.key], amax)
        if group is not None and leaf.split is not None:
            split_keys.add(leaf.key)
        if tp is not None and leaf.tsplit is not None:
            tsplit_keys.add(leaf.key)
        if egroup is not None and leaf.esplit is not None:
            esplit_keys.add(leaf.key)
    if split_keys:
        keys = sorted(split_keys)
        for key, a in zip(keys, _all_max([current[k] for k in keys], group)):
            current[key] = a
    if tsplit_keys:
        keys = sorted(tsplit_keys)
        for key, a in zip(keys, tp.all_max([current[k] for k in keys])):
            current[key] = a
    if esplit_keys:
        keys = sorted(esplit_keys)
        for key, a in zip(keys, _all_max([current[k] for k in keys], egroup)):
            current[key] = a
    scales = {key: delayed_scale(history[key], amax) for key, amax in current.items()}
    out = [wire_roundtrip(g, "fp8_delayed", scale=scales[leaf.key])
           for g, leaf in zip(grads, leaves)]
    new_history = {key: roll_amax_history(row, current[key]) if key in current else row
                   for key, row in history.items()}
    return out, {"amax_history": new_history}


# ---------------------------------------------------------------------------
# the data-parallel runtime
# ---------------------------------------------------------------------------


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


class _Unit:
    """One gather: the local compute-dtype shards of a layer (or of the
    top-level leaves), their split dims, and the copy gathered again for
    the backward while saved handles still point at it."""

    __slots__ = ("dp", "locals", "dims", "kind", "cache", "refs")

    def __init__(self, dp, local_leaves, dims, kind):
        self.dp = dp
        self.locals = [t.detach() for t in local_leaves]
        self.dims = dims
        self.kind = kind
        self.cache = None
        self.refs = 0

    def regather(self):
        if self.cache is None:
            self.cache = self.dp.all_gather(self.locals, self.dims, self.kind)
        return self.cache


class _Gather(torch.autograd.Function):
    """Local shards -> whole tensors (all-gather over fsdp); the backward
    reduce-scatters the whole gradients to the shards (a sum)."""

    @staticmethod
    def forward(ctx, unit, *local_leaves):
        ctx.unit = unit
        fulls = unit.dp.all_gather(unit.locals, unit.dims, unit.kind)
        for j, full in enumerate(fulls):
            full._fms_gathered = (unit, j)
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        grads = [torch.zeros(unit.dp.full_shape(t, d), dtype=t.dtype, device=t.device)
                 if g is None else g
                 for g, t, d in zip(grads, unit.locals, unit.dims)]
        return (None, *unit.dp.reduce_scatter(grads, unit.dims))


class _SumOverWorld(torch.autograd.Function):
    """All-reduce (sum) over ``group`` whose backward is the identity on
    each rank."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


_HANDLE = object()


def _pack(t):
    base = t if t._base is None else t._base
    tag = getattr(base, "_fms_gathered", None)
    if tag is None:
        return t
    unit, j = tag
    unit.refs += 1
    return (_HANDLE, unit, j, tuple(t.shape), t.stride(), t.storage_offset())


def _unpack(packed):
    if not (isinstance(packed, tuple) and packed and packed[0] is _HANDLE):
        return packed
    _, unit, j, shape, stride, offset = packed
    full = unit.regather()[j]
    unit.refs -= 1
    if unit.refs == 0:
        unit.cache = None
    return full.as_strided(shape, stride, offset)


class GatheredLayers:
    """The forward's ``params["layers"]`` under fsdp: layer ``i``'s
    compute-dtype weights, gathered when the forward asks for them.
    Indexing gathers; the forward's cast at entry is a no-op (the shards
    are already in the compute dtype)."""

    def __init__(self, dp, layers, dims):
        self.dp = dp
        self.layers = layers
        self.dims = dims

    def __len__(self):
        return len(self.layers)

    def __getitem__(self, i):
        return self.dp.gather_tree(self.layers[i], self.dims[i], "layer")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def to(self, dtype):
        return self


class DataParallel:
    """The parallel layout of one run: the mesh, the fsdp / replica /
    tensor / expert / data process groups (and on more than one slice
    the within-slice data groups and the dcn group), and the split dims
    of every param leaf over fsdp (``dims``), over tensor (``tdims``)
    and over expert (``edims``)."""

    def __init__(self, mesh, dims: Dict[str, Optional[int]], shapes: Dict[str, Tuple],
                 tdims: Optional[Dict[str, Optional[int]]] = None,
                 edims: Optional[Dict[str, Optional[int]]] = None):
        self.mesh = mesh
        sizes = axis_sizes(mesh)
        self.fsdp = sizes[AXIS_FSDP]
        self.replica = sizes[AXIS_REPLICA]
        self.tensor = sizes[AXIS_TENSOR]
        self.expert = sizes[AXIS_EXPERT]
        self.world = dist.get_world_size()
        self.fsdp_rank = mesh.get_local_rank(AXIS_FSDP)
        self.replica_rank = mesh.get_local_rank(AXIS_REPLICA)
        self.tensor_rank = mesh.get_local_rank(AXIS_TENSOR)
        self.expert_rank = mesh.get_local_rank(AXIS_EXPERT)
        self.fsdp_group = mesh.get_group(AXIS_FSDP) if self.fsdp > 1 else None
        self.replica_group = mesh.get_group(AXIS_REPLICA) if self.replica > 1 else None
        from fms_fsdp_tpu_torch.ops.ring_attention import context_ring
        from fms_fsdp_tpu_torch.parallel.tensor import tensor_groups

        self.ring = context_ring(mesh)
        self.context_group = self.ring.group if self.ring is not None else None
        # the Megatron operators' group, and the ranks of this tensor index
        # (every axis but tensor); both None without a tensor axis, where
        # the data group is the world
        self.tp, self.data_group = tensor_groups(mesh)
        self.data_world = self.world // self.tensor
        # on more than one slice: the ranks of this slice and tensor index
        # (None when alone) and the ranks of every slice at this rank's
        # place in its slice; both None on one slice, where no group is made
        self.slice_group, self.dcn_group = slice_data_groups(mesh)
        # with an expert axis: the expert group, and the data groups (in
        # the slice) without expert, where a leaf split over expert is
        # summed; all None without one, where no group is made
        self.expert_group, self.data_group_ne, self.slice_group_ne = expert_groups(mesh)
        # the MoE FFN's exchange (None without an expert axis)
        self.ep = (ExpertParallel(self.expert_group, self.expert, self.expert_rank)
                   if self.expert > 1 else None)
        self.dims = dict(dims)
        self.tdims = dict(tdims or {})
        self.edims = dict(edims or {})
        self.shapes = dict(shapes)
        # the host snapshots' mesh, made here on every rank in one order
        # (its groups' creation is collective), never from a writer thread
        self.host_mesh = self._make_host_mesh() if self.sharded else None

    @classmethod
    def for_params(cls, mesh, params, model_cfg):
        shape = axis_sizes(mesh)
        from fms_fsdp_tpu_torch.ckpt.state import flatten

        flat = flatten("params", params, {})
        specs = param_specs(model_cfg)
        return cls(mesh, shard_dims(params, specs, shape),
                   {k: tuple(v.shape) for k, v in flat.items()},
                   shard_dims(params, specs, shape, AXIS_TENSOR),
                   shard_dims(params, specs, shape, AXIS_EXPERT))

    @property
    def sharded(self) -> bool:
        """Whether a leaf may be split across ranks (over fsdp, tensor or
        expert)."""
        return self.fsdp > 1 or self.tensor > 1 or self.expert > 1

    @property
    def gathers(self) -> bool:
        """Whether the step gathers layers over fsdp."""
        return self.fsdp > 1

    def dim_of(self, key: str) -> Optional[int]:
        return self.dims.get(param_key(key)) if self.fsdp > 1 else None

    def tdim_of(self, key: str) -> Optional[int]:
        return self.tdims.get(param_key(key)) if self.tensor > 1 else None

    def edim_of(self, key: str) -> Optional[int]:
        return self.edims.get(param_key(key)) if self.expert > 1 else None

    def full_shape(self, local: torch.Tensor, dim: Optional[int]):
        """The shape a gather over fsdp makes of ``local``: the tensor
        block, not the whole leaf."""
        shape = list(local.shape)
        if dim is not None:
            shape[dim] *= self.fsdp
        return shape

    # -- placement ------------------------------------------------------------

    def shard(self, flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{key: whole tensor} -> {key: this rank's part} (a contiguous
        copy of each split leaf: its experts, their tensor block, then its
        fsdp part of that; whole leaves as they are)."""
        out = {}
        for key, t in flat.items():
            d, td, ed = self.dim_of(key), self.tdim_of(key), self.edim_of(key)
            if ed is not None:
                t = t.chunk(self.expert, dim=ed)[self.expert_rank]
            if td is not None:
                t = t.chunk(self.tensor, dim=td)[self.tensor_rank]
            if d is not None:
                t = t.chunk(self.fsdp, dim=d)[self.fsdp_rank]
            out[key] = t if d is None and td is None and ed is None else t.clone(
                memory_format=torch.contiguous_format)
        return out

    def unshard(self, flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{key: local part} -> {key: whole tensor} (an all-gather over
        fsdp, one over tensor and one over expert per split leaf; every
        rank gets the whole)."""
        out = {}
        for key, t in flat.items():
            d, td, ed = self.dim_of(key), self.tdim_of(key), self.edim_of(key)
            if d is not None:
                t = self.all_gather([t], [d], None)[0]
            if td is not None:
                t = self.tp.all_gather(t, td)
            if ed is not None:
                t = t.contiguous()
                parts = [torch.empty_like(t) for _ in range(self.expert)]
                dist.all_gather(parts, t, group=self.expert_group)
                t = torch.cat(parts, ed)
            out[key] = t
        return out

    def _make_host_mesh(self):
        """The mesh with ``cpu`` as its device type, for host snapshots of
        card tensors (a ``DTensor``'s local tensor lives on its mesh's
        device type); the mesh itself on the CPU."""
        if self.mesh.device_type == "cpu":
            return self.mesh
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh("cpu", tuple(self.mesh.shape), mesh_dim_names=MESH_AXES,
                                backend_override={a: "gloo" for a in MESH_AXES})

    def dcp_view(self, flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """``flat`` (local parts) with every split leaf wrapped, without a
        copy, as a ``DTensor`` over the mesh, sharded on the fsdp, tensor
        and expert mesh dims that split it and replicated on the others
        (dcn among them): what DCP saves and loads."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        out = {}
        for key, t in flat.items():
            d, td, ed = self.dim_of(key), self.tdim_of(key), self.edim_of(key)
            if d is None and td is None and ed is None:
                out[key] = t
                continue
            mesh = self.mesh if t.device.type == self.mesh.device_type else self.host_mesh
            placements = [Replicate()] * len(MESH_AXES)
            shape = list(t.shape)
            if d is not None:
                placements[MESH_AXES.index(AXIS_FSDP)] = Shard(d)
                shape[d] *= self.fsdp
            if td is not None:
                placements[MESH_AXES.index(AXIS_TENSOR)] = Shard(td)
                shape[td] *= self.tensor
            if ed is not None:
                placements[MESH_AXES.index(AXIS_EXPERT)] = Shard(ed)
                shape[ed] *= self.expert
            shape = torch.Size(shape)
            stride = torch.empty(shape, device="meta").stride()  # contiguous
            out[key] = DTensor.from_local(t, mesh, placements, run_check=False,
                                          shape=shape, stride=stride)
        return out

    # -- collectives ------------------------------------------------------------

    def all_gather(self, local_leaves, dims, kind) -> List[torch.Tensor]:
        """The whole tensors of ``local_leaves`` (one dtype), in one
        all-gather over fsdp; ``kind`` names the :data:`GATHERS` counter."""
        if kind is not None:
            GATHERS[kind] += 1
        with torch.no_grad():
            flat = torch.cat([t.reshape(-1) for t in local_leaves])
            out = torch.empty(self.fsdp * flat.numel(), dtype=flat.dtype,
                              device=flat.device)
            _quiet(dist.all_gather_into_tensor, out, flat, group=self.fsdp_group)
            out = out.view(self.fsdp, -1)
            fulls, off = [], 0
            for t, d in zip(local_leaves, dims):
                n = t.numel()
                fulls.append(torch.cat(
                    [out[r, off:off + n].view(t.shape) for r in range(self.fsdp)], dim=d))
                off += n
        return fulls

    def reduce_scatter(self, grads, dims) -> List[torch.Tensor]:
        """Whole gradients -> this rank's parts, summed over fsdp, in one
        reduce-scatter."""
        with torch.no_grad():
            send = torch.cat([g.chunk(self.fsdp, dim=d)[r].reshape(-1)
                              for r in range(self.fsdp) for g, d in zip(grads, dims)])
            out = torch.empty(send.numel() // self.fsdp, dtype=send.dtype,
                              device=send.device)
            _quiet(dist.reduce_scatter_tensor, out, send, op=dist.ReduceOp.SUM,
                   group=self.fsdp_group)
            parts, off = [], 0
            for g, d in zip(grads, dims):
                shape = list(g.shape)
                shape[d] //= self.fsdp
                n = math.prod(shape)
                parts.append(out[off:off + n].view(shape))
                off += n
        return parts

    def all_reduce(self, tensors: List[torch.Tensor], group) -> None:
        """Sum ``tensors`` in place over ``group``, in flattened buckets."""
        self._bucketed(tensors, lambda flat: dist.all_reduce(flat, group=group))

    def dcn_reduce(self, flat: torch.Tensor, async_op: bool = False):
        """Sum ``flat`` in place over the slices (:attr:`dcn_group`): the
        one cross-slice all-reduce a gradient takes. Returns the work
        handle under ``async_op``, else None."""
        return dist.all_reduce(flat, group=self.dcn_group, async_op=async_op)

    def _bucketed(self, tensors: List[torch.Tensor], reduce) -> None:
        """``reduce`` (in place) over flattened buckets of ``tensors``, one
        dtype a bucket, the results copied back."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for same in by_dtype.values():
                bucket, size = [], 0
                for t in same + [None]:
                    if t is not None and (size + t.numel() <= _BUCKET or not bucket):
                        bucket.append(t)
                        size += t.numel()
                        continue
                    flat = torch.cat([b.reshape(-1) for b in bucket])
                    reduce(flat)
                    off = 0
                    for b in bucket:
                        b.copy_(flat[off:off + b.numel()].view(b.shape))
                        off += b.numel()
                    bucket, size = ([t], t.numel()) if t is not None else ([], 0)

    # -- the step -------------------------------------------------------------

    def gather_tree(self, tree, dims, kind):
        """``tree`` (a dict of local compute-dtype leaves) with its split
        leaves replaced by their whole tensors, gathered in one call."""
        split = [(path, leaf, dims_leaf) for (path, leaf), (_, dims_leaf)
                 in zip(_paths(tree), _paths(dims)) if dims_leaf is not None]
        if not split:
            return tree
        unit = _Unit(self, [leaf for _, leaf, _ in split],
                     [d for _, _, d in split], kind)
        fulls = _Gather.apply(unit, *[leaf for _, leaf, _ in split])
        whole = {path: full for (path, _, _), full in zip(split, fulls)}

        def rebuild(node, prefix=()):
            if isinstance(node, dict):
                return {k: rebuild(v, prefix + (str(k),)) for k, v in node.items()}
            return whole.get(prefix, node)

        return rebuild(tree)

    def release_saved(self):
        """Context for the forward: a gathered weight that autograd saves
        for the backward is kept as a handle and gathered again there."""
        return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)

    def global_count(self, labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
        """The number of labels != ``ignore_index`` over the global batch
        (at least 1), as an fp32 tensor on the labels' device: summed over
        the data group, so tensor peers' shared rows count once."""
        n = (labels != ignore_index).sum().to(torch.float32).reshape(1)
        dist.all_reduce(n, group=self.data_group)
        return n.clamp(min=1)[0]

    def sum_route(self, route: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A MoE forward's routing sums (``models/mixtral.py``) summed over
        the data group: the counts in one all-reduce without gradient, the
        router probabilities' sums through :class:`_SumOverWorld`, whose
        backward hands each rank the gradient of the global sum as its
        own share's (every rank forms the same global loss term, and the
        ranks' gradients are summed)."""
        names = ("counts", "kept", "tokens")
        flat = torch.cat([route[k].detach().reshape(-1).float() for k in names])
        dist.all_reduce(flat, group=self.data_group)
        out, off = {}, 0
        for k in names:
            n = route[k].numel()
            out[k] = flat[off:off + n].view(route[k].shape)
            off += n
        out["probs"] = _SumOverWorld.apply(route["probs"], self.data_group)
        return out

    def sum_over_world(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` summed over the data group (each tensor peer holds the
        same value)."""
        out = value.detach().clone().reshape(1)
        dist.all_reduce(out, group=self.data_group)
        return out[0]

    def slice_whole_group(self, expert_split: bool):
        """Where a gradient not split over fsdp is summed inside its
        slice: the slice's data group, without expert for a leaf split
        over expert (None when this rank is alone in it)."""
        return self.slice_group_ne if expert_split else self.slice_group

    def part_groups(self, expert_split: bool) -> list:
        """The groups an fsdp part of a gradient is summed over after the
        reduce-scatter, in order: replica, context, then expert unless the
        leaf is split over it."""
        groups = [self.replica_group, self.context_group]
        if not expert_split:
            groups.append(self.expert_group)
        return [g for g in groups if g is not None]

    def reduce_grads(self, grads, split, esplit=None) -> None:
        """After the backward: sum what is still per rank (``split[i]``:
        grads[i] was reduce-scattered over fsdp; ``esplit[i]``: it is
        split over expert): a whole leaf over the data group, an fsdp
        part over :meth:`part_groups`, a leaf split over expert over
        neither the expert group nor its axis. On more than one slice,
        inside the slice first (:meth:`reduce_within_slice`), then over
        the slices."""
        esplit = esplit if esplit is not None else [False] * len(grads)
        kinds = self._kinds(grads, split, esplit)
        if self.dcn_group is not None:
            self.reduce_within_slice(*kinds)
            self._bucketed([g for kind in kinds for g in kind], self.dcn_reduce)
            return
        whole, ewhole, parts, eparts = kinds
        if whole and self.data_world > 1:
            self.all_reduce(whole, self.data_group)
        if ewhole and self.data_group_ne is not None:
            self.all_reduce(ewhole, self.data_group_ne)
        for leaves, e in ((parts, False), (eparts, True)):
            for group in self.part_groups(e) if leaves else ():
                self.all_reduce(leaves, group)

    @staticmethod
    def _kinds(grads, split, esplit):
        """(whole, whole split over expert, fsdp parts, fsdp parts split
        over expert) of ``grads``."""
        kinds = {(False, False): [], (False, True): [], (True, False): [], (True, True): []}
        for g, s, e in zip(grads, split, esplit):
            kinds[(bool(s), bool(e))].append(g)
        return (kinds[(False, False)], kinds[(False, True)], kinds[(True, False)],
                kinds[(True, True)])

    def reduce_within_slice(self, whole, ewhole, parts, eparts) -> None:
        """The in-slice half of a multi-slice gradient sum, in place: the
        whole leaves' over the slice's data group (without expert for a
        leaf split over it), the fsdp parts' over :meth:`part_groups`
        (the reduce-scatter over fsdp ran in the backward)."""
        for leaves, e in ((whole, False), (ewhole, True)):
            group = self.slice_whole_group(e)
            if leaves and group is not None:
                self.all_reduce(leaves, group)
        for leaves, e in ((parts, False), (eparts, True)):
            for group in self.part_groups(e) if leaves else ():
                self.all_reduce(leaves, group)

    def grad_norm(self, grads, split, tsplit=None, esplit=None) -> torch.Tensor:
        """The global gradient norm (fp32): each leaf's local squares
        summed over the axes that split it (``split``: fsdp, ``tsplit``:
        tensor, ``esplit``: expert), a whole leaf's counted once. No sum
        runs over dcn: after :meth:`reduce_grads` every slice holds the
        same gradients."""
        tsplit = tsplit if tsplit is not None else [False] * len(grads)
        sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in grads]
        dev = grads[0].device
        if self.expert_group is not None and esplit is not None and any(esplit):
            # an expert leaf's squares over its experts first, in one
            # all-reduce; then it counts as any leaf of its other splits
            idx = [i for i, e in enumerate(esplit) if e]
            summed = torch.stack([sq[i] for i in idx])
            dist.all_reduce(summed, group=self.expert_group)
            for j, i in enumerate(idx):
                sq[i] = summed[j]

        def total(f, t):
            return torch.stack([s for s, a, b in zip(sq, split, tsplit) if (a, b) == (f, t)]
                               or [torch.zeros((), device=dev)]).sum()

        # [fsdp only, fsdp and tensor] over fsdp; [tensor only, both] over tensor
        fsdp = torch.stack([total(True, False), total(True, True)])
        if self.fsdp_group is not None:
            dist.all_reduce(fsdp, group=self.fsdp_group)
        tensor = torch.stack([total(False, True), fsdp[1]])
        if self.tp is not None:
            dist.all_reduce(tensor, group=self.tp.group)
        return torch.sqrt(fsdp[0] + tensor.sum() + total(False, False))


# ---------------------------------------------------------------------------
# the serving layout (ServeConfig.serve_layout)
# ---------------------------------------------------------------------------

# a serving replica's mesh: fsdp (weights split ZeRO-style) and tensor
# (the Megatron layout). The training rulebooks name no other axis on a
# weight, so resolve_spec reads them on this mesh unchanged
SERVE_MESH_AXES = (AXIS_FSDP, AXIS_TENSOR)


def serve_layout_code(layout: str) -> int:
    """The layout as a number for flat str->number stats
    (``serving_stats()["serve_layout"]``): ``100 * tp + fsdp``, 0 for
    the single-card layout."""
    if not layout:
        return 0
    ext = parse_serve_layout(layout)
    return 100 * ext[AXIS_TENSOR] + ext[AXIS_FSDP]


def serve_kv_pool_specs(quant: str = "none") -> Dict[str, P]:
    """The specs of the PagedKVCache pools on a serving mesh: the
    (L, P, page_size, Nkv, H) pools and their (L, P, page_size, Nkv, 1)
    scale pools split the KV-head dim over tensor; :func:`resolve_spec`
    keeps them whole where Nkv does not divide the tensor extent."""
    spec = P(None, None, None, AXIS_TENSOR, None)
    out = {"k": spec, "v": spec}
    if quant != "none":
        out["k_scale"] = spec
        out["v_scale"] = spec
    return out


def serve_param_specs(family: str):
    """Family -> the spec tree a serving replica places its weights by:
    the training rulebooks of Llama and Mixtral; None for a family that
    refuses a layout (Mamba)."""
    if family == "llama":
        return llama_param_specs(scan=True)
    if family == "mixtral":
        return mixtral_param_specs(scan=True)
    return None


class ServeLayers(dict):
    """A serving replica's stacked (L, ...) layer leaves, this rank's
    blocks of them; under fsdp, :meth:`layer` gives layer ``i`` with its
    fsdp-split leaves gathered whole (one all-gather a layer)."""

    def __init__(self, leaves, dims: Dict[str, Optional[int]], mesh):
        super().__init__(leaves)
        self.dims = dims  # leaf -> its dim split over fsdp, or None
        self.mesh = mesh

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        out = {name: w[i] for name, w in self.items()}
        split = [name for name in out if self.dims.get(name) is not None]
        if split:
            GATHERS["layer"] += 1
            # a stacked leaf's dims count L first
            fulls = self.mesh.gather([out[n] for n in split], [self.dims[n] - 1 for n in split])
            out.update(zip(split, fulls))
        return out


class ServeParams(dict):
    """A serving replica's params under fsdp: this rank's blocks, the
    layers a :class:`ServeLayers`. :meth:`gathered` gives the top-level
    leaves whole over fsdp, for one step."""

    def __init__(self, leaves, dims: Dict[str, Optional[int]], mesh):
        super().__init__(leaves)
        self.dims = dims
        self.mesh = mesh

    def gathered(self) -> Dict:
        out = dict(self)
        split = [name for name in out if self.dims.get(name) is not None]
        if split:
            GATHERS["top"] += 1
            out.update(zip(split, self.mesh.gather([out[n] for n in split],
                                                   [self.dims[n] for n in split])))
        return out


def serve_top(params):
    """The params one step reads: under a serving layout's fsdp
    (:class:`ServeParams`) the top-level leaves gathered, else ``params``
    itself."""
    return params.gathered() if isinstance(params, ServeParams) else params


class ServeMesh:
    """A serving replica's ranks as JAX's ``(fsdp, tensor)`` mesh, tensor
    innermost: rank ``f * tensor + t``. :attr:`tp` is the tensor axis's
    :class:`~fms_fsdp_tpu_torch.parallel.tensor.TensorParallel` (None at
    tensor 1); :attr:`fsdp_group` the ranks that share this rank's tensor
    index (None at fsdp 1). Groups are made on every rank, in one order
    (``new_group`` is collective)."""

    def __init__(self, layout: str, fsdp: int, tensor: int):
        from fms_fsdp_tpu_torch.parallel.tensor import TensorParallel

        self.layout = layout
        self.fsdp, self.tensor = int(fsdp), int(tensor)
        self.rank = dist.get_rank()
        self.fsdp_rank, self.tensor_rank = divmod(self.rank, self.tensor)
        grid = [[f * self.tensor + t for t in range(self.tensor)] for f in range(self.fsdp)]
        self.tp = self.fsdp_group = None
        if self.tensor > 1:
            group, _ = dist.new_subgroups_by_enumeration(grid)
            self.tp = TensorParallel(group, self.tensor, self.tensor_rank)
        if self.fsdp > 1:
            self.fsdp_group, _ = dist.new_subgroups_by_enumeration(
                [list(col) for col in zip(*grid)])

    @property
    def sizes(self) -> Dict[str, int]:
        return {AXIS_FSDP: self.fsdp, AXIS_TENSOR: self.tensor}

    def gather(self, leaves: List[torch.Tensor], dims: List[int]) -> List[torch.Tensor]:
        """The fsdp blocks of ``leaves`` (one dtype) joined whole along
        ``dims``, in one all-gather over fsdp."""
        flat = torch.cat([t.reshape(-1) for t in leaves])
        out = torch.empty(self.fsdp * flat.numel(), dtype=flat.dtype, device=flat.device)
        _quiet(dist.all_gather_into_tensor, out, flat, group=self.fsdp_group)
        out = out.view(self.fsdp, -1)
        fulls, off = [], 0
        for t, d in zip(leaves, dims):
            n = t.numel()
            fulls.append(torch.cat([out[r, off:off + n].view(t.shape)
                                    for r in range(self.fsdp)], dim=d))
            off += n
        return fulls

    def place(self, params, specs, device, dtype):
        """This rank's blocks of the whole ``params`` (nested dicts, every
        leaf whole on every rank) by the spec tree ``specs``: a leaf's
        tensor block, then its fsdp block of that, each copied out
        contiguous, cast to ``dtype`` and only then moved to ``device``.
        Under fsdp the result is a :class:`ServeParams`."""
        spec_of = dict(_paths(specs))

        def dims_of(path, shape):
            spec = resolve_spec(spec_of[path], shape, self.sizes)
            found = {AXIS_FSDP: None, AXIS_TENSOR: None}
            for i, entry in enumerate(spec):
                for axis in (entry if isinstance(entry, tuple) else (entry,)):
                    if axis in found and self.sizes[axis] > 1:
                        found[axis] = i
            return found[AXIS_FSDP], found[AXIS_TENSOR]

        def one(path, w):
            fd, td = dims_of(path, tuple(w.shape))
            if td is not None:
                w = w.chunk(self.tensor, dim=td)[self.tensor_rank]
            if fd is not None:
                w = w.chunk(self.fsdp, dim=fd)[self.fsdp_rank]
            w = w.contiguous().to(dtype)
            return w.to(device), fd

        out, top_dims = {}, {}
        for name, node in params.items():
            if isinstance(node, dict):
                leaves, dims = {}, {}
                for key, w in node.items():
                    leaves[key], dims[key] = one((name, key), w)
                out[name] = ServeLayers(leaves, dims, self) if self.fsdp > 1 else leaves
            else:
                out[name], top_dims[name] = one((name,), node)
        return ServeParams(out, top_dims, self) if self.fsdp > 1 else out


def build_serve_mesh(layout: str, device) -> Optional[ServeMesh]:
    """``serve_layout`` -> the replica's :class:`ServeMesh` over the
    process group, one rank a process (None for a layout of one rank:
    ``""``, ``"tp=1"``). Under ``torchrun`` the group is opened here for
    ``device`` when no one has yet (``utils/dist.py::init_distributed``).
    The world must hold exactly tensor x fsdp ranks: a sharded replica
    that silently ran on fewer would misreport its capacity, and a rank
    outside the mesh would have no work."""
    from fms_fsdp_tpu_torch.utils.dist import init_distributed, launched_by_torchrun, world_size

    ext = parse_serve_layout(layout)
    n = ext[AXIS_FSDP] * ext[AXIS_TENSOR]
    if n <= 1:
        return None
    if launched_by_torchrun() and not dist.is_initialized():
        init_distributed(torch.device(device))
    world = world_size()
    if world != n:
        raise ValueError(
            f"serve_layout {layout!r} needs {n} ranks (fsdp={ext[AXIS_FSDP]} x "
            f"tensor={ext[AXIS_TENSOR]}) but the process group holds {world}: start "
            f"one process a rank (torchrun --nproc_per_node {n})"
        )
    return ServeMesh(layout, ext[AXIS_FSDP], ext[AXIS_TENSOR])
