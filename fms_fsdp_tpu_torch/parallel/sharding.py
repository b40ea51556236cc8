"""Where each leaf of the train state lives on the mesh, and the
collectives of the data-parallel step.

Counterpart of ``fms_fsdp_tpu/parallel/sharding.py:35-215``,
``fms_fsdp_tpu/models/mamba.py:610`` and
``fms_fsdp_tpu/models/mixtral.py:103``. JAX declares a ``PartitionSpec`` per
param and lets GSPMD insert the collectives; here the same spec trees
decide each leaf's placement and :class:`DataParallel` runs the
collectives by hand:

- a leaf whose spec names ``fsdp`` on a dim the fsdp extent divides
  (``resolve_spec``'s rule) is split on that dim over the fsdp axis; every
  other leaf is replicated. Llama's stacked L axis is never split, so
  ``wq`` (L, d, nq*hd) splits dim 1 and ``wo`` (L, nq*hd, d) dim 2. Adam's
  moments split as their params (``infer_state_specs``);
- the train state holds each rank's *local* tensors in JAX's layout, so
  AdamW's elementwise update on them is exact per shard. For a checkpoint
  :meth:`DataParallel.dcp_view` wraps them, without a copy, as
  ``DTensor``\\s placed on the mesh, and DCP writes per-rank shards and
  reshards on load;
- the forward gathers one layer at a time over fsdp, in the compute
  dtype, when it reaches the layer (:class:`GatheredLayers`); a gathered
  weight that autograd saves for the backward is kept as a handle and
  gathered again when the backward needs it
  (:meth:`DataParallel.release_saved`), so no layer's full weights live
  from its forward to its backward, as FSDP's FULL_SHARD reshards after
  the forward. :data:`GATHERS` counts the gathers: 2 x L a step under
  fsdp (a layer under activation checkpointing gathers again in its
  recomputed forward instead), none under ddp;
- gradients are reduce-scattered over fsdp (in the gather's backward),
  all-reduced over ``replica`` under hsdp, and a replicated leaf's are
  all-reduced over the world. Every reduce is a SUM: each rank's loss is
  its summed token loss over the GLOBAL count of labels != -100.

The quantized gradient reduce (``:226-307``) and the serving layout
(``:309-405``) are not ported: ``quantized_reduce`` and ``serve_layout``
stay refused where they are read (``parallel/mixed_precision.py``,
``serve/engine.py``), naming ROADMAP.md A.7 and A.10.
"""

import math
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from fms_fsdp_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_REPLICA,
    AXIS_TENSOR,
    DATA_AXES,
    MESH_AXES,
    axis_sizes,
)

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
    FFN, with E over ``expert`` (size 1 here, so E is never split:
    expert parallelism is ROADMAP.md A.4b)."""
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
        if keys and keys[0] == params_subtree and keys[1:] in flat:
            spec = flat[keys[1:]]
        else:
            for i in range(len(keys)):
                if keys[i:] in flat:
                    spec = flat[keys[i:]]
                    break
        out[key] = spec if spec is not None else P()
    return out


def shard_dims(params, specs, mesh_shape: Dict[str, int]) -> Dict[str, Optional[int]]:
    """{"params.<path>": the dim split over fsdp, or None (replicated)}
    for every param leaf."""
    spec_of = {path: spec for path, spec in _paths(specs)}
    out = {}
    for path, leaf in _paths(params):
        spec = resolve_spec(spec_of[path], tuple(leaf.shape), mesh_shape)
        dim = None
        if mesh_shape.get(AXIS_FSDP, 1) > 1:
            for i, entry in enumerate(spec):
                axes = entry if isinstance(entry, tuple) else (entry,)
                if AXIS_FSDP in axes:
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
    """All-reduce (sum) whose backward is the identity on each rank."""

    @staticmethod
    def forward(ctx, t):
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


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
    """The data-parallel layout of one run: the mesh, the fsdp/replica
    process groups, and the split dim of every param leaf."""

    def __init__(self, mesh, dims: Dict[str, Optional[int]], shapes: Dict[str, Tuple]):
        self.mesh = mesh
        sizes = axis_sizes(mesh)
        self.fsdp = sizes[AXIS_FSDP]
        self.replica = sizes[AXIS_REPLICA]
        self.world = dist.get_world_size()
        self.fsdp_rank = mesh.get_local_rank(AXIS_FSDP)
        self.replica_rank = mesh.get_local_rank(AXIS_REPLICA)
        self.fsdp_group = mesh.get_group(AXIS_FSDP) if self.fsdp > 1 else None
        self.replica_group = mesh.get_group(AXIS_REPLICA) if self.replica > 1 else None
        self.dims = dict(dims)
        self.shapes = dict(shapes)
        # the host snapshots' mesh, made here on every rank in one order
        # (its groups' creation is collective), never from a writer thread
        self.host_mesh = self._make_host_mesh() if self.fsdp > 1 else None

    @classmethod
    def for_params(cls, mesh, params, model_cfg):
        shape = axis_sizes(mesh)
        from fms_fsdp_tpu_torch.ckpt.state import flatten

        flat = flatten("params", params, {})
        return cls(mesh, shard_dims(params, param_specs(model_cfg), shape),
                   {k: tuple(v.shape) for k, v in flat.items()})

    @property
    def sharded(self) -> bool:
        return self.fsdp > 1

    def dim_of(self, key: str) -> Optional[int]:
        return self.dims.get(param_key(key)) if self.fsdp > 1 else None

    def full_shape(self, local: torch.Tensor, dim: Optional[int]):
        shape = list(local.shape)
        if dim is not None:
            shape[dim] *= self.fsdp
        return shape

    # -- placement ------------------------------------------------------------

    def shard(self, flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{key: whole tensor} -> {key: this rank's part} (a contiguous
        copy of each split leaf; replicated leaves as they are)."""
        out = {}
        for key, t in flat.items():
            d = self.dim_of(key)
            out[key] = t if d is None else (
                t.chunk(self.fsdp, dim=d)[self.fsdp_rank].clone(
                    memory_format=torch.contiguous_format))
        return out

    def unshard(self, flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{key: local part} -> {key: whole tensor} (an all-gather per
        split leaf; every rank gets the whole)."""
        out = {}
        for key, t in flat.items():
            d = self.dim_of(key)
            out[key] = t if d is None else self.all_gather([t], [d], None)[0]
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
        copy, as a ``DTensor`` over the mesh: what DCP saves and loads."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        out = {}
        for key, t in flat.items():
            d = self.dim_of(key)
            if d is None:
                out[key] = t
                continue
            mesh = self.mesh if t.device.type == self.mesh.device_type else self.host_mesh
            placements = [Replicate()] * len(MESH_AXES)
            placements[MESH_AXES.index(AXIS_FSDP)] = Shard(d)
            shape = torch.Size(self.full_shape(t, d))
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
                    dist.all_reduce(flat, group=group)
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
        (at least 1), as an fp32 tensor on the labels' device."""
        n = (labels != ignore_index).sum().to(torch.float32).reshape(1)
        dist.all_reduce(n)
        return n.clamp(min=1)[0]

    def sum_route(self, route: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A MoE forward's routing sums (``models/mixtral.py``) summed over
        the world: the counts in one all-reduce without gradient, the
        router probabilities' sums through :class:`_SumOverWorld`, whose
        backward hands each rank the gradient of the global sum as its
        own share's (every rank forms the same global loss term, and the
        ranks' gradients are summed)."""
        names = ("counts", "kept", "tokens")
        flat = torch.cat([route[k].detach().reshape(-1).float() for k in names])
        dist.all_reduce(flat)
        out, off = {}, 0
        for k in names:
            n = route[k].numel()
            out[k] = flat[off:off + n].view(route[k].shape)
            off += n
        out["probs"] = _SumOverWorld.apply(route["probs"])
        return out

    def sum_over_world(self, value: torch.Tensor) -> torch.Tensor:
        out = value.detach().clone().reshape(1)
        dist.all_reduce(out)
        return out[0]

    def reduce_grads(self, grads, split) -> None:
        """After the backward: sum over the world what is still per rank
        (``split[i]``: grads[i] was reduce-scattered over fsdp)."""
        whole = [g for g, s in zip(grads, split) if not s]
        parts = [g for g, s in zip(grads, split) if s]
        if whole and self.world > 1:
            self.all_reduce(whole, None)
        if parts and self.replica_group is not None:
            self.all_reduce(parts, self.replica_group)

    def grad_norm(self, grads, split) -> torch.Tensor:
        """The global gradient norm (fp32): each split leaf's local squares
        summed over fsdp, each replicated leaf's counted once."""
        sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in grads]
        dev = grads[0].device
        parts = torch.stack([s for s, f in zip(sq, split) if f] or
                            [torch.zeros((), device=dev)]).sum().reshape(1)
        whole = torch.stack([s for s, f in zip(sq, split) if not f] or
                            [torch.zeros((), device=dev)]).sum()
        if self.fsdp_group is not None:
            dist.all_reduce(parts, group=self.fsdp_group)
        return torch.sqrt(parts[0] + whole)
