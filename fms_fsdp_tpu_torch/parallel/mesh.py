"""The device mesh.

Counterpart of ``fms_fsdp_tpu/parallel/mesh.py:88-375``. The reference's
sharding strategies (ddp / fsdp / hsdp as NO_SHARD / FULL_SHARD /
HYBRID_SHARD, ref:fms_fsdp/utils/train_utils.py:227-234) are the shape of
one 6-axis ``DeviceMesh`` with JAX's axis names:

    ("dcn", "replica", "fsdp", "expert", "context", "tensor")

- ddp:  replica = the world, fsdp = 1 (params replicated, gradients
        all-reduced);
- fsdp: replica = 1, fsdp = the world (params and Adam's moments sharded,
        each layer gathered for its forward and again for its backward,
        gradients reduce-scattered);
- hsdp: fsdp = ``sharding_group_size`` (default: the processes of a host
        when the world spans hosts, else the world), replica = world /
        group (sharded inside a group, replicated across groups).

- tp:   as fsdp, plus the tensor axis (JAX's ``mesh.py:304-309``: the
        speculator's strategy, the base sharded over the tensor axis and
        FSDP-style over the rest);
- context: ``context_parallel_size`` ranks share one data index and each
  holds S / cp of its rows' sequence (ring attention and the
  context-parallel SSD scan exchange across them). With ``tensor`` = 1 it
  is the innermost axis, as in JAX (``mesh.py:274``), so adjacent ranks
  are context peers;
- tensor: ``tensor_parallel_size`` ranks share one data index and one
  context chunk, each holding its block of JAX's Megatron layout
  (``parallel/tensor.py``); the innermost axis, so adjacent ranks are
  tensor peers. The loader's rank and world stay :func:`data_index` and
  :func:`data_parallel_extent`: tensor peers read the same rows.

One process drives one device, so a process's slot on the mesh is its
rank, in row-major order over ``MESH_AXES``. ``dcn`` and ``expert`` are
built at size 1: :func:`mesh_shape` computes every axis as JAX does (the
tests hold it to JAX's ``build_mesh``), and :func:`build_mesh` refuses
one of them above 1 naming the ROADMAP.md item that brings it. JAX's HLO
collective attribution (``:377-497``) reads XLA programs and has no
counterpart here.
"""

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

AXIS_DCN = "dcn"
AXIS_REPLICA = "replica"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_CONTEXT = "context"
AXIS_TENSOR = "tensor"
MESH_AXES = (AXIS_DCN, AXIS_REPLICA, AXIS_FSDP, AXIS_EXPERT, AXIS_CONTEXT,
             AXIS_TENSOR)
# the axes a batch is split over (all data-parallel dimensions)
DATA_AXES = (AXIS_DCN, AXIS_REPLICA, AXIS_FSDP, AXIS_EXPERT)

# the gloo simulation knob: the process world split into this many
# contiguous equal slices
SIM_SLICES_ENV = "FMS_SIM_SLICES"

# axis -> the ROADMAP.md item that brings it above size 1
_UNPORTED_AXES = {
    AXIS_DCN: "A.6b (multi-slice)",
    AXIS_EXPERT: "A.4b (MoE expert parallelism)",
}


@dataclass(frozen=True)
class MeshConfig:
    sharding_strategy: str = "hsdp"  # ddp | fsdp | hsdp | tp
    sharding_group_size: Optional[int] = None  # fsdp-axis size under hsdp
    tensor_parallel_size: int = 1
    context_parallel_size: int = 1
    expert_parallel_size: int = 1
    num_slices: int = 0  # 0 = from FMS_SIM_SLICES, else one slice

    @classmethod
    def from_train_config(cls, cfg):
        return cls(
            sharding_strategy=cfg.sharding_strategy,
            sharding_group_size=getattr(cfg, "sharding_group_size", None),
            tensor_parallel_size=getattr(cfg, "tensor_parallel_size", 1),
            context_parallel_size=getattr(cfg, "context_parallel_size", 1),
            expert_parallel_size=getattr(cfg, "expert_parallel_size", 1),
            num_slices=int(getattr(cfg, "num_slices", 0) or 0),
        )


# ---------------------------------------------------------------------------
# slices
# ---------------------------------------------------------------------------


def _env_num_slices() -> int:
    raw = os.environ.get(SIM_SLICES_ENV, "")
    try:
        n = int(raw) if raw else 0
    except ValueError:
        return 0
    return max(0, n)


def _process_to_slice(process_index: int, process_count: int, n_slices: int) -> int:
    """Contiguous blocks: processes [k*P/S, (k+1)*P/S) form slice k."""
    return process_index * n_slices // max(1, process_count)


def slice_assignments(process_count: int, num_slices: int = 0) -> Tuple[List[int], int]:
    """Per-process slice ids and the slice count: an explicit count, else
    ``FMS_SIM_SLICES``, else one slice."""
    n_slices = int(num_slices or 0) or _env_num_slices()
    if n_slices <= 1:
        return [0] * process_count, 1
    if process_count % n_slices != 0:
        # one device per process: JAX's words
        raise ValueError(
            f"{process_count} devices cannot split into {n_slices} equal slices"
        )
    return [_process_to_slice(p, process_count, n_slices)
            for p in range(process_count)], n_slices


def process_slice_context(cfg=None) -> Tuple[int, int]:
    """(num_slices, this process's slice index) for the live world."""
    from fms_fsdp_tpu_torch.utils.dist import rank, world_size

    explicit = int(getattr(cfg, "num_slices", 0) or 0) if cfg is not None else 0
    n_slices = explicit or _env_num_slices()
    if n_slices <= 1:
        return 1, 0
    return n_slices, _process_to_slice(rank(), world_size(), n_slices)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def _default_group_size(n_dp: int, local: int) -> int:
    """hsdp's group when unspecified: the processes of one host if the
    data-parallel extent spans hosts (the reference shards within the
    8-GPU node), else the whole extent."""
    if n_dp % local == 0 and n_dp > local:
        return local
    return n_dp


def mesh_shape(mesh_config: MeshConfig, world: int,
               local_world: Optional[int] = None) -> Dict[str, int]:
    """Axis sizes of the mesh over ``world`` processes, one device each,
    ``local_world`` of them on a host (default: all), as JAX's
    ``build_mesh`` lays out ``world`` devices."""
    local = int(local_world or world)
    tp = mesh_config.tensor_parallel_size or 1
    cp = mesh_config.context_parallel_size or 1
    ep = mesh_config.expert_parallel_size or 1
    if world % (tp * cp * ep) != 0:
        raise ValueError(
            f"world size {world} not divisible by "
            f"tensor*context*expert = {tp * cp * ep}"
        )
    n_dp = world // (tp * cp * ep)
    _, n_slices = slice_assignments(world, int(mesh_config.num_slices or 0))
    if n_dp % n_slices != 0:
        raise ValueError(
            f"data-parallel extent {n_dp} not divisible by the slice "
            f"count {n_slices}; tensor/context/expert axes may not span "
            f"slices"
        )
    slice_dp = n_dp // n_slices
    strategy = mesh_config.sharding_strategy
    if strategy == "ddp":
        replica, fsdp = slice_dp, 1
    elif strategy in ("fsdp", "tp"):
        replica, fsdp = 1, slice_dp
    elif strategy == "hsdp":
        group = mesh_config.sharding_group_size or _default_group_size(
            slice_dp, min(local, world // n_slices))
        if slice_dp % group != 0:
            raise ValueError(
                f"per-slice data-parallel extent {slice_dp} not divisible "
                f"by sharding group {group}"
            )
        replica, fsdp = slice_dp // group, group
    else:
        raise ValueError(f"unknown sharding strategy: {strategy}")
    return dict(zip(MESH_AXES, (n_slices, replica, fsdp, ep, cp, tp)))


def build_mesh(mesh_config: Optional[MeshConfig] = None, *, device_type: str = "cuda",
               world: Optional[int] = None, local_world: Optional[int] = None,
               **overrides):
    """The 6-axis ``DeviceMesh`` of the live process group (initialise it
    first: ``utils/dist.py::init_distributed``). Raises
    ``NotImplementedError`` for an axis this port does not run yet."""
    from torch.distributed.device_mesh import init_device_mesh

    from fms_fsdp_tpu_torch.utils.dist import world_size

    if mesh_config is None:
        mesh_config = MeshConfig(**overrides)
    world = world_size() if world is None else int(world)
    shape = mesh_shape(mesh_config, world, local_world)
    for axis, item in _UNPORTED_AXES.items():
        if shape[axis] > 1:
            raise NotImplementedError(
                f"a {axis} axis of {shape[axis]} is not ported yet: ROADMAP.md {item}"
            )
    return init_device_mesh(device_type, tuple(shape[a] for a in MESH_AXES),
                            mesh_dim_names=MESH_AXES)


def axis_sizes(mesh) -> Dict[str, int]:
    return {a: int(mesh.size(mesh.mesh_dim_names.index(a))) for a in MESH_AXES}


def data_parallel_extent(mesh) -> int:
    """Number of ways the global batch is split (product of DATA_AXES;
    the context axis splits sequences, not rows)."""
    sizes = axis_sizes(mesh)
    out = 1
    for a in DATA_AXES:
        out *= sizes[a]
    return out


def data_index(mesh) -> int:
    """This process's index on the data axes (row-major over DATA_AXES):
    which rows of the global batch it trains. Context peers share it."""
    sizes = axis_sizes(mesh)
    out = 0
    for a in DATA_AXES:
        out = out * sizes[a] + mesh.get_local_rank(a)
    return out


def context_index(mesh) -> int:
    """This process's index on the context axis: which S / cp chunk of
    its rows' sequence it holds."""
    return mesh.get_local_rank(AXIS_CONTEXT)


def tensor_index(mesh) -> int:
    """This process's index on the tensor axis: which block of each
    tensor-split leaf it holds."""
    return mesh.get_local_rank(AXIS_TENSOR)
