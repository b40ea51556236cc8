"""The process group of a training run.

Counterpart of the ``jax.distributed`` set-up in
``fms_fsdp_tpu/utils/train_utils.py::setup``. One process drives one
device:

- under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT`` in the environment) the default group
  is initialised from that environment, NCCL for ``cuda`` and gloo for
  ``cpu``, after ``torch.cuda.set_device`` of the rank's card;
- ranks that share one card (more processes on a host than cards, as two
  tensor ranks on the one H100 of a test machine) form a gloo world with
  CUDA tensors: NCCL refuses two ranks on one device, and gloo stages a
  card tensor's collective through the host. The rule is decided before
  the group exists (:func:`shares_devices`, :func:`backend_for`), from
  the environment and the card count alone; nothing tries NCCL and
  falls back. The card of local rank r is ``r * cards //
  LOCAL_WORLD_SIZE`` (:func:`local_device_index`): contiguous ranks on
  one card, one rank a card when there are as many cards as ranks;
- without that environment it is a world of one over a ``HashStore``:
  no TCP port, so many runs in one process (the tests, ``chip_smoke.py``)
  reuse it.

Work beside the step runs on gloo groups of its own (:func:`aux_group`),
so it never runs collectives on the group the step's stream uses (nor,
on a gloo world, interleaves with the step's own collectives): the
checkpoint writer's DCP collectives on ``aux_group("writer")``, which the
async manager's writer thread uses while the step runs; the host-side
agreements of the main thread (the checkpoint scan and verdicts, a DCP
load, the preemption flag, the divergence compare) on ``aux_group()``.
Two threads never share a group: a group's collectives are matched in
the order each process calls them.

Every helper is the identity on a world of one: no collective runs.
"""

import atexit
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# the gloo groups beside the default one, by use, made once per default
# group
_AUX = {"groups": {}, "owner": None}


@dataclass(frozen=True)
class World:
    rank: int
    size: int
    local_size: int  # processes on this host


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN_ENV)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0)) if launched_by_torchrun() else 0


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1)) if launched_by_torchrun() else 1


def shares_devices() -> bool:
    """Whether this host runs more ranks than it has cards, so that ranks
    share a card."""
    return launched_by_torchrun() and local_world_size() > torch.cuda.device_count()


def local_device_index() -> int:
    """The card of this local rank: ``LOCAL_RANK * cards //
    LOCAL_WORLD_SIZE`` when ranks share cards, else ``LOCAL_RANK``."""
    if not shares_devices():
        return local_rank()
    return local_rank() * torch.cuda.device_count() // local_world_size()


def backend_for(device: torch.device) -> str:
    """The default group's backend: NCCL for one rank a card, gloo for
    the CPU and for ranks that share a card (module docstring)."""
    if device.type == "cuda" and not shares_devices():
        return "nccl"
    return "gloo"


def init_distributed(device: torch.device) -> World:
    """Initialise the default group for ``device`` (once per process) and
    return this process's place in the world. An existing default group
    is reused: its backend must suit ``device``."""
    backend = backend_for(device)
    if not dist.is_initialized():
        if launched_by_torchrun():
            kwargs = {}
            if device.type == "cuda":
                torch.cuda.set_device(device)
            if backend == "nccl":
                kwargs["device_id"] = device
            dist.init_process_group(backend=backend, init_method="env://", **kwargs)
        else:
            dist.init_process_group(backend=backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        # torn down before the interpreter's own teardown: a process group
        # left to the exit path can abort the process ("terminate called
        # without an active exception" from its threads)
        atexit.register(_destroy)
    elif dist.get_backend() != backend and dist.get_world_size() > 1:
        raise RuntimeError(
            f"the process group is {dist.get_backend()}, but {device} needs {backend}"
        )
    # the side groups, in one order on every process (new_group is collective)
    aux_group("host")
    aux_group("writer")
    size = dist.get_world_size()
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size)) if launched_by_torchrun() else size
    return World(rank=dist.get_rank(), size=size, local_size=local_size)


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _AUX["groups"], _AUX["owner"] = {}, None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def aux_group(use: str = "host"):
    """The gloo group over the whole world for ``use`` ("host": the main
    thread's agreements; "writer": the checkpoint writer); None without a
    default group. Every process must create them in the same order: the
    entry point makes both before it trains."""
    if not dist.is_initialized():
        return None
    default = dist.group.WORLD
    if _AUX["owner"] is not default:
        _AUX["groups"] = {}
        _AUX["owner"] = default
    if use not in _AUX["groups"]:
        _AUX["groups"][use] = dist.new_group(backend="gloo")
    return _AUX["groups"][use]


def barrier(use: str = "host") -> None:
    """Every process reaches this point (on ``aux_group(use)``)."""
    if world_size() > 1:
        dist.barrier(group=aux_group(use))


def all_agree(ok: bool) -> bool:
    """Collective AND of a per-process verdict."""
    if world_size() == 1:
        return bool(ok)
    t = torch.tensor([1 if ok else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=aux_group())
    return bool(t.item() == 1)


def any_flag(flag: bool) -> bool:
    """Collective OR of a per-process flag."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=aux_group())
    return bool(t.item() == 1)


def broadcast_obj(obj: Any) -> Any:
    """Process 0's ``obj`` on every process (a small picklable object)."""
    if world_size() == 1:
        return obj
    box = [obj if rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=aux_group())
    return box[0]


def all_gather_rows(row: np.ndarray) -> np.ndarray:
    """Every process's fixed-shape int64 ``row``, stacked in rank order."""
    row = np.asarray(row, np.int64).reshape(-1)
    if world_size() == 1:
        return row[None, :]
    local = torch.from_numpy(row.copy())
    out = [torch.empty_like(local) for _ in range(world_size())]
    dist.all_gather(out, local, group=aux_group())
    return torch.stack(out).numpy()
