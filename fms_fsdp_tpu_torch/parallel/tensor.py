"""Tensor parallelism: the Megatron operators over the tensor group.

JAX has no counterpart file: its params carry ``tensor`` in their
``PartitionSpec``s (``fms_fsdp_tpu/parallel/sharding.py:88-112``) and
GSPMD inserts the collectives. Here they are written by hand, as
``torch.autograd.Function``\\s over the ``tensor`` subgroup of the mesh.

The layout is JAX's (Megatron's): wq, wk, wv, w1 and w3 (and Mamba's
``in_proj``) are split by columns, wo, w2 (and ``out_proj``) by rows,
the embedding and the lm_head by vocabulary, the norms and the router
replicated. Activations between the parallel regions are whole on every
tensor rank and every rank computes them alike; so does the gradient of
a whole activation. The operators keep that contract:

- :meth:`TensorParallel.enter` (copy into a region): the identity
  forward; the backward all-reduces the partial gradients that the
  rank's column block sends back to its whole input;
- :meth:`TensorParallel.reduce` (out of a region): all-reduces the
  partial sums of a row-split product; the identity backward;
- :meth:`TensorParallel.gather`: a column split made whole (all-gather);
  the backward keeps this rank's block of the whole gradient;
- :meth:`TensorParallel.split`: a whole tensor cut to this rank's block;
  the backward all-gathers the blocks' gradients;
- :meth:`TensorParallel.embed`: JAX's vocabulary-split lookup
  (``fms_fsdp_tpu/parallel/sharding.py:65-85``): the token ids clamped
  into this rank's rows, the rows of other ranks' tokens selected to
  zero, summed over tensor.

A leaf whose dim the tensor extent does not divide stays whole
(``resolve_spec``'s rule), and a product over a whole weight is whole
compute on every rank: :func:`column_linears` and :func:`row_linear`
read which case holds from the local weight's shape. Their products run
through ``ops/quant.py`` (``quant``), which takes the tensor split: a
quantized product's scales over a split dim are the whole row's.

Collectives run on the tensor group as given: gloo on the CPU and for
ranks that share one card (``utils/dist.py``), NCCL across cards.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fms_fsdp_tpu_torch.ops.quant import expert_matmul, matmul
from fms_fsdp_tpu_torch.parallel.mesh import AXIS_TENSOR, MESH_AXES
from fms_fsdp_tpu_torch.parallel.sharding import _all_max

# collectives issued by the operators since the last reset, by kind
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}


def reset_collectives() -> None:
    for key in COLLECTIVES:
        COLLECTIVES[key] = 0


class TensorParallel:
    """This rank's place on the tensor axis: its group, the axis size and
    its index on it."""

    def __init__(self, group, size: int, rank: int):
        if size < 2:
            raise ValueError(f"a tensor group of {size} ranks")
        self.group = group
        self.size = int(size)
        self.rank = int(rank)

    # -- the collectives ----------------------------------------------------

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the group, in place."""
        COLLECTIVES["all_reduce"] += 1
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_max(self, values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor's elementwise max over the group, in one all-reduce."""
        COLLECTIVES["all_reduce"] += 1
        return _all_max(values, self.group)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks of ``t`` joined along ``dim``, in rank order."""
        COLLECTIVES["all_gather"] += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim)

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (no communication)."""
        return t.chunk(self.size, dim)[self.rank]

    # -- the operators --------------------------------------------------------

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _GatherBlocks.apply(x, self, dim)

    def split(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _SplitBlocks.apply(x, self, dim)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """``table`` (V / tp, d), this rank's rows of the vocabulary:
        clamp, select, sum."""
        rows = table.shape[0]
        local = tokens - self.rank * rows
        inside = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), table)
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        return self.reduce(x)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.block(g, ctx.dim).contiguous(), None, None


class _SplitBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.block(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g, ctx.dim), None, None


def tensor_groups(mesh):
    """(the :class:`TensorParallel` of this rank, the data group: the
    ranks that share its tensor index, every axis but tensor) on
    ``mesh``; (None, None) without a tensor axis. The data groups are made
    on every rank for every tensor index (``new_group`` is collective)."""
    size = int(mesh.size(MESH_AXES.index(AXIS_TENSOR)))
    if size == 1:
        return None, None
    ranks = mesh.mesh.movedim(MESH_AXES.index(AXIS_TENSOR), 0)
    data_group, _ = dist.new_subgroups_by_enumeration(ranks.reshape(size, -1).tolist())
    tp = TensorParallel(mesh.get_group(AXIS_TENSOR), size,
                        mesh.get_local_rank(AXIS_TENSOR))
    return tp, data_group


# ---------------------------------------------------------------------------
# the layers' products
# ---------------------------------------------------------------------------


def is_split(tp: Optional[TensorParallel], local: int, whole: int) -> bool:
    """Whether a dim of ``whole`` entries is held here as its tensor
    block (``local`` = whole / tp), rather than whole."""
    if tp is None or local == whole:
        return False
    if local * tp.size != whole:
        raise ValueError(f"a dim of {local} is neither {whole} nor its 1/{tp.size} block")
    return True


def _product(x, w, quant, expert, tp=None, split=None):
    fn = expert_matmul if expert else matmul
    return fn(x, w, quant=quant, tp=tp, split=split)


def column_linears(h: torch.Tensor, weights: Sequence[torch.Tensor],
                   wholes: Sequence[int], tp: Optional[TensorParallel],
                   quant: str = "none",
                   expert: bool = False) -> Tuple[List[torch.Tensor], List[bool]]:
    """``h @ w`` for each weight (``ops/quant.py::matmul`` in ``quant``;
    the per-expert batched form with ``expert``), whose columns
    (``wholes`` of them) are whole or this rank's block. The split
    products take ``h`` through one :meth:`~TensorParallel.enter`; the
    whole ones read ``h`` itself, so their gradients are not summed over
    tensor. Returns the products and which are split."""
    split = [is_split(tp, w.shape[-1], n) for w, n in zip(weights, wholes)]
    hs = tp.enter(h) if any(split) else h
    return [_product(hs, w, quant, expert, tp, "cols") if s else
            _product(h, w, quant, expert) for w, s in zip(weights, split)], split


def row_linear(x: torch.Tensor, w: torch.Tensor, whole: int,
               tp: Optional[TensorParallel], x_split: bool, quant: str = "none",
               expert: bool = False) -> torch.Tensor:
    """``x @ w`` with ``w``'s rows (the contraction, ``whole`` of them)
    whole or this rank's block; ``x_split`` says ``x``'s last dim is this
    rank's block already. A split contraction's partial sums are reduced
    over tensor; a whole one takes ``x`` whole."""
    if not is_split(tp, w.shape[-2], whole):
        return _product(tp.gather(x, -1) if x_split else x, w, quant, expert)
    x = x if x_split else tp.split(x, -1)
    return tp.reduce(_product(x, w, quant, expert, tp, "rows"))
