"""Expert parallelism: the all-to-all that moves routed tokens to their
experts' ranks and back.

JAX has no counterpart file: its ``_moe_ffn_dispatch_a2a``
(``fms_fsdp_tpu/models/mixtral.py:378``) writes the exchange as two
``lax.all_to_all`` inside a ``shard_map`` manual over the ``expert``
axis alone. Here the pair is a ``torch.autograd.Function`` over the
expert subgroup of the mesh (:class:`ExpertParallel`):

- :meth:`ExpertParallel.dispatch`: each rank's full (E, B, C, D) expert
  buffer, its own rows scattered E-major, is cut along E into ``ep``
  chunks; chunk j goes to expert rank j, which joins the chunks it
  receives along the rows in sender order: (E / ep, B * ep, C, D), the
  buffers of its own experts over every expert peer's rows
  (``lax.all_to_all(split_axis=0, concat_axis=1, tiled=True)``). The
  backward is the inverse exchange;
- :meth:`ExpertParallel.combine`: the inverse, (E / ep, B * ep, C, D) ->
  (E, B, C, D), each row's expert outputs brought home; its backward is
  the forward exchange.

An all-to-all is a permutation of the ranks' blocks, so each one's
adjoint is the other: the expert weights' gradients come out summed
over every expert peer's rows, the rows' over their own experts'
outputs. :data:`EXPERT_A2A` counts the exchanges (forward and backward,
one a call), as ``parallel/tensor.py::COLLECTIVES`` counts the tensor
group's.

The exchange runs on the expert group as given: gloo on the CPU and for
ranks that share one card (``utils/dist.py``; gloo's all-to-all takes
card tensors and stages them through the host itself), NCCL across cards.
"""

import torch
import torch.distributed as dist

# all-to-all exchanges since the last reset
EXPERT_A2A = {"all_to_all": 0}


def reset_exchanges() -> None:
    EXPERT_A2A["all_to_all"] = 0


class ExpertParallel:
    """This rank's place on the expert axis: its group, the axis size and
    its index on it (the experts it holds: E / size of them from
    ``rank * E / size``)."""

    def __init__(self, group, size: int, rank: int):
        if size < 2:
            raise ValueError(f"an expert group of {size} ranks")
        self.group = group
        self.size = int(size)
        self.rank = int(rank)

    def exchange(self, t: torch.Tensor) -> torch.Tensor:
        """One all-to-all: ``t``'s dim 0 cut into ``size`` equal chunks,
        chunk j to rank j; the result holds the chunk rank j sent here at
        position j of dim 0."""
        EXPERT_A2A["all_to_all"] += 1
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def dispatch(self, buf: torch.Tensor) -> torch.Tensor:
        """(E, B, C, D) -> (E / ep, B * ep, C, D) (module docstring)."""
        return _Dispatch.apply(buf, self)

    def combine(self, out: torch.Tensor) -> torch.Tensor:
        """(E / ep, B * ep, C, D) -> (E, B, C, D) (module docstring)."""
        return _Combine.apply(out, self)


def _to_experts(ep: ExpertParallel, buf: torch.Tensor) -> torch.Tensor:
    E, B, C, D = buf.shape
    got = ep.exchange(buf)  # (ep * E/ep, B, C, D): sender j's chunk at j
    got = got.view(ep.size, E // ep.size, B, C, D).transpose(0, 1)
    return got.reshape(E // ep.size, ep.size * B, C, D)


def _to_rows(ep: ExpertParallel, out: torch.Tensor) -> torch.Tensor:
    E_loc, BN, C, D = out.shape
    B = BN // ep.size
    send = out.view(E_loc, ep.size, B, C, D).transpose(0, 1)  # row block j to rank j
    got = ep.exchange(send)  # expert rank j's outputs of these rows at j
    return got.view(ep.size * E_loc, B, C, D)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, ep):
        ctx.ep = ep
        return _to_experts(ep, buf)

    @staticmethod
    def backward(ctx, g):
        return _to_rows(ctx.ep, g), None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, ep):
        ctx.ep = ep
        return _to_rows(ep, out)

    @staticmethod
    def backward(ctx, g):
        return _to_experts(ctx.ep, g), None
