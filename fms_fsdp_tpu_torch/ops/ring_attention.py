"""Ring attention: attention with the sequence split over the context axis.

Counterpart of ``fms_fsdp_tpu/ops/ring_attention.py``. Each context rank
holds S / cp of the queries and of the keys and values; the K/V chunks
travel around the ring while every rank merges its queries' attention
over each chunk that visits. A visiting chunk is, by chunk index, the
diagonal (the causal flash kernels), fully visible (the non-causal flash
kernels) or, under a causal mask, in the future (skipped: no launch).
The partials merge exactly through their logsumexp, in the flash
kernels' lse layout (B, Nq, S):

    lse' = logaddexp(lse_a, lse_b)
    o'   = o_a * exp(lse_a - lse') + o_b * exp(lse_b - lse')

with JAX's clamp for rows masked so far (the running lse starts at
``NEG_INF``). The backward is a ring of its own (:class:`_Ring`): delta
is taken once from the merged output, the K/V chunks travel again with
their fp32 dk/dv accumulators beside them, so after cp steps every chunk
is home with its whole gradient, and the dq partials come out of the dq
kernel in fp32 (``flash_dq(out_dtype=torch.float32)``) and are summed in
fp32. The forward and the backward pin one key tile and skip the tuning
table (the local shapes would nearest-match full-sequence entries).

Where the kernels do not take the local shape (``flash_attention.supports``)
the partials come from a materialised-score einsum, as JAX's fallback
does; for CPU tensors only: on the card such a shape raises. ``impl="xla"``
asks for the einsum partials on any device.

The exchange is one interface with two implementations, chosen by the
caller; neither stands in for the other:

- :class:`GroupRing`: one chunk a process, over the context subgroup of
  the process group, each rotation one ``batch_isend_irecv`` with the
  send and the receive posted together (NCCL on cards, gloo on the CPU);
- :class:`LocalRing`: all cp chunks in one process (the counterpart of
  JAX's one-host virtual mesh); a rotation is a list rotation. The CPU op
  tests and the one-card ``chip_smoke.py`` use it.

With a tensor axis beside the context axis the ring runs on each
rank's heads, as JAX's splits them over ``tensor``
(``ops/ring_attention.py:141-150``): the caller projects this rank's
heads (``ops/attention.py::project_qkv``) under the same GQA guard, so
where the query and KV head counts do not both divide the tensor extent
every rank runs the ring over all heads.
"""

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

from fms_fsdp_tpu_torch.ops import flash_attention as _fa

NEG_INF = -1e30  # JAX's flash NEG_INF: the running lse before any chunk


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------


class LocalRing:
    """All ``cp`` chunks in this process: a tensor's sequence dim is cut
    into cp contiguous chunks (chunk r is context rank r's), and a
    rotation hands slot r the value of slot r - 1 (slot 0 that of slot
    cp - 1)."""

    def __init__(self, cp: int):
        if cp < 1:
            raise ValueError(f"a ring of {cp} chunks")
        self.cp = int(cp)
        self.slots = list(range(self.cp))

    def split(self, t: torch.Tensor) -> List[torch.Tensor]:
        """(B, S, ...) -> cp chunks (B, S / cp, ...), context rank order."""
        if t.shape[1] % self.cp:
            raise ValueError(f"the context size {self.cp} must divide the sequence "
                             f"length {t.shape[1]}")
        return [c.contiguous() for c in t.chunk(self.cp, 1)]

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(parts), 1)

    def rotate(self, parts: list) -> list:
        return parts[-1:] + parts[:-1]

    def gather(self, parts: list) -> list:
        """Every chunk's value, in context-rank order (differentiable)."""
        return list(parts)

    def seq_offset(self, s_local: int) -> int:
        """The position of this process's first token in the sequence."""
        return 0


class GroupRing:
    """One chunk in this process: context rank ``index`` of the ``cp``
    ranks of ``group``. A rotation sends each tensor to rank index + 1 and
    receives rank index - 1's, both posted in one ``batch_isend_irecv``."""

    def __init__(self, group):
        self.group = group
        self.cp = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.slots = [self.index]
        self._next = dist.get_global_rank(group, (self.index + 1) % self.cp)
        self._prev = dist.get_global_rank(group, (self.index - 1) % self.cp)

    def split(self, t: torch.Tensor) -> List[torch.Tensor]:
        return [t.contiguous()]

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return parts[0]

    def _shift(self, parts: list, to: int, frm: int) -> list:
        if self.cp == 1:
            return parts
        (item,) = parts
        single = torch.is_tensor(item)
        sends = [item] if single else list(item)
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t.contiguous(), to, self.group) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, frm, self.group) for t in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [recvs[0] if single else tuple(recvs)]

    def rotate(self, parts: list) -> list:
        return self._shift(parts, self._next, self._prev)

    def rotate_back(self, parts: list) -> list:
        return self._shift(parts, self._prev, self._next)

    def gather(self, parts: list) -> list:
        return list(_GatherContext.apply(self, parts[0]))

    def seq_offset(self, s_local: int) -> int:
        return self.index * s_local


class _GatherContext(torch.autograd.Function):
    """All-gather over the context group; the backward hands each rank
    the sum over the group of the gradients of its own part."""

    @staticmethod
    def forward(ctx, ring, t):
        ctx.ring = ring
        parts = [torch.empty_like(t) for _ in range(ring.cp)]
        dist.all_gather(parts, t.contiguous(), group=ring.group)
        return tuple(parts)

    @staticmethod
    def backward(ctx, *grads):
        ring = ctx.ring
        stacked = torch.stack([torch.zeros_like(g) if g is None else g for g in grads])
        stacked = stacked.contiguous()
        dist.all_reduce(stacked, group=ring.group)
        return None, stacked[ring.index]


class _ShiftContext(torch.autograd.Function):
    """Each rank receives the previous rank's tensor (rank 0 zeros); the
    backward sends the gradient back to the rank it came from."""

    @staticmethod
    def forward(ctx, ring, t):
        ctx.ring = ring
        (out,) = ring.rotate([t.contiguous()])
        return torch.zeros_like(t) if ring.index == 0 else out

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        (out,) = ring.rotate_back([g.contiguous()])
        return None, torch.zeros_like(g) if ring.index == ring.cp - 1 else out


def shift_from_previous(ring, parts: list) -> list:
    """Per slot, the previous context rank's value (zeros at rank 0),
    differentiable: the conv halo's exchange."""
    if isinstance(ring, GroupRing):
        return [_ShiftContext.apply(ring, parts[0])]
    moved = ring.rotate(parts)
    return [torch.zeros_like(parts[0])] + moved[1:]


def context_ring(mesh) -> Optional[GroupRing]:
    """The :class:`GroupRing` over ``mesh``'s context axis, or None when the
    axis has one rank."""
    from fms_fsdp_tpu_torch.parallel.mesh import AXIS_CONTEXT, axis_sizes

    if axis_sizes(mesh)[AXIS_CONTEXT] == 1:
        return None
    return GroupRing(mesh.get_group(AXIS_CONTEXT))


# ---------------------------------------------------------------------------
# partials
# ---------------------------------------------------------------------------


def _relation(idx: int, src: int, causal: bool) -> Optional[str]:
    """How the queries of context rank ``idx`` see the keys of chunk
    ``src``: "diag", "visible", or None (in the future: skipped)."""
    if not causal:
        return "visible"
    if src == idx:
        return "diag"
    return "visible" if src < idx else None


def _scores(q, k, causal, scale):
    """(b, nkv, group, sq, sk) fp32 scores, NEG_INF above the diagonal."""
    b, sq, nq, h = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, nkv, nq // nkv, h)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _einsum_partial(q, k, v, causal, scale):
    """(o (B, S, Nq, H) fp32, lse (B, Nq, S) fp32) through materialised
    scores: JAX's ``_einsum_partial``."""
    b, sq, nq, h = q.shape
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30)
    lse = m + torch.log(l.clamp_min(1e-30))
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, nq, h)
    return o, lse[..., 0].reshape(b, nq, sq)


def _einsum_partial_grads(q, k, v, do, lse, delta, causal, scale):
    """(dq, dk, dv) fp32 of one partial from the global stats lse and
    delta (B, Nq, S): JAX's ``_einsum_partial_grads``."""
    b, sq, nq, h = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    s = _scores(q, k, causal, scale)
    stats = lambda t: t.reshape(b, nkv, g, sq, 1)  # noqa: E731
    p = torch.exp(s - stats(lse))
    dog = do.float().reshape(b, sq, nkv, g, h)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.float())
    ds = p * (dp - stats(delta)) * scale
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()).reshape(b, sq, nq, h)
    qg = q.float().reshape(b, sq, nkv, g, h)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    return dq, dk, dv


def _merge(acc, lse_run, o, lse):
    """One partial into the running (acc (B, S, Nq, H) fp32, lse (B, Nq, S)):
    the weights broadcast through a view, no transpose of the stats."""
    lse_new = torch.logaddexp(lse_run, lse)
    w_run = torch.exp((lse_run - lse_new).clamp_min(NEG_INF)).transpose(1, 2)[..., None]
    w_new = torch.exp((lse - lse_new).clamp_min(NEG_INF)).transpose(1, 2)[..., None]
    return acc * w_run + o.float() * w_new, lse_new


class _Ring(torch.autograd.Function):
    """The ring's forward and its backward ring over the local slots'
    chunks: inputs ``n`` q chunks, then n k, then n v; outputs n o."""

    @staticmethod
    def forward(ctx, ring, causal, scale, flash, block_k, n, *chunks):
        qs, ks, vs = chunks[:n], chunks[n:2 * n], chunks[2 * n:]
        cp = ring.cp
        accs, lses = [], []
        for q in qs:
            b, s, nq, h = q.shape
            accs.append(torch.zeros((b, s, nq, h), dtype=torch.float32, device=q.device))
            lses.append(torch.full((b, nq, s), NEG_INF, dtype=torch.float32,
                                   device=q.device))
        kv = [(k, v) for k, v in zip(ks, vs)]
        for step in range(cp):
            for i, idx in enumerate(ring.slots):
                rel = _relation(idx, (idx - step) % cp, causal)
                if rel is None:
                    continue
                k, v = kv[i]
                if flash:
                    o, lse = _fa.flash_fwd(qs[i], k, v, causal=rel == "diag", scale=scale,
                                           block_k=block_k)
                else:
                    o, lse = _einsum_partial(qs[i], k, v, rel == "diag", scale)
                accs[i], lses[i] = _merge(accs[i], lses[i], o, lse)
            if step < cp - 1:
                kv = ring.rotate(kv)
        outs = [a.to(q.dtype) for a, q in zip(accs, qs)]
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.ring, ctx.causal, ctx.scale, ctx.flash, ctx.block_k, ctx.n = (
            ring, causal, scale, flash, block_k, n)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        with record_function("ring_attention_bwd"):
            return (None,) * 6 + _ring_backward(ctx, douts)


def _ring_backward(ctx, douts):
    ring, causal, scale, flash, block_k, n = (
        ctx.ring, ctx.causal, ctx.scale, ctx.flash, ctx.block_k, ctx.n)
    saved = ctx.saved_tensors
    qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
    cp = ring.cp
    dos = [d.contiguous() for d in douts]
    # delta from the MERGED output, once; q2 once: neither changes over
    # the ring's steps
    deltas = [torch.einsum("bsnh,bsnh->bns", o.float(), d.float()).contiguous()
              for o, d in zip(outs, dos)]
    q2s = [_fa.scaled_q(q, scale) if flash and q.is_cuda else None for q in qs]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    carry = [(k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
              torch.zeros(v.shape, dtype=torch.float32, device=v.device))
             for k, v in zip(ks, vs)]
    for step in range(cp):
        for i, idx in enumerate(ring.slots):
            rel = _relation(idx, (idx - step) % cp, causal)
            if rel is None:
                continue
            k, v, dk, dv = carry[i]
            diag = rel == "diag"
            if flash:
                dq_p = _fa.flash_dq(qs[i], k, v, dos[i], lses[i], deltas[i], causal=diag,
                                    scale=scale, block_k=block_k, out_dtype=torch.float32)
                dk_p, dv_p = _fa.flash_dkv(qs[i], k, v, dos[i], lses[i], deltas[i],
                                           causal=diag, scale=scale, q2=q2s[i])
            else:
                dq_p, dk_p, dv_p = _einsum_partial_grads(qs[i], k, v, dos[i], lses[i],
                                                         deltas[i], diag, scale)
            dqs[i] += dq_p
            dk += dk_p
            dv += dv_p
        if step < cp - 1:
            carry = ring.rotate(carry)
        else:
            # the accumulators travel one step more: home, whole
            moved = ring.rotate([(dk, dv) for _, _, dk, dv in carry])
            carry = [(None, None, dk, dv) for dk, dv in moved]
    return (*[dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            *[dk.to(k.dtype) for (_, _, dk, _), k in zip(carry, ks)],
            *[dv.to(v.dtype) for (_, _, _, dv), v in zip(carry, vs)])


def _use_flash(q_local, k_local, impl: str) -> bool:
    """Whether the partials run the flash kernels (their plain versions on
    the CPU): the kernels' own rule at the local shapes, as JAX's
    ``_flash_eligible``. A shape they refuse runs the einsum partials on
    the CPU and raises on the card."""
    if impl == "xla":
        return False
    if impl not in ("auto", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if _fa.supports(q_local.shape, k_local.shape):
        if q_local.device.type not in ("cpu", "cuda"):
            raise ValueError(f"ring attention runs on cuda or cpu, not {q_local.device}")
        return True
    if q_local.device.type == "cpu":
        return False
    raise NotImplementedError(
        f"ring attention on {q_local.device} runs the flash kernels, which do not take "
        f"the local chunks q{tuple(q_local.shape)} k{tuple(k_local.shape)} (head_dim 128, "
        f"lengths multiples of 64); attention_kernel='xla' runs the einsum partials")


def ring_attention(q, k, v, ring, *, causal: bool = True, scale: Optional[float] = None,
                   impl: str = "auto"):
    """q (B, S, Nq, H), k/v (B, S, Nkv, H): this process's part of the
    sequence (all of it for a :class:`LocalRing`, S / cp for a
    :class:`GroupRing`) -> o (B, S, Nq, H), differentiable."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
    flash = _use_flash(qs[0], ks[0], impl)
    bk = None
    if flash and q.is_cuda:
        # the default key tile, pinned for the forward and the backward
        bk = _fa._pick_block(qs[0].shape[1], _fa._kernel_block_k(q.dtype, None), "k",
                             q.dtype)
    outs = _Ring.apply(ring, causal, scale, flash, bk, len(qs), *qs, *ks, *vs)
    return ring.join(outs)
