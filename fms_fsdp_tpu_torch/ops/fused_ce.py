"""Cross-entropy losses: over full logits, and fused with the lm-head.

Counterparts of ``fms_fsdp_tpu/train/step.py:39 cross_entropy_loss`` and
``fms_fsdp_tpu/ops/fused_ce.py::fused_linear_cross_entropy``, both as
``torch.autograd.Function``s so the fp32 temporaries live only one chunk
of rows at a time. They are plain PyTorch with ``torch.matmul``: JAX
computes them outside any Pallas kernel.

- ``cross_entropy_loss``: token-mean CE over labels != -100 on (B, S, V)
  logits in the compute dtype. The max is subtracted in the logits' dtype
  and exp/sum/log run in fp32, as in JAX; the backward forms
  ``(softmax - onehot) * g / n`` in fp32 and rounds it once to the logits'
  dtype.
- ``fused_linear_cross_entropy``: never materialises the logits. Each
  chunk of tokens computes its fp32 logits tile (the compute-dtype
  operands widened, as ``preferred_element_type=float32`` asks of XLA),
  its logsumexp and gold score; the backward recomputes each tile and
  returns dx in x's dtype and dW summed in fp32.

Both take an optional ``n``: the count the summed token loss is divided
by. A data-parallel step passes the count of labels != -100 over the
GLOBAL batch (``parallel/sharding.py::DataParallel.global_count``), so the
ranks' losses sum to the mean over the global batch.

Both take an optional ``tp`` (``parallel/tensor.py::TensorParallel``)
when the logits, or the lm_head's columns, are this rank's block of the
vocabulary (JAX's lm_head ``P(fsdp, tensor)``,
``fms_fsdp_tpu/models/llama.py:249``). Per chunk of tokens three things
are reduced over tensor: the row max, then the sum of exponentials and
the label's logit (zero on the ranks that do not hold the label) in one
all-reduce; the loss is then the same on every tensor rank. The
backward stays local: each rank forms the softmax of its own columns
from the saved row logsumexp, and the fused form's dx, a partial sum
over the vocabulary, is summed over tensor by the ``enter`` its input
passes through. The whole lm_head is never gathered.
"""

import torch
import torch.distributed as dist

# torch CrossEntropyLoss default; the ignored-label sentinel
IGNORE_INDEX = -100
# rows per chunk of the full-logits loss: ~0.5 GB of fp32 at vocab 128256
_CE_ROWS = 1024


def _row_chunks(n, rows):
    return [(i, min(n, i + rows)) for i in range(0, n, rows)]


def _local_labels(safe, v_local, tp):
    """(this rank's column of each label, clamped into range, and whether
    the label lies in this rank's vocabulary block)."""
    if tp is None:
        return safe, None
    local = safe - tp.rank * v_local
    inside = (local >= 0) & (local < v_local)
    return local.clamp(0, v_local - 1), inside


def _gold(rows, idx, inside):
    """Each row's label logit (fp32); zero where ``inside`` is False."""
    gold = rows.gather(-1, idx[:, None])[:, 0].float()
    return gold if inside is None else torch.where(inside, gold, torch.zeros_like(gold))


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, n, tp):
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        lab = labels.reshape(-1).long()
        mask = lab != IGNORE_INDEX
        safe = torch.where(mask, lab, torch.zeros_like(lab))
        idx, inside = _local_labels(safe, v, tp)
        if n is None:
            n = mask.sum().clamp(min=1)
        m = torch.empty(flat.shape[0], dtype=logits.dtype, device=logits.device)
        lse = torch.empty(flat.shape[0], dtype=torch.float32, device=logits.device)
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for i0, i1 in _row_chunks(flat.shape[0], _CE_ROWS):
            rows = flat[i0:i1]
            m_c = rows.amax(dim=-1)
            if tp is not None:
                m_c = tp.all_reduce(m_c.float(), dist.ReduceOp.MAX).to(rows.dtype)
            m[i0:i1] = m_c
            shifted = (rows - m[i0:i1, None]).float()
            sums = torch.exp(shifted).sum(dim=-1)
            gold = _gold(rows, idx[i0:i1], None if inside is None else inside[i0:i1])
            if tp is not None:
                sums, gold = tp.all_reduce(torch.stack([sums, gold]))
            lse[i0:i1] = torch.log(sums)
            logz = lse[i0:i1] + m[i0:i1].float()
            total = total + ((logz - gold) * mask[i0:i1]).sum()
        ctx.save_for_backward(logits, idx, mask, m, lse, n, inside)
        return total / n

    @staticmethod
    def backward(ctx, g):
        logits, idx, mask, m, lse, n, inside = ctx.saved_tensors
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        grad = torch.empty_like(flat)
        scale = mask.float() * (g / n)
        at_label = scale if inside is None else scale * inside
        for i0, i1 in _row_chunks(flat.shape[0], _CE_ROWS):
            shifted = (flat[i0:i1] - m[i0:i1, None]).float()
            p = torch.exp(shifted - lse[i0:i1, None]) * scale[i0:i1, None]
            p.scatter_add_(-1, idx[i0:i1, None], -at_label[i0:i1, None])
            grad[i0:i1] = p.to(logits.dtype)
        return grad.reshape(logits.shape), None, None, None


def cross_entropy_loss(logits, labels, n=None, tp=None):
    """Token-mean CE over labels != -100, matching
    ``CrossEntropyLoss()(output.view(-1, V), label.view(-1))``; fp32.
    ``n`` replaces the local count of labels != -100 as the divisor;
    ``tp``: the logits are this rank's vocabulary block (module
    docstring)."""
    return _CrossEntropy.apply(logits, labels, n, tp)


class _FusedLinearCE(torch.autograd.Function):
    """Per chunk of tokens: the logits over ``w``'s columns (this rank's
    vocabulary block under ``tp``), their row max, sum of exponentials
    and label logit (reduced over tensor under ``tp``), and the row
    logsumexp saved for the backward's softmax."""

    @staticmethod
    def forward(ctx, x, w, labels, chunk, n, tp):
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        lab = labels.reshape(-1).long()
        mask = lab != IGNORE_INDEX
        safe = torch.where(mask, lab, torch.zeros_like(lab))
        idx, inside = _local_labels(safe, w.shape[-1], tp)
        w32 = w.float()
        lse = torch.empty(b * s, dtype=torch.float32, device=x.device)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i0, i1 in _row_chunks(b * s, chunk):
            logits = xf[i0:i1].float() @ w32
            m = logits.amax(dim=-1)
            if tp is not None:
                m = tp.all_reduce(m, dist.ReduceOp.MAX)
            sums = torch.exp(logits - m[:, None]).sum(dim=-1)
            gold = _gold(logits, idx[i0:i1], None if inside is None else inside[i0:i1])
            if tp is not None:
                sums, gold = tp.all_reduce(torch.stack([sums, gold]))
            lse[i0:i1] = m + torch.log(sums)
            total = total + ((lse[i0:i1] - gold) * mask[i0:i1]).sum()
        if n is None:
            n = mask.sum().clamp(min=1)
        ctx.save_for_backward(x, w, idx, inside, mask, lse, n)
        ctx.chunk = chunk
        return total / n

    @staticmethod
    def backward(ctx, g):
        x, w, idx, inside, mask, lse, n = ctx.saved_tensors
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        w32 = w.float()
        scale = mask.float() * (g / n)
        at_label = scale if inside is None else scale * inside
        dx = torch.empty_like(xf)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i0, i1 in _row_chunks(b * s, ctx.chunk):
            x_c = xf[i0:i1]
            p = torch.exp(x_c.float() @ w32 - lse[i0:i1, None]) * scale[i0:i1, None]
            p.scatter_add_(-1, idx[i0:i1, None], -at_label[i0:i1, None])
            d_logits = p.to(x.dtype)
            dx[i0:i1] = d_logits @ w.t()
            dw += x_c.float().t() @ d_logits.float()
        return dx.reshape(x.shape), dw.to(w.dtype), None, None, None, None


def fused_linear_cross_entropy(x, w, labels, chunk: int = 4096, n=None, tp=None):
    """x (B, S, D) in the compute dtype, w (D, V), labels (B, S) int with
    -100 ignored -> scalar mean CE over valid tokens (fp32); ``n``
    replaces the local count of valid tokens as the divisor. Under ``tp``
    ``w`` is this rank's (D, V / tp) vocabulary block and ``x`` enters the
    tensor region (its gradient summed over tensor; module docstring)."""
    if chunk <= 0:
        raise ValueError(f"loss_chunk_size must be positive, got {chunk}")
    if tp is not None:
        x = tp.enter(x)
    return _FusedLinearCE.apply(x, w, labels, int(chunk), n, tp)
