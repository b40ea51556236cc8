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
"""

import torch

# torch CrossEntropyLoss default; the ignored-label sentinel
IGNORE_INDEX = -100
# rows per chunk of the full-logits loss: ~0.5 GB of fp32 at vocab 128256
_CE_ROWS = 1024


def _row_chunks(n, rows):
    return [(i, min(n, i + rows)) for i in range(0, n, rows)]


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, n):
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        lab = labels.reshape(-1).long()
        mask = lab != IGNORE_INDEX
        safe = torch.where(mask, lab, torch.zeros_like(lab))
        if n is None:
            n = mask.sum().clamp(min=1)
        m = torch.empty(flat.shape[0], dtype=logits.dtype, device=logits.device)
        lse = torch.empty(flat.shape[0], dtype=torch.float32, device=logits.device)
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for i0, i1 in _row_chunks(flat.shape[0], _CE_ROWS):
            rows = flat[i0:i1]
            m[i0:i1] = rows.amax(dim=-1)
            shifted = (rows - m[i0:i1, None]).float()
            lse[i0:i1] = torch.log(torch.exp(shifted).sum(dim=-1))
            logz = lse[i0:i1] + m[i0:i1].float()
            gold = rows.gather(-1, safe[i0:i1, None])[:, 0].float()
            total = total + ((logz - gold) * mask[i0:i1]).sum()
        ctx.save_for_backward(logits, safe, mask, m, lse, n)
        return total / n

    @staticmethod
    def backward(ctx, g):
        logits, safe, mask, m, lse, n = ctx.saved_tensors
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        grad = torch.empty_like(flat)
        scale = mask.float() * (g / n)
        for i0, i1 in _row_chunks(flat.shape[0], _CE_ROWS):
            shifted = (flat[i0:i1] - m[i0:i1, None]).float()
            p = torch.exp(shifted - lse[i0:i1, None]) * scale[i0:i1, None]
            p.scatter_add_(-1, safe[i0:i1, None], -scale[i0:i1, None])
            grad[i0:i1] = p.to(logits.dtype)
        return grad.reshape(logits.shape), None, None


def cross_entropy_loss(logits, labels, n=None):
    """Token-mean CE over labels != -100, matching
    ``CrossEntropyLoss()(output.view(-1, V), label.view(-1))``; fp32.
    ``n`` replaces the local count of labels != -100 as the divisor."""
    return _CrossEntropy.apply(logits, labels, n)


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, chunk, n):
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        lab = labels.reshape(-1).long()
        mask = lab != IGNORE_INDEX
        safe = torch.where(mask, lab, torch.zeros_like(lab))
        w32 = w.float()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i0, i1 in _row_chunks(b * s, chunk):
            logits = xf[i0:i1].float() @ w32
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, safe[i0:i1, None])[:, 0]
            total = total + ((lse - gold) * mask[i0:i1]).sum()
        if n is None:
            n = mask.sum().clamp(min=1)
        ctx.save_for_backward(x, w, safe, mask, n)
        ctx.chunk = chunk
        return total / n

    @staticmethod
    def backward(ctx, g):
        x, w, safe, mask, n = ctx.saved_tensors
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        w32 = w.float()
        scale = mask.float() * (g / n)
        dx = torch.empty_like(xf)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i0, i1 in _row_chunks(b * s, ctx.chunk):
            x_c = xf[i0:i1]
            p = torch.softmax(x_c.float() @ w32, dim=-1) * scale[i0:i1, None]
            p.scatter_add_(-1, safe[i0:i1, None], -scale[i0:i1, None])
            d_logits = p.to(x.dtype)
            dx[i0:i1] = d_logits @ w.t()
            dw += x_c.float().t() @ d_logits.float()
        return dx.reshape(x.shape), dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(x, w, labels, chunk: int = 4096, n=None):
    """x (B, S, D) in the compute dtype, w (D, V), labels (B, S) int with
    -100 ignored -> scalar mean CE over valid tokens (fp32); ``n``
    replaces the local count of valid tokens as the divisor."""
    if chunk <= 0:
        raise ValueError(f"loss_chunk_size must be positive, got {chunk}")
    return _FusedLinearCE.apply(x, w, labels, int(chunk), n)
