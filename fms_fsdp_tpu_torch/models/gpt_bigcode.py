"""GPTBigCode helpers of the port: only ``generate_simple`` so far.

Counterpart of ``generate_simple`` in ``fms_fsdp_tpu/models/gpt_bigcode.py``,
the cache-less generation by full re-forward that the non-Llama
speculator bases share (the Mixtral base uses it). The GPTBigCode model
itself comes with ROADMAP.md A.11.
"""

from typing import Optional

import torch


@torch.no_grad()
def generate_simple(
    params,
    input_ids,
    cfg,
    forward_fn,
    *,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 8,
    do_sample: bool = False,
    temperature: float = 1.0,
    include_embeds: bool = False,
    **_unused,
):
    """Greedy or sampled generation by re-running ``forward_fn`` over the
    whole sequence for every new token. The sequence lives in a fixed
    (B, P+T) buffer written in place, as JAX's ``fori_loop`` does: causal
    attention keeps the trailing zeros invisible to earlier positions.
    Sampling draws from ``generator`` over the full vocabulary (no top-k),
    as JAX's. With ``include_embeds`` also returns the hidden states that
    predicted each generated token (B, T, D)."""
    b, plen = input_ids.shape
    total = plen + max_new_tokens
    toks = torch.zeros((b, total), dtype=input_ids.dtype, device=input_ids.device)
    toks[:, :plen] = input_ids
    for i in range(plen, total):
        out = forward_fn(params, toks, cfg)
        logits_all = out[0] if isinstance(out, tuple) else out
        logits = logits_all[:, i - 1]
        if do_sample:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        toks[:, i] = nxt.to(toks.dtype)
    if include_embeds:
        _, embeds = forward_fn(params, toks, cfg, return_embeds=True)
        return toks, embeds[:, plen - 1:plen - 1 + max_new_tokens]
    return toks
