"""Speculative decoding: the inference side of the trained MLPSpeculator.

Counterpart of ``fms_fsdp_tpu/models/speculative.py``: the speculator
proposes ``n_predict`` tokens, the frozen base verifies the whole chain
in ONE cached forward over n_predict + 1 positions, and the longest
matching prefix is accepted, so greedy speculative decoding reproduces
plain greedy decoding token for token. One candidate chain, greedy
acceptance, batch size 1 over the dense cache (the serving engine runs
the batched, paged form: ``serve/families/llama.py``).
"""

from typing import Dict

import torch

from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.models.generation import decode_chunk, prefill
from fms_fsdp_tpu_torch.models.speculator import (
    SpeculatorConfig,
    head_step,
    scale_input,
)
from fms_fsdp_tpu_torch.ops.rope import rope_table


def speculator_propose(spec_params, embed, last_tok, scfg: SpeculatorConfig):
    """Greedy n_predict-token proposal chain. embed (B, D): the base
    hidden state that predicted ``last_tok`` (B,). Returns (B, n_predict)
    int64: each head's argmax feeds the next head's token input."""
    state = scale_input(embed[:, None, :], scfg)  # (B, 1, D)
    tok = last_tok[:, None].long()
    outs = []
    for i in range(scfg.n_predict):
        state, logits = head_step(spec_params, scfg, state, tok, i)
        tok = torch.argmax(logits, dim=-1)  # (B, 1)
        outs.append(tok)
    return torch.cat(outs, dim=1)


@torch.no_grad()
def speculative_decode(
    base_params,
    spec_params,
    input_ids,
    cfg: LlamaConfig,
    scfg: SpeculatorConfig,
    *,
    max_seq_len: int = 2048,
    max_new_tokens: int = 64,
) -> Dict:
    """Greedy speculative decoding of one row. Returns {"tokens": (1,
    P+T), "accept_rate": mean accepted proposals per verification}. The
    compute dtype is the base params' own."""
    assert input_ids.shape[0] == 1, "speculative_decode is B=1 (see module doc)"
    n = scfg.n_predict
    plen = input_ids.shape[1]
    assert plen + max_new_tokens + n + 1 <= max_seq_len
    dtype = base_params["embedding"].dtype
    rope = rope_table(max_seq_len, cfg.head_dim, cfg.rope_theta, device=input_ids.device)

    logits, embeds, cache = prefill(base_params, input_ids, cfg, max_seq_len, dtype, rope=rope)
    last_tok = torch.argmax(logits[:, -1], dim=-1)  # (1,)
    state_embed = embeds[:, -1]
    pos = plen
    out = [int(last_tok[0])]
    accepted = []
    while len(out) < max_new_tokens:
        props = speculator_propose(spec_params, state_embed, last_tok, scfg)  # (1, n)
        cand = torch.cat([last_tok[:, None], props], dim=1)  # (1, n+1)
        logits, embeds, cache = decode_chunk(base_params, cache, cand, pos, cfg, dtype, rope)
        base_next = torch.argmax(logits, dim=-1)  # (1, n+1)
        match = torch.cumprod((props == base_next[:, :-1]).long(), dim=1)
        # one host sync per verification
        props_h, next_h, match_h = props.cpu(), base_next.cpu(), match.cpu()
        k = int(match_h[0].sum())
        accepted.append(k)
        out.extend([int(t) for t in props_h[0, :k]] + [int(next_h[0, k])])
        last_tok = base_next[:, k]
        state_embed = embeds[:, k]
        pos += k + 1
    gen = torch.tensor(out[:max_new_tokens], dtype=input_ids.dtype, device=input_ids.device)
    tokens = torch.cat([input_ids, gen[None, :]], dim=1)
    rate = float(sum(accepted)) / max(1, len(accepted))
    return {"tokens": tokens, "accept_rate": rate}
