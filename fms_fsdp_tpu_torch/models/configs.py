"""Model architecture configs (Llama; Mamba and Mixtral come with their
slices).

A copy of ``fms_fsdp_tpu/models/configs.py::LlamaConfig``: the same
architectural degrees of freedom the reference variant table exercises
(emb_dim, nheads, kvheads for GQA, nlayers, hidden_grow_factor +
multiple_of SwiGLU rounding, max_expected_seq_len, rope_theta, vocab).
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class LlamaConfig:
    src_vocab_size: int = 32000
    emb_dim: int = 4096
    norm_eps: float = 1e-5
    nheads: int = 32
    kvheads: int = 0  # 0 -> MHA (kvheads = nheads), else GQA group count
    nlayers: int = 32
    hidden_grow_factor: float = 8 / 3
    multiple_of: int = 256
    max_expected_seq_len: int = 4096
    rope_theta: float = 10000.0
    p_dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.emb_dim // self.nheads

    @property
    def n_kv_heads(self) -> int:
        return self.kvheads if self.kvheads else self.nheads

    @property
    def hidden_dim(self) -> int:
        """SwiGLU inner width with multiple_of rounding (fms GatedLinearUnit)."""
        hidden = int(self.emb_dim * self.hidden_grow_factor)
        if self.multiple_of:
            hidden = self.multiple_of * (
                (hidden + self.multiple_of - 1) // self.multiple_of
            )
        return hidden

    def n_params(self, include_embeddings: bool = True) -> int:
        """Exact parameter count (untied input/output embeddings)."""
        d, h = self.emb_dim, self.hidden_dim
        kv_dim = self.n_kv_heads * self.head_dim
        per_layer = (
            d * d  # wq
            + 2 * d * kv_dim  # wk, wv
            + d * d  # wo
            + 3 * d * h  # w1 and w3 (d->h each), w2 (h->d)
            + 2 * d  # attn norm + ffn norm
        )
        total = self.nlayers * per_layer + d  # final norm
        if include_embeddings:
            total += 2 * self.src_vocab_size * d  # embed + lm head
        return int(total)
