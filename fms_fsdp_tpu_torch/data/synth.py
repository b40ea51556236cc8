"""Synthetic arrow-corpus generation for tests and evidence capture.

Writes real .arrow shard files plus the ``meta/combined_counts.csv`` the
streaming pipeline's sampling layer reads — the same on-disk layout the
reference's dataset tooling produces (ref:fms_fsdp/utils/dataset_utils.py
Streaming_Doc_Dataset file discovery + counts csv) — so everything from
file handlers through shard rescaling runs exactly as it would on a real
corpus.

Documents are noisy counter sequences: from a random start, each next
token is previous+1 (mod the vocab band) with probability ``1 - noise``,
else uniform. The +1 transition is learnable by any LM in a few hundred
steps, so perplexity measurably falls after training — which is what the
arrow-streaming -> training -> eval evidence leg needs to show. Token
values stay inside [1, vocab) so the pipeline's eos/bos specials (0 by
default) never collide with corpus tokens.

``build_arrow_corpus`` is a copy of ``fms_fsdp_tpu/data/synth.py``'s;
``build_mixed_corpus`` writes several corpora of mixed document lengths
with one counts csv, as a weighted multi-corpus run reads them.
"""

import os

import numpy as np


def build_arrow_corpus(
    root,
    *,
    n_shards: int = 3,
    docs_per_shard: int = 60,
    doc_len: int = 90,
    vocab: int = 256,
    noise: float = 0.1,
    seed: int = 11,
    dataset_name: str = "dataset_1",
):
    """Write ``n_shards`` arrow files of counter-structured docs under
    ``root/<dataset_name>/`` with the counts csv; returns ``str(root)``."""
    import pyarrow as pa

    root = str(root)
    schema = pa.schema([pa.field("tokens", pa.uint32())])
    os.makedirs(os.path.join(root, dataset_name), exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(n_shards):
        path = os.path.join(root, dataset_name, f"shard_{s}.arrow")
        with pa.ipc.new_file(path, schema) as w:
            for _ in range(docs_per_shard):
                start = rng.integers(1, vocab)
                steps = np.arange(doc_len, dtype=np.uint32)
                counter = (start - 1 + steps) % (vocab - 1) + 1
                flip = rng.random(doc_len) < noise
                noise_tok = rng.integers(1, vocab, size=doc_len)
                doc = np.where(flip, noise_tok, counter).astype(np.uint32)
                w.write(pa.record_batch([pa.array(doc)], schema))
        rows.append(
            (
                f"/{dataset_name}/shard_{s}.arrow",
                docs_per_shard,
                docs_per_shard * doc_len,
            )
        )
    os.makedirs(os.path.join(root, "meta"), exist_ok=True)
    with open(os.path.join(root, "meta", "combined_counts.csv"), "w") as f:
        f.write("dataset/filename,documents,tokens\n")
        for name, d, t in rows:
            f.write(f"{name},{d},{t}\n")
    return root


def build_mixed_corpus(
    root,
    corpora,
    *,
    docs_per_shard: int,
    min_len: int = 64,
    max_len: int = 16384,
    vocab: int = 128256,
    seed: int = 0,
):
    """Write a multi-corpus arrow tree under ``root``: for each
    ``name -> n_shards`` of ``corpora``, ``n_shards`` files of
    ``docs_per_shard`` documents under ``root/<name>/``, with one
    ``meta/combined_counts.csv`` covering every corpus. Document lengths
    are log-uniform over [min_len, max_len] and tokens uniform uint32 in
    [1, vocab), so the pipeline's eos/bos specials (0 by default) never
    collide with corpus tokens. Returns (``str(root)``, total tokens)."""
    import pyarrow as pa

    root = str(root)
    schema = pa.schema([pa.field("tokens", pa.uint32())])
    rng = np.random.default_rng(seed)
    rows = []
    for name, n_shards in corpora.items():
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for s in range(n_shards):
            lens = np.exp(
                rng.uniform(np.log(min_len), np.log(max_len + 1), docs_per_shard)
            ).astype(np.int64)
            toks = rng.integers(1, vocab, size=int(lens.sum()), dtype=np.uint32)
            ends = np.cumsum(lens)
            path = os.path.join(root, name, f"shard_{s}.arrow")
            with pa.ipc.new_file(path, schema) as w:
                for a, b in zip(ends - lens, ends):
                    w.write(pa.record_batch([pa.array(toks[a:b])], schema))
            rows.append((f"/{name}/shard_{s}.arrow", docs_per_shard, int(lens.sum())))
    os.makedirs(os.path.join(root, "meta"), exist_ok=True)
    with open(os.path.join(root, "meta", "combined_counts.csv"), "w") as f:
        f.write("dataset/filename,documents,tokens\n")
        for name, d, t in rows:
            f.write(f"{name},{d},{t}\n")
    return root, sum(t for _, _, t in rows)
