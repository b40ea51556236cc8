"""Shard-file readers (ref:fms_fsdp/utils/dataset_utils.py:286-457).

A copy of ``fms_fsdp_tpu/data/handlers.py``:

- ArrowHandler: pre-tokenized pyarrow IPC files, one document per
  RecordBatch; mmap'd so document chunks slice zero-copy without reading
  whole shards (pyarrow is host-side C++, imported when a shard is
  opened).
- ParquetHandler: HF-style parquet of raw text, tokenized on the fly.
- AutoHandler: dispatch by file extension.

All strip configured bos/eos tokens found at document edges so delimiter
placement is fully owned by the pipeline.
"""

import os
from typing import Any, List, Set

import numpy as np


class ShardFileHandler:
    """Interface: open / length / get / slice over one shard file."""

    def is_legal(self, filepath: str) -> bool:
        return os.path.isfile(filepath)

    def open(self, path: str):
        raise NotImplementedError

    def length(self, path: str) -> int:
        """Number of documents in the file (without reading it whole)."""
        raise NotImplementedError

    def get(self, reader, index: int, drop_tokens: Set):
        """Fetch document ``index``; strip leading/trailing drop_tokens.
        Result must support len()."""
        raise NotImplementedError

    def slice(self, doc, index: int, n_pull: int) -> "np.ndarray":
        """Return doc[index : index + n_pull] as a 1-D int numpy array.

        Token chunks travel the whole host pipeline as numpy arrays —
        per-token python-object conversion (arrow ``to_pylist``) was the
        single hottest call of the loader at ~2/3 of iterator time.
        """
        raise NotImplementedError


class ArrowHandler(ShardFileHandler):
    """Indexable pre-tokenized pyarrow shard files: each RecordBatch holds
    one document as a token list under ``col_name``."""

    def __init__(self, col_name: str = "tokens"):
        self.col_name = col_name

    def is_legal(self, filepath: str) -> bool:
        return "arrow" in os.path.splitext(filepath)[1]

    def open(self, path: str):
        import pyarrow as pa

        return pa.ipc.open_file(pa.memory_map(path))

    def length(self, path: str) -> int:
        return self.open(path).num_record_batches

    def get(self, reader, index: int, drop_tokens: Set):
        doc = reader.get_batch(index)[self.col_name]
        if len(doc) > 0 and doc[0].as_py() in drop_tokens:
            doc = doc.slice(1, len(doc) - 1)
        # re-check: doc may have been exactly [eos]
        if len(doc) > 0 and doc[-1].as_py() in drop_tokens:
            doc = doc.slice(0, len(doc) - 1)
        return doc

    def slice(self, doc, index: int, n_pull: int) -> np.ndarray:
        return doc.slice(index, n_pull).to_numpy(zero_copy_only=False)


class ParquetHandler(ShardFileHandler):
    """Parquet shards of raw text, tokenized on access with an HF tokenizer
    (assumes modest shard/document sizes)."""

    def __init__(self, tokenizer_path: str, col_name: str = "text"):
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(tokenizer_path)
        self.col_name = col_name

    def is_legal(self, filepath: str) -> bool:
        return "parquet" in os.path.splitext(filepath)[1]

    def open(self, path: str):
        import pyarrow.parquet as pq

        return pq.read_pandas(path, columns=[self.col_name], partitioning=None)[
            self.col_name
        ]

    def length(self, path: str) -> int:
        import pyarrow.parquet as pq

        return pq.read_metadata(path).num_rows

    def get(self, reader, index: int, drop_tokens: Set):
        doc = self.tokenizer(str(reader[index]))["input_ids"]
        if len(doc) > 0 and doc[0] in drop_tokens:
            doc = doc[1:]
        if len(doc) > 0 and doc[-1] in drop_tokens:
            doc = doc[:-1]
        return doc

    def slice(self, doc: List, index: int, n_pull: int) -> np.ndarray:
        return np.asarray(doc[index : index + n_pull], dtype=np.int64)


class AutoHandler(ShardFileHandler):
    """Extension-dispatching handler over Arrow + Parquet."""

    def __init__(self, tokenizer_path: str, col_name: str = "text"):
        self.PHandler = ParquetHandler(tokenizer_path, col_name)
        self.AHandler = ArrowHandler()
        self.current: ShardFileHandler = ShardFileHandler()

    def _pick(self, path: str) -> ShardFileHandler:
        if "arrow" in os.path.splitext(path)[1]:
            return self.AHandler
        return self.PHandler

    def is_legal(self, filepath: str) -> bool:
        ext = os.path.splitext(filepath)[1]
        return "parquet" in ext or "arrow" in ext

    def open(self, path: str):
        self.current = self._pick(path)
        return self.current.open(path)

    def length(self, path: str) -> int:
        return self._pick(path).length(path)

    def get(self, reader, index: int, drop_tokens: Set):
        return self.current.get(reader, index, drop_tokens)

    def slice(self, doc, index: int, n_pull: int) -> List:
        return self.current.slice(doc, index, n_pull)
