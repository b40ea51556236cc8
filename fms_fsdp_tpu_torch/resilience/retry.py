"""Bounded retry with exponential backoff, and the retrying shard-file
handler that applies it to every storage touch the streaming pipeline
makes.

Counterpart of ``fms_fsdp_tpu/resilience/retry.py``: the checkpoint
manager's commit path (``ckpt/manager.py``) retries its manifest and
``metadata.json`` writes with ``retry_call``, and ``get_data_loader``
wraps its shard handler in ``RetryingShardHandler``. Exhaustion surfaces
the final error to the caller — ``StreamingDocDataset`` then quarantines
the shard instead of killing the run. The handler hosts the ``shard_read``
fault site (resilience/faults.py).
"""

import logging
import time
from typing import Callable, Set

from fms_fsdp_tpu_torch.data.handlers import ShardFileHandler
from fms_fsdp_tpu_torch.resilience.faults import maybe_raise_fault

logger = logging.getLogger(__name__)

# errors worth retrying: transient storage/io flakes. Anything else
# (KeyError, schema mismatch, ...) is a real bug and propagates raw.
TRANSIENT_EXCEPTIONS = (OSError,)


def backoff_delay(
    attempt: int, backoff_s: float = 0.5, max_backoff_s: float = 30.0
) -> float:
    """The one backoff schedule: ``backoff_s * 2^attempt``, capped at
    ``max_backoff_s``."""
    return min(backoff_s * (2**attempt), max_backoff_s)


def retry_call(
    fn: Callable,
    *,
    retries: int = 3,
    backoff_s: float = 0.5,
    max_backoff_s: float = 30.0,
    exceptions=TRANSIENT_EXCEPTIONS,
    describe: str = "",
):
    """Call ``fn()``; on a transient exception retry up to ``retries``
    times with exponential backoff (backoff_s * 2^attempt, capped).
    Re-raises the final exception after exhaustion."""
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions as e:
            if attempt >= retries:
                raise
            delay = backoff_delay(attempt, backoff_s, max_backoff_s)
            attempt += 1
            logger.warning(
                "transient error in %s (attempt %d/%d, retrying in %.2fs): %s",
                describe or getattr(fn, "__name__", "call"),
                attempt,
                retries,
                delay,
                e,
            )
            time.sleep(delay)


class RetryingShardHandler(ShardFileHandler):
    """Wrap a ShardFileHandler so every open/length/get/slice retries
    transient errors with bounded exponential backoff.

    ``get``/``slice`` receive no path, so the wrapper remembers the last
    opened one for error context (per-clone state: pipeline deepcopies
    clone the wrapper along with its reader).
    """

    def __init__(
        self,
        inner: ShardFileHandler,
        retries: int = 3,
        backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
    ):
        self.inner = inner
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self._last_path = ""

    def _retry(self, op: str, path: str, fn: Callable):
        # the shard_read fault site runs inside each retried attempt: a
        # times=K fault is absorbed by the retry, a permanent one
        # exhausts it
        def attempt():
            maybe_raise_fault("shard_read", path=path, op=op)
            return fn()

        return retry_call(
            attempt,
            retries=self.retries,
            backoff_s=self.backoff_s,
            max_backoff_s=self.max_backoff_s,
            describe=f"shard {op} [{path}]",
        )

    def is_legal(self, filepath: str) -> bool:
        return self.inner.is_legal(filepath)

    def open(self, path: str):
        self._last_path = path
        return self._retry("open", path, lambda: self.inner.open(path))

    def length(self, path: str) -> int:
        return self._retry("length", path, lambda: self.inner.length(path))

    def get(self, reader, index: int, drop_tokens: Set):
        return self._retry(
            "get",
            self._last_path,
            lambda: self.inner.get(reader, index, drop_tokens),
        )

    def slice(self, doc, index: int, n_pull: int):
        return self._retry(
            "slice",
            self._last_path,
            lambda: self.inner.slice(doc, index, n_pull),
        )
