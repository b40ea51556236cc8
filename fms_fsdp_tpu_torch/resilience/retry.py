"""Bounded retry with exponential backoff.

Counterpart of ``fms_fsdp_tpu/resilience/retry.py::backoff_delay`` and
``retry_call``: the checkpoint manager's commit path
(``ckpt/manager.py``) retries its manifest and ``metadata.json`` writes
with them. The retrying shard-file handler of the streaming loader waits
for ROADMAP.md A.15.
"""

import logging
import time
from typing import Callable

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
