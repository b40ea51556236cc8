"""Serving: paged KV cache, ragged paged-attention decode, continuous
batching (counterpart of ``fms_fsdp_tpu/serve/``, unified role).

The fleet router, journal and disaggregation transport come with the
serving extensions (ROADMAP.md A.10).
"""

from fms_fsdp_tpu_torch.serve.engine import ServeConfig, ServingEngine
from fms_fsdp_tpu_torch.serve.kv_cache import PagedKVCache
from fms_fsdp_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestRejected,
)

__all__ = [
    "ContinuousBatchingScheduler",
    "PagedKVCache",
    "Request",
    "RequestRejected",
    "ServeConfig",
    "ServingEngine",
]
