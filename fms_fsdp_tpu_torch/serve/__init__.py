"""Serving: paged KV cache, ragged paged-attention decode, continuous
batching, disaggregated prefill/decode, and the fleet (counterpart of
``fms_fsdp_tpu/serve/``).

The fleet router, its journal and the scheduler import eagerly: they are
orchestration and import no torch, so a thin router process stays light.
The engine, the cache and the families import lazily (PEP 562).
"""

from fms_fsdp_tpu_torch.serve.fleet import (
    FleetConfig,
    FleetRouter,
    ReplicaLostError,
    RequestJournal,
    SubprocessReplica,
)
from fms_fsdp_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestRejected,
)

_LAZY = {
    "ServeConfig": "fms_fsdp_tpu_torch.serve.engine",
    "ServingEngine": "fms_fsdp_tpu_torch.serve.engine",
    "PagedKVCache": "fms_fsdp_tpu_torch.serve.kv_cache",
    "FAMILY_CODES": "fms_fsdp_tpu_torch.serve.families",
    "FamilyAdapter": "fms_fsdp_tpu_torch.serve.families",
    "family_of": "fms_fsdp_tpu_torch.serve.families",
    "init_params_for": "fms_fsdp_tpu_torch.serve.families",
    "load_model_config": "fms_fsdp_tpu_torch.serve.families",
    "resolve_adapter": "fms_fsdp_tpu_torch.serve.families",
    "HandoffError": "fms_fsdp_tpu_torch.serve.disagg",
    "ROLE_CODES": "fms_fsdp_tpu_torch.serve.disagg",
    "pack_handoff": "fms_fsdp_tpu_torch.serve.disagg",
    "unpack_handoff": "fms_fsdp_tpu_torch.serve.disagg",
}

__all__ = [
    "ContinuousBatchingScheduler",
    "FAMILY_CODES",
    "FamilyAdapter",
    "FleetConfig",
    "FleetRouter",
    "HandoffError",
    "PagedKVCache",
    "ROLE_CODES",
    "ReplicaLostError",
    "Request",
    "RequestJournal",
    "RequestRejected",
    "ServeConfig",
    "ServingEngine",
    "SubprocessReplica",
    "family_of",
    "init_params_for",
    "load_model_config",
    "pack_handoff",
    "resolve_adapter",
    "unpack_handoff",
]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod), name)
