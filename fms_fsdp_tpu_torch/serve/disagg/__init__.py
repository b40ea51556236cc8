"""Disaggregated serving: the prefill/decode role split and the handoff.

Counterpart of ``fms_fsdp_tpu/serve/disagg/__init__.py``:

- :mod:`~fms_fsdp_tpu_torch.serve.disagg.handoff`: the PageHandoff codec
  (deterministic wire bytes for a sequence's KV pages + sampling state);
- :mod:`~fms_fsdp_tpu_torch.serve.disagg.slab`: how the Mamba slab (conv
  window, fp32 SSD state, hybrid pages) is named inside the same frame;
- :mod:`~fms_fsdp_tpu_torch.serve.disagg.transport`: the chunked,
  acked, resumable transfer layer on each replica's data channel;
- ``ServeConfig.role`` (``serve/engine.py``): ``unified`` serves end to
  end, ``prefill`` packs a handoff after the first token, ``decode`` also
  accepts ``submit_handoff`` resumes;
- ``FleetConfig.prefill_replicas`` (``serve/fleet.py``): the first K
  replica indices are prefill workers, the rest decode replicas.

Role codes mirror FAMILY_CODES: the flat ``serving`` map carries
ROLE_CODES[name]. The codec names import lazily (PEP 562): they need
torch, and the fleet router, which imports the transport from here,
imports no torch.
"""

from fms_fsdp_tpu_torch.serve.disagg.transport import (
    ChunkReceiver,
    ChunkSender,
    DataChannel,
    TransportError,
)

ROLE_UNIFIED = "unified"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLES = (ROLE_UNIFIED, ROLE_PREFILL, ROLE_DECODE)
ROLE_CODES = {ROLE_UNIFIED: 0, ROLE_PREFILL: 1, ROLE_DECODE: 2}

_LAZY = {
    "HandoffError": "fms_fsdp_tpu_torch.serve.disagg.handoff",
    "PAGE_CODEC_VERSION": "fms_fsdp_tpu_torch.serve.disagg.handoff",
    "WIRE_VERSION": "fms_fsdp_tpu_torch.serve.disagg.handoff",
    "check_codec_version": "fms_fsdp_tpu_torch.serve.disagg.handoff",
    "pack_handoff": "fms_fsdp_tpu_torch.serve.disagg.handoff",
    "unpack_handoff": "fms_fsdp_tpu_torch.serve.disagg.handoff",
    "SLAB_CODEC_VERSION": "fms_fsdp_tpu_torch.serve.disagg.slab",
}

__all__ = [
    "ChunkReceiver",
    "ChunkSender",
    "DataChannel",
    "HandoffError",
    "PAGE_CODEC_VERSION",
    "ROLES",
    "ROLE_CODES",
    "ROLE_DECODE",
    "ROLE_PREFILL",
    "ROLE_UNIFIED",
    "SLAB_CODEC_VERSION",
    "TransportError",
    "WIRE_VERSION",
    "check_codec_version",
    "pack_handoff",
    "unpack_handoff",
]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod), name)
