"""Mamba slab handoff codec: the recurrent state's wire layout.

Counterpart of ``fms_fsdp_tpu/serve/disagg/slab.py``. Mamba's decode
state is not paged: per mamba layer it is a fixed-size slab slice (the
conv window in the compute dtype plus the fp32 SSD state) and, in hybrid
configs, ordinary KV pages for the attention layers. This module names
that state inside the same ``FMSH`` frame (``handoff.py``);
``MambaAdapter``'s handoff methods do the device reads and writes.

=====================  ================================================
leaf                   contents
=====================  ================================================
``slab.NNNN.conv``     layer NNNN's conv window row, shape
                       ``(d_conv-1, conv_dim)``, compute dtype
``slab.NNNN.ssd``      layer NNNN's SSD state row, shape
                       ``(nheads, headdim, d_state)``, always fp32
``kv.k`` / ``kv.v``    hybrid attention-layer pages, exactly the page
                       codec's leaves (hybrid configs only)
=====================  ================================================

The header carries ``codec="mamba_slab"`` + ``codec_version`` and the
slab geometry, so a mismatched receiver rejects at the door.
"""

from typing import Dict, Optional, Tuple

from fms_fsdp_tpu_torch.serve.disagg.handoff import HandoffError, check_codec_version

SLAB_CODEC_VERSION = 1

_SLAB_PREFIX = "slab."
_KV_PREFIX = "kv."
_PARTS = ("conv", "ssd")


def slab_leaf_name(layer: int, part: str) -> str:
    if part not in _PARTS:
        raise ValueError(f"unknown slab part {part!r}")
    return f"{_SLAB_PREFIX}{layer:04d}.{part}"


def pack_slab_leaves(layer_states: Dict[int, Dict], kv_arrays: Optional[Dict] = None) -> Dict:
    """Flatten per-layer slab rows (+ optional hybrid page leaves) into
    the flat leaf-name -> tensor dict ``pack_handoff`` expects."""
    arrays = {}
    for layer, parts in layer_states.items():
        if set(parts) != set(_PARTS):
            raise ValueError(f"layer {layer} has parts {sorted(parts)}, not {_PARTS}")
        for part in _PARTS:
            arrays[slab_leaf_name(layer, part)] = parts[part]
    for name, arr in (kv_arrays or {}).items():
        arrays[_KV_PREFIX + name] = arr
    return arrays


def split_slab_leaves(arrays: Dict) -> Tuple[Dict[int, Dict], Dict]:
    """The unpack half: flat leaves -> (per-layer slab rows, hybrid page
    leaves). An unrecognized name is a typed HandoffError: a frame from a
    different codec must not be half-applied."""
    layer_states: Dict[int, Dict] = {}
    kv: Dict = {}
    for name, arr in arrays.items():
        if name.startswith(_KV_PREFIX):
            kv[name[len(_KV_PREFIX):]] = arr
            continue
        if not name.startswith(_SLAB_PREFIX):
            raise HandoffError(
                f"slab frame carries unrecognized leaf {name!r} "
                f"(expected 'slab.NNNN.conv/ssd' or 'kv.*')"
            )
        rest = name[len(_SLAB_PREFIX):]
        try:
            layer_s, part = rest.split(".", 1)
            layer = int(layer_s)
        except ValueError:
            raise HandoffError(
                f"slab frame leaf {name!r} is not 'slab.NNNN.part'"
            ) from None
        if part not in _PARTS:
            raise HandoffError(
                f"slab frame leaf {name!r} names unknown part {part!r}"
            )
        layer_states.setdefault(layer, {})[part] = arr
    for layer, parts in layer_states.items():
        if set(parts) != set(_PARTS):
            raise HandoffError(
                f"slab frame layer {layer} ships {sorted(parts)}; "
                f"both of {_PARTS} are required"
            )
    return layer_states, kv


def check_slab_header(header: Dict, expected: Dict) -> None:
    """Raise a typed HandoffError for each geometry field where the frame
    and this replica disagree. ``expected`` is the receiving adapter's own
    geometry (same field names as the header)."""
    check_codec_version(header, "mamba_slab", SLAB_CODEC_VERSION)
    for field, mine in expected.items():
        if header.get(field) != mine:
            raise HandoffError(
                f"slab handoff {field}={header.get(field)!r} does not "
                f"match this replica's {field}={mine!r}: sending and "
                f"receiving replicas must share one model config and "
                f"ServeConfig"
            )
