"""PageHandoff: deterministic wire bytes for a sequence's decode state.

Counterpart of ``fms_fsdp_tpu/serve/disagg/handoff.py``, byte for byte:
a prefill engine packs a stream's restartable state (its KV pages in the
pool's STORAGE dtype plus the sampling state in the header), a decode
engine unpacks it and continues the stream. int8/fp8 pages ship as their
1-byte values plus the fp32 scale leaves, never widened.

Wire format (version 1, little-endian)::

    b"FMSH" | u16 version | u32 header_len | header JSON (canonical)
    | leaf bytes, in the header's leaf order | u32 crc32(everything
    before it)

The header JSON is canonical (sorted keys, no whitespace), leaves are
packed in sorted-name order and each leaf is its C-order storage bytes,
so two processes (or the two packages) packing the same state emit
identical bytes. The trailing CRC turns a torn transfer into a typed
:class:`HandoffError` at unpack.

Leaves are torch tensors. Their bytes go through a ``uint8`` view of the
storage, so bf16 and e4m3 leaves need no numpy dtype of their own (the
JAX codec types them through ``ml_dtypes``); the header names them
``"bfloat16"`` and ``"float8_e4m3fn"`` as JAX does. This module imports
torch and numpy only.
"""

import json
import struct
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

MAGIC = b"FMSH"
WIRE_VERSION = 1

# the family codec version carried inside the header (``codec`` /
# ``codec_version``): what the leaves mean for a family (page layout for
# llama/mixtral, slab layout for mamba)
PAGE_CODEC_VERSION = 1

# storage dtypes a leaf may ship in, by their wire name
_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "int8": torch.int8,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


class HandoffError(ValueError):
    """A handoff that cannot be applied: torn or corrupt wire bytes, a
    wire version this build does not speak, or pages packed for a
    different pool shape or quant than the receiving replica's."""


def check_codec_version(header: Dict, codec: str, version: int) -> None:
    """Raise a typed :class:`HandoffError` naming BOTH versions when a
    frame's family codec does not match what this replica speaks: version
    skew in a mixed-version fleet is a reject-and-requeue (the router
    re-prefills), never a crash-loop on the resume."""
    got_codec = header.get("codec")
    if got_codec != codec:
        raise HandoffError(
            f"handoff codec {got_codec!r} != this replica's {codec!r}: "
            f"the frame was packed by a different family/codec"
        )
    got = header.get("codec_version")
    if got != version:
        raise HandoffError(
            f"handoff codec version skew: frame carries {codec!r} "
            f"version {got!r}, this replica speaks version {version!r} "
            f"— mixed-version fleet; requeue for re-prefill and "
            f"upgrade the older replicas"
        )


def _dtype_name(name: str, t) -> str:
    dname = str(t.dtype).replace("torch.", "")
    if dname not in _DTYPES:
        raise HandoffError(
            f"leaf {name!r} has unshippable dtype {dname!r}: "
            f"expected one of {sorted(_DTYPES)}"
        )
    return dname


def _leaf_bytes(t) -> bytes:
    """C-order storage bytes of ``t`` (copied to the host)."""
    if isinstance(t, np.ndarray):
        return np.ascontiguousarray(t).tobytes()
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    return flat.view(torch.uint8).numpy().tobytes()


def pack_handoff(header: Dict, arrays: Dict[str, torch.Tensor]) -> bytes:
    """Pack ``arrays`` (leaf name -> tensor in its storage dtype; a numpy
    array of a plain dtype, as JAX's codec takes, packs the same) plus the
    caller's header fields into deterministic wire bytes. This function
    adds the leaf manifest."""
    header = dict(header)
    names = sorted(arrays)
    header["leaves"] = [
        {
            "name": name,
            "dtype": _dtype_name(name, arrays[name]),
            "shape": [int(s) for s in arrays[name].shape],
        }
        for name in names
    ]
    hj = json.dumps(header, sort_keys=True, separators=(",", ":")).encode("utf-8")
    parts = [MAGIC, struct.pack("<HI", WIRE_VERSION, len(hj)), hj]
    parts += [_leaf_bytes(arrays[name]) for name in names]
    body = b"".join(parts)
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def unpack_handoff(data: bytes) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """Wire bytes -> (header, leaf tensors on the CPU in their recorded
    storage dtype). Every structural check is a typed
    :class:`HandoffError`; the round trip with :func:`pack_handoff` is
    bit-exact."""
    if len(data) < 14 or data[:4] != MAGIC:
        raise HandoffError(
            "not a PageHandoff: bad magic (torn transfer or a "
            "non-handoff payload on the resume channel)"
        )
    (crc,) = struct.unpack_from("<I", data, len(data) - 4)
    if crc != (zlib.crc32(data[:-4]) & 0xFFFFFFFF):
        raise HandoffError(
            "PageHandoff checksum mismatch: the transfer was torn or "
            "corrupted in flight — reject and let the router requeue"
        )
    version, hlen = struct.unpack_from("<HI", data, 4)
    if version != WIRE_VERSION:
        raise HandoffError(
            f"PageHandoff wire version {version} != {WIRE_VERSION}: "
            f"mixed-version fleet — upgrade the older replicas"
        )
    off = 10
    try:
        header = json.loads(data[off:off + hlen].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise HandoffError(f"PageHandoff header unparseable: {e}") from None
    off += hlen
    arrays: Dict[str, torch.Tensor] = {}
    for leaf in header.get("leaves", []):
        dtype = _DTYPES.get(leaf["dtype"])
        if dtype is None:
            raise HandoffError(
                f"leaf {leaf['name']!r} carries dtype {leaf['dtype']!r} "
                f"this build cannot decode"
            )
        shape = tuple(int(s) for s in leaf["shape"])
        count = int(np.prod(shape))
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        if off + nbytes > len(data) - 4:
            raise HandoffError(
                f"leaf {leaf['name']!r} overruns the payload "
                f"(truncated transfer)"
            )
        # an aligned copy of the leaf's bytes, viewed as its dtype
        raw = np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=off).copy()
        arrays[leaf["name"]] = torch.from_numpy(raw).view(dtype).reshape(shape)
        off += nbytes
    if off != len(data) - 4:
        raise HandoffError(
            f"{len(data) - 4 - off} trailing byte(s) after the last "
            f"leaf: header/payload disagree"
        )
    return header, arrays
