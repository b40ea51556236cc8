"""The versioned metrics-record schema shared by every sink.

Counterpart of ``fms_fsdp_tpu/obs/schema.py``: the same fields, version
and digest, so one reader serves both packages' ``metrics.jsonl``. One
record is emitted per report step. ``SCHEMA_FIELDS`` is the contract:
field name -> (type tag, required). Changing the field set or a type
without bumping ``SCHEMA_VERSION`` breaks the pinned digest in
``SCHEMA_DIGESTS``; the JAX package owns the schema's evolution, and a
test holds this copy to it.

Type tags: ``int`` / ``float`` (``null`` allowed only where required is
False) / ``str`` / ``map`` (flat str->number dict). Field names keep the
JAX package's words (``tokens_per_sec_per_chip`` is per card here).
"""

import hashlib
import json
import numbers
from typing import Any, Dict, List

SCHEMA_VERSION = 15

# name -> (type, required)
SCHEMA_FIELDS = {
    "schema_version": ("int", True),
    "step": ("int", True),
    "time_unix": ("float", True),
    # nullable: a report window whose every step was non-finite has no
    # finite loss to state (null, never a bare NaN in the JSON)
    "loss": ("float", False),
    "grad_norm": ("float", False),
    "learning_rate": ("float", False),
    "tokens_seen": ("int", False),
    "tokens_per_sec_per_chip": ("float", True),
    "tokens_per_sec_per_chip_overall": ("float", False),
    "step_time_s": ("float", False),
    "mfu": ("float", False),
    "hfu": ("float", False),
    "data_wait_s": ("float", True),
    "data_wait_frac": ("float", True),
    "compute_s": ("float", True),
    # the blocking part of a save at the step boundary (the snapshot
    # under the async manager), and the writer thread's seconds that
    # landed in this window with a flag for a save still committing
    "checkpoint_s": ("float", True),
    "checkpoint_bg_s": ("float", True),
    "checkpoint_in_flight": ("int", True),
    # the multi-slice collective split and DCN overlap: 0.0 on one card
    "ici_collective_s": ("float", True),
    "dcn_collective_s": ("float", True),
    "dcn_overlap_frac": ("float", True),
    "wall_s": ("float", True),
    "goodput": ("float", True),
    "goodput_overall": ("float", False),
    "skipped_steps": ("int", True),
    "skipped_steps_window": ("int", True),
    # "<corpus>.<stat>": tokens_seen / target_share / realized_share /
    # quarantined per corpus of the live mixing layer; null on dummy data
    # and with process workers
    "data_mix": ("map", False),
    # manifest verification seconds of the window, the cumulative count
    # of content-verified checkpoints and of cross-replica compares
    "integrity_verify_s": ("float", True),
    "scrub_verified": ("int", True),
    "divergence_checks": ("int", True),
    # serving-engine and serving-fleet maps; null on training runs
    "serving": ("map", False),
    "serving_fleet": ("map", False),
    # the supervisor's restart ledger: relaunches before this incarnation
    # and their cumulative downtime (charged against goodput)
    "restarts": ("int", True),
    "restart_downtime_s": ("float", True),
    "kernel_tuning": ("str", False),
    "quantized_matmuls": ("str", False),
    "quantized_reduce": ("str", False),
    "memory_reserved_bytes": ("int", False),
    "memory_allocated_bytes": ("int", False),
    "extra": ("map", False),
}

# Digest of the canonical field serialization for each published version
# (the JAX package's table)
SCHEMA_DIGESTS = {
    1: "01cf2035086946667a852893e38535f44bd340e20871a10be2d6f4103cd62f90",
    2: "6fe196571d7fdf02da2dc0060f5151ddbcee7fae5275ad45277c0bce95be49c8",
    3: "f040074f56e65a7aef0e33bb7281fd38b6f1941115ee5e862412962b5f5c2a84",
    4: "488f2ccf06394fbc05445c7134628520fef64de1cd61a1bd6bf44000bd1ee66e",
    5: "5b3a957aa5736c7bce67ed7650ee3f5dc6fc322bc1edb85409dcc4653eddb011",
    6: "beafaf1c7f6338ad6693fe16ce1b2c4403c5447e3135e12b3776d5494864b8ce",
    7: "fed0cc09460e2c7da58cf4519e40e8d4e0ff6c25874b65fbd9d0e7f44ff83af9",
    8: "96ce592c9a1e990018a24d93757370679c594bfac64269b225cd2ff635ee4a3e",
    9: "178c0ec2d1d31834a0ae939d0df6e734ce66665f0dfccb662ab97dcc5fcc4e12",
    10: "864cdd64b4d6f3fa3dd7e24c3e0a18f42ae118f56965c32fbfb2f0a847f7287a",
    11: "3fa631fc73a3499c0515780e834069bd2874861a64e3bab5bd14770fdb45d513",
    12: "30df6d1be6e3214a083627b8cbb8a765d7c7e51aef6bdf4eca8fe469d13e5881",
    13: "598cbb44447e0667b8655a5b06dc569b2e00b33f748561f2d2ec6d365600418d",
    14: "2f8909a62cde9d1cdfd1d4153c219e37d8f16b8011a7f3dca7feeb5ebb2a567a",
    15: "72f5816eded0eb4caa3a834f60eb0dc10db1a31772699bf81af6c0c40665b38a",
}


def schema_digest() -> str:
    canon = json.dumps(
        {"version": SCHEMA_VERSION, "fields": SCHEMA_FIELDS},
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(canon.encode()).hexdigest()


def _type_ok(tag: str, v: Any) -> bool:
    if tag == "int":
        return isinstance(v, numbers.Integral) and not isinstance(v, bool)
    if tag == "float":
        return isinstance(v, numbers.Real) and not isinstance(v, bool)
    if tag == "str":
        return isinstance(v, str)
    if tag == "map":
        return isinstance(v, dict) and all(
            isinstance(k, str)
            and (v[k] is None or isinstance(v[k], numbers.Real))
            for k in v
        )
    return False


def validate_record(rec: Dict[str, Any]) -> List[str]:
    """Return a list of violations (empty = valid). Checks: required
    fields present and non-null, all present fields well-typed, no
    fields outside the schema, version matches."""
    errs = []
    if rec.get("schema_version") != SCHEMA_VERSION:
        errs.append(
            f"schema_version {rec.get('schema_version')!r} != {SCHEMA_VERSION}"
        )
    for name, (tag, required) in SCHEMA_FIELDS.items():
        if name not in rec or rec[name] is None:
            if required:
                errs.append(f"missing required field {name!r}")
            continue
        if not _type_ok(tag, rec[name]):
            errs.append(f"field {name!r}={rec[name]!r} is not a {tag}")
    for name in rec:
        if name not in SCHEMA_FIELDS:
            errs.append(f"unknown field {name!r} (bump SCHEMA_VERSION?)")
    return errs
