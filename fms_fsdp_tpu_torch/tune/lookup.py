"""Tile resolution: table -> nearest -> static defaults.

Counterpart of ``fms_fsdp_tpu/tune/lookup.py``, with the port's table
(``tune/table.py::default_table_path``) and cost model
(``tune/candidates.py``, the Hopper kernels'). The mode/table/chip are
module state resolved ONCE per step build (and once per engine build) via
:func:`configure_kernel_tuning`, as ``set_kernel_variant`` is
(``ops/flash_attention.py``). The env defaults (read once at import):

- ``FMS_KERNEL_TUNING``   -- "auto" | "off" | /path/to/table.json
- ``FMS_KERNEL_TUNING_TABLE`` -- table path override (mode stays auto)
- ``FMS_TUNE_CHIP``       -- chip-kind override ("h100", ...) for lookup

Resolution is pure table + cost model -- no timing, no clock -- so CPU
runs are deterministic. Without a CUDA device the chip kind is "cpu";
the committed table carries only "h100" entries, so CPU runs take the
static defaults unless a test or operator names the chip.

Chosen configs are recorded as ``kernel.tune.*`` gauges/counters once a
MetricRegistry is attached (``obs/observer.py::build_observer`` attaches
the Observer's), and :func:`choices` exposes them to ``chip_smoke.py``.
"""

import functools
import logging
import os
from typing import Dict, Optional, Tuple

from fms_fsdp_tpu_torch.tune import candidates as cand
from fms_fsdp_tpu_torch.tune.table import TuningTable, default_table_path

logger = logging.getLogger(__name__)

_VALID_MODES = ("auto", "off")


def _env_default() -> Tuple[str, Optional[str]]:
    mode = os.environ.get("FMS_KERNEL_TUNING", "auto")
    path = os.environ.get("FMS_KERNEL_TUNING_TABLE") or None
    if mode not in _VALID_MODES:
        if os.sep in mode or mode.endswith(".json"):
            # a path value means "auto, against this table"
            return "auto", mode
        # fail loud: a typo'd value silently resolving to defaults would
        # mislabel every benchmark run under it (same contract as
        # FLASH_KERNEL_VARIANT)
        raise ValueError(
            f"FMS_KERNEL_TUNING={mode!r}: expected 'auto' | 'off' | "
            f"/path/to/table.json"
        )
    return mode, path

_ENV_MODE, _ENV_TABLE = _env_default()
_ENV_CHIP = os.environ.get("FMS_TUNE_CHIP") or None

_MODE = _ENV_MODE
_TABLE_PATH = _ENV_TABLE
_CHIP = _ENV_CHIP
# True when the active table path was named by the operator (config/env)
# rather than the committed default — an unusable explicit table FAILS
# LOUD (same contract as a typo'd FMS_KERNEL_TUNING), while a missing
# committed default just falls back to the static tiles
_TABLE_EXPLICIT = _ENV_TABLE is not None

_TABLE_CACHE: Dict[str, Optional[TuningTable]] = {}
_CHOICES: Dict[str, Dict] = {}
_REGISTRY = None
_DEGRADED_WARNED = set()
_ILLEGAL_WARNED = set()
# answers of once_per_build, keyed by the caller
_RESOLVED: Dict = {}


def configure_kernel_tuning(mode: Optional[str] = None,
                            table_path: Optional[str] = None,
                            chip: Optional[str] = None) -> None:
    """Apply TrainConfig.kernel_tuning when a step (or engine) is built.

    ``mode``: "auto" | "off" | a table path (implies auto); None
    restores the import-time env default — so every step build resolves
    tuning deterministically from its own config, never inheriting a
    forcing left by an earlier build in the same process. Also clears
    the per-build choice record (``chip_smoke.py`` reads it per run) and the table
    cache (a table regenerated at the same path is re-read by the next
    build). An explicitly named table that fails to load raises here —
    a run labeled as tuned against a table it never read would mislabel
    every benchmark under it."""
    global _MODE, _TABLE_PATH, _CHIP, _TABLE_EXPLICIT
    if mode is None:
        _MODE, _TABLE_PATH = _ENV_MODE, _ENV_TABLE
        _TABLE_EXPLICIT = _ENV_TABLE is not None
    elif mode in _VALID_MODES:
        _MODE, _TABLE_PATH = mode, (table_path or _ENV_TABLE)
        _TABLE_EXPLICIT = table_path is not None or _ENV_TABLE is not None
    elif os.sep in mode or mode.endswith(".json"):
        _MODE, _TABLE_PATH = "auto", mode
        _TABLE_EXPLICIT = True
    else:
        raise ValueError(
            f"kernel_tuning={mode!r}: expected 'auto' | 'off' | "
            f"/path/to/table.json"
        )
    if table_path:
        _TABLE_PATH = table_path
        _TABLE_EXPLICIT = True
    _CHIP = chip if chip is not None else _ENV_CHIP
    _CHOICES.clear()
    _TABLE_CACHE.clear()
    _RESOLVED.clear()
    if _MODE != "off" and _TABLE_EXPLICIT:
        _table()  # fail loud NOW if the named table is unusable


def once_per_build(key, resolve):
    """``resolve()``'s answer for ``key``, computed at its first call after
    a configure and kept until the next: an eager op that resolves its
    tiles on every call records them (and counts its ``how``) once per
    build, as JAX's trace-time resolution does."""
    if key not in _RESOLVED:
        _RESOLVED[key] = resolve()
    return _RESOLVED[key]


def tuning_mode() -> str:
    return _MODE


def attach_registry(registry) -> None:
    """Wire a MetricRegistry (the Observer's) in; choices recorded
    before the attach are replayed so build-before-attach ordering does
    not lose gauges."""
    global _REGISTRY
    _REGISTRY = registry
    if registry is not None:
        for name, rec in _CHOICES.items():
            for k, v in rec.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    registry.gauge(f"kernel.tune.{name}.{k}").set(v)


def choices() -> Dict[str, Dict]:
    """Configs resolved since the last configure (for chip_smoke.py/tests)."""
    return {k: dict(v) for k, v in _CHOICES.items()}


def _record(name: str, rec: Dict) -> None:
    _CHOICES[name] = rec
    if _REGISTRY is not None:
        for k, v in rec.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                _REGISTRY.gauge(f"kernel.tune.{name}.{k}").set(v)
        _REGISTRY.counter(f"kernel.tune.{rec.get('how', 'default')}").add()


def chip_kind() -> str:
    """Chip key for table lookup: the FMS_TUNE_CHIP/configure override,
    else "h100" for a card whose name says H100, "cpu" without CUDA, and
    the card's name in lower case with underscores otherwise."""
    return _CHIP or _detected_chip()


@functools.lru_cache(maxsize=1)
def _detected_chip() -> str:
    """The process's card, asked once (the ops resolve at every call)."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name()
    if "H100" in name:
        return "h100"
    return name.lower().replace(" ", "_")


def _table() -> Optional[TuningTable]:
    path = _TABLE_PATH or default_table_path()
    if path not in _TABLE_CACHE:
        try:
            _TABLE_CACHE[path] = TuningTable.load(path)
        except (OSError, ValueError) as e:
            if _TABLE_EXPLICIT:
                # operator named this table: defaults-with-a-warning
                # would silently mislabel the run as tuned
                raise ValueError(
                    f"kernel tuning table {path} unusable: {e}"
                ) from e
            logger.warning("kernel tuning table %s unusable: %s", path, e)
            _TABLE_CACHE[path] = None
    return _TABLE_CACHE[path]


def _lookup(kernel: str, sig: Dict[str, int], dtype: str,
            chip: Optional[str]) -> Tuple[Optional[Dict], str]:
    """(config, how) with legality re-checked against THIS shape; an
    illegal table config (stale entry, nearest mismatch) falls through
    to the defaults rather than asking a kernel for a tile it lacks."""
    chip = chip or chip_kind()
    tab = _table()
    if tab is None:
        return None, "default"
    config, how = tab.lookup(kernel, chip, str(dtype), sig)
    if config is None:
        return None, "default"
    if not cand.config_legal(kernel, config, sig, str(dtype), chip):
        # once per shape: the ops resolve at every call, not once per trace
        key = (kernel, how, chip, str(dtype), tuple(sorted(sig.items())))
        if key not in _ILLEGAL_WARNED:
            _ILLEGAL_WARNED.add(key)
            logger.warning(
                "tuning table %s entry for %s %s is illegal for this shape; "
                "using defaults", how, kernel, sig,
            )
        return None, "default"
    return config, how


# ---------------------------------------------------------------------------
# per-kernel resolvers (called from the ops, the step and the engine)
# ---------------------------------------------------------------------------


_FLASH_QUANT_CODE = {"none": 0, "int8": 1, "fp8": 2}


def resolve_flash(q_shape, k_shape, dtype: str,
                  requested_q: Optional[int] = None,
                  requested_k: Optional[int] = None,
                  requested_variant: Optional[str] = None,
                  requested_quant: Optional[str] = None,
                  chip: Optional[str] = None,
                  ) -> Tuple[int, int, Optional[str], Optional[str], str]:
    """(block_q, block_k, family, quant, how) for one attention call,
    public (B, S, N, H) layout.

    Explicitly requested pieces are always honored (callers passing
    block sizes -- the sweep, tests -- pin them); only unset pieces
    consult the table. With tuning off the static defaults fill the gaps:
    the kernels' tiles before the tuner (128 x 128 for 16-bit inputs, the
    fp32 kernels' one 64 x 64 tile).

    ``quant`` is the quantized-family selection (None | "int8" | "fp8"):
    a table entry carrying a ``quant`` field turns the q/k wire on for
    this call. The resolved mode is exported as the
    ``kernel.tune.flash.quant_code`` gauge (0/1/2) alongside the string
    in :func:`choices`."""
    sig = cand.flash_sig(q_shape, k_shape)
    pinned = requested_q is not None and requested_k is not None
    if str(dtype) == "float32":
        default_q = default_k = cand.FLASH_FP32_BLOCK
    else:
        default_q, default_k = cand.FLASH_DEFAULT_BLOCK_Q, cand.FLASH_DEFAULT_BLOCK_K
    bq = requested_q or default_q
    bk = requested_k or default_k
    fam = requested_variant
    qnt = requested_quant
    # "off" = tuning disabled; "pinned" = the caller named the tiles
    # (tuning may be on) — the record must never claim tuning was off
    # when the mode was auto
    how = "pinned" if (_MODE != "off" and pinned) else "off"
    if _MODE != "off" and not pinned:
        config, how = _lookup("flash_attention", sig, dtype, chip)
        if config is not None:
            if requested_q is None:
                bq = int(config.get("block_q", bq))
            if requested_k is None:
                bk = int(config.get("block_k", bk))
            if fam is None:
                fam = config.get("family")
            if qnt is None:
                qnt = config.get("quant")
    _record(
        "flash",
        {
            "block_q": bq,
            "block_k": bk,
            "kvgrid": 1 if fam == "kvgrid" else 0,
            "quant": qnt or "none",
            "quant_code": _FLASH_QUANT_CODE.get(qnt or "none", 0),
            "how": how,
            "seq_k": sig["seq_k"],
        },
    )
    return bq, bk, fam, qnt, how


def record_final_flash_blocks(block_q: int, block_k: int,
                              kvgrid: Optional[bool] = None) -> None:
    """Patch the last flash record with what actually runs --
    _pick_block can change the resolved request,
    and the kernel family may come from the sequence-length rule rather
    than the table (fam=None out of resolve_flash), so flash_attention
    calls this after both decisions land. The perf record's contract is
    to state the tiles AND family that produced it."""
    rec = _CHOICES.get("flash")
    if rec is None:
        return
    kv = rec["kvgrid"] if kvgrid is None else int(kvgrid)
    if (rec["block_q"], rec["block_k"], rec["kvgrid"]) == (
        block_q, block_k, kv
    ):
        return
    rec = dict(rec, block_q=block_q, block_k=block_k, kvgrid=kv)
    _CHOICES["flash"] = rec
    if _REGISTRY is not None:
        _REGISTRY.gauge("kernel.tune.flash.block_q").set(block_q)
        _REGISTRY.gauge("kernel.tune.flash.block_k").set(block_k)
        _REGISTRY.gauge("kernel.tune.flash.kvgrid").set(kv)


def resolve_ssd_chunk(x_shape, groups: int, dstate: int, dtype: str,
                      requested: int, chip: Optional[str] = None) -> int:
    """Chunk length L for one SSD scan. ``requested`` is the config's
    value (MambaConfig.chunk_size): when it still holds the static
    default the table may override it; a NON-default value is an
    explicit operator choice and pins — same contract as resolve_flash's
    requested blocks (turning tuning fully off is not required to force
    one knob)."""
    sig = cand.ssd_sig(x_shape, groups, dstate)
    default = min(cand.SSD_DEFAULT_CHUNK, sig["seq"])
    pinned = int(requested) != default
    L, how = int(requested), "off"
    if _MODE != "off":
        if pinned:
            how = "pinned"
        else:
            config, how = _lookup("ssd", sig, dtype, chip)
            if config is not None:
                L = int(config["chunk"])
    L = min(L, sig["seq"])
    _record("ssd", {"chunk": L, "how": how, "seq": sig["seq"]})
    return L


def resolve_paged_decode(batch: int, nq: int, nkv: int, head: int,
                         max_seq: int, dtype: str,
                         requested_page_size: Optional[int] = None,
                         requested_block_kv: Optional[int] = None,
                         chip: Optional[str] = None,
                         ) -> Tuple[int, int, str]:
    """(page_size, block_kv, how) for the serving engine's paged decode
    (ops/paged_attention.py). Resolved ONCE at engine build -- page size
    shapes the allocator's pool, so unlike the per-call flash blocks it
    can never change under a live cache. Same pinning contract as
    resolve_flash: explicitly requested values are honored (ServeConfig
    .page_size != 0 pins), only unset pieces consult the table, and the
    static defaults fill the gaps with tuning off — pure table +
    cost-model work, no timing."""
    sig = cand.paged_decode_sig(batch, nq, nkv, head, max_seq)
    pinned = requested_page_size is not None
    ps = requested_page_size or cand.PAGED_DEFAULT_PAGE_SIZE
    bkv = requested_block_kv or ps
    if pinned and max_seq % ps != 0:
        # fail loud: silently halving an OPERATOR-pinned page size would
        # build a different allocator than the one the config names
        # (same contract as an unusable explicit tuning table)
        raise ValueError(
            f"ServeConfig.page_size={ps} does not divide "
            f"max_seq_len={max_seq}; pick a dividing page size or leave "
            f"it 0 for table resolution"
        )
    how = "pinned" if (_MODE != "off" and pinned) else "off"
    if _MODE != "off" and not pinned:
        config, how = _lookup("paged_decode", sig, dtype, chip)
        if config is not None:
            ps = int(config.get("page_size", ps))
            bkv = int(config.get("block_kv", ps))
    # the per-sequence capacity must stay page-aligned whatever the
    # table or static default said (a nearest-signature hit, re-checked
    # as it is, can still differ from this max_seq's divisors)
    while max_seq % ps != 0 and ps > 1:
        ps //= 2
        bkv = ps
    _record(
        "paged",
        {"page_size": ps, "block_kv": bkv, "how": how, "max_seq": max_seq},
    )
    return ps, bkv, how


def resolve_ce_chunk(d_model: int, vocab: int, dtype: str,
                     requested: int, chip: Optional[str] = None) -> int:
    """Logits-chunk size for the fused lm-head+CE; ``requested`` is
    TrainConfig.loss_chunk_size. Same pinning contract as
    resolve_ssd_chunk: the table only overrides the static default — an
    operator-set value (e.g. a smaller tile to fit HBM) wins."""
    sig = cand.ce_sig(d_model, vocab)
    pinned = int(requested) != cand.CE_DEFAULT_CHUNK
    c, how = int(requested), "off"
    if _MODE != "off":
        if pinned:
            how = "pinned"
        else:
            config, how = _lookup("fused_ce", sig, dtype, chip)
            if config is not None:
                c = int(config["chunk"])
    _record("ce", {"chunk": c, "how": how, "vocab": sig["vocab"]})
    return c


def resolve_dcn_bucket(grad_mb: int, leaves: int, slices: int,
                       wire_bytes: int, requested: int = 0,
                       chip: Optional[str] = None) -> int:
    """Bucket size (MB of wire bytes) for the overlapped cross-host
    gradient reduction (JAX's parallel/overlap.py; the port's caller comes
    with ROADMAP.md A.6b), resolved once per step build.

    Same pinning contract as resolve_ce_chunk: ``requested`` is
    TrainConfig.dcn_bucket_mb — nonzero is an explicit operator choice
    and wins over the table; 0 consults the table (exact -> nearest ->
    the cost model's pick over the candidate sizes, so even a tableless
    host gets a bytes-on-wire/DCN-bandwidth-reasoned size rather than a
    blind constant)."""
    sig = cand.dcn_bucket_sig(grad_mb, leaves, slices, wire_bytes)
    pinned = int(requested) != 0
    mb, how = int(requested) or cand.DCN_BUCKET_DEFAULT_MB, "off"
    chip_key = chip or chip_kind()
    if _MODE != "off":
        if pinned:
            how = "pinned"
        else:
            config, how = _lookup("dcn_bucket", sig, "bfloat16", chip)
            if config is not None:
                mb = int(config["bucket_mb"])
            else:
                # cost-model fallback: cheapest modeled exposed latency
                # among the candidate sizes (pure host arithmetic)
                cands = cand.dcn_bucket_candidates(sig, "bfloat16", chip_key)
                if cands:
                    mb = min(cands, key=lambda c: c["cost_us"])["bucket_mb"]
    _record(
        "dcn_bucket",
        {"bucket_mb": mb, "how": how, "grad_mb": sig["grad_mb"],
         "slices": sig["slices"], "wire_bytes": sig["wire_bytes"]},
    )
    return mb


# ---------------------------------------------------------------------------
# degradation signal for _pick_block (ops/flash_attention.py)
# ---------------------------------------------------------------------------


def note_block_degradation(kind: str, seq: int, requested: int,
                           resolved: int) -> None:
    """Called when divisibility halving degraded a block below half the
    requested size (e.g. seq 2944 @ 512 -> 128): count it in the obs
    registry and warn once per (kind, seq, requested) — a silent 4x tile
    shrink is an MFU cliff nobody sees otherwise."""
    if _REGISTRY is not None:
        _REGISTRY.counter("kernel.tune.block_degraded").add()
        _REGISTRY.gauge(f"kernel.tune.block_degraded_{kind}").set(resolved)
    key = (kind, seq, requested)
    if key not in _DEGRADED_WARNED:
        _DEGRADED_WARNED.add(key)
        logger.warning(
            "flash block_%s degraded %d -> %d for seq %d (divisibility "
            "halving); consider a tuned table entry or an aligned "
            "sequence length", kind, requested, resolved, seq,
        )
