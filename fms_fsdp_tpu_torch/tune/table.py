"""The schema-versioned JSON tuning table.

Counterpart of ``fms_fsdp_tpu/tune/table.py``, the same code with its own
committed document: ``fms_fsdp_tpu_torch/tune/kernel_tuning_h100.json``,
written on the card by ``scripts/torch_autotune_kernels.py``. One
document holds every tuned entry:

    {
      "schema_version": 1,
      "generated_by": "scripts/torch_autotune_kernels.py",
      "card": "NVIDIA H100 80GB HBM3, 700.00 W",
      "entries": [
        {"kernel": "flash_attention", "chip": "h100",
         "dtype": "bfloat16",
         "signature": {"batch": 2, "nq": 32, ...},
         "config": {"family": "resident", "block_q": 128, "block_k": 64},
         "source": "measured" | "cost_model",
         "measured_ms": <ms on the card> | null},
        ...
      ]
    }

Keys are (kernel, chip, dtype, canonical signature); the signatures are
JAX's (``tune/candidates.py``), so one document reads the same through
both packages. Top-level fields beside ``schema_version`` and
``entries`` (``generated_by``, ``card``) are free. ``source`` keeps the
table honest: cost-model-seeded entries are distinguishable from
measured winners, and the sweep only ever *upgrades* cost_model ->
measured, never the reverse.

Everything here is pure dict/JSON work -- no torch, no clock -- so
loading and lookup are deterministic on any host.
"""

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

TUNING_SCHEMA_VERSION = 1

KNOWN_KERNELS = (
    "flash_attention", "ssd", "fused_ce", "paged_decode", "dcn_bucket"
)

_REQUIRED_ENTRY_FIELDS = ("kernel", "chip", "dtype", "signature", "config")


def default_table_path() -> str:
    """The port's committed table, beside this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "kernel_tuning_h100.json")


def canonical_sig(sig: Dict[str, int]) -> str:
    return ",".join(f"{k}={int(v)}" for k, v in sorted(sig.items()))


def entry_key(kernel: str, chip: str, dtype: str,
              sig: Dict[str, int]) -> str:
    return "|".join((kernel, chip, str(dtype), canonical_sig(sig)))


def validate_table(doc) -> List[str]:
    """Return a list of violations (empty = valid)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["table document is not an object"]
    v = doc.get("schema_version")
    if v != TUNING_SCHEMA_VERSION:
        errs.append(
            f"schema_version {v!r} != {TUNING_SCHEMA_VERSION}"
        )
    entries = doc.get("entries")
    if not isinstance(entries, list):
        return errs + ["'entries' missing or not a list"]
    seen = set()
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            errs.append(f"entries[{i}] is not an object")
            continue
        for f in _REQUIRED_ENTRY_FIELDS:
            if f not in e:
                errs.append(f"entries[{i}] missing {f!r}")
        if e.get("kernel") not in KNOWN_KERNELS:
            errs.append(f"entries[{i}] unknown kernel {e.get('kernel')!r}")
        sig = e.get("signature")
        if not isinstance(sig, dict) or not all(
            isinstance(x, int) and not isinstance(x, bool)
            for x in sig.values()
        ):
            errs.append(f"entries[{i}] signature must be a str->int map")
            continue
        cfg = e.get("config")
        if not isinstance(cfg, dict):
            errs.append(f"entries[{i}] config must be an object")
            continue
        if e.get("source") not in ("measured", "cost_model"):
            errs.append(
                f"entries[{i}] source must be 'measured' or 'cost_model'"
            )
        k = entry_key(
            str(e.get("kernel")), str(e.get("chip")), str(e.get("dtype")), sig
        )
        if k in seen:
            errs.append(f"entries[{i}] duplicates key {k}")
        seen.add(k)
    return errs


def _sig_distance(a: Dict[str, int], b: Dict[str, int]) -> Optional[float]:
    """Log-space distance between two signatures; None when they are not
    comparable (different key sets)."""
    if set(a) != set(b):
        return None
    d = 0.0
    for k in a:
        x, y = max(1, int(a[k])), max(1, int(b[k]))
        hi, lo = (x, y) if x >= y else (y, x)
        # |log2(x/y)| without importing math: exact for the power-of-two
        # shapes we key on, monotone for everything else
        ratio = hi / lo
        while ratio >= 2.0:
            d += 1.0
            ratio /= 2.0
        d += ratio - 1.0
    return d


class TuningTable:
    """In-memory view of one table document with exact + nearest lookup."""

    def __init__(self, doc: Optional[Dict] = None, path: Optional[str] = None):
        self.doc = doc or {
            "schema_version": TUNING_SCHEMA_VERSION,
            "generated_by": "scripts/torch_autotune_kernels.py",
            "entries": [],
        }
        self.path = path
        self._index: Dict[str, Dict] = {}
        for e in self.doc.get("entries", []):
            try:
                self._index[
                    entry_key(e["kernel"], e["chip"], e["dtype"],
                              e["signature"])
                ] = e
            except (KeyError, TypeError, ValueError):
                continue  # validate_table reports these; lookup skips them

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path) as f:
            doc = json.load(f)
        errs = validate_table(doc)
        if errs:
            raise ValueError(
                f"invalid tuning table {path}: {errs[:5]}"
            )
        return cls(doc, path=path)

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        assert path, "no path to save the tuning table to"
        self.doc["entries"] = sorted(
            self.doc["entries"],
            key=lambda e: entry_key(
                e["kernel"], e["chip"], e["dtype"], e["signature"]
            ),
        )
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.doc, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    def add(self, kernel: str, chip: str, dtype: str, sig: Dict[str, int],
            config: Dict, source: str, measured_ms: Optional[float] = None,
            keep_measured: bool = True) -> None:
        """Insert or replace one entry. With ``keep_measured`` a
        cost_model write never clobbers an existing measured entry."""
        key = entry_key(kernel, chip, dtype, sig)
        old = self._index.get(key)
        if (
            old is not None
            and keep_measured
            and old.get("source") == "measured"
            and source != "measured"
        ):
            return
        entry = {
            "kernel": kernel,
            "chip": chip,
            "dtype": str(dtype),
            "signature": {k: int(v) for k, v in sig.items()},
            "config": config,
            "source": source,
            "measured_ms": measured_ms,
        }
        if old is not None:
            self.doc["entries"].remove(old)
        self.doc["entries"].append(entry)
        self._index[key] = entry

    def lookup(self, kernel: str, chip: str, dtype: str,
               sig: Dict[str, int]) -> Tuple[Optional[Dict], Optional[str]]:
        """(config, how) where how is "exact" | "nearest" | None.

        Nearest: the minimum log-space signature distance among entries
        for the same (kernel, chip, dtype) with a comparable signature;
        ties break on the canonical key so the answer never depends on
        file order. The caller re-validates legality for its shape."""
        e = self._index.get(entry_key(kernel, chip, str(dtype), sig))
        if e is not None:
            return dict(e["config"]), "exact"
        best = None
        for key, cand in sorted(self._index.items()):
            if not key.startswith(f"{kernel}|{chip}|{dtype}|"):
                continue
            d = _sig_distance(sig, cand["signature"])
            if d is None:
                continue
            if best is None or d < best[0]:
                best = (d, cand)
        if best is not None:
            return dict(best[1]["config"]), "nearest"
        return None, None
