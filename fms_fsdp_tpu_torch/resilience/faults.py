"""Deterministic fault injection at named sites.

Counterpart of ``fms_fsdp_tpu/resilience/faults.py``: the same spec
grammar, the same filters and the same ``times`` counting, so one
``FMS_FAULTS`` string injects the same faults into either package. Every
recovery path (shard-read retry and quarantine, loader worker restart,
the non-finite skip and abort, checkpoint-corruption fallback, the
watchdog, the preemption save) is testable on the CPU this way.

==================  ====================================================
site                fires where
==================  ====================================================
shard_read          ``RetryingShardHandler``, inside each retried
                    open/length/get/slice attempt (raises OSError)
loader_worker       the loader's thread and process workers and the
                    workerless path, after each produced batch (raises
                    RuntimeError, or hard-exits with ``action=exit``)
nan_loss            the train step: multiplies the loss and the
                    gradients by NaN for steps [``step``,
                    ``step + count``) of the state's step counter; read
                    once when the step is built (:func:`fault_params`)
ckpt_corrupt        after a save's commit marker: truncates one file of
                    the committed step dir (``file=<substring>``)
ckpt_shard_corrupt  after a save's commit marker: flips ``bytes=N``
                    (default 4) at the midpoint of the largest
                    manifest-recorded file matching ``file=``, size
                    unchanged; only content checksums or the scrubber
                    see it
ckpt_writer_crash   the async manager's writer thread, after the payload
                    write and before the commit (raises RuntimeError;
                    the next ``save``/``finalize`` re-raises it)
ckpt_precommit_kill the async manager's writer, between the manifest and
                    the ``metadata.json`` marker: hard-exits with
                    ``code`` (default ``injected_kill``), leaving a torn
                    dir that resume must skip
ckpt_durable_write  the async manager's per-tier commit IO, before the
                    manifest (raises OSError: the bounded retry absorbs
                    ``times=K``, an unbounded one degrades to the local
                    tier)
slice_kill          the loop's step boundary: hard-exits with ``code``
                    (default ``injected_kill``); on one process it kills
                    this process
dcn_reduce_stall    the same boundary: parks the process in a
                    ``seconds``-long sleep (default 3600), the hang the
                    step watchdog must turn into exit ``watchdog_stall``
corpus_kill         ``SamplingDataset``'s document boundaries and
                    re-probes: every shard of the named corpus dies at
                    once (``corpus=``, a substring)
==================  ====================================================

Sites of the JAX package that need a part the port has not yet are
refused when a spec names them (:data:`UNPORTED_SITES`), never silently
inert.

Spec strings: ``site[:key=value]*`` joined by ``;``, from the
``FMS_FAULTS`` environment variable or ``TrainConfig.faults``. Filters
``path`` / ``op`` / ``tier`` / ``corpus`` / ``transport`` match as
substrings, ``worker`` / ``batch`` / ``step`` / ``slice`` / ``proc`` /
``replica`` by equality; a filter the call site does not supply is a
non-match. ``times=N`` caps the fires per process. Everything else is
payload the call site reads. With no spec every hook is a dict lookup.
"""

import os
import threading
from typing import Any, Dict, Optional

_LOCK = threading.Lock()
# site -> params; None until first configure (lazy env read)
_SPECS: Optional[Dict[str, Dict[str, Any]]] = None
_FIRED: Dict[str, int] = {}

ENV_VAR = "FMS_FAULTS"

# params that filter whether a call-site context matches (vs payload)
_FILTER_KEYS = (
    "path", "op", "worker", "batch", "step", "tier", "slice", "corpus",
    "proc", "replica", "transport",
)

# sites of the JAX package whose call site the port does not have yet,
# and the ROADMAP.md item that brings it
UNPORTED_SITES = {
    "replica_kill": "A.10 (serving extensions: the fleet)",
    "replica_stall": "A.10 (serving extensions: the fleet)",
    "handoff_chunk_corrupt": "A.10 (serving extensions: the page handoff)",
    "handoff_chunk_drop": "A.10 (serving extensions: the page handoff)",
    "transport_stall": "A.10 (serving extensions: the page handoff)",
}


def _parse_value(v: str):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def parse_spec(spec: str) -> Dict[str, Dict[str, Any]]:
    """Parse ``site:key=val:key=val;site2:...`` into {site: params}."""
    out: Dict[str, Dict[str, Any]] = {}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        site, params = parts[0].strip(), {}
        for kv in parts[1:]:
            if not kv.strip():
                continue
            if "=" not in kv:
                raise ValueError(
                    f"fault clause {clause!r}: expected key=value, got {kv!r}"
                )
            k, v = kv.split("=", 1)
            params[k.strip()] = _parse_value(v.strip())
        out[site] = params
    return out


def check_spec(spec: Optional[str]) -> Dict[str, Dict[str, Any]]:
    """Parse ``spec`` and refuse a site the port has no call site for
    yet: ``NotImplementedError`` naming its ROADMAP.md item."""
    specs = parse_spec(spec) if spec else {}
    for site in specs:
        if site in UNPORTED_SITES:
            raise NotImplementedError(
                f"fault site {site!r} is not ported yet: ROADMAP.md "
                f"{UNPORTED_SITES[site]}"
            )
    return specs


def configure_faults(spec: Optional[str]) -> None:
    """(Re)configure the registry from a spec string; None or "" clears
    it (and suppresses the lazy env read)."""
    global _SPECS
    specs = check_spec(spec)
    with _LOCK:
        _SPECS = specs
        _FIRED.clear()


def _specs() -> Dict[str, Dict[str, Any]]:
    global _SPECS
    if _SPECS is None:
        specs = check_spec(os.environ.get(ENV_VAR, ""))
        with _LOCK:
            if _SPECS is None:
                _SPECS = specs
    return _SPECS


def fault_params(site: str) -> Optional[Dict[str, Any]]:
    """The raw configured params for ``site`` (no firing, no counters),
    for sites read once when something is built (``nan_loss``)."""
    return _specs().get(site)


def fire_fault(site: str, **ctx) -> Optional[Dict[str, Any]]:
    """Fire ``site`` if configured and the context matches its filters.
    Returns the params dict on fire (the call site interprets payload
    keys), else None."""
    params = _specs().get(site)
    if params is None:
        return None
    for key in _FILTER_KEYS:
        if key in params:
            if key not in ctx:
                # a filter the call site cannot evaluate is a non-match: a
                # typo must never degrade into firing everywhere
                return None
            want, got = params[key], ctx[key]
            if isinstance(want, str):
                if want not in str(got):
                    return None
            elif want != got:
                return None
    with _LOCK:
        times = params.get("times")
        if times is not None and _FIRED.get(site, 0) >= times:
            return None
        _FIRED[site] = _FIRED.get(site, 0) + 1
    return params


def maybe_raise_fault(site: str, exc_cls=OSError, **ctx) -> None:
    """Fire ``site`` and raise ``exc_cls`` when it matches."""
    params = fire_fault(site, **ctx)
    if params is not None:
        raise exc_cls(
            f"injected fault at site {site!r} (ctx={ctx}, params={params})"
        )
