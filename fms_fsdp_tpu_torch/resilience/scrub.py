"""Checkpoint scrubber: background re-verification of committed
checkpoints, quarantine of corrupt ones, and a verdict cache keyed by
manifest digest.

Counterpart of ``fms_fsdp_tpu/resilience/scrub.py``:

- :class:`CheckpointScrubber` re-verifies every committed checkpoint of
  every tier at a step cadence (``scrub_interval_steps``) on a daemon
  thread, one sweep in flight; the loop pays a comparison;
- a checkpoint that fails verification is quarantined: an
  ``integrity_quarantine.json`` sidecar and one line naming the bad
  shard. ``Checkpointer._candidate_ckp_paths`` skips quarantined dirs,
  so a resume routes around the poison before a crash needs it;
- verdicts are cached by manifest digest (the ``integrity_scrub.json``
  sidecar and an in-process memo), so a restore walk that verifies the
  dirs a sweep already verified never re-hashes them;
- :func:`verified_resume_active` reads the ``FMS_VERIFIED_RESUME``
  policy the supervisor exports after a ``state_divergence`` exit.

The manifest itself is ``resilience/integrity.py``'s. The fleet CLI
(``scripts/scrub_checkpoints.py`` in the JAX package) is not ported.
"""

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from fms_fsdp_tpu_torch.resilience.integrity import (
    MANIFEST_NAME,
    verify_manifest,
)

VERDICT_NAME = "integrity_scrub.json"
QUARANTINE_NAME = "integrity_quarantine.json"
ENV_VERIFIED_RESUME = "FMS_VERIFIED_RESUME"
ENV_VERDICT_TTL = "FMS_SCRUB_VERDICT_TTL_S"
# Positive verdicts EXPIRE: the manifest digest keys the cache, but the
# digest only changes when the dir is re-written — bit-rot that lands
# AFTER a dir's first successful scrub leaves the manifest bytes (and
# the digest) untouched, so without a TTL the rot would hide behind the
# verdict forever, including under the verified-resume policy. A week
# default re-hashes each retained checkpoint once per TTL window —
# noise at fleet scale. 0 disables expiry.
VERDICT_TTL_S = 7 * 24 * 3600.0

# in-process verdict memo:
# (ckpt_dir) -> (manifest_digest, ok, problems, verified_unix).
# The topology scan and the restore walk both verify the same candidate
# list within one process — the second pass must be a dict lookup, not a
# terabyte re-hash. Keyed by the manifest digest so a re-written dir
# re-verifies; positive entries expire with the verdict TTL.
_MEMO_LOCK = threading.Lock()
_MEMO: Dict[str, Tuple[Optional[str], bool, List[str], float]] = {}
# checkpoints confirmed content-verified by this process (a sweep or a
# restore walk). _VERIFIED_TOTAL is the record's ``scrub_verified`` and
# is monotone: a re-committed dir leaves the set (its new bytes are
# unverified) but the confirmations already made stay counted.
_VERIFIED_DIRS: set = set()
_VERIFIED_TOTAL = 0


def _mark_verified(ckpt_dir: str) -> None:
    """Caller holds _MEMO_LOCK."""
    global _VERIFIED_TOTAL
    if ckpt_dir not in _VERIFIED_DIRS:
        _VERIFIED_DIRS.add(ckpt_dir)
        _VERIFIED_TOTAL += 1


def total_verified() -> int:
    with _MEMO_LOCK:
        return _VERIFIED_TOTAL


def reset_cache() -> None:
    """Drop the in-process memo and verified set (sidecar files on disk
    are untouched)."""
    global _VERIFIED_TOTAL
    with _MEMO_LOCK:
        _MEMO.clear()
        _VERIFIED_DIRS.clear()
        _VERIFIED_TOTAL = 0


def verified_resume_active() -> bool:
    """True when the supervisor demanded a verified resume (the
    ``state_divergence`` relaunch policy). Parsed as a boolean flag:
    ``FMS_VERIFIED_RESUME=0`` (an operator opting OUT during an
    incident, e.g. to force-restore the newest checkpoint) must
    disable the policy, not enable it."""
    val = os.environ.get(ENV_VERIFIED_RESUME, "")
    return val.strip().lower() not in ("", "0", "false", "no", "off")


def _verdict_ttl_s() -> float:
    try:
        raw = os.environ.get(ENV_VERDICT_TTL, "").strip()
        return float(raw) if raw else VERDICT_TTL_S
    except ValueError:
        return VERDICT_TTL_S


def _verdict_expired(verified_unix) -> bool:
    """True when a POSITIVE verdict is older than the TTL and must be
    re-earned by a full re-hash (failures never expire — they are
    routed around via the quarantine sidecar, not trusted)."""
    ttl = _verdict_ttl_s()
    if ttl <= 0:
        return False
    try:
        return (time.time() - float(verified_unix)) > ttl
    except (TypeError, ValueError):
        return True  # unreadable stamp: treat as expired, re-verify


def manifest_digest(ckpt_dir: str) -> Optional[str]:
    """sha256 of the manifest bytes, or None (legacy/no manifest). The
    cache key: any change to what the manifest records invalidates every
    cached verdict for the dir."""
    try:
        with open(os.path.join(ckpt_dir, MANIFEST_NAME), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None


def is_quarantined(ckpt_dir: str) -> bool:
    return os.path.isfile(os.path.join(ckpt_dir, QUARANTINE_NAME))


def quarantine_info(ckpt_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(ckpt_dir, QUARANTINE_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def quarantine_checkpoint(ckpt_dir: str, problems: List[str], report=print):
    """Write the quarantine sidecar and print the ONE actionable line
    naming the bad shard. Idempotent; the sidecar is excluded from the
    manifest's unrecorded-file check."""
    info = {
        "problems": list(problems)[:20],
        "manifest_digest": manifest_digest(ckpt_dir),
        "quarantined_unix": time.time(),
    }
    path = os.path.join(ckpt_dir, QUARANTINE_NAME)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(info, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only storage: the verdict memo still routes around it
    report(
        f"INTEGRITY: checkpoint {ckpt_dir} quarantined: "
        f"{problems[0] if problems else 'verification failed'} "
        f"(sidecar {QUARANTINE_NAME}; resume and the fallback chain "
        f"will skip this step dir)"
    )
    return path


def clear_integrity_sidecars(ckpt_dir: str) -> None:
    """Drop any verdict/quarantine sidecar (and the memo entry) for a
    step dir being (re)committed: a fallback resume that routed around a
    quarantined step N re-commits step N with FRESH content when it
    trains back past it, and the stale verdicts must not outlive the
    bytes they judged. Called by both save paths before the manifest is
    written."""
    with _MEMO_LOCK:
        _MEMO.pop(ckpt_dir, None)
        _VERIFIED_DIRS.discard(ckpt_dir)
    for name in (VERDICT_NAME, QUARANTINE_NAME):
        try:
            os.remove(os.path.join(ckpt_dir, name))
        except OSError:
            pass


def release_quarantine(ckpt_dir: str) -> bool:
    """Remove a quarantine marker (after an operator repaired the dir or
    accepts it). Both sidecars and the memo entry go, so the next walk
    re-verifies from scratch. False when there was no marker or its
    removal failed (then nothing was touched)."""
    path = os.path.join(ckpt_dir, QUARANTINE_NAME)
    if not os.path.isfile(path):
        return False
    try:
        os.remove(path)
    except OSError:
        return False
    with _MEMO_LOCK:
        _MEMO.pop(ckpt_dir, None)
        _VERIFIED_DIRS.discard(ckpt_dir)
    try:
        os.remove(os.path.join(ckpt_dir, VERDICT_NAME))
    except OSError:
        pass
    return True


def _read_verdict(ckpt_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(ckpt_dir, VERDICT_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _write_verdict(
    ckpt_dir: str,
    digest: Optional[str],
    verify_s: float,
    verified_at: Optional[float] = None,
):
    if digest is None:
        return  # legacy checkpoint: nothing content-verified to cache
    info = {
        "manifest_digest": digest,
        # the moment the content was ACTUALLY hashed — a memo-hit
        # persist (scan verified, sidecar write deferred to the walk)
        # must stamp the ORIGINAL hash time, not now, or the TTL clock
        # restarts without a byte having been re-read
        "verified_unix": time.time() if verified_at is None else verified_at,
        "verify_s": round(float(verify_s), 6),
    }
    path = os.path.join(ckpt_dir, VERDICT_NAME)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(info, f)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only storage: the in-process memo still has it


def cached_verify(
    ckpt_dir: str,
    write_sidecars: bool = False,
    report=print,
) -> Tuple[bool, List[str]]:
    """``verify_manifest`` behind the verdict cache.

    Order: quarantine sidecar -> verdict sidecar (digest match) ->
    in-process memo -> full verification. ``write_sidecars`` (rank 0
    only — sidecars live on shared storage) persists the outcome so no
    later walk, in this process or the next incarnation, re-hashes the
    same bytes: a fresh pass writes the verified marker, a failed pass
    quarantines the dir with the one actionable line."""
    if is_quarantined(ckpt_dir):
        info = quarantine_info(ckpt_dir) or {}
        first = (info.get("problems") or ["verification failed"])[0]
        return False, [f"quarantined checkpoint ({first})"]
    digest = manifest_digest(ckpt_dir)
    cached_ok = None
    have_sidecar = False
    # the moment the content was ACTUALLY hashed — carried forward on
    # every cache hit, NEVER refreshed by one: a hit that re-stamped
    # "now" would let a sweep cadence shorter than the TTL keep a
    # positive verdict alive forever, defeating the rot-detection
    # guarantee the TTL exists for
    verified_at = time.time()
    if digest is not None:
        verdict = _read_verdict(ckpt_dir)
        if (
            verdict is not None
            and verdict.get("manifest_digest") == digest
            and not _verdict_expired(verdict.get("verified_unix"))
        ):
            cached_ok = (True, [])
            have_sidecar = True
            try:
                verified_at = float(verdict.get("verified_unix"))
            except (TypeError, ValueError):
                pass  # unreadable stamp: _verdict_expired rejected it
        else:
            with _MEMO_LOCK:
                memo = _MEMO.get(ckpt_dir)
            # a POSITIVE memo entry expires exactly like the sidecar —
            # on a multi-week run rank 0's memo would otherwise mask
            # the TTL for the whole incarnation; negatives never expire
            # (they are dropped when their quarantine sidecar lands)
            if (
                memo is not None
                and memo[0] == digest
                and not (memo[1] and _verdict_expired(memo[3]))
            ):
                cached_ok = (memo[1], list(memo[2]))
                verified_at = memo[3]
    verify_s = 0.0
    if cached_ok is not None and cached_ok[0]:
        # the content hashing is trusted from the verdict/memo, but the
        # CHEAP half (presence/sizes/unrecorded sweep) is metadata reads
        # and re-runs every time: truncation or deletion AFTER the
        # verification must not hide behind the cache — only same-size
        # bit-rot relies on it, which is the documented cache contract
        # (a re-written manifest, i.e. a re-saved dir, invalidates it)
        ok, problems = verify_manifest(ckpt_dir, content=False)
        if ok:
            # keep the cached coverage notes (size-only large files):
            # a memo hit must report exactly what the original pass did
            problems = list(cached_ok[1])
    elif cached_ok is not None:
        ok, problems = cached_ok
    else:
        t0 = time.monotonic()
        ok, problems = verify_manifest(ckpt_dir)
        verify_s = time.monotonic() - t0
    # "verified" means CONTENT-verified: a pass that carries coverage
    # notes (v1 manifest / ckpt_full_checksums=False — large files
    # checked by size only) is accepted for loading but must not count
    # toward scrub_verified nor persist a verified verdict sidecar, or the
    # verified-resume policy would silently degrade to exactly the
    # trust-on-size restore it rules out.
    content_verified = ok and digest is not None and not problems
    # persistence runs for FRESH results and for memo hits alike: an
    # earlier walk without sidecars must not leave a corrupt checkpoint
    # detected-but-never-quarantined, nor a verified one without its
    # verdict sidecar. Only a verdict-sidecar hit skips the rewrite.
    with _MEMO_LOCK:
        _MEMO[ckpt_dir] = (digest, ok, list(problems), verified_at)
        if content_verified:
            _mark_verified(ckpt_dir)
    if write_sidecars:
        if content_verified and not have_sidecar:
            _write_verdict(ckpt_dir, digest, verify_s, verified_at)
        elif not ok and os.path.isfile(
            os.path.join(ckpt_dir, "metadata.json")
        ):
            # metadata.json gone means the retention GC is deleting the
            # dir under the sweep — a failure over vanishing files is
            # not corruption, and stamping a sidecar into a dir rmtree
            # is walking would make its final rmdir fail
            qpath = quarantine_checkpoint(ckpt_dir, problems, report=report)
            if os.path.isfile(qpath):
                # the sidecar is now the single source of truth for this
                # failure; dropping the memo lets an operator repair +
                # CLI --release (which removes the sidecar but cannot
                # reach this process's memo, and does not change the
                # manifest digest the memo is keyed on) trigger a TRUE
                # re-verify here instead of a stale-memo re-quarantine.
                # A stamp that failed (read-only storage) keeps the memo
                # — then it is the only record routing around the dir.
                with _MEMO_LOCK:
                    _MEMO.pop(ckpt_dir, None)
    return ok, problems


def scrub_checkpoint(ckpt_dir: str, report=print) -> Tuple[str, List[str]]:
    """One committed checkpoint: (status, problems) with status
    ``"verified"`` (content confirmed, freshly or from a matching cached
    verdict), ``"quarantined"`` (newly failed or already marked) or
    ``"legacy"`` (content not fully confirmable: no manifest, or large
    files recorded by size only)."""
    if is_quarantined(ckpt_dir):
        info = quarantine_info(ckpt_dir) or {}
        return "quarantined", list(info.get("problems") or [])
    if manifest_digest(ckpt_dir) is None:
        return "legacy", [f"no manifest in {ckpt_dir}"]
    ok, problems = cached_verify(ckpt_dir, write_sidecars=True, report=report)
    if not ok:
        return "quarantined", problems
    return ("verified" if not problems else "legacy"), problems


def committed_step_dirs(root: str) -> List[str]:
    """Committed step checkpoints under a ``checkpoints/`` root, newest
    first: the scrub population (torn dirs without a commit marker are
    the retention GC's, not the scrubber's)."""
    from fms_fsdp_tpu_torch.utils.ckpt_paths import (
        is_step_ckp,
        safe_listdir,
        step_number,
    )

    if not root or not os.path.isdir(root):
        return []
    out = [
        os.path.join(root, x)
        for x in safe_listdir(root)
        if is_step_ckp(os.path.join(root, x))
        and os.path.isdir(os.path.join(root, x))
        and "metadata.json" in safe_listdir(os.path.join(root, x))
    ]
    out.sort(key=step_number, reverse=True)
    return out


def scrub_roots(checkpointer) -> List[str]:
    """The checkpoint roots a live run scrubs: every tier of an
    ``AsyncCheckpointManager``, or a bare ``Checkpointer``'s own dir."""
    tiers = getattr(checkpointer, "tiers", None)
    if tiers:
        return [t.ckp.ckp_path for t in tiers]
    path = getattr(checkpointer, "ckp_path", None)
    return [path] if path else []


def scrub_pass(roots: List[str], report=print) -> Dict[str, int]:
    """One sweep over every committed checkpoint in ``roots``: counts per
    status. Cached verdicts make repeat sweeps near-free: only new
    commits hash bytes."""
    counts = {"verified": 0, "quarantined": 0, "legacy": 0}
    for root in roots:
        for ckpt_dir in committed_step_dirs(root):
            status, _ = scrub_checkpoint(ckpt_dir, report=report)
            counts[status] = counts.get(status, 0) + 1
    return counts


class CheckpointScrubber:
    """Step-cadence background scrubber the train loop drives.

    ``maybe_scrub(step)`` costs a comparison; when ``interval_steps``
    have passed since the last sweep it starts one on a daemon thread, at
    most one in flight (a slow sweep throttles itself to its own
    duration). Rank 0 only: the sidecars must have a single writer."""

    def __init__(self, roots: List[str], interval_steps: int, report=print):
        self.roots = [r for r in roots if r]
        self.interval_steps = max(0, int(interval_steps))
        self.report = report
        self.last_counts: Dict[str, int] = {}
        self._last_step: Optional[int] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.interval_steps > 0 and bool(self.roots)

    def maybe_scrub(self, step: int) -> bool:
        if not self.enabled:
            return False
        if self._last_step is not None and (
            step - self._last_step < self.interval_steps
        ):
            return False
        if self._thread is not None and self._thread.is_alive():
            return False  # the previous sweep is still running
        self._last_step = step
        self._thread = threading.Thread(
            target=self._sweep, name="ckpt-scrubber", daemon=True
        )
        self._thread.start()
        return True

    def _sweep(self) -> None:
        try:
            self.last_counts = scrub_pass(self.roots, report=self.report)
        except Exception as e:  # noqa: BLE001 — the scrubber must never
            # kill training; a failed sweep reports and retries at the
            # next cadence
            self.report(f"WARNING: checkpoint scrub sweep failed: {e!r}")

    def stop(self, timeout_s: float = 5.0) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout_s)
