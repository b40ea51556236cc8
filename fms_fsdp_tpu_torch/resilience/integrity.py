"""Checkpoint manifests: file list + sizes + content checksums, written
at commit time and verified on load.

Counterpart of ``fms_fsdp_tpu/resilience/integrity.py``, kept byte for
byte in what it writes: both packages produce the same ``manifest.json``
for the same directory, and each verifies the other's. Here the files it
covers are a ``torch.distributed.checkpoint`` payload (``state/.metadata``
and ``state/__0_*.distcp``) instead of an Orbax one. The chunks of a
large file are hashed by several threads at once; the digests are those
of the JAX package's single pass.

A torn or bit-flipped checkpoint usually fails loudly only deep inside
the restore, or not at all. The manifest makes corruption detectable
before the restore: sizes catch truncation (the dominant torn-write
mode), checksums catch content corruption where a size coincidentally
matches.

Manifest versions:

- **version 1**: sizes for every file, sha256 for files at/below
  ``CHECKSUM_MAX_BYTES`` only. Version-1 manifests keep verifying
  (size-only for large files, with a note).
- **version 2**: additionally records **chunked sha256 digests** for
  every large file (``chunks[rel] = {chunk_bytes, digests[]}``), so a
  same-size corruption anywhere in a multi-GB payload file is caught and
  the failing CHUNK is named. Chunk digests are computed on the
  checkpoint manager's background writer (ckpt/manager.py
  ``_commit_tier_io``), so the blocking snapshot does not grow.
  ``write_manifest(full_checksums=False)`` (the ``ckpt_full_checksums``
  knob) drops the chunk records and degrades large files back to
  size-only verification.

Write ordering matters: the manifest lands BEFORE the ``metadata.json``
commit marker, so a save torn between the two leaves no marker and the
candidate is skipped by the scanners; a committed checkpoint always has
a verifiable manifest. Checkpoints without a manifest verify as
legacy-ok with a warning.

Verification also flags **unrecorded files**: a file present in the
checkpoint dir that the manifest never recorded is a problem. Only
``loader_state*`` files, the commit marker, the manifest itself, and the
``integrity_*`` sidecars (resilience/scrub.py) are exempt. A torn
``manifest.json`` is returned as a verification problem, never raised:
the restore fallback chain must walk past it.

Verification work is accounted: every verify adds its wall seconds and
any content-checksum detections to a buffered event window
(:func:`drain_integrity_events`).
"""

import hashlib
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

logger = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 2
# checksum files at/below this size whole (metadata, index structures);
# above it, files are "large": chunked digests under version 2, size
# only under version 1 / full_checksums=False
CHECKSUM_MAX_BYTES = 1 << 20
# chunk granularity for large-file digests: big enough that the digest
# list stays tiny next to the data (64 MiB -> 16 digests per GiB), small
# enough that a mismatch localizes the corruption usefully
CHUNK_BYTES = 1 << 26
# threads hashing the chunks of one large file
HASH_THREADS = min(8, os.cpu_count() or 1)

# files outside the manifest's scope: the commit marker is written after
# the manifest, loader state files are per-rank (another host may still
# be writing its own), the manifest itself, and the scrubber's verdict/
# quarantine sidecars (resilience/scrub.py) which land post-commit by
# design
_EXCLUDE_PREFIXES = (
    "metadata.json",
    MANIFEST_NAME,
    "loader_state",
    "integrity_",
)

# buffered verification events, drained into the obs registry at report
# cadence by the train loop (the scrubber thread and the load path both
# record here; the MetricRegistry itself is main-thread-only by
# contract)
_EVENTS_LOCK = threading.Lock()
_EVENTS = {"verify_s": 0.0, "shard_corrupt_detected": 0}


def record_integrity_event(verify_s: float = 0.0, corrupt: int = 0) -> None:
    with _EVENTS_LOCK:
        _EVENTS["verify_s"] += float(verify_s)
        _EVENTS["shard_corrupt_detected"] += int(corrupt)


def drain_integrity_events() -> Dict[str, float]:
    """Return-and-reset the buffered verification window."""
    global _EVENTS
    with _EVENTS_LOCK:
        out, _EVENTS = _EVENTS, {
            "verify_s": 0.0,
            "shard_corrupt_detected": 0,
        }
    return out


def _excluded(rel: str) -> bool:
    # exclusions match the file NAME anywhere in the tree (loader_state
    # and sidecars land at the top level today, but a rename-safe check
    # costs nothing): a path is exempt when its basename starts with an
    # excluded prefix
    return any(os.path.basename(rel).startswith(p) for p in _EXCLUDE_PREFIXES)


def _manifest_files(ckpt_dir: str) -> List[str]:
    out = []
    for root, _, files in os.walk(ckpt_dir):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), ckpt_dir)
            if _excluded(rel):
                continue
            out.append(rel)
    out.sort()
    return out


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 16), b""):
            h.update(block)
    return h.hexdigest()


def _digest_range(path: str, offset: int, nbytes: int) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        f.seek(offset)
        got = 0
        while got < nbytes:
            block = f.read(min(1 << 20, nbytes - got))
            if not block:
                break
            h.update(block)
            got += len(block)
    return h.hexdigest()


def _chunk_digests(path: str, chunk_bytes: int) -> List[str]:
    """Per-chunk sha256 hexdigests of ``path`` in ``chunk_bytes`` strides
    (last chunk short): the digests of the JAX package's single pass,
    computed by up to ``HASH_THREADS`` threads at once (hashlib releases
    the GIL), one chunk of 1 MiB reads each."""
    n = -(-os.path.getsize(path) // chunk_bytes)
    if n <= 1:
        return [_digest_range(path, 0, chunk_bytes)] if n else []
    with ThreadPoolExecutor(max_workers=min(n, HASH_THREADS)) as pool:
        return list(pool.map(
            lambda i: _digest_range(path, i * chunk_bytes, chunk_bytes), range(n)
        ))


def write_manifest(
    ckpt_dir: str,
    full_checksums: bool = True,
    chunk_bytes: int = CHUNK_BYTES,
) -> str:
    """Write a version-2 ``manifest.json`` covering every file under
    ``ckpt_dir`` (except the exclusions above): sizes for all, whole-file
    sha256 for small files, chunked sha256 for large files (omitted when
    ``full_checksums`` is off — the ``ckpt_full_checksums`` knob).
    Atomic via rename: a torn manifest write can never masquerade as a
    valid one.

    Called from the async manager's BACKGROUND writer (the blocking
    snapshot never pays the hashing) and from the synchronous save path
    (where the whole save is on the critical path anyway)."""
    files = {}
    checksums = {}
    chunks = {}
    for rel in _manifest_files(ckpt_dir):
        full = os.path.join(ckpt_dir, rel)
        try:
            size = os.path.getsize(full)
        except OSError:
            continue  # concurrently pruned; verification scopes what exists
        files[rel] = size
        if size <= CHECKSUM_MAX_BYTES:
            checksums[rel] = _sha256(full)
        elif full_checksums:
            chunks[rel] = {
                "chunk_bytes": int(chunk_bytes),
                "digests": _chunk_digests(full, int(chunk_bytes)),
            }
    manifest = {
        "version": MANIFEST_VERSION,
        "files": files,
        "checksums": checksums,
        "chunks": chunks,
    }
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def verify_manifest(
    ckpt_dir: str, content: bool = True
) -> Tuple[bool, List[str]]:
    """Check ``ckpt_dir`` against its manifest.

    Returns ``(ok, problems)``. A checkpoint with no manifest (written
    before this layer) is legacy-ok: ``(True, ["no manifest ..."])`` —
    the caller may log the note but must accept the checkpoint. A
    version-1 manifest (or a v2 written with full checksums off)
    verifies large files by size only, with a note appended when such
    files exist, so the caller can state exactly how much was checked.

    ``content=False`` runs the CHEAP half only — presence, sizes, and
    the unrecorded-file sweep, no hashing. This is the re-check behind a
    cached scrub verdict (resilience/scrub.py): the expensive content
    hashing is trusted from the verdict, but metadata reads cost nothing
    and still catch truncation/deletion that happened after the scrub.

    Any torn/invalid manifest — unreadable, non-JSON, or structurally
    wrong (a list where a dict belongs) — is returned as a verification
    PROBLEM, never raised: the restore fallback chain walks past it to
    the next-newest committed checkpoint instead of crashing the
    restore."""
    t0 = time.monotonic()
    try:
        return _verify_manifest(ckpt_dir, content)
    finally:
        record_integrity_event(verify_s=time.monotonic() - t0)


def _verify_manifest(
    ckpt_dir: str, content: bool = True
) -> Tuple[bool, List[str]]:
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.isfile(path):
        return True, [f"no manifest in {ckpt_dir} (pre-manifest checkpoint)"]
    try:
        with open(path) as f:
            manifest = json.load(f)
        version = int(manifest["version"])
        files = dict(manifest["files"])
        checksums = dict(manifest.get("checksums") or {})
        chunks = dict(manifest.get("chunks") or {})
        sizes = {rel: int(size) for rel, size in files.items()}
    except (OSError, ValueError, KeyError, TypeError, AttributeError) as e:
        # a torn manifest truncates to invalid JSON — or to VALID JSON of
        # the wrong shape (a bare list, files-as-list), which indexes or
        # int() above throw on. Either way it is a corrupt checkpoint,
        # reported as such so the fallback chain keeps walking.
        return False, [f"unreadable or malformed manifest {path}: {e!r}"]

    problems = []
    corrupt = 0
    size_only_large = 0
    for rel, size in sizes.items():
        full = os.path.join(ckpt_dir, rel)
        if not os.path.isfile(full):
            problems.append(f"missing file {rel}")
            continue
        actual = os.path.getsize(full)
        if actual != size:
            problems.append(f"size mismatch {rel}: {actual} != {size}")
            continue
        if not content:
            continue
        want = checksums.get(rel)
        if want is not None:
            if _sha256(full) != want:
                problems.append(f"checksum mismatch {rel}")
                corrupt += 1
            continue
        chunk_rec = chunks.get(rel)
        if chunk_rec is not None:
            try:
                chunk_bytes = int(chunk_rec["chunk_bytes"])
                want_digests = list(chunk_rec["digests"])
            except (KeyError, TypeError, ValueError):
                problems.append(f"malformed chunk record for {rel}")
                continue
            got = _chunk_digests(full, chunk_bytes)
            if got != want_digests:
                bad = next(
                    (
                        i
                        for i, (g, w) in enumerate(zip(got, want_digests))
                        if g != w
                    ),
                    min(len(got), len(want_digests)),
                )
                problems.append(
                    f"checksum mismatch {rel} (chunk {bad + 1}/"
                    f"{len(want_digests)}, offset {bad * chunk_bytes})"
                )
                corrupt += 1
        elif size > CHECKSUM_MAX_BYTES:
            size_only_large += 1

    # files on disk the manifest never recorded: a foreign/partial stray
    # in a committed dir must be visible, not silently restored around
    recorded = set(sizes)
    for rel in _manifest_files(ckpt_dir):
        if rel not in recorded:
            try:
                size = os.path.getsize(os.path.join(ckpt_dir, rel))
            except OSError:
                continue
            problems.append(
                f"unrecorded file {rel} ({size} bytes) not in manifest"
            )

    if corrupt:
        record_integrity_event(corrupt=corrupt)
    if problems:
        logger.warning(
            "checkpoint %s failed integrity verification: %s",
            ckpt_dir,
            "; ".join(problems[:5]),
        )
        return False, problems
    if size_only_large:
        # informational note on a PASSING verify (the legacy-ok
        # contract: ok=True with notes the caller may log)
        problems.append(
            f"manifest version {version} without full checksums: "
            f"{size_only_large} large file(s) verified by size only "
            f"(re-save with ckpt_full_checksums for content coverage)"
        )
    return True, problems
