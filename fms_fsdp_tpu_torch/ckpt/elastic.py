"""Elastic resume: topology fingerprinting and rescale legality.

Counterpart of ``fms_fsdp_tpu/ckpt/elastic.py``, with the same field set,
version and digest, so a ``metadata.json`` either package writes carries
the same ``"topology"`` stamp:

- ``current_fingerprint(cfg)`` builds the topology dict every checkpoint
  stamps into ``metadata.json`` under the ``"topology"`` key (both the
  synchronous ``Checkpointer.save`` and every ``AsyncCheckpointManager``
  tier);
- ``check_rescale(old, new)`` decides, *before* any restore is entered,
  whether the restart world can consume the checkpoint, returning
  actionable problems instead of letting the run die later in a shape
  error or a silently shifted document walk.

The field set is a cross-run contract (old checkpoints are read by new
code): changing it without bumping ``TOPOLOGY_VERSION`` changes
:func:`topology_digest` away from ``TOPOLOGY_DIGESTS``.

Policy: the *global* batch is preserved across a rescale; a rescale that
cannot preserve it, or an explicit batch/seq change, is a hard error
unless ``--allow_batch_change=True``. The port's world is one device
per process and one slice (multi-slice is ROADMAP.md A.6b).
"""

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

from fms_fsdp_tpu_torch.data.loader import parse_data_args

TOPOLOGY_VERSION = 3

# name -> type tag. The topology fingerprint stamped into every
# checkpoint's metadata.json (key "topology"). ``loader_files`` is the
# number of per-rank loader_state files the save wrote (0 when no
# dataloader rode along) == process_count * num_workers of the saving
# run; it is the world size the loader state reshards FROM.
#
# v2 adds the slice dims (multi-slice DCN meshes, parallel/mesh.py):
# ``num_slices`` (the dcn-axis extent / fault-domain count) and the
# per-slice process/device shape. The slice is the FAULT DOMAIN:
# ``check_rescale`` admits slice-count changes (a lost or regained
# slice) but pins the per-slice shape while multi-slice — capacity that
# comes back in different slice sizes must restart single-slice or
# matching. Old (v1) fingerprints lack the fields; they load with a
# note and skip the slice checks.
#
# v3 adds the data-mix dims (weighted multi-corpus mixing,
# data/streaming.py SamplingDataset): ``corpus_names`` is the comma-
# joined corpus list in config order ("" for dummy-data runs) and
# ``mix_weights_digest`` a digest of the normalized weight vector.
# ``check_rescale`` gates corpus-SET changes (per-corpus mix state pairs
# by name and cannot follow added/removed corpora without
# ``allow_corpus_change``) while weight changes and pure reorders stay
# legal with a note (``describe_mixing_change``). Pre-v3 fingerprints
# lack the fields and skip the mixing checks.
TOPOLOGY_FIELDS = {
    "process_count": "int",
    "device_count": "int",
    "tensor_parallel_size": "int",
    "context_parallel_size": "int",
    "global_batch_rows": "int",
    "seq_length": "int",
    "n_logical_shards": "int",
    "loader_files": "int",
    "num_slices": "int",
    "slice_process_count": "int",
    "slice_device_count": "int",
    "corpus_names": "str",
    "mix_weights_digest": "str",
}

# Digest of the canonical field serialization per published version; a
# mismatch for the CURRENT version means the fingerprint contract
# changed without a version bump (pinned in CI, tests/test_elastic.py).
TOPOLOGY_DIGESTS = {
    1: "a8d823b4a35b82fa1e2c91d376e485caf15a6f4558edfe0696426dd7ea129334",
    # v2: + num_slices / slice_process_count / slice_device_count (the
    # multi-slice fault-domain dims)
    2: "41468023883ed0cf352f1e808cef04a5b5788ecb5f44d8d033773ec6ba2b66fe",
    # v3: + corpus_names / mix_weights_digest (the weighted multi-corpus
    # mix joins the elastic contract)
    3: "ed18d2b2c9ee9fb0efbe627f52a36d77a96b44ccad180430c905df9772de179c",
}


def topology_digest() -> str:
    canon = json.dumps(
        {"version": TOPOLOGY_VERSION, "fields": TOPOLOGY_FIELDS},
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(canon.encode()).hexdigest()


def data_parallel_rows_extent(cfg, device_count: int) -> int:
    """Data-parallel extent (replica x fsdp x expert) the global batch
    spreads over — the mesh-free mirror of ``parallel.mesh.
    data_parallel_extent`` (every mesh axis not tensor/context carries
    batch rows)."""
    tp = max(1, int(getattr(cfg, "tensor_parallel_size", 1) or 1))
    cp = max(1, int(getattr(cfg, "context_parallel_size", 1) or 1))
    return max(1, device_count // tp // cp)


def _split_names(joined: str) -> List[str]:
    return [n for n in str(joined or "").split(",") if n]


def mixing_fingerprint(cfg) -> Tuple[str, str]:
    """The data-mix dims of the fingerprint: (comma-joined corpus names
    in config order, digest of the normalized weight vector). Dummy-data
    runs (no stateful loader) fingerprint as ("", "") and skip every
    mixing check."""
    if bool(getattr(cfg, "use_dummy_dataset", False)):
        return "", ""
    try:
        datasets, weights = parse_data_args(
            getattr(cfg, "datasets", ""), getattr(cfg, "weights", "1")
        )
    except (ValueError, TypeError):
        return "", ""
    total = float(sum(weights)) or 1.0
    canon = json.dumps(
        [round(w / total, 12) for w in weights], separators=(",", ":")
    )
    return ",".join(datasets), hashlib.sha256(canon.encode()).hexdigest()[:16]


def current_fingerprint(
    cfg, process_count: Optional[int] = None, device_count: Optional[int] = None
) -> Dict[str, int]:
    """The live world's topology fingerprint, from TrainConfig and the
    world the run trains on: the process group's size (1 without one),
    one device per process, one slice. ``loader_files`` is the EXPECTED
    per-rank loader state count (data-parallel ranks x num_workers, the
    processes x num_workers without a context axis; 0 when the run has no
    stateful loader): the save path substitutes 0 when no dataloader
    actually rides along."""
    from fms_fsdp_tpu_torch.utils.dist import world_size

    pc = world_size() if process_count is None else int(process_count)
    dc = pc if device_count is None else int(device_count)
    data_extent = data_parallel_rows_extent(cfg, dc)
    stateful_loader = not bool(getattr(cfg, "use_dummy_dataset", False))
    workers = max(1, int(getattr(cfg, "num_workers", 1) or 1))
    n_slices = 1
    corpus_names, weights_digest = mixing_fingerprint(cfg)
    return {
        "process_count": pc,
        "device_count": dc,
        "tensor_parallel_size": max(
            1, int(getattr(cfg, "tensor_parallel_size", 1) or 1)
        ),
        "context_parallel_size": max(
            1, int(getattr(cfg, "context_parallel_size", 1) or 1)
        ),
        "global_batch_rows": int(cfg.batch_size) * data_extent,
        "seq_length": int(cfg.seq_length),
        "n_logical_shards": int(getattr(cfg, "logical_shards", 0) or 0),
        "loader_files": data_extent * workers if stateful_loader else 0,
        "num_slices": n_slices,
        "slice_process_count": max(1, pc // n_slices),
        "slice_device_count": max(1, dc // n_slices),
        "corpus_names": corpus_names,
        "mix_weights_digest": weights_digest,
    }


def describe_change(old: Dict, new: Dict) -> str:
    """Compact "field: old -> new" summary of the differing fields."""
    parts = [
        f"{k}: {old.get(k)} -> {new.get(k)}"
        for k in TOPOLOGY_FIELDS
        if old.get(k) != new.get(k)
    ]
    return ", ".join(parts)


def stamp_topology(metadata: Dict, fingerprint: Optional[Dict], dataloader) -> Dict:
    """Stamp ``metadata["topology"]`` for a save (no-op without a
    fingerprint). Shared by the synchronous ``Checkpointer.save`` and
    every ``AsyncCheckpointManager`` tier so the stamped contract cannot
    fork between the two save paths: ``loader_files`` records what THIS
    save wrote (the expected count, not a listdir — peers' files may not
    be visible yet on shared storage), 0 when no dataloader rode along."""
    if fingerprint is not None:
        metadata["topology"] = dict(
            fingerprint,
            loader_files=(
                fingerprint.get("loader_files", 0)
                if dataloader is not None
                else 0
            ),
        )
    return metadata


def _count_loader_files(ckp_dir: str) -> int:
    try:
        return len(
            [f for f in os.listdir(ckp_dir) if f.startswith("loader_state")]
        )
    except OSError:
        return 0


def describe_mixing_change(old: Dict, new: Dict) -> Optional[str]:
    """Human note for LEGAL data-mix changes across a resume (printed by
    the load gate), or None when the mix is unchanged / unfingerprinted.
    Corpus-SET changes are not described here — they are gated as
    problems by ``check_rescale`` unless ``allow_corpus_change``."""
    old_names = _split_names(old.get("corpus_names"))
    new_names = _split_names(new.get("corpus_names"))
    if not old_names or not new_names:
        return None
    notes = []
    if old_names != new_names and set(old_names) == set(new_names):
        notes.append(
            "corpus order changed (harmless: per-corpus mix state pairs "
            "by name, not index)"
        )
    old_d = str(old.get("mix_weights_digest") or "")
    new_d = str(new.get("mix_weights_digest") or "")
    if old_d and new_d and old_d != new_d:
        notes.append(
            "mixing weights changed: the token-share controller steers "
            "toward the new targets from here (no stream position is "
            "lost)"
        )
    return "; ".join(notes) or None


def check_rescale(
    old: Dict,
    new: Dict,
    ckp_dir: Optional[str] = None,
    allow_batch_change: bool = False,
    allow_corpus_change: bool = False,
) -> Tuple[List[str], bool]:
    """Validate that the ``new`` world may consume a checkpoint stamped
    with ``old``. Returns ``(problems, changed)`` — ``problems`` is a
    list of actionable error strings (empty = legal), ``changed`` is
    True when any topology field differs (a legal elastic resume).

    Every check runs BEFORE the restore, so an illegal
    rescale fails fast on every host with the same message instead of
    deadlocking half the pod inside a collective. The caller is
    responsible for making the verdict collective (``_all_agree``) —
    the on-disk loader-file count below is a local observation that
    eventually-consistent shared storage could briefly split."""
    # what the state trains: a speculator entry stamps "speculator:<base
    # arch>" (speculator/train_speculator.py); a pretraining fingerprint
    # carries no "model" key. One never resumes as the other.
    old_model, new_model = old.get("model", "pretrain"), new.get("model", "pretrain")
    if old_model != new_model:
        return [
            f"the checkpoint holds a {old_model!r} train state and this run "
            f"trains {new_model!r}: point ckpt_save_path / ckpt_load_path "
            f"at a checkpoint of this kind of run"
        ], True
    changed = any(old.get(k) != new.get(k) for k in TOPOLOGY_FIELDS)
    if not changed:
        return [], False
    problems: List[str] = []

    # Slice fault-domain legality (docs/checkpointing.md "Elastic
    # resume", docs/resilience.md "Slice fault domains"): the slice is
    # the unit capacity is lost or regained in, so a changed SLICE COUNT
    # is legal (the batch policy recomputes via the global-batch rules
    # below; the loader walk reshards by fractional ownership exactly as
    # any other rescale) — but while both worlds are multi-slice the
    # PER-SLICE shape is pinned: an hsdp group / ICI collective layout
    # sized for one slice shape cannot silently absorb another, and a
    # rescale mixing both dims is almost always a mis-launched restart.
    # A single-slice restart (new num_slices == 1) escapes the pin: it
    # is governed by the ordinary process/device rules alone. Legacy v1
    # fingerprints carry no slice fields (all zeros) and skip this block
    # (the load gate prints a note).
    old_s = int(old.get("num_slices") or 0)
    new_s = int(new.get("num_slices") or 0)
    if old_s > 1 and new_s > 1:
        for field, unit in (
            ("slice_process_count", "process(es)"),
            ("slice_device_count", "device(s)"),
        ):
            ov, nv = int(old.get(field) or 0), int(new.get(field) or 0)
            if ov and nv and ov != nv:
                problems.append(
                    f"{field} changed across the rescale ({ov} -> {nv} "
                    f"{unit} per slice): the slice is the fault domain — "
                    f"rescale by whole slices of the saved shape "
                    f"({old.get('slice_process_count')} process(es) x "
                    f"{old.get('slice_device_count')} device(s); any "
                    f"slice count), or restart as a single slice "
                    f"(--num_slices=1) to rescale freely"
                )

    # Data-mix legality (v3, docs/dataloader.md "Multi-corpus mixing"):
    # per-corpus resume state pairs by NAME, so a changed corpus SET
    # (added/removed/renamed) cannot silently misassign another corpus's
    # walk position — it is gated behind allow_corpus_change. A pure
    # reorder or a weight change is legal (the gate prints the
    # describe_mixing_change note). Pre-v3 fingerprints carry no mix
    # fields and skip this block.
    old_corpora = _split_names(old.get("corpus_names"))
    new_corpora = _split_names(new.get("corpus_names"))
    if old_corpora and new_corpora and set(old_corpora) != set(new_corpora):
        if not allow_corpus_change:
            added = [n for n in new_corpora if n not in old_corpora]
            removed = [n for n in old_corpora if n not in new_corpora]
            problems.append(
                f"the corpus set changed across the resume (added: "
                f"{added or 'none'}, removed: {removed or 'none'}): "
                f"per-corpus mix state pairs by name and cannot follow "
                f"a changed set. Restart with "
                f"--datasets={','.join(old_corpora)}, or pass "
                f"--allow_corpus_change=True to accept it (removed "
                f"corpora drop their stream position; new corpora start "
                f"cold)"
            )

    old_logical = int(old.get("n_logical_shards") or 0)
    new_logical = int(new.get("n_logical_shards") or 0)
    if old_logical != new_logical:
        problems.append(
            f"n_logical_shards changed ({old_logical} -> {new_logical}): "
            f"the logical-shard count is fixed when the run first saves; "
            f"restart with --logical_shards={old_logical}"
        )

    old_lw = int(old.get("loader_files") or 0)
    new_lw = int(new.get("loader_files") or 0)
    if old_lw and new_lw and old_logical and old_logical % new_lw != 0:
        legal = [
            d
            for d in range(1, old_logical + 1)
            if old_logical % d == 0
        ]
        problems.append(
            f"new loader world {new_lw} (process_count x num_workers) does "
            f"not divide n_logical_shards {old_logical}; loader state "
            f"cannot be repartitioned. Legal process x worker products: "
            f"{legal} — adjust --num_workers (or the host count) to one "
            f"of them"
        )

    if old_lw and ckp_dir is not None:
        found = _count_loader_files(ckp_dir)
        # 0 on-disk files is legal: the loader resumes from its own
        # newest auto-save dir, not necessarily this model checkpoint
        if 0 < found < old_lw:
            problems.append(
                f"checkpoint {ckp_dir} holds {found} loader_state file(s) "
                f"but was written by {old_lw} loader rank(s); an elastic "
                f"resume needs every per-rank file to reassemble the "
                f"document walk — the checkpoint copy is incomplete"
            )

    old_rows = int(old.get("global_batch_rows") or 0)
    new_rows = int(new.get("global_batch_rows") or 0)
    if old_rows and new_rows and old_rows != new_rows and not allow_batch_change:
        problems.append(
            f"global batch would change across the rescale "
            f"({old_rows} -> {new_rows} rows), shifting tokens_seen, the "
            f"LR schedule, and the loss trajectory. Set --batch_size so "
            f"per-rank rows x data-parallel extent = {old_rows}, or pass "
            f"--allow_batch_change=True to accept the change"
        )

    old_seq = int(old.get("seq_length") or 0)
    new_seq = int(new.get("seq_length") or 0)
    if old_seq and new_seq and old_seq != new_seq and not allow_batch_change:
        problems.append(
            f"seq_length changed across the resume ({old_seq} -> "
            f"{new_seq}): tokens-per-step and the packed loader stream "
            f"both shift. Restart with --seq_length={old_seq}, or pass "
            f"--allow_batch_change=True to accept the change"
        )

    return problems, changed
