"""Model/optimizer checkpointing of the port's train state.

Counterpart of ``fms_fsdp_tpu/utils/checkpointing.py`` (itself the
replacement of the reference ``Checkpointer``,
ref:fms_fsdp/utils/checkpointing_utils.py:65-316), keeping its observable
contract:

- directory layout ``<ckpdir>/checkpoints/step_N_ckp/`` with
  ``state/`` (the payload), ``manifest.json`` and ``metadata.json`` (the
  commit marker: step, tokens_seen, skipped_steps, topology), the same
  keys as the JAX package writes;
- ``load`` prefers a checkpoint in the save directory (a restarted job
  resumes itself, ref:checkpointing_utils.py:203-206), falling back to
  the provided path (continued pretraining) with step/stat reset;
- each candidate is manifest-verified and a torn or corrupt newest
  checkpoint falls back to the next-newest committed one;
- single-file checkpoints (a pickle of params) load params only;
- rolling retention of the newest ``n_to_save`` step checkpoints (ordered
  by the step number in the name), and a quiesce-gated GC of torn and
  loader-only step dirs;
- the ``ckpt_corrupt`` and ``ckpt_shard_corrupt`` fault sites
  (resilience/faults.py) after every commit marker, of this class's save
  and of the async manager's writer alike.

The payload is ``torch.distributed.checkpoint`` (DCP) with
``FileSystemWriter`` / ``FileSystemReader``, keys as in ``ckpt/state.py``
(the JAX train state's tree paths). With a process group up, DCP runs
over the gloo groups of ``utils/dist.py::aux_group``: every rank writes its own
parts (``state/__<rank>_<i>.distcp``), each leaf split over fsdp, tensor
or expert as a ``DTensor`` (``parallel/sharding.py::DataParallel.dcp_view``:
a Mixtral expert leaf and its Adam moments cut along E), a replicated
leaf once; rank 0 writes ``state/.metadata``, and after a
barrier the manifest and the commit marker. DCP reshards on load, as
Orbax does for JAX, so a checkpoint of one world loads into another.
The multi-process agreement of the JAX package runs here too: rank 0's
directory scan is broadcast (``_broadcast_obj``) and every fallback
verdict is a collective AND (``_all_agree``). Orbax payloads of the JAX
package are not read here; a JAX state reaches the port through
``bridge.py``.
"""

import json
import os
import pickle
import shutil
import time
import warnings
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from fms_fsdp_tpu_torch.ckpt.state import (
    apply_scalars,
    checkpoint_state,
    flatten,
    unflatten,
)
from fms_fsdp_tpu_torch.utils.ckpt_paths import (
    get_latest,
    get_oldest,
    is_step_ckp,
    safe_listdir,
    step_number,
)
from fms_fsdp_tpu_torch.utils.dist import world_size
from fms_fsdp_tpu_torch.utils.tree import tree_map

STATE_DIR = "state"
# payload files written at once (``state/__0_<i>.distcp``)
WRITE_THREADS = 4


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def _dist_kwargs(use: str) -> Dict:
    """DCP's process arguments: the gloo group ``use`` beside the step's
    (``utils/dist.py::aux_group``) when a process group is up, else one
    process without one."""
    from fms_fsdp_tpu_torch.utils.dist import aux_group

    group = aux_group(use)
    return {"no_dist": True} if group is None else {"process_group": group}


def dcp_payload(flat: Dict[str, torch.Tensor], dp=None) -> Dict:
    """``flat`` as DCP takes it: under a sharded ``dp`` each split leaf's
    local part wrapped as a ``DTensor`` (no copy), else ``flat``."""
    if dp is not None and dp.sharded:
        return dp.dcp_view(flat)
    return flat


def write_state(path: str, flat: Dict) -> None:
    """The DCP payload of ``flat`` (host or card tensors, or
    :func:`dcp_payload`'s DTensors) into ``path``: ``WRITE_THREADS``
    files written at once by each rank, each synced. A collective when a
    process group is up. No copy-ahead: DCP's overlapping loader would
    synchronize the card's stream from the calling thread, and the async
    manager's writer hands it host tensors only."""
    dcp = _dcp()
    writer = dcp.FileSystemWriter(path, thread_count=WRITE_THREADS,
                                  per_thread_copy_ahead=0)
    with warnings.catch_warnings():
        # DCP says it assumes a single process when no group is up: it is
        warnings.filterwarnings("ignore", message=".*single process.*")
        dcp.save(flat, storage_writer=writer, **_dist_kwargs("writer"))


def read_state(path: str, flat: Dict[str, torch.Tensor], dp=None,
               local: bool = False) -> None:
    """Load the keys of ``flat`` from the DCP payload at ``path`` into
    ``flat``'s tensors, in place (this rank's parts under a sharded
    ``dp``, whatever world wrote the payload); a collective unless
    ``local`` (one process reading whole tensors). Raises when a key is
    missing."""
    dcp = _dcp()
    flat = dcp_payload(flat, dp)
    kwargs = {"no_dist": True} if local else _dist_kwargs("host")
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        dcp.load(flat, storage_reader=dcp.FileSystemReader(path), **kwargs)


def _payload_tensors(path: str, prefix: str):
    """{key: (shape, dtype)} and the payload bytes of the keys under
    ``prefix`` in the DCP metadata at ``path``."""
    reader = _dcp().FileSystemReader(path)
    meta = reader.read_metadata()
    head = prefix + "."
    shapes = {}
    for key, md in meta.state_dict_metadata.items():
        if key.startswith(head):
            shapes[key] = (tuple(md.size), md.properties.dtype)
    nbytes = sum(info.length for index, info in meta.storage_data.items()
                 if index.fqn in shapes)
    return shapes, nbytes


def _to_tensors(tree):
    """A pickled params tree (numpy leaves, as the JAX package and
    ``bridge.params_to_numpy`` write them, or tensors) as CPU tensors."""

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.array(a, copy=True))

    return tree_map(leaf, tree)


def _newest_committed(load_path: str) -> str:
    """The newest step dir under a ``checkpoints/`` folder holding a
    COMMITTED model checkpoint (``metadata.json`` is written last):
    loader-only auto-save dirs and torn mid-save dirs are both skipped."""
    latest = get_latest(
        load_path,
        qualifier=lambda p: is_step_ckp(p)
        and os.path.isdir(p)
        and "metadata.json" in safe_listdir(p),
        key=step_number,
    )
    assert latest is not None, f"no checkpoint under {load_path}"
    return latest


def load_params_only(load_path: str, with_bytes: bool = False):
    """Load just the model params from a training checkpoint (the serving
    and converter path): a params pickle, a step_N_ckp dir, or a
    checkpoints/ folder. Returns the params tree as CPU tensors in the
    dtype they were saved in, and with ``with_bytes`` also the payload
    bytes read.

    Only the ``params.*`` keys are read: the optimizer moments and
    counters are never materialized, so this reads about a third of a
    checkpoint's bytes. The tree's structure comes from the payload's
    own metadata."""
    if os.path.isfile(load_path):
        with open(load_path, "rb") as f:
            payload = pickle.load(f)
        params = _to_tensors(payload.get("model_state", payload))
        return (params, os.path.getsize(load_path)) if with_bytes else params
    state_dir = os.path.join(load_path, STATE_DIR)
    if not os.path.isdir(state_dir):
        state_dir = os.path.join(_newest_committed(load_path), STATE_DIR)
    shapes, nbytes = _payload_tensors(state_dir, "params")
    flat = {key: torch.empty(shape, dtype=dtype) for key, (shape, dtype) in shapes.items()}
    read_state(state_dir, flat, local=True)
    params = unflatten(flat, "params")
    return (params, nbytes) if with_bytes else params


def scan_topology(candidates, verify=True):
    """The topology fingerprint stamped into the newest loadable
    checkpoint of ``candidates`` (a newest-first ``_candidate_ckp_paths``
    list), or None. Single-file checkpoints carry no metadata; a torn
    ``metadata.json`` or (with ``verify``) a failed manifest check falls
    through to the next candidate, the chain ``load`` walks, so the batch
    policy decided from this scan matches the checkpoint a restore reads."""
    from fms_fsdp_tpu_torch.resilience.scrub import (
        cached_verify,
        verified_resume_active,
    )

    for cand in candidates:
        if os.path.isfile(cand):
            break  # single-file checkpoints carry no metadata
        if (verify or verified_resume_active()) and not cached_verify(cand)[0]:
            continue  # load() will reject it and fall back too
        try:
            with open(os.path.join(cand, "metadata.json")) as f:
                return json.load(f).get("topology")
        except (OSError, ValueError):
            continue  # torn metadata: the next candidate may do
    return None


def _merge_into(target, loaded, strict: bool):
    """Copy ``loaded`` (a params tree) into ``target``'s tensors in place,
    so every view of them (the optimizer's per-layer leaves) sees it.
    strict=True requires identical structure; strict=False takes
    matching keys and keeps target leaves for anything missing (torch
    load_state_dict(strict=False) analog)."""
    if isinstance(target, dict):
        if strict and set(target) != set(loaded):
            raise KeyError(f"params keys differ: {sorted(set(target) ^ set(loaded))}")
        for k, v in target.items():
            if k in loaded:
                _merge_into(v, loaded[k], strict)
        return
    if isinstance(target, (list, tuple)):
        if strict and len(target) != len(loaded):
            raise KeyError(f"{len(loaded)} layers for {len(target)}")
        for t, l in zip(target, loaded):
            _merge_into(t, l, strict)
        return
    if loaded is not None:
        with torch.no_grad():
            target.copy_(_to_tensors(loaded))


class Checkpointer:
    """Manages the checkpoint directory: rolling saves, resume detection,
    directory checkpoints or single-file (params pickle) loads."""

    # minimum local seconds a stale loader auto-save dir must hold an
    # unchanged mtime across cleanup passes before it is pruned
    PRUNE_QUIESCE_S = 60.0

    # the train loop attaches its Observer here: save() wall time lands in
    # the "checkpoint" phase and the save counters in its registry
    observer = None

    def __init__(
        self,
        ckpdir: str,
        n_to_save: int,
        parallel_mode: str,
        rank: int = None,
        report_fn=None,
        verify: bool = True,
        full_checksums: bool = True,
    ):
        self.max_ckps = n_to_save
        self.rank = 0 if rank is None else rank
        # verify per-checkpoint manifests on load and fall back to the
        # next-newest committed checkpoint on corruption
        self.verify = verify
        # manifest v2 full-content coverage: chunked checksums for large
        # payload files (the ckpt_full_checksums knob)
        self.full_checksums = bool(full_checksums)
        self.ckp_path = os.path.join(ckpdir, "checkpoints/")
        os.makedirs(self.ckp_path, exist_ok=True)
        assert parallel_mode in ["fsdp", "hsdp", "ddp", "tp"]
        self.p_mode = parallel_mode
        self.report = self._selective_print if report_fn is None else report_fn
        # loader-only prune candidates awaiting quiescence: path ->
        # (newest mtime when marked, local time when marked)
        self._prune_marks: dict = {}
        # elastic resume (ckpt/elastic.py): the live world's topology
        # fingerprint, stamped into every metadata.json by save() and
        # checked against the checkpoint's stamp by load(). None stamps
        # nothing and skips the gate; the entry points always set one.
        self.fingerprint: dict = None
        self.allow_batch_change = False
        self.allow_corpus_change = False

    def _selective_print(self, *args, **kwargs):
        if self.rank == 0:
            print(*args)
            for k, v in kwargs.items():
                print(k, "=", v)

    def set_fingerprint(
        self,
        fingerprint,
        allow_batch_change: bool = False,
        allow_corpus_change: bool = False,
    ):
        """Arm the elastic-resume contract: ``fingerprint`` (a
        ``ckpt/elastic.py`` topology dict for the LIVE world) is stamped
        into every save's metadata.json and compared against the
        checkpoint's stamp on load."""
        self.fingerprint = dict(fingerprint) if fingerprint else None
        self.allow_batch_change = bool(allow_batch_change)
        self.allow_corpus_change = bool(allow_corpus_change)

    def resume_topology(self, candidates=None):
        """The topology fingerprint stamped into the checkpoint a resume
        from the save dir would restore, or None (fresh start, legacy or
        single-file checkpoint). Rank 0's read is broadcast, so every
        process resolves the same elastic batch policy before building its
        loader. ``candidates`` lets the tiered manager pass its merged
        newest-first list."""
        from fms_fsdp_tpu_torch.utils.dist import world_size

        if candidates is None:
            candidates = self._candidate_ckp_paths(self.ckp_path)
        topo = scan_topology(candidates, verify=self.verify)
        if world_size() > 1:
            topo = self._broadcast_obj({"topo": topo})["topo"]
        return topo

    def _elastic_gate(self, load_path, meta):
        """Validate the checkpoint's topology stamp against the live
        fingerprint BEFORE the restore: an illegal rescale fails fast
        with an actionable error. No-op when topologies match, when
        either side carries no fingerprint, or on single-file
        checkpoints."""
        from fms_fsdp_tpu_torch.ckpt.elastic import (
            check_rescale,
            describe_change,
            describe_mixing_change,
        )

        if self.fingerprint is None:
            return
        topo = (meta or {}).get("topology")
        if topo is None:
            self.report(
                f"Note: checkpoint {load_path} predates topology "
                f"fingerprints; skipping the elastic-resume "
                f"compatibility check."
            )
            return
        if "num_slices" not in topo and "num_slices" in self.fingerprint:
            self.report(
                f"Note: checkpoint {load_path} predates slice-aware "
                f"topology fingerprints (no slice fields); slice "
                f"fault-domain checks are skipped for this resume."
            )
        problems, changed = check_rescale(
            topo,
            self.fingerprint,
            ckp_dir=load_path,
            allow_batch_change=self.allow_batch_change,
            allow_corpus_change=self.allow_corpus_change,
        )
        if not self._all_agree(not problems):
            raise RuntimeError(
                f"elastic resume from {load_path} is not legal for this "
                f"world ({describe_change(topo, self.fingerprint) or 'peer report'}):\n- "
                + "\n- ".join(problems or ["a peer process rejected the rescale"])
            )
        if changed:
            self.report(
                f"Elastic resume: restart topology differs from the "
                f"save topology ({describe_change(topo, self.fingerprint)}); "
                f"model/optimizer reshard onto the live world and loader "
                f"state reshards across the new ranks."
            )
            mix_note = describe_mixing_change(topo, self.fingerprint)
            if mix_note:
                self.report(f"Elastic resume mixing note: {mix_note}")

    # -- path resolution ----------------------------------------------------

    def _candidate_ckp_paths(self, path):
        """All loadable checkpoints under ``path``, newest first: a file
        or committed step dir resolves to itself; a checkpoint folder
        resolves to its committed step entries ordered by step number,
        quarantined dirs (resilience/scrub.py) left out. The fallback
        chain for corrupt-restore recovery walks this list."""
        if not path or not os.path.exists(path):
            return []
        if os.path.isfile(path):
            return [path]
        entries = os.listdir(path)
        if "metadata.json" in entries:
            return [path]
        from fms_fsdp_tpu_torch.resilience.scrub import is_quarantined

        candidates = sorted(
            (
                os.path.join(path, x)
                for x in entries
                if is_step_ckp(os.path.join(path, x))
            ),
            key=step_number,
            reverse=True,
        )
        return [
            cand
            for cand in candidates
            if os.path.isfile(cand)
            or (
                "metadata.json" in safe_listdir(cand)
                and not is_quarantined(cand)
            )
        ]

    def _broadcast_obj(self, obj):
        """Process 0's small picklable ``obj`` on every process."""
        from fms_fsdp_tpu_torch.utils.dist import broadcast_obj

        return broadcast_obj(obj)

    def _all_agree(self, ok: bool) -> bool:
        """Collective AND of a per-process verdict (on the gloo group
        beside the step's). Fallback decisions must be identical on every
        process: the DCP restore is collective, so two processes restoring
        different candidates would hang the world (or assemble a
        mixed-step state). A world of one returns the local verdict."""
        from fms_fsdp_tpu_torch.utils.dist import all_agree

        return all_agree(ok)

    # -- cleanup ------------------------------------------------------------

    def _cleanup(self):
        """Rolling retention: delete the oldest saved step checkpoints
        beyond max_ckps, by the step number in the name (copied trees do
        not keep ctime). Then the quiesce-gated GC of non-model step
        dirs: loader-only auto-save dirs beyond the newest two, and torn
        (uncommitted) model saves."""
        if self.rank != 0:
            return None

        def is_model_ckp(p):
            return is_step_ckp(p) and (
                os.path.isfile(p) or "metadata.json" in safe_listdir(p)
            )

        # the quota counts MODEL checkpoints only: loader auto-save dirs
        # (loader_state files, no metadata.json) share the folder
        while (
            len(
                [
                    x
                    for x in os.listdir(self.ckp_path)
                    if is_model_ckp(os.path.join(self.ckp_path, x))
                ]
            )
            > self.max_ckps
        ):
            oldest = get_oldest(
                self.ckp_path, qualifier=is_model_ckp, key=step_number
            )
            if oldest is None:
                break
            ckp_to_remove = Path(oldest)
            if os.path.isfile(ckp_to_remove):
                ckp_to_remove.unlink()
            else:
                try:
                    shutil.rmtree(ckp_to_remove)
                except OSError:
                    # a verdict/quarantine sidecar stamped between
                    # rmtree's scan and its final rmdir (ENOTEMPTY): drop
                    # the sidecars and retry once; a second failure must
                    # not kill the save path over housekeeping
                    from fms_fsdp_tpu_torch.resilience.scrub import (
                        clear_integrity_sidecars,
                    )

                    clear_integrity_sidecars(str(ckp_to_remove))
                    try:
                        shutil.rmtree(ckp_to_remove)
                    except OSError as e:
                        self.report(
                            f"WARNING: retention cleanup of "
                            f"{ckp_to_remove} failed ({e}); retrying at "
                            f"the next save"
                        )
                        break

        # non-model step dirs: loader-only auto-save dirs (keep the
        # newest two, ranked among themselves: their step numbers are on
        # the workers' clock) and torn model saves (payload or manifest
        # but no commit marker), all prune candidates after the quiesce
        # window, which spares a save still being written
        def has_loader_state(p):
            return any(
                f.startswith("loader_state") for f in safe_listdir(p)
            )

        def has_state_payload(p):
            return any(
                f == STATE_DIR or f == "manifest.json" for f in safe_listdir(p)
            )

        non_model = [
            os.path.join(self.ckp_path, x)
            for x in os.listdir(self.ckp_path)
            if is_step_ckp(x)
            and not is_model_ckp(os.path.join(self.ckp_path, x))
        ]
        loader_only = sorted(
            (
                p
                for p in non_model
                if has_loader_state(p) and not has_state_payload(p)
            ),
            key=step_number,
            reverse=True,
        )
        torn = [p for p in non_model if p not in loader_only]

        def newest_mtime(p):
            # a full (path, mtime) fingerprint of the tree: a file still
            # being written bumps its own mtime, not the directory's
            try:
                entries = [("", os.path.getmtime(p))]
                for root, _, files in os.walk(p):
                    for f in files:
                        full = os.path.join(root, f)
                        entries.append(
                            (os.path.relpath(full, p), os.path.getmtime(full))
                        )
                return tuple(sorted(entries))
            except OSError:
                return None

        # prune a candidate only after its mtimes hold STILL across two
        # passes at least PRUNE_QUIESCE_S of local time apart: progress
        # is an mtime CHANGE, never an mtime against the local clock
        now = time.time()
        marks = self._prune_marks
        candidates = {p: newest_mtime(p) for p in loader_only[2:] + torn}
        for p, m in candidates.items():
            if m is None:
                marks.pop(p, None)
                continue
            marked = marks.get(p)
            if marked is None or marked[0] != m:
                marks[p] = (m, now)  # (re)arm: new candidate or still writing
                continue
            if now - marked[1] >= self.PRUNE_QUIESCE_S:
                shutil.rmtree(p, ignore_errors=True)
                marks.pop(p, None)
        for p in list(marks):
            if p not in candidates:
                marks.pop(p)
        return None

    # -- save ---------------------------------------------------------------

    def save(self, step, state, dataloader=None, reason="interval", **metadata):
        """Write the train state + loader state + metadata to
        ``step_<step>_ckp``. ``metadata`` kwargs (e.g. tokens_seen) land
        in metadata.json with the step count. ``reason`` is accepted for
        call-compatibility with the tiered AsyncCheckpointManager; the
        synchronous path has no tier routing, so it is ignored.

        Commit ordering: state payload -> loader state -> manifest ->
        metadata.json (the commit marker, atomic rename). A save torn
        before the marker leaves an uncommitted dir every scanner skips;
        a committed checkpoint always has a verifiable manifest."""
        from contextlib import nullcontext

        from fms_fsdp_tpu_torch.ckpt.elastic import stamp_topology
        from fms_fsdp_tpu_torch.utils.dist import barrier

        obs = self.observer
        save_time = time.time()
        with obs.phase("checkpoint") if obs is not None else nullcontext():
            save_name = os.path.join(self.ckp_path, f"step_{step}_ckp")
            os.makedirs(save_name, exist_ok=True)
            write_state(os.path.join(save_name, STATE_DIR),
                        dcp_payload(checkpoint_state(state), state.get("dp")))
            if dataloader is not None:
                dataloader.save_to_path(save_name)
            # every rank's parts and loader state are on disk before rank 0
            # hashes the dir and writes the commit marker
            barrier("writer")
            if self.rank == 0:
                metadata["step"] = step
                stamp_topology(metadata, self.fingerprint, dataloader)
                self.commit(save_name, metadata, step)
        if obs is not None:
            obs.registry.counter("checkpoint.saves").add()
            obs.registry.hist("checkpoint.save_s").record(time.time() - save_time)
        self.report(
            f"Checkpoint saved in {save_name}",
            model_save_time=time.time() - save_time,
        )
        return self._cleanup()

    def commit(self, save_name, metadata, step, before_marker=None, **fault_ctx):
        """Commit a step dir whose payload is written: the manifest, then
        the metadata.json marker, then the corruption fault sites. The
        one copy of the commit order, for this class's save and the async
        manager's writer, which passes its ``ckpt_precommit_kill`` site as
        ``before_marker`` and its tier in ``fault_ctx``. Returns the
        seconds the manifest took."""
        from fms_fsdp_tpu_torch.resilience.integrity import write_manifest
        from fms_fsdp_tpu_torch.resilience.scrub import clear_integrity_sidecars

        # a re-commit into a previously-quarantined step dir carries
        # fresh content: stale verdicts must not outlive the bytes
        clear_integrity_sidecars(save_name)
        t0 = time.time()
        write_manifest(save_name, full_checksums=self.full_checksums)
        manifest_s = time.time() - t0
        if before_marker is not None:
            before_marker()
        commit_metadata(save_name, metadata)
        # again after the marker: on a re-commit a sweep racing the
        # manifest hash saw the old marker with the new payload and may
        # have quarantined the fresh dir
        clear_integrity_sidecars(save_name)
        self._maybe_corrupt(save_name, step, **fault_ctx)
        self._maybe_flip(save_name, step, **fault_ctx)
        return manifest_s

    @staticmethod
    def _maybe_corrupt(save_name, step, **ctx):
        """``ckpt_corrupt`` fault site: truncate one file inside the
        just-committed checkpoint (``file=<substring>`` selects it), the
        torn-storage failure the load-time verification and fallback
        chain must absorb."""
        from fms_fsdp_tpu_torch.resilience.faults import fire_fault

        params = fire_fault("ckpt_corrupt", step=step, **ctx)
        if params is None:
            return
        want = str(params.get("file", ""))
        victims = []
        for root, _, files in os.walk(save_name):
            for name in files:
                full = os.path.join(root, name)
                if want in full and os.path.getsize(full) > 0:
                    victims.append(full)
        victims.sort()
        if not victims:
            raise RuntimeError(f"ckpt_corrupt: no file matching {want!r} in {save_name}")
        victim = victims[0]
        size = os.path.getsize(victim)
        with open(victim, "rb+") as f:
            f.truncate(size // 2)
        print(f"ckpt_corrupt fault: truncated {victim} ({size} -> {size // 2})")

    @staticmethod
    def _maybe_flip(save_name, step, **ctx):
        """``ckpt_shard_corrupt`` fault site: flip ``bytes=N`` (default 4)
        at the midpoint of the largest manifest-recorded file matching
        ``file=`` of the just-committed checkpoint, its size unchanged:
        the silent bit-rot only content checksums or the scrubber see."""
        from fms_fsdp_tpu_torch.resilience.faults import fire_fault
        from fms_fsdp_tpu_torch.resilience.integrity import MANIFEST_NAME
        from fms_fsdp_tpu_torch.resilience.scrub import clear_integrity_sidecars

        params = fire_fault("ckpt_shard_corrupt", step=step, **ctx)
        if params is None:
            return
        want = str(params.get("file", ""))
        try:
            with open(os.path.join(save_name, MANIFEST_NAME)) as f:
                recorded = json.load(f).get("files", {})
        except (OSError, ValueError):
            recorded = {}
        victims = sorted(
            ((int(size), rel) for rel, size in recorded.items()
             if want in rel and int(size) > 0),
            key=lambda t: (-t[0], t[1]),
        )
        if not victims:
            raise RuntimeError(
                f"ckpt_shard_corrupt: no recorded file matching {want!r} in {save_name}"
            )
        size, rel = victims[0]
        victim = os.path.join(save_name, rel)
        n = max(1, int(params.get("bytes", 4)))
        off = size // 2
        with open(victim, "rb+") as f:
            f.seek(off)
            data = f.read(min(n, size - off))
            f.seek(off)
            f.write(bytes(b ^ 0xFF for b in data))
        # a sweep racing the commit may have stamped a verdict in the
        # instant before the flip: the injected corruption must be
        # deterministic, so this dir's verdict goes with it
        clear_integrity_sidecars(save_name)
        print(
            f"ckpt_shard_corrupt fault: flipped {len(data)} byte(s) at "
            f"offset {off} of {victim} (size {size} unchanged)"
        )

    def finalize(self):
        """No-op: the synchronous save has nothing in flight when it
        returns. Lets callers invoke ``finalize()`` unconditionally at
        loop exit (the async manager's is mandatory)."""

    # -- load ---------------------------------------------------------------

    def load(
        self,
        state,
        dataloader=None,
        path="",
        reset_stepcount=False,
        strict=True,
        candidates=None,
        is_resuming=None,
    ):
        """Restore (state, dataloader) from the save dir if it holds a
        checkpoint (job restart), else from ``path``.

        ``state`` is the freshly initialized train state; the load writes
        into its tensors in place. Returns (state, dataloader, step,
        tokens_seen, is_resuming).

        ``candidates`` (with ``is_resuming``) lets a caller that already
        scanned (the tiered AsyncCheckpointManager merging several
        checkpoint roots) inject its own newest-first candidate list.

        Integrity: each candidate checkpoint is manifest-verified (when
        ``self.verify``) and its restore wrapped: a corrupt or torn
        newest checkpoint falls back to the next-newest committed one
        with a warning instead of killing the restart. Only when every
        candidate fails does load raise (restarting a long run from
        scratch silently would be worse than crashing)."""
        from fms_fsdp_tpu_torch.resilience.scrub import (
            cached_verify,
            verified_resume_active,
        )

        verified_resume = verified_resume_active()
        verify = self.verify or verified_resume
        if verified_resume and self.rank == 0:
            self.report(
                "Verified-resume policy active (FMS_VERIFIED_RESUME): "
                "restoring only from scrub-verified checkpoints; the "
                "newest unverified candidate is verified in place "
                "before it may be restored."
            )

        if candidates is None:
            is_resuming = False
            candidates = self._candidate_ckp_paths(self.ckp_path)
            if candidates:
                path = self.ckp_path
                is_resuming = True
            else:
                candidates = self._candidate_ckp_paths(path)
            # rank 0's scan is authoritative: every process must walk the
            # same candidates in the same order, the votes and collective
            # restores below are counted in lockstep
            decision = self._broadcast_obj({"resume": is_resuming, "cands": candidates,
                                            "path": path})
            is_resuming = bool(decision["resume"])
            candidates = [str(c) for c in decision["cands"]]
            path = decision["path"]
        else:
            is_resuming = bool(is_resuming)
        if not candidates:
            self.report(
                f"No valid checkpoint detected at {path}, starting from scratch."
            )
            _fresh_start(dataloader)
            return state, dataloader, 0, 0, False

        last_err = None
        for load_path in candidates:
            self.report(f"Prior checkpoint {load_path} detected.")
            t0 = time.time()
            if os.path.isfile(load_path):
                # single-file checkpoint: bare model params; optimizer and
                # dataloader start fresh
                err = None
                payload = None
                try:
                    with open(load_path, "rb") as f:
                        payload = pickle.load(f)
                except (OSError, pickle.UnpicklingError, EOFError) as e:
                    err = e
                if not self._all_agree(err is None):
                    self.report(
                        f"WARNING: single-file checkpoint {load_path} is "
                        f"unreadable on at least one process ({err}); "
                        f"falling back to the next-newest checkpoint."
                    )
                    last_err = err or RuntimeError(
                        f"peer process failed to read {load_path}"
                    )
                    continue
                params = payload.get("model_state", payload)
                dp = state.get("dp")
                if dp is not None and dp.sharded:
                    # whole params in the pickle: this rank takes its parts
                    params = unflatten(dp.shard(flatten("params", _to_tensors(params), {})),
                                       "params")
                _merge_into(state["params"], params, strict)
                self.report(
                    f"Checkpoint {load_path} is a single-file checkpoint "
                    "containing only a model. Optimizer and dataloader are "
                    "from scratch.",
                    model_load_time=time.time() - t0,
                )
                _fresh_start(dataloader)
                return state, dataloader, 0, 0, is_resuming

            if verify:
                ok, problems = cached_verify(
                    load_path,
                    write_sidecars=(self.rank == 0),
                    report=self.report,
                )
                if not self._all_agree(ok):
                    self.report(
                        f"WARNING: checkpoint {load_path} failed integrity "
                        f"verification on at least one process "
                        f"({'; '.join(problems[:3]) or 'peer report'}); "
                        f"falling back to the next-newest committed "
                        f"checkpoint."
                    )
                    last_err = RuntimeError(
                        f"integrity verification failed: {problems}"
                    )
                    continue
                if problems:  # coverage note: legacy / size-only large files
                    if verified_resume:
                        self.report(
                            f"WARNING: verified-resume policy active but "
                            f"{load_path} is only partially "
                            f"content-verifiable ({problems[0]}); "
                            f"restoring it anyway — enable "
                            f"ckpt_full_checksums to close this gap."
                        )
                    else:
                        self.report(f"Note: {problems[0]}")

            # metadata is read BEFORE the restore: a torn metadata.json is
            # a corrupt checkpoint, and the elastic gate must fail fast
            meta = None
            if is_resuming and not reset_stepcount:
                meta_err = None
                try:
                    with open(os.path.join(load_path, "metadata.json")) as f:
                        meta = json.load(f)
                except (OSError, ValueError) as e:
                    meta_err = e
                if not self._all_agree(meta_err is None):
                    self.report(
                        f"WARNING: checkpoint {load_path} has an "
                        f"unreadable metadata.json on at least one "
                        f"process ({meta_err}); falling back to the "
                        f"next-newest committed checkpoint."
                    )
                    last_err = meta_err or RuntimeError(
                        f"peer process failed to read metadata of {load_path}"
                    )
                    continue
                self._elastic_gate(load_path, meta)

            # directory checkpoint: every key of the train state, read in
            # place into its tensors; the scalars apply only on success
            try:
                flat = checkpoint_state(state)
                read_state(os.path.join(load_path, STATE_DIR), flat, state.get("dp"))
                if dataloader is not None:
                    t1 = time.time()
                    dataloader.load_from_path(load_path)
                    self.report(dataset_load_time=time.time() - t1)
                else:
                    self.report("Skipping dataset load, no dataloader provided.")
            except Exception as e:  # noqa: BLE001 — any restore failure
                # falls back to the next-newest committed checkpoint
                if world_size() > 1:
                    # a failure on THIS process inside the collective
                    # restore cannot be recovered alone: peers may be
                    # parked in it, and moving to an older candidate would
                    # hang the world or mix steps. Fail loudly; the
                    # supervisor restarts the whole job.
                    raise RuntimeError(
                        f"restore from {load_path} failed on process "
                        f"{self.rank}; multi-process fallback cannot proceed "
                        f"safely from inside a failed collective restore"
                    ) from e
                self.report(
                    f"WARNING: restore from {load_path} failed ({e!r}); "
                    f"falling back to the next-newest committed checkpoint."
                )
                last_err = e
                continue
            apply_scalars(state, flat)
            self.report(model_load_time=time.time() - t0)

            step, ntok = 0, 0
            if meta is not None:
                step = meta.get("step", 0)
                ntok = meta.get("tokens_seen", 0)
                self.report(
                    "Metadata loaded", start_step=step, n_tokens_seen=ntok
                )
            else:
                # continued pretraining from an external checkpoint: keep
                # the optimizer moments but restart the schedule clock,
                # which the step counter drives
                # (ref:main_training_llama.py:130-134)
                state["step"] = 0

            return state, dataloader, step, ntok, is_resuming

        raise RuntimeError(
            f"all {len(candidates)} checkpoint(s) under {path} failed to "
            f"load; refusing to silently restart from scratch"
        ) from last_err


def _fresh_start(dataloader) -> None:
    """Tell a stateful loader that the trainer resolved a from-scratch
    start (the empty-path marker of ``data/buffering.py::
    CheckpointDataset.load_from_path``), so its own auto-load cannot
    resume the walk from a stale loader auto-save that this scan just
    rejected (model@0 + loader@N). Gated on the advertised contract: a
    loader without ``supports_fresh_start`` treats ``""`` as a real path
    and is left untouched."""
    if dataloader is not None and getattr(dataloader, "supports_fresh_start", False):
        dataloader.load_from_path("")


def commit_metadata(save_name: str, metadata: Dict) -> None:
    """Write the ``metadata.json`` commit marker: a ``.tmp`` file,
    fsync, then an atomic rename."""
    meta_path = os.path.join(save_name, "metadata.json")
    with open(meta_path + ".tmp", "w") as f:
        json.dump(metadata, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(meta_path + ".tmp", meta_path)
