"""Async multi-tier checkpoint manager.

Counterpart of ``fms_fsdp_tpu/ckpt/manager.py``. ``Checkpointer.save`` is
fully synchronous: the train loop stalls on the whole write. This manager
splits a save in two:

- a **blocking snapshot** at the step boundary: every tensor of the train
  state copied to host memory (pinned buffers for card tensors, clones
  for CPU ones, ``ckpt/state.py::snapshot``), plus the loader state. Its
  cost is bounded by the device-to-host copy, not by storage.
- a **background commit** on a writer thread that touches host tensors
  only: the DCP payload, then the manifest, then the ``metadata.json``
  commit marker (the commit order of the synchronous path), then the
  tier's retention GC.

Concurrency contract:

- **at most one save in flight**: ``save()`` first joins any running
  writer (a storage tier slower than the save cadence throttles the loop
  instead of queueing snapshots);
- **errors propagate**: a writer failure is re-raised by the *next*
  ``save()`` or by ``finalize()``, never swallowed;
- **mandatory ``finalize()``** on loop exit: joins the in-flight writer
  so the final save is never torn by process exit.

Tiers (``CheckpointTier``): a *fast local* tier saved often with tight
retention and a *durable* tier saved sparsely, each backed by its own
``Checkpointer``. Resume merges every tier's committed checkpoints,
newest step first, and walks the manifest-verified fallback chain across
them.

Across processes every rank snapshots and writes its own parts (DCP over
the writer's gloo group, ``utils/dist.py::aux_group("writer")``, from each
rank's writer thread), the writers meet at a barrier on that group, and rank 0 alone
writes the manifest and the commit marker and collects old saves; rank
0's merged candidate list is broadcast before a load or a resume-topology
scan, so every rank walks the same chain.

Fault sites (resilience/faults.py), at the JAX manager's points of the
save: ``ckpt_writer_crash`` raises in the writer after the payload write
(the error surfaces in the next ``save``/``finalize``);
``ckpt_durable_write`` raises OSError in a tier's commit IO before the
manifest (the bounded retry and the degrade path absorb it);
``ckpt_precommit_kill`` hard-exits between the manifest and the commit
marker (resume must skip the torn dir); ``ckpt_corrupt`` and
``ckpt_shard_corrupt`` corrupt the committed dir after its marker.

The train loop attaches its Observer (``observer``): a save's blocking
part lands in the ``checkpoint`` phase, and ``obs_stats`` drains the
writer's seconds and committed saves into each record.
"""

import os
import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

from fms_fsdp_tpu_torch.ckpt.elastic import stamp_topology
from fms_fsdp_tpu_torch.ckpt.state import checkpoint_state, snapshot
from fms_fsdp_tpu_torch.utils.checkpointing import (
    STATE_DIR,
    Checkpointer,
    dcp_payload,
    write_state,
)
from fms_fsdp_tpu_torch.utils.ckpt_paths import step_number
from fms_fsdp_tpu_torch.utils.dist import barrier, world_size


class CheckpointTier:
    """One storage destination: a name, a save cadence, and a retention
    quota, backed by a ``Checkpointer`` owning the directory layout."""

    def __init__(
        self,
        name: str,
        root: str,
        interval: int,
        keep: int,
        parallel_mode: str,
        rank=None,
        report_fn=None,
        verify: bool = True,
        full_checksums: bool = True,
    ):
        self.name = name
        self.root = root
        self.interval = int(interval)
        self.ckp = Checkpointer(
            root,
            keep,
            parallel_mode,
            rank=rank,
            report_fn=report_fn,
            verify=verify,
            full_checksums=full_checksums,
        )

    def due(self, step: int) -> bool:
        return self.interval > 0 and step % self.interval == 0


class AsyncCheckpointManager:
    """Multi-tier, async-commit checkpoint manager the train loop drives.

    Drop-in for ``Checkpointer`` at the loop's touchpoints:
    ``save(step, state, dataloader, reason, **metadata)``, ``load(...)``
    (same return tuple), ``save_due`` (tier cadence) and the mandatory
    ``finalize()``. ``save_log`` holds one record per committed tier
    save: its step, tier, reason, bytes, the blocking snapshot's and the
    background commit's seconds, within the snapshot the loader state's
    (``loader_s``), and within the commit the payload write's and the
    manifest's."""

    def __init__(
        self,
        tiers: List[CheckpointTier],
        async_save: bool = True,
        rank=None,
        durable_retries: int = 3,
        durable_backoff_s: float = 0.5,
    ):
        assert tiers, "at least one (durable) tier is required"
        self.tiers = tiers
        # the durable tier is the last one by convention: it receives
        # forced saves (final / preemption / abort) and resolves
        # external-path loads (continued pretraining)
        self.durable = tiers[-1]
        self.async_save = async_save
        self.rank = 0 if rank is None else rank
        # manifest/metadata writes retry with bounded backoff
        # (resilience/retry.py); when the DURABLE tier still fails and a
        # fast-local tier exists, the manager degrades to it instead of
        # killing the writer on the first ENOSPC/EIO
        self.durable_retries = max(0, int(durable_retries))
        self.durable_backoff_s = float(durable_backoff_s)
        self._durable_degraded = False
        self._writer: Optional[threading.Thread] = None
        self._writer_err: Optional[BaseException] = None
        self._lock = threading.Lock()
        # pinned host buffers of the snapshot, reused across saves: at
        # most one save is in flight, and save() joins it first
        self._host: Dict = {}
        self.save_log: List[Dict] = []
        self.fingerprint: dict = None
        # observer accounting, drained by obs_stats() at report cadence:
        # writer seconds, committed saves (tier, bytes, seconds) and
        # degraded durable commits since the last report
        self._observer = None
        self._bg_seconds = 0.0
        self._pending_saves: List = []
        self._pending_degraded = 0
        self._in_flight = 0

    def set_fingerprint(
        self,
        fingerprint,
        allow_batch_change: bool = False,
        allow_corpus_change: bool = False,
    ):
        """Arm the elastic-resume contract on every tier (see
        ``Checkpointer.set_fingerprint``)."""
        self.fingerprint = dict(fingerprint) if fingerprint else None
        for tier in self.tiers:
            tier.ckp.set_fingerprint(
                fingerprint, allow_batch_change, allow_corpus_change
            )

    def _merged_candidates(self):
        candidates = []
        for tier in self.tiers:
            candidates.extend(tier.ckp._candidate_ckp_paths(tier.ckp.ckp_path))
        # tier saves are always step dirs; order strictly by step number
        # so "newest committed" is global across tiers, not per-tier
        candidates.sort(key=step_number, reverse=True)
        return candidates

    def resume_topology(self):
        """The topology fingerprint of the newest committed checkpoint a
        resume would restore, merged across tiers, or None; rank 0's scan
        is broadcast, so every rank resolves the same elastic batch
        policy before building its loader."""
        return self.durable.ckp.resume_topology(self._merged_candidates())

    # -- observability -----------------------------------------------------

    @property
    def observer(self):
        return self._observer

    @observer.setter
    def observer(self, obs):
        self._observer = obs
        if obs is not None:
            obs.attach_checkpoint_stats(self.obs_stats)

    def obs_stats(self) -> dict:
        """Drain the background-write window: the writer's seconds since
        the last report and whether a save is in flight now. Called by
        ``Observer.report`` on the main thread, so the committed saves'
        counters reach the registry without the writer touching it."""
        with self._lock:
            bg_s, self._bg_seconds = self._bg_seconds, 0.0
            done, self._pending_saves = self._pending_saves, []
            in_flight = self._in_flight
            degraded, self._pending_degraded = self._pending_degraded, 0
        obs = self._observer
        if obs is not None:
            if degraded:
                obs.registry.counter("checkpoint.durable_degraded").add(degraded)
            for tier_name, nbytes, save_bg_s in done:
                obs.registry.counter("checkpoint.saves").add()
                obs.registry.counter(f"checkpoint.saves.{tier_name}").add()
                if nbytes:
                    obs.registry.counter("checkpoint.bytes").add(nbytes)
                if save_bg_s is not None:
                    obs.registry.hist("checkpoint.bg_write_s").record(save_bg_s)
        return {"bg_s": bg_s, "in_flight": in_flight}

    # -- save --------------------------------------------------------------

    def save_due(self, step: int) -> bool:
        """Any tier due at this step (the loop's interval check)."""
        return any(t.due(step) for t in self.tiers)

    def save(self, step, state, dataloader=None, reason="interval", **metadata):
        """Blocking snapshot now; payload/manifest/marker commit in the
        background. ``reason`` routes forced saves ("final", "preempt",
        "abort", "demand") to the durable tier even off its cadence.

        Raises any error recorded by the *previous* save's writer thread
        (the failed save's step dir stays uncommitted and invisible to
        every scanner)."""
        obs = self._observer
        with obs.phase("checkpoint") if obs is not None else nullcontext():
            # the join is inside the phase: a storage tier slower than the
            # save cadence blocks the loop here, and that is checkpoint time
            self._join_writer()  # at most one save in flight
            self._raise_pending()
            self._snapshot_and_commit(step, state, dataloader, reason, metadata)

    def _snapshot_and_commit(self, step, state, dataloader, reason, metadata):
        due = [t for t in self.tiers if t.due(step)]
        if reason != "interval" and self.durable not in due:
            due.append(self.durable)
        if not due:
            due = [self.durable]
        if self.durable in due:
            # rank 0 alone sees the degraded flag, so only a world of one
            # may route on it: ranks must write the same tiers
            if self._durable_degraded and len(self.tiers) > 1 and world_size() == 1:
                # durable commits are failing: keep a fast-local copy of
                # this step too, so SOME tier holds a committed checkpoint
                due = [t for t in self.tiers if t is not self.durable] + [self.durable]
            else:
                # a durable-step save satisfies the local cadence too:
                # the resume scan merges tiers
                due = [self.durable]

        snap_start = time.time()
        host = snapshot(checkpoint_state(state), self._host)
        dp = state.get("dp")
        jobs = []
        loader_s = 0.0
        for tier in due:
            save_name = os.path.join(tier.ckp.ckp_path, f"step_{step}_ckp")
            os.makedirs(save_name, exist_ok=True)
            if dataloader is not None:
                # loader state is captured at the step boundary so it
                # matches the model snapshot exactly
                t0 = time.time()
                dataloader.save_to_path(save_name)
                loader_s += time.time() - t0
            jobs.append((tier, save_name))
        snapshot_s = time.time() - snap_start
        if self._observer is not None:
            self._observer.registry.hist("checkpoint.snapshot_s").record(snapshot_s)

        meta = dict(metadata)
        meta["step"] = step
        # stamped on the main thread (the writer must not guess whether a
        # dataloader rode along)
        stamp_topology(meta, self.fingerprint, dataloader)
        info = {"step": step, "reason": reason, "snapshot_s": snapshot_s,
                "loader_s": loader_s}
        with self._lock:
            self._in_flight = 1
        if self.async_save:
            self._writer = threading.Thread(
                target=self._commit_job,
                args=(jobs, host, meta, info, dp),
                name="ckpt-writer",
                daemon=True,
            )
            self._writer.start()
        else:
            # synchronous: the commit is the critical path, inside the
            # checkpoint phase, and adds nothing to the background seconds
            self._commit_job(jobs, host, meta, info, dp, background=False)
            self._raise_pending()

    def _commit_tier_io(self, tier, save_name, meta, timing):
        """One tier's commit IO (manifest -> metadata marker), idempotent
        so the transient-FS retry may re-run it. Hosts the
        ``ckpt_durable_write`` site (an injected ENOSPC/EIO before the
        manifest) and the ``ckpt_precommit_kill`` window (after the
        manifest, before the marker)."""
        from fms_fsdp_tpu_torch.resilience.exits import EXIT_CODES
        from fms_fsdp_tpu_torch.resilience.faults import fire_fault, maybe_raise_fault

        if self.rank != 0:
            return
        step = meta["step"]
        maybe_raise_fault("ckpt_durable_write", exc_cls=OSError, step=step,
                          tier=tier.name)

        def precommit_kill():
            params = fire_fault("ckpt_precommit_kill", step=step, tier=tier.name)
            if params is not None:
                os._exit(int(params.get("code", EXIT_CODES["injected_kill"])))

        timing["manifest_s"] = tier.ckp.commit(
            save_name, meta, step, before_marker=precommit_kill, tier=tier.name)

    def _commit_job(self, jobs, host, meta, info, dp=None, background=True):
        """Writer body: the payload, then the commit (manifest ->
        metadata marker) with bounded retry on transient FS errors, then
        the tier's GC. A durable tier whose retry budget is exhausted
        degrades to the fast-local tier (the save dir stays uncommitted
        and the torn-dir GC reclaims it) instead of killing the writer."""
        from fms_fsdp_tpu_torch.resilience.faults import maybe_raise_fault
        from fms_fsdp_tpu_torch.resilience.retry import retry_call

        job_start = time.time()
        try:
            for tier, save_name in jobs:
                bg_start = time.time()
                write_state(os.path.join(save_name, STATE_DIR), dcp_payload(host, dp))
                # every rank's parts and loader state are on disk before
                # rank 0 hashes the dir and writes the commit marker
                barrier("writer")
                timing = {"write_s": time.time() - bg_start}
                # writer crash site: the error must surface in the NEXT
                # save()/finalize(), never vanish
                maybe_raise_fault("ckpt_writer_crash", exc_cls=RuntimeError,
                                  step=meta["step"], tier=tier.name)
                try:
                    retry_call(
                        lambda t=tier, s=save_name: self._commit_tier_io(
                            t, s, meta, timing
                        ),
                        retries=self.durable_retries,
                        backoff_s=self.durable_backoff_s,
                        describe=f"{tier.name} checkpoint commit [{save_name}]",
                    )
                except OSError as e:
                    if tier is self.durable and len(self.tiers) > 1:
                        with self._lock:
                            self._durable_degraded = True
                            self._pending_degraded += 1
                        tier.ckp.report(
                            f"WARNING: durable checkpoint commit for step "
                            f"{meta['step']} failed after "
                            f"{self.durable_retries} retries ({e}); "
                            f"degrading to the fast local tier until a "
                            f"durable commit succeeds. The step dir stays "
                            f"uncommitted; resume falls back to the newest "
                            f"committed checkpoint on any tier."
                        )
                        continue
                    raise
                if tier is self.durable and self._durable_degraded:
                    with self._lock:
                        self._durable_degraded = False
                    tier.ckp.report(
                        f"durable checkpoint commit recovered at step "
                        f"{meta['step']}; leaving degraded mode"
                    )
                record = dict(info, tier=tier.name, path=save_name,
                              bytes=_dir_bytes(save_name),
                              bg_s=time.time() - bg_start, **timing)
                with self._lock:
                    self.save_log.append(record)
                    if self._observer is not None:
                        # flushed into the registry by obs_stats(); a
                        # synchronous commit's time is checkpoint phase
                        self._pending_saves.append(
                            (tier.name, record["bytes"],
                             record["bg_s"] if background else None))
                tier.ckp.report(
                    f"Checkpoint saved in {save_name}",
                    model_save_time=record["bg_s"],
                )
                tier.ckp._cleanup()
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            # by the next save()/finalize(); a writer error silently
            # dropped would let the run believe it is checkpointed
            with self._lock:
                self._writer_err = e
        finally:
            with self._lock:
                if background:
                    self._bg_seconds += time.time() - job_start
                self._in_flight = 0

    def _join_writer(self):
        w = self._writer
        if w is not None and w is not threading.current_thread():
            w.join()
            self._writer = None

    def _raise_pending(self):
        with self._lock:
            err, self._writer_err = self._writer_err, None
        if err is not None:
            raise RuntimeError(
                "background checkpoint writer failed; the affected save "
                "is uncommitted (resume falls back to the previous "
                "committed checkpoint)"
            ) from err

    def finalize(self):
        """Join the in-flight writer and surface any writer error.
        MANDATORY on loop exit: returning from the loop with a save
        still in flight would tear the final checkpoint when the process
        exits. The snapshot's pinned host buffers are released."""
        self._join_writer()
        self._host = {}
        self._raise_pending()

    # -- load --------------------------------------------------------------

    def load(self, state, dataloader=None, path="", reset_stepcount=False,
             strict=True):
        """Resume from the newest committed checkpoint across all tiers
        (merged candidate list, newest step first, manifest-verified
        fallback down the chain); if no tier holds one, fall through to
        ``path`` (continued pretraining) via the durable tier."""
        lead = self.durable.ckp
        # one authoritative scan (rank 0's) across tiers: every rank must
        # walk the same merged list in the same order
        candidates = [str(c) for c in lead._broadcast_obj(self._merged_candidates())]
        if not candidates:
            return lead.load(
                state,
                dataloader,
                path=path,
                reset_stepcount=reset_stepcount,
                strict=strict,
            )
        return lead.load(
            state,
            dataloader,
            path=self.durable.root,
            reset_stepcount=reset_stepcount,
            strict=strict,
            candidates=candidates,
            is_resuming=True,
        )


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


def build_checkpoint_manager(
    cfg, rank=None, parallel_mode=None, report_fn=None
) -> AsyncCheckpointManager:
    """Manager from TrainConfig knobs: the durable tier at
    ``ckpt_save_path`` on the ``checkpoint_interval`` cadence, plus an
    optional fast local tier (``ckpt_local_dir`` + ``ckpt_local_interval``)
    with tight retention."""
    from fms_fsdp_tpu_torch.ckpt.elastic import current_fingerprint

    mode = parallel_mode or cfg.sharding_strategy
    verify = bool(getattr(cfg, "checkpoint_verify", True))
    full_checksums = bool(getattr(cfg, "ckpt_full_checksums", True))
    tiers = []
    local_dir = getattr(cfg, "ckpt_local_dir", "") or ""
    local_interval = int(getattr(cfg, "ckpt_local_interval", 0) or 0)
    if local_dir and local_interval > 0:
        tiers.append(
            CheckpointTier(
                "local",
                local_dir,
                local_interval,
                int(getattr(cfg, "ckpt_local_keep", 2)),
                mode,
                rank=rank,
                report_fn=report_fn,
                verify=verify,
                full_checksums=full_checksums,
            )
        )
    tiers.append(
        CheckpointTier(
            "durable",
            cfg.ckpt_save_path,
            int(cfg.checkpoint_interval),
            int(getattr(cfg, "ckpt_keep", 1000)),
            mode,
            rank=rank,
            report_fn=report_fn,
            verify=verify,
            full_checksums=full_checksums,
        )
    )
    mgr = AsyncCheckpointManager(
        tiers,
        async_save=bool(getattr(cfg, "ckpt_async", True)),
        rank=rank,
        durable_retries=int(getattr(cfg, "ckpt_durable_retries", 3)),
        durable_backoff_s=float(getattr(cfg, "ckpt_durable_backoff_s", 0.5)),
    )
    # default elastic fingerprint from the config as given; the entry
    # points re-stamp it after their batch size is resolved
    mgr.set_fingerprint(
        current_fingerprint(cfg),
        allow_batch_change=bool(getattr(cfg, "allow_batch_change", False)),
        allow_corpus_change=bool(getattr(cfg, "allow_corpus_change", False)),
    )
    return mgr
