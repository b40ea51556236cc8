"""Self-healing run supervisor: classified-exit auto-restart through
resume.

Counterpart of ``fms_fsdp_tpu/resilience/supervisor.py`` (``RunSupervisor``
and its CLI): the same policies, backoff, crash-loop guard, ledger and
post-mortem, so either package's supervisor runs either package's
trainer. It launches the training entry as child processes, reads the
incarnation's exit classification (resilience/exits.py) and relaunches
under a per-class restart policy; the relaunched child resumes from the
newest committed, unquarantined checkpoint:

==============  =============================================================
class           policy (``default_policies``)
==============  =============================================================
ok              heartbeat step >= target_step -> done; below it, the run
                exited clean early (a preemption save) -> immediate relaunch
slice_loss      relaunch; ``on_slice_loss="shrink"`` drops one fault domain
                (``num_slices - 1``), ``"same"`` keeps the world
anomaly_abort   relaunch from the last committed checkpoint after a cooldown
                (an instant relaunch into the same poisoned data would
                re-abort)
watchdog_stall  relaunch with backoff
loader_death    relaunch with backoff
corpus_loss     relaunch with backoff (expects the corpus restored)
state_divergence relaunch under the verified-resume rule
injected_kill   relaunch with backoff (fault-injection hard kills)
error           bounded generic retry with backoff (unknown exit codes)
==============  =============================================================

Safety rails: ``max_restarts`` caps the relaunches, and the crash-loop
guard ends the run with a post-mortem (every restart's exit class,
resumed step and downtime) when ``crash_loop_threshold`` incarnations in
a row make no heartbeat progress.

The restart ledger (JSON, written before each launch and at exit) is
read by the relaunched child through ``FMS_RESTART_LEDGER``
(obs/observer.py::build_observer): ``restarts`` and
``restart_downtime_s`` ride every metrics record and the downtime is
charged against goodput. Each launch exports ``FMS_RUN_ID``
(``<ledger stem>-i<attempt>``), which stamps the heartbeat.

CLI::

    python -m fms_fsdp_tpu_torch.resilience.supervisor \\
        --ledger /tmp/run/ledger.json --heartbeat /tmp/run/obs/heartbeat.json \\
        --target-step 50000 --max-restarts 8 -- \\
        python -m fms_fsdp_tpu_torch.main_training_llama --num_steps=50000 \\
            --obs_dir=/tmp/run/obs ...

``ReplicaSetSupervisor`` is the keep-N supervisor of the serving fleet
(``serve/fleet.py``): N replica children, each on its own
classify/backoff/crash-loop track, polled without blocking, with a restart
ledger folded into an availability metric (counterpart of JAX's
``resilience/supervisor.py:574-981``).
"""

import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from fms_fsdp_tpu_torch.resilience.exits import (
    ENV_LEDGER,
    ENV_RUN_ID,
    EXIT_CODES,
    classify_exit,
    classify_world,
)
from fms_fsdp_tpu_torch.resilience.scrub import ENV_VERIFIED_RESUME

LEDGER_VERSION = 1


@dataclass
class RestartPolicy:
    """Per-exit-class restart decision: whether to relaunch, the backoff
    base (doubles per consecutive no-progress restart, like every other
    backoff in resilience/), an extra fixed cooldown, whether the next
    incarnation drops a fault domain, and whether it must resume under
    the VERIFIED-resume rule (restore only a scrub-verified checkpoint —
    the state-divergence policy, resilience/divergence.py)."""

    restart: bool = True
    backoff: bool = True
    cooldown_s: float = 0.0
    drop_slice: bool = False
    verified_resume: bool = False


def default_policies(
    anomaly_cooldown_s: float = 30.0, on_slice_loss: str = "shrink"
) -> Dict[str, RestartPolicy]:
    assert on_slice_loss in ("shrink", "same"), on_slice_loss
    return {
        "ok": RestartPolicy(restart=False),
        # a clean exit below the target step is a preemption save:
        # relaunch immediately (the grace window already cost time)
        "preempted": RestartPolicy(backoff=False),
        "slice_loss": RestartPolicy(drop_slice=(on_slice_loss == "shrink")),
        "anomaly_abort": RestartPolicy(cooldown_s=anomaly_cooldown_s),
        "watchdog_stall": RestartPolicy(),
        "loader_death": RestartPolicy(),
        # the data itself is gone (mix below min_live_corpora), not the
        # worker: relaunch with backoff expecting the corpus restored —
        # a still-dead corpus re-exits and the crash-loop guard ends it
        "corpus_loss": RestartPolicy(),
        # a replica's state silently diverged (SDC / broken reduce): the
        # newest checkpoint may hold the diverged replica's poison, so
        # every later incarnation resumes from the last SCRUB-VERIFIED
        # checkpoint (FMS_VERIFIED_RESUME exported to the children),
        # never trust-on-size the newest
        "state_divergence": RestartPolicy(verified_resume=True),
        "injected_kill": RestartPolicy(),
        "error": RestartPolicy(),
    }


@dataclass
class SupervisorResult:
    status: str  # "completed" | "crash_loop" | "max_restarts" | "gave_up"
    restarts: int
    final_step: int
    ledger: dict
    post_mortem: str = ""


@dataclass
class _Entry:
    attempt: int
    run_id: str
    exit_codes: List[Optional[int]] = field(default_factory=list)
    classification: str = ""
    started_unix: float = 0.0
    ended_unix: float = 0.0
    resumed_step: int = -1  # heartbeat step going INTO the incarnation
    step_at_exit: int = -1  # heartbeat step when it died
    downtime_s: float = 0.0  # death -> next launch (backoff + spawn)
    note: str = ""

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class RunSupervisor:
    """Launch -> classify -> relaunch loop over one training run.

    ``build_command(ctx)`` returns the incarnation's child specs: a list
    with one entry per host process, each either an argv list or a dict
    ``{"argv": [...], "env": {...}, "cwd": ...}``. ``ctx`` carries
    ``attempt`` (0 = first launch), ``run_id``, ``num_slices`` (already
    decremented after a shrink restart), ``restarts`` and the ledger so
    ``build_command`` can reshape the world per incarnation.

    ``target_step`` tells completion apart from a clean preemption exit:
    both exit 0, but only one has heartbeat step >= target. Without it,
    any all-zero exit completes the run.

    Injectables (``launch``, ``clock``, ``sleep``, ``read_step``) keep
    the whole policy loop unit-testable without real processes.
    """

    def __init__(
        self,
        build_command: Callable[[dict], list],
        *,
        ledger_path: str,
        heartbeat_path: Optional[str] = None,
        target_step: Optional[int] = None,
        max_restarts: int = 8,
        restart_backoff_s: float = 5.0,
        crash_loop_threshold: int = 3,
        anomaly_cooldown_s: float = 30.0,
        on_slice_loss: str = "shrink",
        num_slices: int = 1,
        reset_paths: tuple = (),
        log_dir: Optional[str] = None,
        policies: Optional[Dict[str, RestartPolicy]] = None,
        launch=None,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        log: Callable[[str], None] = None,
    ):
        self.build_command = build_command
        self.ledger_path = ledger_path
        self.heartbeat_path = heartbeat_path
        if target_step is not None and not heartbeat_path:
            # completion vs clean-preemption is decided from the
            # heartbeat step; without one, every clean exit would read
            # as step -1 < target and a finished run would be
            # relaunched into the crash-loop guard
            raise ValueError(
                "target_step requires heartbeat_path (the obs "
                "heartbeat.json): the supervisor reads the reached "
                "step from it to tell completion from a clean "
                "preemption exit"
            )
        self.target_step = target_step
        self.max_restarts = int(max_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        self.crash_loop_threshold = max(1, int(crash_loop_threshold))
        self.num_slices = max(1, int(num_slices))
        self.reset_paths = tuple(reset_paths)
        self.log_dir = log_dir
        self.policies = policies or default_policies(
            anomaly_cooldown_s=anomaly_cooldown_s, on_slice_loss=on_slice_loss
        )
        self._launch = launch or self._launch_subprocesses
        # sticky once set (a state_divergence classification): every
        # later incarnation restores only scrub-verified checkpoints —
        # once a replica has silently diverged, "newest" is no longer a
        # trustworthy resume point for the rest of this run
        self._verified_resume = False
        self._clock = clock
        self._sleep = sleep
        self._log = log or (lambda msg: print(f"[supervisor] {msg}", flush=True))
        # resume a prior supervisor's ledger at the same path: attempt
        # numbering (and therefore run_ids) and downtime accounting
        # continue instead of restarting at i0 — a restarted supervisor
        # must never reuse a dead incarnation's run_id, or the dead
        # run's heartbeat/liveness records would pass the incarnation
        # filters they exist for
        self.entries: List[_Entry] = []
        prior = None
        try:
            with open(self.ledger_path) as f:
                prior = json.load(f)
        except (OSError, ValueError):
            prior = None
        if prior and isinstance(prior.get("entries"), list):
            for e in prior["entries"]:
                try:
                    self.entries.append(
                        _Entry(
                            **{
                                k: e[k]
                                for k in _Entry.__dataclass_fields__
                                if k in e
                            }
                        )
                    )
                except TypeError:
                    continue  # unknown ledger shape: start fresh past it
            if self.entries:
                self._log(
                    f"resuming restart ledger {self.ledger_path}: "
                    f"{len(self.entries)} prior incarnation(s)"
                )

    # -- ledger ------------------------------------------------------------

    def _ledger(self, run_id: str, final: bool = False) -> dict:
        # written BEFORE each launch, ``restarts`` is "relaunches that
        # preceded the incarnation about to start" == len(entries); in
        # the final ledger the last entry is the terminal incarnation
        # itself, not a restart
        restarts = len(self.entries) - (1 if final and self.entries else 0)
        return {
            "version": LEDGER_VERSION,
            "run_id": run_id,
            "restarts": max(0, restarts),
            "restart_downtime_s": round(
                sum(e.downtime_s for e in self.entries), 6
            ),
            "entries": [e.as_dict() for e in self.entries],
        }

    def _write_ledger(self, run_id: str, final: bool = False) -> dict:
        led = self._ledger(run_id, final=final)
        d = os.path.dirname(os.path.abspath(self.ledger_path))
        os.makedirs(d, exist_ok=True)
        tmp = self.ledger_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(led, f, indent=1)
        os.replace(tmp, self.ledger_path)
        return led

    # -- heartbeat ---------------------------------------------------------

    def _read_step(self, run_id: Optional[str] = None) -> int:
        """Last heartbeat step, or -1. When ``run_id`` is given, a
        heartbeat stamped by a DIFFERENT incarnation reads as -1 (no
        progress observed from THIS incarnation) — the dead run's file
        must not count as the live run's progress."""
        if not self.heartbeat_path:
            return -1
        try:
            with open(self.heartbeat_path) as f:
                hb = json.load(f)
        except (OSError, ValueError):
            return -1
        if run_id is not None and hb.get("run_id") not in (None, run_id):
            return -1
        try:
            return int(hb.get("step", -1))
        except (TypeError, ValueError):
            return -1

    # -- launching ---------------------------------------------------------

    def _launch_subprocesses(self, specs: list, attempt: int, run_id: str):
        """Default launcher: one subprocess per spec, stdout/stderr to
        per-child log files under ``log_dir`` (or inherited)."""
        procs = []
        try:
            for i, spec in enumerate(specs):
                if isinstance(spec, dict):
                    argv = list(spec["argv"])
                    env = dict(os.environ, **(spec.get("env") or {}))
                    cwd = spec.get("cwd")
                else:
                    argv, env, cwd = list(spec), dict(os.environ), None
                env[ENV_RUN_ID] = run_id
                env[ENV_LEDGER] = os.path.abspath(self.ledger_path)
                if self._verified_resume:
                    env[ENV_VERIFIED_RESUME] = "1"
                out = None
                if self.log_dir:
                    os.makedirs(self.log_dir, exist_ok=True)
                    out = open(
                        os.path.join(
                            self.log_dir, f"attempt{attempt}_child{i}.log"
                        ),
                        "w",
                    )
                try:
                    procs.append(
                        (
                            subprocess.Popen(
                                argv,
                                env=env,
                                cwd=cwd,
                                stdout=out,
                                stderr=subprocess.STDOUT if out else None,
                            ),
                            out,
                        )
                    )
                except BaseException:
                    if out:
                        out.close()
                    raise
        except BaseException:
            # a later spawn failed (bad argv, ENOMEM): the children
            # already started must not keep training unsupervised
            for p, out in procs:
                p.kill()
                p.wait()
                if out:
                    out.close()
            raise
        codes = []
        for p, out in procs:
            codes.append(p.wait())
            if out:
                out.close()
        return codes

    def _reset_incarnation_state(self):
        """Clear per-incarnation shared state (slice liveness dirs):
        the next world must not read the dead world's files."""
        for path in self.reset_paths:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)

    # -- the loop ----------------------------------------------------------

    def run(self) -> SupervisorResult:
        no_progress = 0
        backoff_exp = 0
        # on a resumed ledger, the dead supervisor's final incarnation
        # already ended: the gap from its death to our first relaunch is
        # real downtime and must be charged like any other restart gap
        last_end: Optional[float] = (
            self.entries[-1].ended_unix if self.entries else None
        )
        while True:
            attempt = len(self.entries)
            stem = os.path.splitext(os.path.basename(self.ledger_path))[0]
            run_id = f"{stem}-i{attempt}"
            # before EVERY launch (including the first): a previous
            # world — this supervisor's, or a dead supervisor's whose
            # ledger we resumed — may have left per-incarnation shared
            # state (slice liveness files) behind
            self._reset_incarnation_state()
            led = self._write_ledger(run_id)  # the child folds this in
            ctx = {
                "attempt": attempt,
                "run_id": run_id,
                "num_slices": self.num_slices,
                "restarts": led["restarts"],
                "ledger": led,
                # custom launchers (tests, fleets) see the
                # verified-resume demand too; the default subprocess
                # launcher exports FMS_VERIFIED_RESUME itself
                "verified_resume": self._verified_resume,
            }
            specs = self.build_command(ctx)
            entry = _Entry(
                attempt=attempt,
                run_id=run_id,
                resumed_step=self._read_step(),
                started_unix=self._clock(),
            )
            if last_end is not None and self.entries:
                # downtime of the PREVIOUS incarnation's restart: death
                # -> this launch (backoff + cooldown + spawn overhead)
                self.entries[-1].downtime_s = max(
                    0.0, entry.started_unix - last_end
                )
                self._write_ledger(run_id)
            self._log(
                f"attempt {attempt} (run_id {run_id}, num_slices "
                f"{self.num_slices}, resumed step {entry.resumed_step}): "
                f"launching {len(specs)} child process(es)"
            )
            entry.exit_codes = list(self._launch(specs, attempt, run_id))
            entry.ended_unix = self._clock()
            last_end = entry.ended_unix
            entry.classification = classify_world(entry.exit_codes)
            entry.step_at_exit = self._read_step(run_id)
            self.entries.append(entry)

            cls = entry.classification
            if cls == "ok":
                step = entry.step_at_exit
                if self.target_step is not None and (
                    step < self.target_step
                ):
                    # a clean exit short of the target: the preemption
                    # save path ("exiting clean") — relaunch
                    cls = entry.classification = "preempted"
                    entry.note = (
                        f"clean exit at step {step} < target "
                        f"{self.target_step}: classified preempted"
                    )
                else:
                    self._log(
                        f"attempt {attempt} completed (step "
                        f"{entry.step_at_exit}); "
                        f"{len(self.entries) - 1} restart(s) total"
                    )
                    return self._finish("completed", run_id)
            policy = self.policies.get(cls) or self.policies["error"]
            self._log(
                f"attempt {attempt} exited {entry.exit_codes} -> "
                f"classified {cls!r} (heartbeat step {entry.step_at_exit})"
            )
            if policy.verified_resume and not self._verified_resume:
                self._verified_resume = True
                entry.note = (
                    entry.note + " " if entry.note else ""
                ) + (
                    "state divergence: all further incarnations resume "
                    "under the verified-resume rule (scrub-verified "
                    "checkpoints only)"
                )
                self._log(entry.note)
            if not policy.restart:
                return self._finish("gave_up", run_id)

            # crash-loop guard: heartbeat progress across incarnations.
            # A restart that failed before its first report (step -1) or
            # never got past the previous incarnation's step counts
            # toward the loop; any advance resets it.
            prev_best = max(
                (e.step_at_exit for e in self.entries[:-1]), default=-1
            )
            if entry.step_at_exit > prev_best:
                no_progress = 0
                backoff_exp = 0
            else:
                no_progress += 1
                if no_progress >= self.crash_loop_threshold:
                    return self._finish(
                        "crash_loop",
                        run_id,
                        reason=(
                            f"step did not advance across "
                            f"{no_progress} consecutive restart(s) "
                            f"(stuck at {max(prev_best, entry.step_at_exit)})"
                        ),
                    )
            if len(self.entries) - 1 >= self.max_restarts:
                return self._finish(
                    "max_restarts",
                    run_id,
                    reason=f"max_restarts={self.max_restarts} exhausted",
                )

            delay = policy.cooldown_s
            if policy.backoff:
                delay += self.restart_backoff_s * (2**backoff_exp)
                backoff_exp += 1
            if policy.drop_slice and self.num_slices > 1:
                self.num_slices -= 1
                entry.note = (
                    entry.note + " " if entry.note else ""
                ) + (
                    f"slice loss: relaunching at world minus one fault "
                    f"domain (num_slices -> {self.num_slices})"
                )
                self._log(entry.note)
            if delay > 0:
                self._log(
                    f"relaunching after {delay:.1f}s "
                    f"({'cooldown + ' if policy.cooldown_s else ''}backoff)"
                )
                self._sleep(delay)

    def _finish(self, status: str, run_id: str, reason: str = ""):
        led = self._write_ledger(run_id, final=True)
        final_step = max((e.step_at_exit for e in self.entries), default=-1)
        pm = ""
        if status != "completed":
            pm = self.post_mortem(reason)
            self._log(pm)
        return SupervisorResult(
            status=status,
            restarts=max(0, len(self.entries) - 1),
            final_step=final_step,
            ledger=led,
            post_mortem=pm,
        )

    def post_mortem(self, reason: str = "") -> str:
        """The give-up summary: one line per incarnation — exit class,
        resumed step, step at exit, downtime its restart cost — so the
        operator reads the whole restart history without grepping logs."""
        lines = [
            "supervisor giving up"
            + (f": {reason}" if reason else "")
            + f" (ledger: {self.ledger_path})"
        ]
        for e in self.entries:
            lines.append(
                f"  attempt {e.attempt}: exit {e.exit_codes} -> "
                f"{e.classification or '?'}, resumed step "
                f"{e.resumed_step}, step at exit {e.step_at_exit}, "
                f"restart downtime {e.downtime_s:.1f}s"
                + (f" ({e.note})" if e.note else "")
            )
        lines.append(
            f"  total: {max(0, len(self.entries) - 1)} restart(s), "
            f"{sum(e.downtime_s for e in self.entries):.1f}s downtime"
        )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# keep-N replica supervision (the serving-fleet generalization)
# ---------------------------------------------------------------------------


def default_replica_policies() -> Dict[str, RestartPolicy]:
    """Per-exit-class relaunch policy for a serving replica set. Much
    simpler than the training table: a replica is stateless capacity
    (its KV cache is recomputable — the router's journal requeues its
    in-flight requests), so almost every death class relaunches with
    backoff. ``ok`` is the drain path: a replica that exited clean was
    ASKED to stop and must not be resurrected."""
    return {
        "ok": RestartPolicy(restart=False),
        # the dedicated replica death class (and the watchdog-killed
        # stall the router classifies the same way): relaunch without
        # backoff — lost capacity is paid for by every queued request,
        # and the crash-loop guard still ends a replica that dies
        # repeatedly without serving anything
        "replica_loss": RestartPolicy(backoff=False),
        # drain-and-migrate (serve/replica.py SIGTERM path): the replica
        # packed its live streams, shipped them to siblings through the
        # router, and exited clean with the ``preempted`` registry code.
        # Planned eviction is not a crash — relaunch immediately, no
        # backoff (the scheduler that preempted the host decides whether
        # the relaunch actually lands)
        "preempted": RestartPolicy(backoff=False),
        "injected_kill": RestartPolicy(),
        "watchdog_stall": RestartPolicy(),
        "anomaly_abort": RestartPolicy(),
        "error": RestartPolicy(),
    }


@dataclass
class _ReplicaEntry:
    """One replica incarnation's ledger row."""

    replica: int
    incarnation: int
    run_id: str
    started_unix: float = 0.0
    ended_unix: float = 0.0
    exit_code: Optional[int] = None
    classification: str = ""
    progress_at_exit: int = 0  # router-fed completions when it died
    downtime_s: float = 0.0  # death -> its successor's launch
    note: str = ""

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class _ReplicaSlot:
    """Mutable per-replica-index state: the live handle plus the
    relaunch bookkeeping (state machine live -> down -> live, or
    -> failed when a rail fires)."""

    def __init__(self, index: int):
        self.index = index
        self.state = "idle"  # idle | live | down | failed
        self.handle = None
        self.incarnation = -1
        self.run_id = ""
        self.started = 0.0
        self.died_at = 0.0
        self.relaunch_at = 0.0
        self.backoff_exp = 0
        self.no_progress = 0
        self.progress = 0  # router-fed monotone completion count
        self.progress_at_launch = 0
        self.pending_class: Optional[str] = None
        self.pending_note = ""
        self.restarts = 0
        self.fail_reason = ""


class ReplicaSetSupervisor:
    """Keep N serving replicas alive: the RunSupervisor loop generalized
    from "relaunch the training world" (one blocking launch-classify-
    relaunch cycle) to "N concurrent children, each on its own
    classify/backoff/crash-loop track, polled without blocking" —
    the fleet router drives ``poll()`` from its dispatch loop.

    Shared with RunSupervisor: the exits-registry classification
    (``classify_exit``), :class:`RestartPolicy` semantics (backoff
    doubling on consecutive no-progress deaths, reset on progress),
    per-incarnation run ids (``replica<K>-i<N>`` — heartbeats and
    journal assignments are stamped with them so a dead incarnation's
    records never pass for the live one's), the crash-loop guard
    (``crash_loop_threshold`` consecutive deaths of one replica without
    a served request end THAT replica with a post-mortem — the fleet
    degrades to N-1 instead of burning the host on a relaunch loop),
    and a restart ledger. New here: the ledger folds into an
    **availability** metric — replica-seconds live over replica-seconds
    owed since ``start()`` — the serving twin of the training ledger's
    goodput charge (obs schema v11 ``serving_fleet`` map).

    ``spawn(ctx)`` returns a replica handle exposing ``poll() ->
    Optional[int]`` and ``kill()`` (the router's subprocess handles add
    send/recv on top; the supervisor only manages lifecycle). ``ctx``
    carries ``replica``, ``incarnation``, ``run_id``, ``restarts``.

    The router reports progress via ``note_progress(idx, completed)``
    (a monotone per-replica completion count from heartbeats) and asks
    for watchdog kills via ``kill(idx, classify_as=..., note=...)`` —
    a stalled replica's SIGKILL would otherwise classify as ``error``;
    the router knows the cause (no heartbeat with work in flight) and
    pins the classification before the exit code exists.
    """

    def __init__(
        self,
        spawn: Callable[[dict], object],
        n_replicas: int,
        *,
        ledger_path: Optional[str] = None,
        policies: Optional[Dict[str, RestartPolicy]] = None,
        max_restarts_per_replica: int = 8,
        restart_backoff_s: float = 1.0,
        crash_loop_threshold: int = 3,
        clock: Callable[[], float] = time.time,
        log: Callable[[str], None] = None,
    ):
        assert n_replicas >= 1, n_replicas
        self.spawn = spawn
        self.n_replicas = int(n_replicas)
        self.ledger_path = ledger_path
        self.policies = policies or default_replica_policies()
        self.max_restarts_per_replica = int(max_restarts_per_replica)
        self.restart_backoff_s = float(restart_backoff_s)
        self.crash_loop_threshold = max(1, int(crash_loop_threshold))
        self._clock = clock
        self._log = log or (
            lambda msg: print(f"[replica-supervisor] {msg}", flush=True)
        )
        self.slots = [_ReplicaSlot(i) for i in range(self.n_replicas)]
        self.entries: List[_ReplicaEntry] = []
        self.started_at: Optional[float] = None
        self.stalls_detected = 0

    # -- lifecycle ---------------------------------------------------------

    def _launch(self, slot: _ReplicaSlot) -> dict:
        slot.incarnation += 1
        slot.run_id = f"replica{slot.index}-i{slot.incarnation}"
        ctx = {
            "replica": slot.index,
            "incarnation": slot.incarnation,
            "run_id": slot.run_id,
            "restarts": slot.restarts,
        }
        slot.handle = self.spawn(ctx)
        slot.started = self._clock()
        slot.progress_at_launch = slot.progress
        slot.pending_class = None
        slot.pending_note = ""
        if slot.incarnation > 0 and slot.died_at:
            # close the downtime of the incarnation this launch replaces
            for e in reversed(self.entries):
                if e.replica == slot.index:
                    e.downtime_s = max(0.0, slot.started - slot.died_at)
                    break
        slot.state = "live"
        self._write_ledger()
        return ctx

    def start(self) -> None:
        """Launch all N replicas (incarnation 0 each)."""
        assert self.started_at is None, "start() is one-shot"
        self.started_at = self._clock()
        for slot in self.slots:
            self._launch(slot)
            self._log(
                f"replica {slot.index} launched (run_id {slot.run_id})"
            )

    def handle(self, idx: int):
        """The CURRENT incarnation's handle for replica ``idx`` (None
        while it is down/failed)."""
        slot = self.slots[idx]
        return slot.handle if slot.state == "live" else None

    def run_id(self, idx: int) -> str:
        return self.slots[idx].run_id

    def live_indices(self) -> List[int]:
        return [s.index for s in self.slots if s.state == "live"]

    def note_progress(self, idx: int, completed: int) -> None:
        """Router-fed monotone completion count for replica ``idx`` —
        the crash-loop guard's progress signal (a replica that keeps
        dying without ever completing a request is looping)."""
        self.slots[idx].progress = max(self.slots[idx].progress, completed)

    def kill(
        self, idx: int, classify_as: str = "replica_loss", note: str = ""
    ) -> None:
        """Router-initiated kill with a pinned classification: the
        watchdog path for a stalled replica. The SIGKILL's raw exit
        code (a signal death -> ``error``) must not pick the policy —
        the router knows WHY it killed."""
        slot = self.slots[idx]
        if slot.state != "live" or slot.handle is None:
            return
        if slot.pending_class is not None:
            return  # kill already in flight; don't double-count
        slot.pending_class = classify_as
        slot.pending_note = note
        self.stalls_detected += 1
        self._log(
            f"replica {idx} (run_id {slot.run_id}) killed by router: "
            f"{note or classify_as}"
        )
        slot.handle.kill()

    def stop_all(self) -> None:
        """Kill every live replica (fleet shutdown; no relaunch —
        callers stop polling after this)."""
        for slot in self.slots:
            if slot.state == "live" and slot.handle is not None:
                slot.pending_class = "ok"
                slot.pending_note = "fleet shutdown"
                slot.handle.kill()
                slot.state = "idle"
        self._write_ledger(final=True)

    # -- the poll loop -----------------------------------------------------

    def poll(self) -> List[dict]:
        """One non-blocking sweep: reap deaths, classify, schedule and
        perform due relaunches. Returns events the router acts on:
        ``{"event": "died", "replica": i, "run_id": ...,
        "classification": ...}`` (requeue that incarnation's in-flight
        work), ``{"event": "relaunched", "replica": i, "run_id": ...}``
        (a fresh handle is installed), and ``{"event": "gave_up",
        "replica": i, "reason": ..., "post_mortem": ...}`` (the fleet
        is permanently down a replica)."""
        now = self._clock()
        events: List[dict] = []
        for slot in self.slots:
            if slot.state == "live" and slot.handle is not None:
                code = slot.handle.poll()
                if code is None:
                    continue
                events.extend(self._reap(slot, code, now))
            elif slot.state == "down" and now >= slot.relaunch_at:
                ctx = self._launch(slot)
                self._log(
                    f"replica {slot.index} relaunched (run_id "
                    f"{slot.run_id}, restart {slot.restarts})"
                )
                events.append(
                    {
                        "event": "relaunched",
                        "replica": slot.index,
                        "run_id": slot.run_id,
                        "ctx": ctx,
                    }
                )
        return events

    def _reap(self, slot: _ReplicaSlot, code: int, now: float) -> List[dict]:
        cls = slot.pending_class or classify_exit(code)
        entry = _ReplicaEntry(
            replica=slot.index,
            incarnation=slot.incarnation,
            run_id=slot.run_id,
            started_unix=slot.started,
            ended_unix=now,
            exit_code=code,
            classification=cls,
            progress_at_exit=slot.progress,
            note=slot.pending_note,
        )
        self.entries.append(entry)
        slot.died_at = now
        dead_run_id = slot.run_id
        self._log(
            f"replica {slot.index} (run_id {dead_run_id}) exited "
            f"{code} -> classified {cls!r}"
        )
        events = [
            {
                "event": "died",
                "replica": slot.index,
                "run_id": dead_run_id,
                "classification": cls,
                # the dead incarnation's handle: the router drains its
                # remaining output (exactly-once delivery) before the
                # journal requeues its in-flight work
                "handle": slot.handle,
            }
        ]
        policy = self.policies.get(cls) or self.policies["error"]
        if not policy.restart:
            slot.state = "idle"
            slot.handle = None
            self._write_ledger()
            return events

        # crash-loop guard: progress (router-fed completions) must
        # advance across THIS replica's consecutive incarnations
        if slot.progress > slot.progress_at_launch:
            slot.no_progress = 0
            slot.backoff_exp = 0
        else:
            slot.no_progress += 1
        slot.handle = None
        if slot.no_progress >= self.crash_loop_threshold:
            return events + [self._give_up(
                slot,
                f"no completed request across {slot.no_progress} "
                f"consecutive incarnation(s)",
            )]
        if slot.restarts >= self.max_restarts_per_replica:
            return events + [self._give_up(
                slot,
                f"max_restarts_per_replica="
                f"{self.max_restarts_per_replica} exhausted",
            )]
        delay = policy.cooldown_s
        if policy.backoff:
            delay += self.restart_backoff_s * (2**slot.backoff_exp)
            slot.backoff_exp += 1
        slot.restarts += 1
        slot.state = "down"
        slot.relaunch_at = now + delay
        self._write_ledger()
        return events

    def _give_up(self, slot: _ReplicaSlot, reason: str) -> dict:
        slot.state = "failed"
        slot.fail_reason = reason
        pm_lines = [
            f"replica {slot.index} given up: {reason}"
            + (f" (ledger: {self.ledger_path})" if self.ledger_path else "")
        ]
        for e in self.entries:
            if e.replica != slot.index:
                continue
            pm_lines.append(
                f"  incarnation {e.incarnation}: exit {e.exit_code} -> "
                f"{e.classification}, completions at exit "
                f"{e.progress_at_exit}, restart downtime "
                f"{e.downtime_s:.1f}s"
                + (f" ({e.note})" if e.note else "")
            )
        pm = "\n".join(pm_lines)
        self._log(pm)
        self._write_ledger()
        return {
            "event": "gave_up",
            "replica": slot.index,
            "reason": reason,
            "post_mortem": pm,
        }

    # -- ledger / availability ---------------------------------------------

    def restarts(self) -> int:
        return sum(s.restarts for s in self.slots)

    def availability(self, now: Optional[float] = None) -> float:
        """Replica-seconds live / replica-seconds owed since start():
        the restart ledger folded into one number. 1.0 = no replica was
        ever down; every death subtracts its death-to-relaunch gap
        (open gaps of currently-down/failed replicas count up to
        ``now``). The serving acceptance records this measured < 1.0
        under churn (chip_smoke.py's fleet phase)."""
        if self.started_at is None:
            return 1.0
        now = self._clock() if now is None else now
        owed = (now - self.started_at) * self.n_replicas
        if owed <= 0:
            return 1.0
        down = sum(e.downtime_s for e in self.entries)
        for slot in self.slots:
            if slot.state in ("down", "failed") and slot.died_at:
                closed = any(
                    e.replica == slot.index and e.downtime_s > 0
                    for e in reversed(self.entries)
                    if e.incarnation == slot.incarnation
                )
                if not closed:
                    down += max(0.0, now - slot.died_at)
        return max(0.0, min(1.0, 1.0 - down / owed))

    def ledger(self, final: bool = False) -> dict:
        return {
            "version": LEDGER_VERSION,
            "kind": "replica_set",
            "n_replicas": self.n_replicas,
            "restarts": self.restarts(),
            "stalls_detected": self.stalls_detected,
            "availability": round(self.availability(), 6),
            "replica_downtime_s": round(
                sum(e.downtime_s for e in self.entries), 6
            ),
            "entries": [e.as_dict() for e in self.entries],
        }

    def _write_ledger(self, final: bool = False) -> None:
        if not self.ledger_path:
            return
        led = self.ledger(final=final)
        d = os.path.dirname(os.path.abspath(self.ledger_path))
        os.makedirs(d, exist_ok=True)
        tmp = self.ledger_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(led, f, indent=1)
        os.replace(tmp, self.ledger_path)


def supervise_from_config(cfg, build_command, **kwargs) -> RunSupervisor:
    """RunSupervisor with the policy knobs read from TrainConfig
    (``max_restarts`` / ``restart_backoff_s`` / ``crash_loop_threshold``,
    as in the JAX package)."""
    kwargs.setdefault("max_restarts", int(getattr(cfg, "max_restarts", 8)))
    kwargs.setdefault(
        "restart_backoff_s", float(getattr(cfg, "restart_backoff_s", 5.0))
    )
    kwargs.setdefault(
        "crash_loop_threshold",
        int(getattr(cfg, "crash_loop_threshold", 3)),
    )
    kwargs.setdefault("num_slices", max(1, int(getattr(cfg, "num_slices", 0) or 1)))
    return RunSupervisor(build_command, **kwargs)


def main(argv=None) -> int:
    """One-host CLI: everything after ``--`` is the training command,
    relaunched verbatim each incarnation (an ``{num_slices}`` placeholder
    in any arg is substituted per incarnation for shrink restarts)."""
    import argparse

    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" in argv:
        split = argv.index("--")
        argv, cmd = argv[:split], argv[split + 1 :]
    else:
        cmd = []
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ledger", required=True)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--target-step", type=int, default=None)
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--restart-backoff-s", type=float, default=5.0)
    ap.add_argument("--crash-loop-threshold", type=int, default=3)
    ap.add_argument("--anomaly-cooldown-s", type=float, default=30.0)
    ap.add_argument("--num-slices", type=int, default=1)
    ap.add_argument(
        "--on-slice-loss", choices=("shrink", "same"), default="shrink"
    )
    ap.add_argument("--log-dir", default=None)
    args = ap.parse_args(argv)
    if not cmd:
        ap.error("no training command after '--'")
    if args.target_step is not None and not args.heartbeat:
        ap.error(
            "--target-step requires --heartbeat (the run's obs "
            "heartbeat.json): completion is read from the heartbeat step"
        )

    def build(ctx):
        return [[a.replace("{num_slices}", str(ctx["num_slices"])) for a in cmd]]

    result = RunSupervisor(
        build,
        ledger_path=args.ledger,
        heartbeat_path=args.heartbeat,
        target_step=args.target_step,
        max_restarts=args.max_restarts,
        restart_backoff_s=args.restart_backoff_s,
        crash_loop_threshold=args.crash_loop_threshold,
        anomaly_cooldown_s=args.anomaly_cooldown_s,
        on_slice_loss=args.on_slice_loss,
        num_slices=args.num_slices,
        log_dir=args.log_dir,
    ).run()
    print(
        f"[supervisor] {result.status}: {result.restarts} restart(s), "
        f"final step {result.final_step}"
    )
    return 0 if result.status == "completed" else 1


if __name__ == "__main__":
    sys.exit(main())
