"""Serving-fleet resilience: a router + replica pool over ServingEngine.

Counterpart of ``fms_fsdp_tpu/serve/fleet.py``. N replica child
processes (``serve/replica.py``), each running a full ``ServingEngine``,
speak a line-delimited JSON protocol over stdin/stdout to one
:class:`FleetRouter` in the parent:

    router -> replica:  {"type": "submit", "rid", "prompt",
                         "max_new_tokens", "deadline_s"}
                        {"type": "resume", "rid", "data" | "transfer_id"
                         + "total", "max_new_tokens", "deadline_s"}
                        {"type": "drain"}
    replica -> router:  {"type": "hb", "iterations", "completed",
                         "slots_busy", "queue_depth"}
                        {"type": "done", "rid", "tokens", "ttft"}
                        {"type": "handoff" | "migrate", "rid", "bytes",
                         "data" | "transfer_id" + "total", "ttft"}
                        {"type": "reject" | "returned" | "expired", "rid"}

Disaggregation (``FleetConfig.prefill_replicas`` > 0): the first K
replica indices run ``role="prefill"`` engines, the rest
``role="decode"``. A fresh request dispatches to a prefill replica, which
answers with a ``handoff`` (serve/disagg/handoff.py); the router JOURNALS
it before forwarding it as a ``resume`` to a decode replica, so a death
on either side replays the journaled bytes or re-prefills: exactly once
either way.

Transport (``FleetConfig.handoff_transport``): ``"chunked"`` moves
handoff frames on each replica's data channel (a socketpair made at
spawn) as CRC-checked, acked chunks with bounded-backoff retransmit and
an in-flight cap (serve/disagg/transport.py), with chunk-level progress
journaled so an interrupted transfer to a live incarnation resumes with
only the unacked chunks; ``"blob"`` relays the frame as one base64 line.

Drain-and-migrate (:meth:`FleetRouter.preempt`): SIGTERM, not SIGKILL.
The replica hands queued rids back, packs each live decode stream and
ships them as ``migrate`` transfers, then exits ``preempted``; the
streams resume on siblings with zero recompute.

Durability lives at the router: every transition is a journal record
(:class:`RequestJournal`); a replica death loses computation, never
requests: its in-flight rids requeue at the queue front in admission
order, and completions are deduplicated against the journal. Death is
an exit (classified by
:class:`~fms_fsdp_tpu_torch.resilience.supervisor.ReplicaSetSupervisor`)
or a stall (no heartbeat with work in flight for ``stall_timeout_s``: the
watchdog kills it as ``replica_loss``). Relaunch is the supervisor's
keep-N policy; the restart ledger folds into the availability metric.
Admission sheds typed (:class:`RequestRejected`): ``too_large``,
``overloaded``, ``deadline_unmeetable``.

This module imports no torch: the router is orchestration.
"""

import base64
import json
import os
import socket as _socketlib
import subprocess
import sys as _sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from queue import Empty, Queue
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from fms_fsdp_tpu_torch.resilience.supervisor import ReplicaSetSupervisor
from fms_fsdp_tpu_torch.serve.disagg.transport import (
    KIND_ACK,
    ChunkReceiver,
    ChunkSender,
    DataChannel,
    TransportError,
    ensure_transfer_ids_above,
    next_transfer_id,
    split_payload,
)
from fms_fsdp_tpu_torch.serve.scheduler import (
    REJECT_DEADLINE_UNMEETABLE,
    REJECT_OVERLOADED,
    REJECT_TOO_LARGE,
    RequestRejected,
)


class ReplicaLostError(RuntimeError):
    """The fleet can no longer serve: every replica is gone (dead or
    given up by the crash-loop guard) with work still outstanding.
    Raised by the router's poll loop; through the classified entry
    wrapper it exits with the ``replica_loss`` registry code (10) so an
    outer supervisor reads the cause from the exit status."""


# journal record states
J_QUEUED = "queued"
J_ASSIGNED = "assigned"
J_COMPLETED = "completed"
J_EXPIRED = "expired"
J_FAILED = "failed"


@dataclass
class JournalRecord:
    """One request's durable router-side state. ``rid`` is the router's
    id (admission order — requeue ordering keys on it); the engine-side
    rid inside a replica is private to that incarnation."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    deadline_s: Optional[float] = None  # absolute, router-clock
    state: str = J_QUEUED
    submit_t: float = 0.0
    finish_t: Optional[float] = None
    replica: Optional[int] = None  # current/last assignment
    run_id: str = ""  # incarnation the assignment went to
    tokens: Optional[List[int]] = None
    requeues: int = 0
    fail_reason: str = ""
    # engine-reported time-to-first-token of the COMPLETING
    # incarnation (a duration; requeue waits are visible in ``latency``
    # instead, which spans admission to delivery on the router clock).
    # In a disagg fleet the prefill side's handoff carries the true
    # TTFT — the decode side never re-records it.
    engine_ttft: Optional[float] = None
    # disaggregation: the journaled PageHandoff (base64 wire bytes)
    # once a prefill replica produced it; a rid carrying one dispatches
    # as a "resume" to a decode replica, and a decode-side death
    # requeues the BYTES, not a recompute
    handoff: Optional[str] = None
    handoff_bytes: int = 0
    handoff_t: Optional[float] = None
    handoffs: int = 0  # times a prefill replica handed this rid off

    @property
    def latency(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t


class RequestJournal:
    """Admission/assignment/completion journal: the router's source of
    truth for what has been promised and what has been delivered.

    Every transition appends one line to the event log (JSONL,
    ``path``; "" disables) and mutates the in-memory record — the
    in-memory side answers the hot-path queries (what is queued, what
    is in flight on incarnation X, has rid Y already completed), the
    log is the post-mortem artifact the soak inspects.

    Exactly-once completion: :meth:`complete` returns False (and
    counts a duplicate) when the rid is already terminal — the dedup
    point that makes replica-death-after-emit safe.

    Chunk-level transfer progress (``transfer_begin``/``chunk_ack``/
    ``transfer_complete`` events, mirrored in :attr:`transfers`) makes
    partial state transfers resumable: a sender rebuilt over
    :meth:`transfer_acks` retransmits only the unacked chunks.

    ``resume=True`` replays an existing event log before appending:
    records are rebuilt, terminal rids stay terminal (the dedup gate
    survives the relaunch), non-terminal rids requeue, and in-flight
    chunk progress is restored. A torn TRAILING line (the crash
    happened mid-append) is truncated with a warning; a torn line with
    valid records after it means the file is corrupt and replay raises.
    Handoff/token payloads are not journaled — a replayed rid that had
    handed off re-prefills from its prompt (which IS journaled)."""

    def __init__(
        self, path: str = "", clock: Callable[[], float] = time.monotonic,
        resume: bool = False,
    ):
        self.path = path
        self.clock = clock
        self.records: Dict[int, JournalRecord] = {}
        self.queued: deque = deque()  # rids, dispatch order
        # run_id -> set of rids currently assigned to that incarnation
        self._inflight: Dict[str, set] = {}
        self._next_rid = 0
        self.duplicates_dropped = 0
        self.requeued_total = 0
        # transfer_id -> {"rid", "total", "kind", "run_id", "acked" set}
        self.transfers: Dict[int, dict] = {}
        self.torn_tail_dropped = 0
        self._fh = None
        replayed = []
        if path and resume and os.path.exists(path):
            replayed = self._read_for_replay(path)
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(path, "a")
        if replayed:
            self._apply_replay(replayed)

    # -- replay (router relaunch over an existing journal) -----------------

    def _read_for_replay(self, path: str) -> List[dict]:
        """Parse the event log, tolerating one torn line AT THE TAIL
        (truncate-and-warn — a crash mid-append tears at most the last
        record). A torn line followed by valid records is real
        corruption: refuse to replay rather than silently skip."""
        with open(path, "rb") as f:
            raw = f.read()
        lines = raw.split(b"\n")
        events: List[dict] = []
        keep_upto = 0  # byte offset of the last clean record boundary
        off = 0
        for i, line in enumerate(lines):
            nxt = off + len(line) + 1
            if line.strip():
                try:
                    events.append(json.loads(line))
                except ValueError:
                    tail = b"".join(
                        ln for ln in lines[i + 1:] if ln.strip()
                    )
                    if tail:
                        raise ValueError(
                            f"journal {path}: torn record at line "
                            f"{i + 1} with valid records after it — "
                            f"corrupt log, refusing to replay"
                        ) from None
                    _sys.stderr.write(
                        f"[request-journal] WARNING: {path} ends in a "
                        f"torn record (line {i + 1}, "
                        f"{len(line)} bytes) — dropped; events up to "
                        f"the last clean boundary replay\n"
                    )
                    self.torn_tail_dropped = 1
                    with open(path, "wb") as f:
                        f.write(raw[:keep_upto])
                    return events
            keep_upto = min(nxt, len(raw))
            off = nxt
        return events

    def _apply_replay(self, events: List[dict]) -> None:
        for ev in events:
            kind = ev.get("event")
            rid = ev.get("rid")
            if kind == "transfer_begin":
                self.transfers[ev["transfer_id"]] = {
                    "rid": rid,
                    "total": int(ev.get("total", 0)),
                    "kind": ev.get("kind", "resume"),
                    "run_id": ev.get("run_id", ""),
                    "acked": set(),
                }
                continue
            if kind == "chunk_ack":
                t = self.transfers.get(ev["transfer_id"])
                if t is not None:
                    t["acked"].add(int(ev["seq"]))
                continue
            if kind in ("transfer_complete", "transfer_abort"):
                self.transfers.pop(ev["transfer_id"], None)
                continue
            if kind == "duplicate_dropped":
                self.duplicates_dropped += 1
                continue
            if kind == "admit":
                rec = JournalRecord(
                    rid=rid,
                    prompt=list(ev.get("prompt", [])),
                    max_new_tokens=int(ev.get("max_new_tokens", 0)),
                    deadline_s=ev.get("deadline_s"),
                    submit_t=ev.get("t", 0.0),
                )
                self.records[rid] = rec
                self._next_rid = max(self._next_rid, rid + 1)
                continue
            rec = self.records.get(rid)
            if rec is None:
                continue
            if kind == "assign":
                rec.state = J_ASSIGNED
                rec.replica = ev.get("replica")
                rec.run_id = ev.get("run_id", "")
            elif kind == "complete":
                rec.state = J_COMPLETED
                rec.finish_t = ev.get("t")
            elif kind == "handoff":
                # the wire bytes are not journaled: the replayed rid
                # re-prefills from its prompt (counted, not resurrected)
                rec.state = J_QUEUED
                rec.replica = None
                rec.run_id = ""
                rec.handoff = None
                rec.handoff_bytes = int(ev.get("bytes", 0))
                rec.handoffs += 1
            elif kind in ("requeue", "returned", "reprefill"):
                rec.state = J_QUEUED
                rec.replica = None
                rec.run_id = ""
                if kind == "requeue":
                    rec.requeues += 1
                    self.requeued_total += 1
                if kind == "reprefill":
                    rec.handoff = None
                    rec.handoff_bytes = 0
            elif kind == "fail":
                rec.state = J_FAILED
                rec.fail_reason = ev.get("reason", "")
                rec.finish_t = ev.get("t")
            elif kind == "expire":
                rec.state = J_EXPIRED
                rec.finish_t = ev.get("t")
        # every incarnation of the previous process is gone: requeue
        # what was assigned (new events — the log stays append-only)
        for rid in sorted(self.records):
            rec = self.records[rid]
            if rec.state == J_ASSIGNED:
                from_run = rec.run_id
                rec.state = J_QUEUED
                rec.replica = None
                rec.run_id = ""
                rec.requeues += 1
                self.requeued_total += 1
                self._event("requeue", rid, from_run_id=from_run,
                            by="replay")
        self.queued = deque(
            rid for rid in sorted(self.records)
            if self.records[rid].state == J_QUEUED
        )
        if self.transfers:
            ensure_transfer_ids_above(max(self.transfers))

    def _event(self, event: str, rid: int, **extra) -> None:
        # first arg deliberately named ``event``: payloads may carry a
        # ``kind=`` field of their own (transfer_begin, duplicate
        # handoff drops)
        if self._fh is None:
            return
        rec = {"event": event, "rid": rid, "t": self.clock(), **extra}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- transitions -------------------------------------------------------

    def admit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        deadline_s: Optional[float] = None,
    ) -> int:
        rid = self._next_rid
        self._next_rid += 1
        rec = JournalRecord(
            rid=rid,
            prompt=list(prompt),
            max_new_tokens=int(max_new_tokens),
            deadline_s=deadline_s,
            submit_t=self.clock(),
        )
        self.records[rid] = rec
        self.queued.append(rid)
        # the prompt itself is journaled: replay after a router relaunch
        # must be able to re-dispatch (recompute-on-resume needs the
        # tokens, not just their count)
        self._event("admit", rid, prompt=rec.prompt,
                    prompt_len=len(rec.prompt),
                    max_new_tokens=rec.max_new_tokens,
                    deadline_s=rec.deadline_s)
        return rid

    def assign(self, rid: int, replica: int, run_id: str) -> JournalRecord:
        rec = self.records[rid]
        assert rec.state == J_QUEUED, (rid, rec.state)
        rec.state = J_ASSIGNED
        rec.replica = replica
        rec.run_id = run_id
        self._inflight.setdefault(run_id, set()).add(rid)
        self._event("assign", rid, replica=replica, run_id=run_id)
        return rec

    def complete(self, rid: int, tokens: Sequence[int]) -> bool:
        """Record a delivered completion. Returns False — and drops the
        tokens — when the rid is already terminal: the exactly-once
        gate (a dead replica's late ``done`` line, or a replica killed
        after emitting, must not double-deliver)."""
        rec = self.records.get(rid)
        if rec is None or rec.state in (J_COMPLETED, J_EXPIRED, J_FAILED):
            self.duplicates_dropped += 1
            self._event("duplicate_dropped", rid)
            return False
        if rec.state == J_ASSIGNED:
            self._inflight.get(rec.run_id, set()).discard(rid)
        elif rec.state == J_QUEUED:
            # completed by an incarnation we already requeued it from
            # (the done line raced the death sweep): deliver this copy
            # and pull it back out of the queue — recompute would
            # double-emit
            try:
                self.queued.remove(rid)
            except ValueError:
                pass
        rec.state = J_COMPLETED
        rec.tokens = list(tokens)
        rec.finish_t = self.clock()
        rec.handoff = None  # delivered: the journaled bytes are dead
        self._event("complete", rid, n_tokens=len(rec.tokens))
        return True

    def handoff(self, rid: int, data: str, nbytes: int) -> bool:
        """A prefill replica handed this rid off: journal the wire
        bytes and move the rid back to QUEUED so dispatch forwards it
        to a decode replica. The journal write IS the crash-safety
        point — from here on, a death on either side replays these
        bytes instead of recomputing the prefill. Returns False (and
        counts a duplicate) when the rid is already terminal — a
        handoff that raced a completion or expiry must not resurrect
        the request."""
        rec = self.records.get(rid)
        if rec is None or rec.state in (J_COMPLETED, J_EXPIRED, J_FAILED):
            self.duplicates_dropped += 1
            self._event("duplicate_dropped", rid, kind="handoff")
            return False
        if rec.state == J_ASSIGNED:
            self._inflight.get(rec.run_id, set()).discard(rid)
        rec.state = J_QUEUED
        rec.replica = None
        rec.run_id = ""
        rec.handoff = data
        rec.handoff_bytes = int(nbytes)
        rec.handoff_t = self.clock()
        rec.handoffs += 1
        if rid not in self.queued:
            self.queued.appendleft(rid)
        self._event("handoff", rid, bytes=int(nbytes))
        return True

    def requeue_incarnation(self, run_id: str) -> List[int]:
        """A replica incarnation died: move every rid still assigned to
        it back to the queue FRONT, preserving original admission order
        among themselves (lowest rid dispatches first — the same
        position they would have held had they never been assigned).
        Their partial streams were never delivered, so they recompute
        from the original prompt on re-dispatch."""
        rids = sorted(self._inflight.pop(run_id, set()))
        for rid in reversed(rids):
            rec = self.records[rid]
            rec.state = J_QUEUED
            rec.replica = None
            rec.run_id = ""
            rec.requeues += 1
            # rec.handoff survives on purpose: a rid that died on a
            # DECODE replica re-dispatches its journaled bytes; one
            # that died on the PREFILL side never had any and
            # re-prefills from the prompt
            self.queued.appendleft(rid)
            self.requeued_total += 1
            self._event("requeue", rid, from_run_id=run_id)
        return rids

    def fail(self, rid: int, reason: str) -> None:
        rec = self.records[rid]
        if rec.state == J_ASSIGNED:
            self._inflight.get(rec.run_id, set()).discard(rid)
        rec.state = J_FAILED
        rec.fail_reason = reason
        rec.finish_t = self.clock()
        self._event("fail", rid, reason=reason)

    def expire(self, rid: int) -> None:
        rec = self.records[rid]
        assert rec.state == J_QUEUED, (rid, rec.state)
        self.queued.remove(rid)
        rec.state = J_EXPIRED
        rec.finish_t = self.clock()
        self._event("expire", rid)

    def expire_assigned(self, rid: int) -> bool:
        """A replica reported it expired this request engine-side
        (deadline passed while queued or in flight there). Terminal,
        idempotent against races with the death sweep."""
        rec = self.records.get(rid)
        if rec is None or rec.state in (J_COMPLETED, J_EXPIRED, J_FAILED):
            return False
        if rec.state == J_ASSIGNED:
            self._inflight.get(rec.run_id, set()).discard(rid)
        elif rec.state == J_QUEUED:
            try:
                self.queued.remove(rid)
            except ValueError:
                pass
        rec.state = J_EXPIRED
        rec.finish_t = self.clock()
        self._event("expire", rid, by="replica")
        return True

    def unassign(self, rid: int) -> None:
        """A draining replica handed this request back unrun: back to
        the queue front for redispatch (same recompute contract as a
        death requeue, minus the death)."""
        rec = self.records.get(rid)
        if rec is None or rec.state != J_ASSIGNED:
            return
        self._inflight.get(rec.run_id, set()).discard(rid)
        rec.state = J_QUEUED
        rec.replica = None
        rec.run_id = ""
        self.queued.appendleft(rid)
        self._event("returned", rid)

    def reprefill(self, rid: int, reason: str = "") -> bool:
        """A decode replica rejected this rid's journaled handoff with a
        typed ``handoff_error`` (codec/version skew, import failure):
        the bytes are unusable for this fleet. Drop them and requeue at
        the FRONT for a fresh prefill — re-dispatching the same bytes
        would crash-loop the resume, and failing terminally would drop
        a request the fleet can still serve."""
        rec = self.records.get(rid)
        if rec is None or rec.state in (J_COMPLETED, J_EXPIRED, J_FAILED):
            return False
        if rec.state == J_ASSIGNED:
            self._inflight.get(rec.run_id, set()).discard(rid)
        elif rec.state == J_QUEUED:
            try:
                self.queued.remove(rid)
            except ValueError:
                pass
        rec.state = J_QUEUED
        rec.replica = None
        rec.run_id = ""
        rec.handoff = None
        rec.handoff_bytes = 0
        rec.requeues += 1
        self.requeued_total += 1
        self.queued.appendleft(rid)
        self._event("reprefill", rid, reason=reason)
        return True

    # -- chunk-level transfer progress -------------------------------------

    def transfer_begin(
        self, rid: int, transfer_id: int, total: int, nbytes: int,
        kind: str = "resume", run_id: str = "",
    ) -> None:
        self.transfers[transfer_id] = {
            "rid": rid,
            "total": int(total),
            "kind": kind,
            "run_id": run_id,
            "acked": set(),
        }
        self._event("transfer_begin", rid, transfer_id=transfer_id,
                    total=int(total), bytes=int(nbytes), kind=kind,
                    run_id=run_id)

    def chunk_ack(self, rid: int, transfer_id: int, seq: int) -> None:
        t = self.transfers.get(transfer_id)
        if t is not None:
            t["acked"].add(int(seq))
        self._event("chunk_ack", rid, transfer_id=transfer_id,
                    seq=int(seq))

    def transfer_complete(self, rid: int, transfer_id: int) -> None:
        self.transfers.pop(transfer_id, None)
        self._event("transfer_complete", rid, transfer_id=transfer_id)

    def transfer_acks(self, transfer_id: int) -> Set[int]:
        """The journaled acked-seq set — the seed that lets a rebuilt
        sender retransmit only what the receiver never confirmed."""
        t = self.transfers.get(transfer_id)
        return set(t["acked"]) if t is not None else set()

    def abort_transfers(self, run_id: str) -> List[int]:
        """Void every in-flight transfer whose receiving incarnation
        died: its chunk progress is meaningless against the relaunched
        incarnation's empty receiver (resume-with-seed is only sound
        toward the SAME incarnation)."""
        gone = [
            tid for tid, t in self.transfers.items()
            if t.get("run_id") == run_id
        ]
        for tid in gone:
            t = self.transfers.pop(tid)
            self._event("transfer_abort", t["rid"], transfer_id=tid,
                        run_id=run_id)
        return gone

    # -- queries -----------------------------------------------------------

    def inflight(self, run_id: str) -> int:
        return len(self._inflight.get(run_id, ()))

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in
               (J_QUEUED, J_ASSIGNED, J_COMPLETED, J_EXPIRED, J_FAILED)}
        for rec in self.records.values():
            out[rec.state] += 1
        return out

    def outstanding(self) -> int:
        c = self.counts()
        return c[J_QUEUED] + c[J_ASSIGNED]


class SubprocessReplica:
    """A replica child process handle: Popen + a reader thread draining
    its stdout into a message queue. Satisfies the supervisor's handle
    contract (``poll``/``kill``) and adds the router's ``send``/``recv``.

    The reader thread (daemon) parses line-delimited JSON; it exits when
    the child's stdout closes. ``recv`` drains whatever has arrived —
    including after death, which is exactly what the router's
    drain-before-requeue step needs.

    ``data_channel_label`` switches on the chunked transport: a
    socketpair is created here, the child's end rides ``--data-fd`` +
    ``pass_fds``, and the parent's end is wrapped in a
    :class:`~fms_fsdp_tpu_torch.serve.disagg.transport.DataChannel` exposed
    as :attr:`data_channel` (the label is the ``transport=`` fault
    filter key for the ROUTER side of this replica's wire)."""

    def __init__(
        self,
        argv: Sequence[str],
        env: Optional[Dict[str, str]] = None,
        stderr_path: Optional[str] = None,
        data_channel_label: str = "",
    ):
        self._stderr_f = (
            open(stderr_path, "ab") if stderr_path else subprocess.DEVNULL
        )
        self.data_channel: Optional[DataChannel] = None
        child_sock = None
        pass_fds = ()
        if data_channel_label:
            parent_sock, child_sock = _socketlib.socketpair()
            argv = list(argv) + ["--data-fd", str(child_sock.fileno())]
            pass_fds = (child_sock.fileno(),)
        self.proc = subprocess.Popen(
            list(argv),
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=self._stderr_f,
            env=env,
            pass_fds=pass_fds,
        )
        if child_sock is not None:
            child_sock.close()  # the child holds its own copy now
            self.data_channel = DataChannel(
                parent_sock, label=data_channel_label
            )
        self._msgs: Queue = Queue()
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True
        )
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            for line in self.proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    self._msgs.put(json.loads(line))
                except ValueError:
                    # a torn line from a killed replica: drop it (its
                    # rid stays non-terminal and recomputes)
                    pass
        except (OSError, ValueError):
            pass

    def send(self, msg: dict) -> bool:
        """Write one protocol line. Returns False when the pipe is gone
        (the death sweep will requeue whatever this failed to carry)."""
        try:
            self.proc.stdin.write((json.dumps(msg) + "\n").encode())
            self.proc.stdin.flush()
            return True
        except (OSError, ValueError):
            return False

    def recv(self) -> List[dict]:
        out = []
        while True:
            try:
                out.append(self._msgs.get_nowait())
            except Empty:
                return out

    def drain_final(self, timeout_s: float = 1.0) -> List[dict]:
        """After death: wait for the reader thread to consume the
        pipe's remainder, then drain. This runs BEFORE requeueing the
        dead incarnation's rids so any completion that escaped the
        dying process is delivered exactly once instead of recomputed."""
        self._reader.join(timeout=timeout_s)
        return self.recv()

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass

    def terminate(self) -> None:
        """SIGTERM — the drain-and-migrate preemption notice (the
        replica packs its live streams and exits ``preempted``), as
        opposed to ``kill``'s SIGKILL (unplanned death, requeue path)."""
        try:
            self.proc.terminate()
        except OSError:
            pass

    def close(self) -> None:
        if self.data_channel is not None:
            self.data_channel.close()
        if self._stderr_f is not subprocess.DEVNULL:
            try:
                self._stderr_f.close()
            except OSError:
                pass


def make_subprocess_spawn(
    workdir: str,
    model_cfg: dict,
    serve_cfg: dict,
    *,
    params: str = "",
    init_seed: int = 0,
    faults: str = "",
    env_extra: Optional[Dict[str, str]] = None,
    python: Optional[str] = None,
    prefill_replicas: int = 0,
    transport: str = "chunked",
    device: str = "",
    chunk_bytes: int = 0,
    inflight_bytes: int = 0,
    retries: int = -1,
    backoff_s: float = 0.0,
):
    """Build the supervisor spawn callback for real ``serve/replica.py``
    children. Writes the model/serve config JSONs under ``workdir`` once;
    each spawn launches ``python -m fms_fsdp_tpu_torch.serve.replica``
    with stderr teed to ``workdir/replica<K>-i<N>.stderr`` and its stats
    file at ``workdir/replica<K>-i<N>.stats.json``. The package's parent
    directory leads the child's ``PYTHONPATH``, so the child imports the
    same tree from any working directory.

    ``prefill_replicas`` mirrors FleetConfig: when > 0, replica indices
    below it get a ``role="prefill"`` ServeConfig and the rest
    ``role="decode"``.

    ``faults`` (an FMS_FAULTS spec) is exported ONLY to incarnation 0 of
    each replica: fire counters are per process, so a ``times=1`` kill
    inherited by the relaunch would fire again and crash-loop it.

    ``transport="chunked"`` gives every incarnation a data channel
    (``--data-fd``); ``"blob"`` keeps the stdio base64 relay.
    ``chunk_bytes`` / ``inflight_bytes`` size the child's outbound chunks
    and its in-flight cap, ``retries`` / ``backoff_s`` its retransmits (0
    and -1: the transport's defaults); give them FleetConfig's
    ``transport_*`` values so both directions of a handoff share one
    budget. ``device`` is the child's ``--device`` (empty: the card)."""
    os.makedirs(workdir, exist_ok=True)
    mpath = os.path.join(workdir, "model_cfg.json")
    spath = os.path.join(workdir, "serve_cfg.json")
    with open(mpath, "w") as f:
        json.dump(model_cfg, f)
    with open(spath, "w") as f:
        if prefill_replicas > 0:
            json.dump(dict(serve_cfg, role="decode"), f)
        else:
            json.dump(serve_cfg, f)
    ppath = os.path.join(workdir, "serve_cfg_prefill.json")
    if prefill_replicas > 0:
        with open(ppath, "w") as f:
            json.dump(dict(serve_cfg, role="prefill"), f)
    py = python or _sys.executable
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    def spawn(ctx: dict) -> "SubprocessReplica":
        env = dict(os.environ)
        env.update(env_extra or {})
        if faults and ctx["incarnation"] == 0:
            env["FMS_FAULTS"] = faults
        else:
            env.pop("FMS_FAULTS", None)
        env["FMS_RUN_ID"] = ctx["run_id"]
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p
        )
        scfg_path = (
            ppath if ctx["replica"] < prefill_replicas else spath
        )
        argv = [
            py, "-m", "fms_fsdp_tpu_torch.serve.replica",
            "--model-cfg", mpath,
            "--serve-cfg", scfg_path,
            "--replica", str(ctx["replica"]),
            "--stats-path", os.path.join(workdir, f"{ctx['run_id']}.stats.json"),
        ]
        if params:
            argv += ["--params", params]
        else:
            argv += ["--init-seed", str(init_seed)]
        if device:
            argv += ["--device", device]
        if chunk_bytes:
            argv += ["--chunk-bytes", str(chunk_bytes)]
        if inflight_bytes:
            argv += ["--inflight-bytes", str(inflight_bytes)]
        if retries >= 0:
            argv += ["--transport-retries", str(retries)]
        if backoff_s:
            argv += ["--transport-backoff-s", str(backoff_s)]
        return SubprocessReplica(
            argv,
            env=env,
            stderr_path=os.path.join(
                workdir, f"{ctx['run_id']}.stderr"
            ),
            data_channel_label=(
                f"rtr{ctx['replica']}" if transport == "chunked" else ""
            ),
        )

    return spawn


@dataclass
class FleetConfig:
    """Router-side knobs. ``max_seq_len`` mirrors the replicas'
    ServeConfig so ``too_large`` sheds at the router instead of
    bouncing off every replica."""

    n_replicas: int = 2
    max_seq_len: int = 0  # 0 = no router-side length check
    max_queue: int = 0  # router admission bound; 0 = unbounded
    max_inflight_per_replica: int = 8
    # stall watchdog: arms per incarnation only after its FIRST
    # heartbeat (readiness) — torch import, CUDA context and the warmup
    # step on a cold replica can dwarf any sane stall timeout, and requests are only
    # dispatched to ready replicas anyway. startup_timeout_s bounds the
    # never-became-ready case instead.
    stall_timeout_s: float = 10.0
    startup_timeout_s: float = 120.0
    min_decode_tokens_per_s: float = 0.0  # deadline admission estimator
    journal_path: str = ""
    ledger_path: str = ""
    restart_backoff_s: float = 0.5
    max_restarts_per_replica: int = 8
    crash_loop_threshold: int = 3
    drain_grace_s: float = 10.0
    # disaggregation: the first K replica indices are prefill-role, the
    # remaining n_replicas - K decode-role; 0 = every replica unified
    # (the v1 fleet). Fresh rids dispatch only to prefill replicas,
    # handoff-carrying rids only to decode replicas.
    prefill_replicas: int = 0
    # state-transfer transport (serve/disagg/transport.py): "chunked"
    # moves handoff/migrate frames on each replica's dedicated data
    # channel as CRC-checked, acked, retried chunks; "blob" keeps the
    # single-message base64 relay on stdio (byte-identical frames —
    # the codec is shared, pinned by tests/test_torch_transport.py)
    handoff_transport: str = "chunked"
    transport_chunk_bytes: int = 64 * 1024
    transport_inflight_bytes: int = 256 * 1024  # backpressure cap
    transport_retries: int = 5  # per chunk, exponential backoff
    transport_backoff_s: float = 0.05
    # replay an existing journal_path event log at startup (router
    # relaunch): terminal rids stay terminal, assigned rids requeue,
    # chunk progress restores; a torn trailing line truncates with a
    # warning
    journal_resume: bool = False


class FleetRouter:
    """The fleet's front door: typed admission, least-loaded dispatch,
    heartbeat/stall watchdog, death-sweep requeue, exactly-once
    delivery. Drive it with ``poll()`` from a loop (or
    ``run_until_idle``); it never blocks on a replica.

    ``spawn(ctx)`` builds a :class:`SubprocessReplica` (or a test
    double) for supervisor context ``ctx`` (``replica``,
    ``incarnation``, ``run_id``, ``restarts``)."""

    def __init__(
        self,
        spawn: Callable[[dict], SubprocessReplica],
        cfg: FleetConfig,
        *,
        clock: Callable[[], float] = time.monotonic,
        log: Callable[[str], None] = None,
    ):
        self.cfg = cfg
        self.clock = clock
        self._log = log or (
            lambda msg: print(f"[fleet-router] {msg}", flush=True)
        )
        self.journal = RequestJournal(
            cfg.journal_path, clock=clock, resume=cfg.journal_resume
        )
        self.supervisor = ReplicaSetSupervisor(
            spawn,
            cfg.n_replicas,
            ledger_path=cfg.ledger_path or None,
            max_restarts_per_replica=cfg.max_restarts_per_replica,
            restart_backoff_s=cfg.restart_backoff_s,
            crash_loop_threshold=cfg.crash_loop_threshold,
            clock=clock,
            log=self._log,
        )
        self._last_hb: Dict[int, float] = {}
        self._ready: Dict[int, bool] = {}  # first hb of this incarnation
        self._hb_stats: Dict[int, dict] = {}
        self.completed: List[JournalRecord] = []
        self.rejected: Dict[str, int] = {
            REJECT_TOO_LARGE: 0,
            REJECT_OVERLOADED: 0,
            REJECT_DEADLINE_UNMEETABLE: 0,
        }
        self.expired = 0
        self.failed = 0
        self.handoffs = 0  # handoff messages journaled (incl. repeats)
        # chunked transport state: outbound resume senders
        # (transfer_id -> (replica_idx, ChunkSender, rid)) and inbound
        # handoff/migrate reassembly ((replica_idx, transfer_id) ->
        # [ChunkReceiver, control-msg-or-None] — chunks can race ahead
        # of the stdio control message naming them)
        self._tx: Dict[int, Tuple[int, ChunkSender, int]] = {}
        self._rx: Dict[Tuple[int, int], list] = {}
        self._draining: Set[int] = set()  # preempted, excluded from dispatch
        self.handoff_retries = 0  # transfers that needed >= 1 retransmit
        self.chunks_resent = 0  # total retransmitted chunks (router side)
        self.transfers_resumed = 0  # continued past an interruption
        self.drain_migrations = 0  # live streams migrated off a preempt
        self.handoff_reprefills = 0  # typed handoff_error -> re-prefill
        self._started = False
        if not 0 <= cfg.prefill_replicas < max(1, cfg.n_replicas):
            raise ValueError(
                f"prefill_replicas={cfg.prefill_replicas} must leave at "
                f"least one decode replica out of n_replicas="
                f"{cfg.n_replicas} (0 disables disaggregation)"
            )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.supervisor.start()
        now = self.clock()
        for idx in self.supervisor.live_indices():
            self._last_hb[idx] = now
            self._ready[idx] = False
        self._started = True

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Graceful wind-down: ask every live replica to drain (running
        streams finish, its queued work comes back for redispatch),
        then poll until the replicas exit clean. A replica that exits 0
        classifies ``ok`` — the keep-N policy does NOT relaunch it."""
        timeout_s = self.cfg.drain_grace_s if timeout_s is None else timeout_s
        for idx in self.supervisor.live_indices():
            handle = self.supervisor.handle(idx)
            if handle is not None:
                handle.send({"type": "drain"})
        deadline = self.clock() + timeout_s
        while self.supervisor.live_indices() and self.clock() < deadline:
            self.poll()
            time.sleep(0.01)

    def preempt(self, idx: int) -> None:
        """Planned eviction of one replica: SIGTERM (drain-and-migrate
        notice) and stop dispatching to it. The replica packs each live
        decode stream (llama/mixtral pages, mamba slab) and ships them
        back as ``migrate`` transfers — re-journaled like handoffs,
        they resume on siblings with zero recompute — then exits clean
        (``preempted``) and the keep-N policy relaunches it."""
        handle = self.supervisor.handle(idx)
        if handle is None:
            return
        self._draining.add(idx)
        self._log(f"replica {idx} preempted: drain-and-migrate (SIGTERM)")
        terminate = getattr(handle, "terminate", None)
        if terminate is not None:
            terminate()
        else:
            handle.send({"type": "drain"})  # signal-less test double

    def shutdown(self) -> None:
        self.supervisor.stop_all()
        self.journal.close()

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        deadline_s: Optional[float] = None,
    ) -> int:
        """Admit a request into the journal (typed rejection on shed) —
        the same three-reason contract as engine-level admission
        (serve/scheduler.py), enforced before any replica sees it."""
        need = len(prompt) + int(max_new_tokens)
        if self.cfg.max_seq_len and need > self.cfg.max_seq_len:
            self.rejected[REJECT_TOO_LARGE] += 1
            raise RequestRejected(
                REJECT_TOO_LARGE,
                f"prompt+max_new_tokens = {need} exceeds replica "
                f"max_seq_len {self.cfg.max_seq_len}",
            )
        if self.cfg.max_queue and len(self.journal.queued) >= self.cfg.max_queue:
            self.rejected[REJECT_OVERLOADED] += 1
            raise RequestRejected(
                REJECT_OVERLOADED,
                f"router queue full ({self.cfg.max_queue}); back off",
            )
        if (
            deadline_s is not None
            and self.cfg.min_decode_tokens_per_s > 0
            and (deadline_s - self.clock())
            < max_new_tokens / self.cfg.min_decode_tokens_per_s
        ):
            self.rejected[REJECT_DEADLINE_UNMEETABLE] += 1
            raise RequestRejected(
                REJECT_DEADLINE_UNMEETABLE,
                f"deadline {deadline_s} unmeetable for {max_new_tokens} "
                f"tokens at floor rate "
                f"{self.cfg.min_decode_tokens_per_s}/s",
            )
        return self.journal.admit(prompt, max_new_tokens, deadline_s)

    # -- the poll loop -----------------------------------------------------

    def poll(self) -> List[JournalRecord]:
        """One router tick: reap/relaunch via the supervisor, deliver
        completions, watchdog stalls, expire hopeless queued work,
        dispatch. Returns records COMPLETED this tick."""
        assert self._started, "call start() first"
        delivered: List[JournalRecord] = []
        now = self.clock()

        # 1) supervisor sweep: deaths, relaunches, give-ups
        for ev in self.supervisor.poll():
            idx = ev["replica"]
            if ev["event"] == "died":
                # drain the dead incarnation's surviving output FIRST:
                # completions that escaped before death deliver
                # exactly once instead of recomputing — and a preempted
                # replica's final migrate chunks may still sit in its
                # data-channel socket buffer
                handle = ev.get("handle")
                if handle is not None:
                    delivered.extend(
                        self._process_msgs(idx, handle.drain_final())
                    )
                    ch = getattr(handle, "data_channel", None)
                    if ch is not None:
                        self._pump_channel_msgs(idx, ch)
                        self._finish_rx(idx)
                    handle.close()
                # outbound transfers to the dead incarnation are void:
                # the relaunched incarnation's receiver holds nothing,
                # so the rid re-sends whole on redispatch
                for tid in [
                    t for t, e in self._tx.items() if e[0] == idx
                ]:
                    _, sender, _rid = self._tx.pop(tid)
                    self.chunks_resent += sender.chunks_resent
                self.journal.abort_transfers(ev["run_id"])
                for key in [k for k in self._rx if k[0] == idx]:
                    del self._rx[key]
                self._draining.discard(idx)
                requeued = self.journal.requeue_incarnation(ev["run_id"])
                if requeued:
                    self._log(
                        f"replica {idx} ({ev['run_id']}) died "
                        f"[{ev['classification']}]; requeued "
                        f"{len(requeued)} in-flight request(s): "
                        f"{requeued}"
                    )
            elif ev["event"] == "relaunched":
                self._last_hb[idx] = now
                self._ready[idx] = False
                self._draining.discard(idx)
            elif ev["event"] == "gave_up":
                self._log(ev["post_mortem"])

        # 2) live replicas: drain protocol messages, then the data
        # plane (chunk/ack frames, outbound sender timers, completed
        # reassemblies)
        for idx in self.supervisor.live_indices():
            handle = self.supervisor.handle(idx)
            if handle is None:
                continue
            delivered.extend(self._process_msgs(idx, handle.recv()))
            ch = getattr(handle, "data_channel", None)
            if ch is not None:
                self._pump_channel_msgs(idx, ch)
        self._pump_senders()
        for idx in {k[0] for k in self._rx}:
            self._finish_rx(idx)

        # 3) stall watchdog: a READY replica owning in-flight work that
        # has not heartbeat within stall_timeout_s is wedged — kill it
        # with the classification pinned (the death sweep requeues). A
        # replica that never became ready (no first heartbeat: wedged
        # in startup) is bounded by startup_timeout_s instead.
        for idx in self.supervisor.live_indices():
            run_id = self.supervisor.run_id(idx)
            gap = now - self._last_hb.get(idx, now)
            if (
                self._ready.get(idx)
                and self.journal.inflight(run_id) > 0
                and gap > self.cfg.stall_timeout_s
            ):
                self.supervisor.kill(
                    idx,
                    classify_as="replica_loss",
                    note=(
                        f"replica_stall: no heartbeat for {gap:.1f}s "
                        f"with {self.journal.inflight(run_id)} "
                        f"request(s) in flight (stall_timeout_s="
                        f"{self.cfg.stall_timeout_s})"
                    ),
                )
            elif (
                not self._ready.get(idx)
                and gap > self.cfg.startup_timeout_s
            ):
                self.supervisor.kill(
                    idx,
                    classify_as="replica_loss",
                    note=(
                        f"replica never became ready within "
                        f"startup_timeout_s={self.cfg.startup_timeout_s}"
                    ),
                )

        # 4) expire hopeless queued requests (deadline passed while
        # waiting for a replica — the fleet-level expire_queued)
        for rid in [
            r for r in self.journal.queued
            if self.journal.records[r].deadline_s is not None
            and now > self.journal.records[r].deadline_s
        ]:
            self.journal.expire(rid)
            self.expired += 1

        # 5) dispatch: least-loaded live replica first, FIFO queue
        self._dispatch()

        # 6) liveness floor: nothing live, nothing relaunching, work
        # outstanding -> the fleet is lost
        if (
            self.journal.outstanding() > 0
            and not self.supervisor.live_indices()
            and not any(s.state == "down" for s in self.supervisor.slots)
        ):
            raise ReplicaLostError(
                f"all {self.cfg.n_replicas} replica(s) failed with "
                f"{self.journal.outstanding()} request(s) outstanding"
            )
        return delivered

    def _process_msgs(self, idx: int, msgs: List[dict]):
        delivered = []
        now = self.clock()
        for msg in msgs:
            t = msg.get("type")
            if t == "hb":
                self._last_hb[idx] = now
                self._ready[idx] = True
                self._hb_stats[idx] = msg
                self.supervisor.note_progress(
                    idx, int(msg.get("completed", 0))
                )
            elif t == "done":
                if self.journal.complete(msg["rid"], msg["tokens"]):
                    rec = self.journal.records[msg["rid"]]
                    if rec.engine_ttft is None:
                        # disagg: the prefill side's handoff already
                        # carried the true TTFT — keep it
                        rec.engine_ttft = msg.get("ttft")
                    self.completed.append(rec)
                    delivered.append(rec)
            elif t in ("handoff", "migrate"):
                if "data" in msg:
                    # blob transport: the frame rides the control line
                    self._ingest_frame(t, idx, msg, msg["data"])
                else:
                    # chunked transport: the control message names a
                    # transfer on the data channel; attach it to the
                    # reassembly entry (creating one if the chunks
                    # have not arrived yet)
                    key = (idx, msg["transfer_id"])
                    ent = self._rx.get(key)
                    if ent is None:
                        self._rx[key] = [
                            ChunkReceiver(
                                msg["rid"], msg["transfer_id"],
                                msg["total"], label=f"rtr{idx}",
                            ),
                            msg,
                        ]
                    else:
                        ent[1] = msg
            elif t == "expired":
                if self.journal.expire_assigned(msg["rid"]):
                    self.expired += 1
            elif t == "returned":
                self.journal.unassign(msg["rid"])
            elif t == "reject":
                rid = msg["rid"]
                reason = str(msg.get("reason") or "")
                rec = self.journal.records.get(rid)
                if (
                    reason.startswith("handoff_error")
                    and rec is not None
                    and rec.handoff is not None
                ):
                    # typed decode-side import failure (codec/version
                    # skew, pool mismatch): the journaled bytes are
                    # unusable — requeue for re-prefill instead of
                    # failing terminally or crash-looping the resume
                    if self.journal.reprefill(rid, reason):
                        self.handoff_reprefills += 1
                        self._log(
                            f"rid {rid} handoff rejected by replica "
                            f"{idx} ({reason}); requeued for re-prefill"
                        )
                else:
                    # replica-side admission disagreement (misconfig):
                    # terminal — recomputing would reject again
                    self.journal.fail(rid, f"replica reject: {reason}")
                    self.failed += 1
        return delivered

    # -- the data plane ----------------------------------------------------

    def _ingest_frame(
        self, kind: str, idx: int, msg: dict, data_b64: str
    ) -> None:
        """A whole handoff/migrate frame arrived (assembled or blob):
        journal it. Both kinds requeue the rid at the FRONT carrying
        the bytes — a migrated stream resumes on a sibling exactly the
        way a prefill handoff resumes on a decode replica."""
        rid = msg["rid"]
        if self.journal.handoff(rid, data_b64, msg.get("bytes", 0)):
            self.handoffs += 1
            rec = self.journal.records[rid]
            if rec.engine_ttft is None:
                rec.engine_ttft = msg.get("ttft")
            if kind == "migrate":
                self.drain_migrations += 1
                self.journal._event("migrate", rid, replica=idx)

    def _pump_channel_msgs(self, idx: int, channel: DataChannel) -> None:
        """Drain one replica's data channel: acks retire outbound
        chunks (journaling the progress), data frames feed inbound
        reassembly."""
        for m in channel.pump():
            tid = m["transfer_id"]
            if m["kind"] == KIND_ACK:
                ent = self._tx.get(tid)
                if ent is not None and ent[0] == idx:
                    if ent[1].on_ack(m):
                        self.journal.chunk_ack(ent[2], tid, m["seq"])
            else:
                key = (idx, tid)
                ent = self._rx.get(key)
                if ent is None:
                    ent = [
                        ChunkReceiver(
                            m["rid"], tid, m["total"], label=f"rtr{idx}"
                        ),
                        None,
                    ]
                    self._rx[key] = ent
                ent[0].on_chunk(m, channel)

    def _pump_senders(self) -> None:
        """Drive outbound resume transfers: retransmit timers, the
        in-flight cap, completion, permanent failure."""
        for tid in list(self._tx):
            idx, sender, rid = self._tx[tid]
            try:
                sender.pump()
            except TransportError as e:
                # retries exhausted / channel gone: the receiving
                # replica is the suspect — kill it with the
                # classification pinned; the death sweep requeues the
                # rid WITH its journaled bytes and the resume replays
                # whole on the relaunch
                del self._tx[tid]
                self.chunks_resent += sender.chunks_resent
                if sender.chunks_resent:
                    self.handoff_retries += 1
                self._log(
                    f"transfer {tid} (rid {rid}) to replica {idx} "
                    f"failed: {e}"
                )
                self.supervisor.kill(
                    idx,
                    classify_as="replica_loss",
                    note=f"transport: transfer {tid} failed ({e})",
                )
                continue
            if sender.done:
                del self._tx[tid]
                self.chunks_resent += sender.chunks_resent
                if sender.chunks_resent:
                    self.handoff_retries += 1
                if sender.resumed:
                    self.transfers_resumed += 1
                self.journal.transfer_complete(rid, tid)

    def _finish_rx(self, idx: int) -> None:
        """Hand completed inbound reassemblies (receiver full AND the
        control message arrived) to the journal."""
        for key in [k for k in self._rx if k[0] == idx]:
            receiver, meta = self._rx[key]
            if meta is None or not receiver.complete:
                continue
            del self._rx[key]
            data_b64 = base64.b64encode(receiver.assemble()).decode(
                "ascii"
            )
            self._ingest_frame(meta["type"], idx, meta, data_b64)

    def _eligible(self, rec: JournalRecord, live: List[int]) -> List[int]:
        """The replica indices allowed to take this record. Unified
        fleets: everyone. Disagg fleets: fresh rids go to the prefill
        indices, handoff-carrying rids to the decode indices."""
        k = self.cfg.prefill_replicas
        if k <= 0:
            return live
        if rec.handoff is None:
            return [i for i in live if i < k]
        return [i for i in live if i >= k]

    def _dispatch(self) -> None:
        # only READY replicas take work: a cold replica (importing,
        # warming up) would sit on assignments the others could serve —
        # and a preempted replica is packing up, not admitting
        live = [
            i for i in self.supervisor.live_indices()
            if self._ready.get(i) and i not in self._draining
        ]
        if not live:
            return
        while self.journal.queued:
            rid = self.journal.queued[0]
            rec = self.journal.records[rid]
            # head-of-line, no bypass (same contract as the engine's
            # FIFO admission): if the head's role pool is down or
            # saturated, the queue waits — the supervisor is relaunching
            # the pool, and bypassing would reorder delivery
            eligible = self._eligible(rec, live)
            if not eligible:
                return
            loads = [
                (self.journal.inflight(self.supervisor.run_id(i)), i)
                for i in eligible
            ]
            load, idx = min(loads)
            if load >= self.cfg.max_inflight_per_replica:
                return  # every eligible replica is saturated
            handle = self.supervisor.handle(idx)
            run_id = self.supervisor.run_id(idx)
            # journal deadlines are absolute router-clock; the engine
            # takes time-remaining (its clock differs from ours)
            remaining = (
                None
                if rec.deadline_s is None
                else max(0.0, rec.deadline_s - self.clock())
            )
            if rec.handoff is not None:
                msg = {
                    "type": "resume",
                    "rid": rid,
                    "max_new_tokens": rec.max_new_tokens,
                    "deadline_s": remaining,
                }
                channel = getattr(handle, "data_channel", None)
                if (
                    self.cfg.handoff_transport == "chunked"
                    and channel is not None
                ):
                    data = base64.b64decode(rec.handoff)
                    # resume an interrupted transfer to the SAME
                    # incarnation: seed the sender with the journaled
                    # acked set so only unacked chunks touch the wire
                    # (a dead incarnation's transfers were aborted in
                    # the death sweep, so a stale seed cannot match)
                    tid = None
                    seed: Set[int] = set()
                    for t, info in self.journal.transfers.items():
                        if (
                            info["rid"] == rid
                            and info.get("run_id") == run_id
                            and t not in self._tx
                        ):
                            tid = t
                            seed = set(info["acked"])
                            break
                    if tid is None:
                        tid = next_transfer_id()
                        self.journal.transfer_begin(
                            rid, tid, len(split_payload(
                                data, self.cfg.transport_chunk_bytes
                            )), len(data), kind="resume", run_id=run_id,
                        )
                    sender = ChunkSender(
                        channel, rid, tid, data,
                        chunk_bytes=self.cfg.transport_chunk_bytes,
                        max_inflight_bytes=(
                            self.cfg.transport_inflight_bytes
                        ),
                        retries=self.cfg.transport_retries,
                        backoff_s=self.cfg.transport_backoff_s,
                        label=f"rtr{idx}.tx",
                        acked=seed,
                    )
                    self._tx[tid] = (idx, sender, rid)
                    msg.update(
                        transfer_id=tid,
                        total=sender.total,
                        bytes=len(data),
                    )
                else:
                    msg["data"] = rec.handoff
            else:
                msg = {
                    "type": "submit",
                    "rid": rid,
                    "prompt": rec.prompt,
                    "max_new_tokens": rec.max_new_tokens,
                    "deadline_s": remaining,
                }
            ok = handle is not None and handle.send(msg)
            if not ok:
                # pipe already gone: the supervisor sweep will reap it
                # next tick; stop dispatching to it
                return
            self.journal.queued.popleft()
            self.journal.assign(rid, idx, run_id)

    def run_until_idle(
        self, timeout_s: float = 120.0, tick_s: float = 0.01
    ) -> None:
        """Drive poll() until every journaled request is terminal."""
        deadline = self.clock() + timeout_s
        while self.journal.outstanding() > 0:
            if self.clock() > deadline:
                raise TimeoutError(
                    f"fleet not idle after {timeout_s}s: "
                    f"{self.journal.counts()}"
                )
            self.poll()
            time.sleep(tick_s)

    # -- stats -------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """The obs ``serving_fleet`` map (schema v11; transport/drain
        counters added in v15)."""
        c = self.journal.counts()
        lats = sorted(
            r.latency for r in self.completed if r.latency is not None
        )
        p99 = (
            lats[min(len(lats) - 1, int(0.99 * len(lats)))] if lats else 0.0
        )
        admitted = len(self.journal.records)
        return {
            "replicas": float(self.cfg.n_replicas),
            "replicas_live": float(len(self.supervisor.live_indices())),
            "availability": self.supervisor.availability(),
            "restarts": float(self.supervisor.restarts()),
            "stalls_detected": float(self.supervisor.stalls_detected),
            "requests_admitted": float(admitted),
            "requests_completed": float(c[J_COMPLETED]),
            "requests_expired": float(c[J_EXPIRED]),
            "requests_failed": float(c[J_FAILED]),
            "requests_requeued": float(self.journal.requeued_total),
            "duplicates_dropped": float(self.journal.duplicates_dropped),
            "requests_rejected": float(sum(self.rejected.values())),
            "p99_latency_s": float(p99),
            "completion_rate": (
                float(c[J_COMPLETED]) / admitted if admitted else 1.0
            ),
            # disaggregation (0s in a unified fleet)
            "prefill_replicas": float(self.cfg.prefill_replicas),
            "requests_handed_off": float(self.handoffs),
            "handoff_bytes": float(
                sum(
                    r.handoff_bytes for r in self.journal.records.values()
                )
            ),
            # streaming transport + drain-and-migrate (v15; live
            # senders' resends are folded in so mid-run reads are
            # accurate, not just post-completion totals)
            "handoff_retries": float(self.handoff_retries),
            "chunks_resent": float(
                self.chunks_resent
                + sum(s.chunks_resent for _, s, _ in self._tx.values())
            ),
            "transfers_resumed": float(self.transfers_resumed),
            "drain_migrations": float(self.drain_migrations),
            "handoff_reprefills": float(self.handoff_reprefills),
        }
