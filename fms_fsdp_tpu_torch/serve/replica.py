"""Serving replica child: one ServingEngine behind the fleet protocol.

Counterpart of ``fms_fsdp_tpu/serve/replica.py``. Launched by the
:class:`~fms_fsdp_tpu_torch.serve.fleet.FleetRouter` (through the
``ReplicaSetSupervisor``'s spawn callback), this process speaks the
line-delimited JSON protocol of ``serve/fleet.py`` on stdin/stdout:
``submit``/``resume``/``drain`` in, ``hb``/``done``/``handoff``/
``migrate``/``reject``/``returned``/``expired`` out. stdout is the
protocol channel and nothing else may print there: at start the process
keeps its stdout for the protocol and points file descriptor 1 (and
``sys.stdout``) at stderr, so logs, tracebacks and anything a kernel
build prints land in the router's per-incarnation log.

``--data-fd`` (the child's end of a socketpair made at spawn) selects the
chunked transport: handoff frames move as acked, CRC-checked chunks on
that channel (``serve/disagg/transport.py``) and stdio carries only the
control messages naming them. Without it the frame rides the control
line as base64.

SIGTERM is the preemption notice: the serve loop stops admitting, hands
queued rids back (``returned``), packs each live decode stream (Llama and
Mixtral through the page codec, Mamba through the slab codec), ships them
as ``migrate`` transfers, heartbeating while the chunks drain, and exits
with the ``preempted`` registry code.

A heartbeat goes out after every engine iteration and on idle ticks. Two
fault sites fire at the engine-iteration boundary
(``resilience/faults.py``), both filtered by ``replica`` (index) and
``step`` (engine iteration): ``replica_kill`` hard-exits with ``code``
(default ``replica_loss``), ``replica_stall`` sleeps ``seconds`` (default
3600) without dying. The transport sites fire inside the chunk sender and
the data channel, whose label here is ``rep<idx>``.

Engine failures exit through :func:`classified_exit` as
:class:`~fms_fsdp_tpu_torch.serve.fleet.ReplicaLostError` (exit
``replica_loss``). Weights come from ``--params`` (a training checkpoint)
or ``--init-seed`` (random init from a seeded generator on the engine's
device: two replicas, or a replica and an in-process engine, given the
same seed hold the same weights). The engine runs on the card unless
``--device cpu``.

A serving layout (``serve_layout="tp=T[,fsdp=F]"``) makes this process
the leader, rank 0, of a replica over T x F processes. JAX's sharded
replica is one process over its devices; here one process drives one
device, so the leader starts the T x F - 1 followers itself, first
thing, before it imports torch (this module again, ``--follower-rank
r``; stdin from ``/dev/null``, output to the leader's stderr log, no data
channel), then hosts the group's rendezvous on a port of its own
(``utils/dist.py::local_store``) and sends each follower the port
through a pipe. Every rank builds the engine on its blocks of the
weights; the followers sit in
``engine.follow()`` (``serve/layout.py``) and the leader serves. To the
router the group is one replica: one pid, one protocol and one data
channel, one log, one exit code, one relaunch. A death on either side is
the replica's:

- a follower that exits before it is released (or never joins) ends the
  leader: a watcher thread polls the followers every ``WATCH_S`` and
  hard-exits ``replica_loss``, as the ``replica_kill`` site does, without
  waiting for a collective to time out;
- a follower dies with its leader (``PR_SET_PDEATHSIG``): a kill fault,
  the stall watchdog's SIGKILL or a crash leaves no follower holding the
  card.

At drain and at preemption (after the live streams were packed, which
the followers take part in) the leader releases the followers, joins
them, and only then exits; each follower writes its own stats file
first. No fallback: a replica never serves on fewer ranks than its
layout names. Mamba refuses a layout (JAX's "single-chip" message)
before the group forms; its followers end with it.

The data channel moves on a thread of its own as well as in the loop
(``WIRE_S``): a layout's engine step waits on its ranks' collectives, and
a channel read only between steps would move a socket buffer's worth a
step.

``--stats-path``: when the replica drains or is preempted it writes
there, as one JSON object, its own paged-decode kernel launches
(``ops/paged_attention.py::LAUNCHES``, and by heads ``HEAD_LAUNCHES``,
counted from after the warmup), its decode steps and iterations over the
same span, its role and layer count, and its start-up seconds (process
start to the readiness heartbeat); a layout's leader adds its followers'
exit codes. A follower writes ``<stem>.rank<r>.stats.json`` beside it:
the calls it ran by name, its launches by heads and its decode calls,
both counted from its start (the warmup's included).
"""

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import threading
import time
from queue import Empty, Queue

# how long a preempted replica keeps pumping its migrate transfers before
# giving up and exiting (unfinished rids fall back to requeue)
MIGRATE_GRACE_S = 20.0
# a layout leader's watch over its followers (seconds between polls), and
# how long it waits for them to exit once released
WATCH_S = 0.02
JOIN_S = 60.0
# seconds between the data channel thread's turns
WIRE_S = 0.002

_T_START = time.monotonic()
# seconds from process start to each step of the start-up, for the stats
STARTUP = {}
# the protocol channel: the process's stdout as it was at start (main()
# points fd 1 and sys.stdout at stderr for everything else)
_PROTO = sys.stdout


def _emit(msg: dict) -> None:
    _PROTO.write(json.dumps(msg) + "\n")
    _PROTO.flush()


def _claim_stdout() -> None:
    """Keep stdout for the protocol; send every other write to fd 1 (a
    library's print, a subprocess's output) to stderr."""
    global _PROTO
    _PROTO = os.fdopen(os.dup(1), "w")
    sys.stdout.flush()
    os.dup2(2, 1)
    sys.stdout = sys.stderr


def _stdin_reader(q: Queue) -> None:
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            q.put(json.loads(line))
        except ValueError:
            continue  # torn router line; the router retries via requeue
    q.put({"type": "drain"})  # stdin closed: the router is gone, wind down


def load_configs(args):
    """(model config, ServeConfig) from the two config files."""
    from fms_fsdp_tpu_torch.serve.engine import ServeConfig
    from fms_fsdp_tpu_torch.serve.families import load_model_config

    with open(args.model_cfg) as f:
        model_cfg = load_model_config(json.load(f))
    with open(args.serve_cfg) as f:
        serve_cfg = ServeConfig(**json.load(f))
    return model_cfg, serve_cfg


def layout_ranks(serve_cfg_path: str) -> int:
    """The processes of the replica's layout (1 on one card), read from
    the serving config file without importing torch."""
    from fms_fsdp_tpu_torch.parallel.mesh import parse_serve_layout

    with open(serve_cfg_path) as f:
        ext = parse_serve_layout(json.load(f).get("serve_layout", ""))
    return ext["tensor"] * ext["fsdp"]


def build_engine(args, store=None):
    """The engine from the two config files, on ``args.device`` (the card
    when empty). A layout's rank joins its group at ``store`` first
    (``utils/dist.py::init_distributed``); it draws the whole seeded
    weights on its device, as a one-card replica does, and keeps its
    blocks of them."""
    import torch

    from fms_fsdp_tpu_torch.serve.engine import ServingEngine
    from fms_fsdp_tpu_torch.serve.families import init_params_for
    from fms_fsdp_tpu_torch.utils.device import resolve_device
    from fms_fsdp_tpu_torch.utils.dist import init_distributed

    model_cfg, serve_cfg = load_configs(args)
    device = resolve_device(args.device or None)
    if store is not None:
        init_distributed(device, store=store)
        STARTUP["group_joined"] = time.monotonic() - _T_START
    if args.params:
        return ServingEngine.from_checkpoint(
            args.params, model_cfg, serve_cfg, device=device
        )
    gen = torch.Generator(device=device).manual_seed(args.init_seed)
    params = init_params_for(model_cfg)(gen)
    engine = ServingEngine(params, model_cfg, serve_cfg, device=device)
    if device.type == "cuda":
        # the draw's scratch, and a layout rank's whole model beside the
        # blocks it keeps, back to the card
        del params
        torch.cuda.empty_cache()
    return engine


def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _write_stats(path: str, engine, base: dict, ready_s: float, loop_s: dict,
                 extra: dict) -> None:
    from fms_fsdp_tpu_torch.ops import paged_attention as pa

    heads = base["head_launches"]
    _write_json(path, {
        "role": engine.serve_cfg.role,
        "layers": int(engine.adapter.cache.n_layers) if engine.cache is not None else 0,
        "decode_steps": engine.decode_steps - base["decode_steps"],
        "warmup_decode_steps": base["decode_steps"],
        "iterations": engine.iterations - base["iterations"],
        "launches": {k: v - base["launches"][k] for k, v in pa.LAUNCHES.items()},
        "head_launches": {k: v - heads.get(k, 0) for k, v in pa.HEAD_LAUNCHES.items()
                          if v - heads.get(k, 0)},
        "startup_s": ready_s,
        "startup_parts": STARTUP,
        "loop_s": loop_s,
        "serving": engine.serving_stats(),
        **extra,
    })


def rank_stats_path(path: str, rank: int) -> str:
    """A follower's stats file beside its leader's ``<stem>.stats.json``."""
    stem = path[:-len(".stats.json")] if path.endswith(".stats.json") else path
    return f"{stem}.rank{rank}.stats.json"


class Followers:
    """A layout leader's other ranks: started first thing, before this
    process imports torch, so that their start-up overlaps the leader's;
    watched until released, then joined. Puts torchrun's environment for
    rank 0 of ``n`` into this process's. :meth:`open_store` opens the
    group's rendezvous once torch is in, and hands each follower its port
    through a pipe: a leader that dies first leaves the pipe at end of
    file."""

    def __init__(self, args, n: int):
        self.replica = args.replica
        os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(n),
                          LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1")
        env = dict(os.environ)
        env.pop("FMS_FAULTS", None)  # the fault sites are the leader's
        argv = [sys.executable, "-m", "fms_fsdp_tpu_torch.serve.replica",
                "--model-cfg", args.model_cfg, "--serve-cfg", args.serve_cfg,
                "--replica", str(args.replica), "--init-seed", str(args.init_seed),
                "--leader-pid", str(os.getpid())]
        for flag, value in (("--params", args.params), ("--device", args.device)):
            if value:
                argv += [flag, value]
        self.procs, self._ports = [], []
        for r in range(1, n):
            stats = ["--stats-path", rank_stats_path(args.stats_path, r)] if args.stats_path else []
            read, write = os.pipe()
            self.procs.append(subprocess.Popen(
                argv + stats + ["--follower-rank", str(r), "--port-fd", str(read)],
                stdin=subprocess.DEVNULL, stdout=2, stderr=2, pass_fds=(read,),
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
            os.close(read)
            self._ports.append(write)
        self.released = threading.Event()
        threading.Thread(target=self._watch, daemon=True, name="followers").start()

    def open_store(self):
        """The group's rendezvous (``utils/dist.py::local_store``), its
        port sent to every follower."""
        from fms_fsdp_tpu_torch.utils.dist import local_store

        store = local_store()
        os.environ["MASTER_PORT"] = str(store.port)
        for fd in self._ports:
            os.write(fd, f"{store.port}\n".encode())
            os.close(fd)
        return store

    def _watch(self) -> None:
        from fms_fsdp_tpu_torch.resilience.exits import EXIT_CODES

        while not self.released.wait(WATCH_S):
            for r, proc in enumerate(self.procs, 1):
                code = proc.poll()
                if code is not None and not self.released.is_set():
                    sys.stderr.write(f"replica {self.replica}: follower rank {r} (pid "
                                     f"{proc.pid}) exited {code} before its release: "
                                     f"the replica is lost\n")
                    sys.stderr.flush()
                    os._exit(EXIT_CODES["replica_loss"])

    def release(self, engine) -> dict:
        """End the followers' loop and wait for them (each writes its
        stats file first); their exit codes, for the leader's stats."""
        self.released.set()
        engine.release_followers()
        codes = []
        for proc in self.procs:
            try:
                codes.append(proc.wait(timeout=JOIN_S))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
        return {"follower_exits": codes}


def _die_with_leader(leader_pid: int) -> None:
    """A follower: the kernel kills this process when its leader dies;
    a leader that died before this call ends it now."""
    import ctypes

    pr_set_pdeathsig = 1
    if ctypes.CDLL(None, use_errno=True).prctl(pr_set_pdeathsig, signal.SIGKILL, 0, 0, 0):
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != leader_pid:
        os._exit(1)


def follower_main(args) -> None:
    """Rank ``args.follower_rank`` of a layout replica: join the leader's
    group, build the engine, follow until released, write the stats."""
    _die_with_leader(args.leader_pid)
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.resilience.exits import classified_exit
    from fms_fsdp_tpu_torch.serve import layout
    from fms_fsdp_tpu_torch.utils.dist import local_store

    with os.fdopen(args.port_fd, "rb") as f:
        port = f.readline().strip()
    if not port:
        os._exit(1)  # the leader died before it opened the group
    os.environ["MASTER_PORT"] = port.decode()
    with classified_exit():
        engine = build_engine(args, store=local_store(int(port)))
        ready_s = STARTUP["engine_built"] = time.monotonic() - _T_START
        engine.follow()
        if args.stats_path:
            _write_json(args.stats_path, {
                "rank": args.follower_rank, "role": engine.serve_cfg.role,
                "layers": int(engine.cache.n_layers) if engine.cache is not None else 0,
                "calls": dict(layout.CALLS), "decode_steps": layout.CALLS.get("decode", 0),
                "launches": dict(pa.LAUNCHES), "head_launches": dict(pa.HEAD_LAUNCHES),
                "startup_s": ready_s, "startup_parts": STARTUP,
            })


def serve_loop(engine, replica_idx: int, idle_sleep_s: float = 0.02,
               data_fd: int = -1, preempt_evt=None, stats_path: str = "",
               chunk_bytes: int = 0, inflight_bytes: int = 0, retries: int = -1,
               backoff_s: float = 0.0, release=None):
    """The replica's life: drain router messages, step the engine, stream
    completions and heartbeats. Returns when drained; a SIGTERM
    (``preempt_evt``) instead migrates live streams and hard-exits
    ``preempted``. ``release`` (a layout leader's
    :meth:`Followers.release`, bound to the engine) runs on either way
    out, before the stats are written."""
    from fms_fsdp_tpu_torch.ops import paged_attention as pa
    from fms_fsdp_tpu_torch.resilience.exits import EXIT_CODES
    from fms_fsdp_tpu_torch.resilience.faults import fire_fault
    from fms_fsdp_tpu_torch.serve.disagg.transport import (
        DEFAULT_BACKOFF_S,
        DEFAULT_CHUNK_BYTES,
        DEFAULT_MAX_INFLIGHT_BYTES,
        DEFAULT_RETRIES,
        KIND_ACK,
        ChunkReceiver,
        ChunkSender,
        DataChannel,
        TransportError,
        encode_chunk,
        next_transfer_id,
    )
    from fms_fsdp_tpu_torch.serve.scheduler import RequestRejected

    inbox: Queue = Queue()
    reader = threading.Thread(target=_stdin_reader, args=(inbox,), daemon=True)
    reader.start()

    by_req = {}  # id(engine Request) -> (Request, router rid)
    draining = False
    preempting = False
    preempt_t0 = 0.0
    label = f"rep{replica_idx}"
    channel = DataChannel.from_fd(data_fd, label=label) if data_fd >= 0 else None
    out_senders = {}  # transfer_id -> (ChunkSender, rid)
    # transfer_id -> [ChunkReceiver, resume-msg-or-None]: chunks can race
    # ahead of the stdio "resume" naming them
    in_receivers = {}
    # inbound transfers already assembled: a retransmitted chunk that
    # arrives after the last one is re-acked, not taken for a new transfer
    # (a receiver that never completes would hold the drain open)
    done_tids = set()

    def admit_resume(meta: dict, data: bytes) -> None:
        try:
            req = engine.submit_handoff(
                data,
                max_new_tokens=meta.get("max_new_tokens"),
                deadline_s=meta.get("deadline_s"),
            )
            by_req[id(req)] = (req, meta["rid"])
        except RequestRejected as e:
            _emit({"type": "reject", "rid": meta["rid"], "reason": e.reason})
        except ValueError as e:  # HandoffError: bad wire bytes
            _emit({"type": "reject", "rid": meta["rid"],
                   "reason": f"handoff_error: {e}"})

    # the channel moves on a thread of its own as well as in the loop, so
    # that a long engine step (a layout's) holds up neither the acks nor
    # the chunks: a socketpair buffers a few hundred KB, so a peer that
    # reads only between steps caps the wire at that much a step. ``wire``
    # guards the channel and the transfer tables; only the loop emits and
    # admits
    wire = threading.Lock()
    lost_out = []  # rids whose outbound transfer failed, for the loop

    def move_chunks() -> None:
        """Read the channel, ack and file inbound chunks, send the due
        outbound ones (under ``wire``)."""
        for m in channel.pump():
            if m["kind"] == KIND_ACK:
                ent = out_senders.get(m["transfer_id"])
                if ent is not None:
                    ent[0].on_ack(m)
            elif m["transfer_id"] in done_tids:
                channel.send(encode_chunk(KIND_ACK, m["rid"], m["transfer_id"],
                                          m["seq"], m["total"]))
            else:
                ent = in_receivers.get(m["transfer_id"])
                if ent is None:
                    ent = [ChunkReceiver(m["rid"], m["transfer_id"], m["total"],
                                         label=label), None]
                    in_receivers[m["transfer_id"]] = ent
                ent[0].on_chunk(m, channel)
        for tid in list(out_senders):
            sender, rid = out_senders[tid]
            try:
                sender.pump()
            except TransportError as e:
                sys.stderr.write(f"replica {replica_idx} transfer {tid} failed: {e}\n")
                sys.stderr.flush()
                del out_senders[tid]
                lost_out.append(rid)
                continue
            if sender.done:
                del out_senders[tid]

    def move_chunks_forever() -> None:
        while True:
            time.sleep(WIRE_S)
            with wire:
                move_chunks()

    def pump_channel() -> None:
        if channel is None:
            return
        with wire:
            move_chunks()
            lost, lost_out[:] = lost_out[:], []
            complete = []
            for tid in list(in_receivers):
                receiver, meta = in_receivers[tid]
                if meta is not None and receiver.complete:
                    del in_receivers[tid]
                    done_tids.add(tid)
                    complete.append((meta, receiver))
        for rid in lost:
            # permanent loss: the frame never reached the router, which
            # holds no timeout for it; hand the rid back so it requeues
            # (a handoff re-prefills, a migration resumes from its
            # journaled bytes or recomputes)
            _emit({"type": "returned", "rid": rid})
        for meta, receiver in complete:
            if draining:
                # a resume that completes after the drain notice would
                # be refused "overloaded" (a terminal failure at the
                # router): hand it back for another replica instead
                _emit({"type": "returned", "rid": meta["rid"]})
            else:
                admit_resume(meta, receiver.assemble())

    def ship(kind: str, rid: int, data: bytes, ttft=None) -> None:
        """A packed frame toward the router: chunked on the data channel
        when one exists, inline base64 otherwise."""
        msg = {"type": kind, "rid": rid, "bytes": len(data)}
        if ttft is not None:
            msg["ttft"] = ttft
        if channel is not None:
            tid = next_transfer_id()
            with wire:
                sender = ChunkSender(
                    channel, rid, tid, data, label=label + ".tx",
                    chunk_bytes=chunk_bytes or DEFAULT_CHUNK_BYTES,
                    max_inflight_bytes=inflight_bytes or DEFAULT_MAX_INFLIGHT_BYTES,
                    retries=DEFAULT_RETRIES if retries < 0 else retries,
                    backoff_s=backoff_s or DEFAULT_BACKOFF_S,
                )
                out_senders[tid] = (sender, rid)
            msg.update(transfer_id=tid, total=sender.total)
        else:
            msg["data"] = base64.b64encode(data).decode("ascii")
        _emit(msg)

    # warm up BEFORE the readiness heartbeat: the first step loads the
    # kernels and allocates, and a replica must not take dispatched work
    # until a step is cheap. The warmup request is engine-local; its
    # completion is subtracted from the heartbeat's progress count, and
    # its steps and launches from the stats
    engine.submit([0] * min(8, engine.serve_cfg.max_seq_len // 2), 2)
    while engine.has_work():
        engine.step()
    warmup_completed = engine.scheduler.completed
    base = {"decode_steps": engine.decode_steps, "iterations": engine.iterations,
            "launches": dict(pa.LAUNCHES), "head_launches": dict(pa.HEAD_LAUNCHES)}

    def heartbeat():
        h = engine.health()
        _emit({
            "type": "hb",
            "replica": replica_idx,
            "iterations": int(h["iterations"]),
            "completed": int(engine.scheduler.completed - warmup_completed),
            "slots_busy": int(h["slots_busy"]),
            "queue_depth": int(h["queue_depth"]),
            "draining": bool(draining),
        })

    def emit_failed():
        # handoff imports that failed typed after admission: reject back so
        # the router requeues for re-prefill
        for req in engine.take_failed():
            ent = by_req.pop(id(req), None)
            if ent is not None:
                _emit({"type": "reject", "rid": ent[1],
                       "reason": getattr(req, "fail_reason", "handoff_error: unknown")})

    def return_queued():
        # whatever is still QUEUED will never run here: hand it back
        for req in list(engine.scheduler.queue):
            ent = by_req.pop(id(req), None)
            if ent is not None:
                _emit({"type": "returned", "rid": ent[1]})
        engine.scheduler.queue.clear()

    def finish():
        extra = release() if release is not None else {}
        if stats_path:
            _write_stats(stats_path, engine, base, ready_s, loop_s, extra)

    if channel is not None:
        threading.Thread(target=move_chunks_forever, daemon=True, name="wire").start()
    heartbeat()  # readiness: the router dispatches only after this
    ready_s = STARTUP["ready"] = time.monotonic() - _T_START
    last_idle_hb = 0.0
    # seconds the loop spent stepping the engine and moving transfer chunks
    loop_s = {"step": 0.0, "pump": 0.0}
    while True:
        # 0) preemption notice: drain, pack live streams, migrate
        if preempt_evt is not None and preempt_evt.is_set() and not preempting:
            preempting = True
            draining = True
            preempt_t0 = time.monotonic()
            engine.drain()
            return_queued()
            for req in engine.live_requests():
                ent = by_req.pop(id(req), None)
                if ent is None:
                    continue  # engine-local (a warmup remnant)
                data = engine.pack_stream(req)
                if data is None:
                    # mid-chunked-prefill or speculative: not packable, the
                    # router's requeue path recomputes it
                    _emit({"type": "returned", "rid": ent[1]})
                    continue
                ship("migrate", ent[1], data, ttft=req.ttft)

        if preempting:
            # no more engine steps: pump the transfers out, keep
            # heartbeating, then exit with the preempted code
            pump_channel()
            heartbeat()
            with wire:
                unsent = [rid for _, rid in out_senders.values()]
            if not unsent or time.monotonic() - preempt_t0 > MIGRATE_GRACE_S:
                for rid in unsent:
                    _emit({"type": "returned", "rid": rid})
                finish()
                sys.stderr.write(
                    f"replica {replica_idx} preempted: drained + migrated, "
                    f"exiting clean\n"
                )
                sys.stderr.flush()
                _PROTO.flush()
                os._exit(EXIT_CODES["preempted"])
            time.sleep(0.001)
            continue

        # 1) ingest router messages
        while True:
            try:
                msg = inbox.get_nowait()
            except Empty:
                break
            if msg.get("type") == "submit":
                try:
                    req = engine.submit(msg["prompt"], msg["max_new_tokens"],
                                        deadline_s=msg.get("deadline_s"))
                    by_req[id(req)] = (req, msg["rid"])
                except RequestRejected as e:
                    _emit({"type": "reject", "rid": msg["rid"], "reason": e.reason})
            elif msg.get("type") == "resume":
                # admit by importing a packed handoff instead of prefilling
                if "data" in msg:
                    admit_resume(msg, base64.b64decode(msg["data"]))
                else:
                    tid = msg["transfer_id"]
                    with wire:
                        ent = in_receivers.get(tid)
                        if ent is None:
                            in_receivers[tid] = [
                                ChunkReceiver(msg["rid"], tid, msg["total"], label=label),
                                msg]
                        else:
                            ent[1] = msg
            elif msg.get("type") == "drain":
                draining = True
                engine.drain()
                return_queued()

        # 2) fault sites at the engine-iteration boundary
        p = fire_fault("replica_stall", replica=replica_idx, step=engine.iterations)
        if p is not None:
            time.sleep(float(p.get("seconds", 3600)))
        p = fire_fault("replica_kill", replica=replica_idx, step=engine.iterations)
        if p is not None:
            sys.stderr.write(f"injected replica_kill at iteration {engine.iterations}\n")
            sys.stderr.flush()
            os._exit(int(p.get("code", EXIT_CODES["replica_loss"])))

        # 3) move transfer chunks and acks (both directions, non-blocking)
        t0 = time.perf_counter()
        pump_channel()
        t1 = time.perf_counter()
        loop_s["pump"] += t1 - t0

        # 4) step + stream completions
        if engine.has_work():
            done = engine.step()
            loop_s["step"] += time.perf_counter() - t1
            for req in done:
                ent = by_req.pop(id(req), None)
                if ent is None:
                    continue
                if req.handoff_out is not None:
                    # prefill role: the router journals these bytes before
                    # forwarding them to a decode replica
                    ship("handoff", ent[1], req.handoff_out, ttft=req.ttft)
                    continue
                _emit({"type": "done", "rid": ent[1], "tokens": list(req.generated),
                       "ttft": req.ttft})
            emit_failed()
            # engine-side deadline expiries never come back from step()
            for key, (req, rid) in list(by_req.items()):
                if req.state == "expired":
                    _emit({"type": "expired", "rid": rid})
                    del by_req[key]
            heartbeat()
        else:
            now = time.monotonic()
            if now - last_idle_hb >= idle_sleep_s:
                heartbeat()
                last_idle_hb = now
            if draining and not out_senders and not in_receivers:
                finish()
                return
            # a transfer in flight wants the channel pumped again soon (its
            # idle heartbeats stay at one per idle_sleep_s)
            time.sleep(0.001 if (out_senders or in_receivers) else idle_sleep_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-cfg", required=True,
                    help="JSON file of model-config fields; family inferred "
                         "from the keys or pinned by a \"family\" entry")
    ap.add_argument("--serve-cfg", required=True, help="JSON file of ServeConfig fields")
    ap.add_argument("--params", default="", help="checkpoint path (omit to random-init)")
    ap.add_argument("--init-seed", type=int, default=0,
                    help="generator seed for random init when --params is unset")
    ap.add_argument("--replica", type=int, required=True,
                    help="replica index (fault-site filter key)")
    ap.add_argument("--data-fd", type=int, default=-1,
                    help="fd of this replica's data-channel socket (chunked "
                         "transport); -1 = single-blob stdio relay")
    ap.add_argument("--device", default="",
                    help="the engine's device (default: the card)")
    ap.add_argument("--stats-path", default="",
                    help="JSON file the replica writes at drain or preemption")
    ap.add_argument("--chunk-bytes", type=int, default=0,
                    help="outbound transfer chunk size (0: the transport's default)")
    ap.add_argument("--inflight-bytes", type=int, default=0,
                    help="outbound in-flight cap (0: the transport's default)")
    ap.add_argument("--transport-retries", type=int, default=-1,
                    help="resends a chunk may take (-1: the transport's default)")
    ap.add_argument("--transport-backoff-s", type=float, default=0.0,
                    help="first retransmit backoff (0: the transport's default)")
    # a layout's follower, started by its leader (module docstring)
    ap.add_argument("--follower-rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port-fd", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--leader-pid", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.follower_rank:
        return follower_main(args)
    _claim_stdout()

    from fms_fsdp_tpu_torch.resilience.exits import classified_exit
    from fms_fsdp_tpu_torch.serve.fleet import ReplicaLostError

    # SIGTERM is the preemption notice: the handler only sets a flag
    preempt_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: preempt_evt.set())

    with classified_exit():
        try:
            n = layout_ranks(args.serve_cfg)
            followers = Followers(args, n) if n > 1 else None
            from fms_fsdp_tpu_torch.serve.families import adapter_class

            model_cfg, serve_cfg = load_configs(args)
            adapter_class(model_cfg).check_layout(serve_cfg)
            store = None
            if followers is not None:
                store = followers.open_store()
                STARTUP["store_opened"] = time.monotonic() - _T_START
            engine = build_engine(args, store=store)
            STARTUP["engine_built"] = time.monotonic() - _T_START
            serve_loop(
                engine, args.replica, data_fd=args.data_fd, preempt_evt=preempt_evt,
                stats_path=args.stats_path, chunk_bytes=args.chunk_bytes,
                inflight_bytes=args.inflight_bytes, retries=args.transport_retries,
                backoff_s=args.transport_backoff_s,
                release=(lambda: followers.release(engine)) if followers else None,
            )
        except (SystemExit, KeyboardInterrupt):
            raise
        except Exception as e:  # noqa: BLE001 — the replica death boundary
            raise ReplicaLostError(
                f"replica {args.replica} engine failure: {e!r}"
            ) from e


if __name__ == "__main__":
    main()
