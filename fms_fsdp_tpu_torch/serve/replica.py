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
``--device cpu``. A serving layout (``serve_layout``) is refused: this
process would have to start and supervise its replica's followers
(ROADMAP.md A.6b, the fleet replica over a rank group).

``--stats-path``: when the replica drains or is preempted it writes
there, as one JSON object, its own paged-decode kernel launches
(``ops/paged_attention.py::LAUNCHES``, counted from after the warmup), its
decode steps and iterations over the same span, its role and layer count,
and its start-up seconds (process start to the readiness heartbeat).
"""

import argparse
import base64
import json
import os
import signal
import sys
import threading
import time
from queue import Empty, Queue

# how long a preempted replica keeps pumping its migrate transfers before
# giving up and exiting (unfinished rids fall back to requeue)
MIGRATE_GRACE_S = 20.0

_T_START = time.monotonic()
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


def build_engine(args):
    """The engine from the two config files, on ``args.device`` (the card
    when empty)."""
    import torch

    from fms_fsdp_tpu_torch.serve.engine import ServeConfig, ServingEngine
    from fms_fsdp_tpu_torch.serve.families import init_params_for, load_model_config
    from fms_fsdp_tpu_torch.utils.device import resolve_device

    with open(args.model_cfg) as f:
        model_cfg = load_model_config(json.load(f))
    with open(args.serve_cfg) as f:
        serve_cfg = ServeConfig(**json.load(f))
    if serve_cfg.serve_layout:
        raise NotImplementedError(
            f"serve_layout={serve_cfg.serve_layout!r}: a fleet replica over a group "
            f"of ranks (its followers started and supervised with it) is not ported "
            f"yet (ROADMAP.md A.6b, the fleet replica over a rank group); run the "
            f"fleet's replicas single-card"
        )
    device = resolve_device(args.device or None)
    if args.params:
        return ServingEngine.from_checkpoint(
            args.params, model_cfg, serve_cfg, device=device
        )
    gen = torch.Generator(device=device).manual_seed(args.init_seed)
    params = init_params_for(model_cfg)(gen)
    return ServingEngine(params, model_cfg, serve_cfg, device=device)


def _write_stats(path: str, engine, base: dict, ready_s: float) -> None:
    from fms_fsdp_tpu_torch.ops import paged_attention as pa

    stats = {
        "role": engine.serve_cfg.role,
        "layers": int(engine.adapter.cache.n_layers) if engine.cache is not None else 0,
        "decode_steps": engine.decode_steps - base["decode_steps"],
        "iterations": engine.iterations - base["iterations"],
        "launches": {k: v - base["launches"][k] for k, v in pa.LAUNCHES.items()},
        "startup_s": ready_s,
        "serving": engine.serving_stats(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(stats, f)
    os.replace(tmp, path)


def serve_loop(engine, replica_idx: int, idle_sleep_s: float = 0.02,
               data_fd: int = -1, preempt_evt=None, stats_path: str = "",
               chunk_bytes: int = 0, inflight_bytes: int = 0, retries: int = -1,
               backoff_s: float = 0.0):
    """The replica's life: drain router messages, step the engine, stream
    completions and heartbeats. Returns when drained; a SIGTERM
    (``preempt_evt``) instead migrates live streams and hard-exits
    ``preempted``."""
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

    def pump_channel() -> None:
        if channel is None:
            return
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
                # permanent loss: the frame never reached the router, which
                # holds no timeout for it; hand the rid back so it requeues
                # (a handoff re-prefills, a migration resumes from its
                # journaled bytes or recomputes)
                sys.stderr.write(f"replica {replica_idx} transfer {tid} failed: {e}\n")
                sys.stderr.flush()
                del out_senders[tid]
                _emit({"type": "returned", "rid": rid})
                continue
            if sender.done:
                del out_senders[tid]
        for tid in list(in_receivers):
            receiver, meta = in_receivers[tid]
            if meta is not None and receiver.complete:
                del in_receivers[tid]
                done_tids.add(tid)
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
            "launches": dict(pa.LAUNCHES)}

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

    def write_stats():
        if stats_path:
            _write_stats(stats_path, engine, base, ready_s)

    heartbeat()  # readiness: the router dispatches only after this
    ready_s = time.monotonic() - _T_START
    last_idle_hb = 0.0
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
            if not out_senders or time.monotonic() - preempt_t0 > MIGRATE_GRACE_S:
                for _, rid in out_senders.values():
                    _emit({"type": "returned", "rid": rid})
                write_stats()
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
                    ent = in_receivers.get(tid)
                    if ent is None:
                        in_receivers[tid] = [
                            ChunkReceiver(msg["rid"], tid, msg["total"], label=label), msg]
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
        pump_channel()

        # 4) step + stream completions
        if engine.has_work():
            for req in engine.step():
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
                write_stats()
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
    args = ap.parse_args(argv)
    _claim_stdout()

    from fms_fsdp_tpu_torch.resilience.exits import classified_exit
    from fms_fsdp_tpu_torch.serve.fleet import ReplicaLostError

    # SIGTERM is the preemption notice: the handler only sets a flag
    preempt_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: preempt_evt.set())

    with classified_exit():
        try:
            engine = build_engine(args)
            serve_loop(
                engine, args.replica, data_fd=args.data_fd, preempt_evt=preempt_evt,
                stats_path=args.stats_path, chunk_bytes=args.chunk_bytes,
                inflight_bytes=args.inflight_bytes, retries=args.transport_retries,
                backoff_s=args.transport_backoff_s,
            )
        except (SystemExit, KeyboardInterrupt):
            raise
        except Exception as e:  # noqa: BLE001 — the replica death boundary
            raise ReplicaLostError(
                f"replica {args.replica} engine failure: {e!r}"
            ) from e


if __name__ == "__main__":
    main()
