"""Pipeline assembly + batching loader
(ref:fms_fsdp/utils/dataloader_utils.py:17-163).

A copy of ``fms_fsdp_tpu/data/loader.py``, with its ``loader_worker``
fault site and ``elastic_batch_size``.

``StatefulDataLoader`` replaces torch's DataLoader: it stacks pipeline
outputs into numpy batches and realizes ``num_workers`` as logical
sub-ranks — each worker is a full pipeline clone whose (rank, worldsize)
is inflated exactly the way the reference inflates them inside torch
worker processes (worldsize *= num_workers,
rank = rank * num_workers + worker_id, ref:dataset_utils.py:108-119), with
batches drawn round-robin across workers (torch IterableDataset semantics).

With ``num_workers > 1`` each worker pipeline runs in its own thread
(``worker_mode="thread"``, default) or its own forked process
(``worker_mode="process"``) feeding a bounded queue, with batches popped
round-robin. Threads gain only where the work releases the GIL (HF
tokenizers' rust encode on the ParquetHandler path); the process mode
matches the reference's process-level parallelism (torch DataLoader
worker processes, ref:dataloader_utils.py:144-146) and is immune to GIL
contention from the pure-Python stages. Round-robin popping preserves
the exact single-threaded batch order, and loader checkpointing keeps
the reference's worker semantics: CheckpointDataset auto-saves inside
each worker at its own batch boundaries (which, as with torch's
prefetching workers, may run ahead of consumption by up to
``num_workers * (prefetch_batches + 1)`` batches; explicit state
captures log the skew — see ``_log_skew``).
The copy to the card happens at the device-feed layer (device_feed.py).
"""

import multiprocessing
import os
import pickle
import queue
import threading
import time
import traceback
from copy import deepcopy
from typing import List

import numpy as np

from fms_fsdp_tpu_torch.data.buffering import (
    BufferDataset,
    CheckpointDataset,
    PreloadBufferDataset,
    PreprocessDataset,
)
from fms_fsdp_tpu_torch.data.handlers import ArrowHandler, AutoHandler, ParquetHandler
from fms_fsdp_tpu_torch.data.streaming import (
    CorpusLossError,
    SamplingDataset,
    ScalableShardDataset,
    StreamingDocDataset,
)

_HANDLER_BUILDERS = {
    "arrow": lambda cfg: ArrowHandler(cfg.col_name),
    "hf_parquet": lambda cfg: ParquetHandler(cfg.tokenizer_path, cfg.col_name),
    "auto": lambda cfg: AutoHandler(cfg.tokenizer_path, cfg.col_name),
}


def causal_lm(data_seq, prompt_len: int = 1):
    """Shift for next-token prediction: input = seq[:-1], label = seq[1:]
    with the first ``prompt_len`` labels masked to -100
    (ref:dataloader_utils.py:24-33)."""
    data_seq = np.asarray(data_seq, dtype=np.int32)
    t = data_seq[1:].copy()
    data_seq = data_seq[:-1]
    t[:prompt_len] = -100
    return data_seq, t


def _stack(items):
    """Stack a list of items (arrays or tuples of arrays) into a batch."""
    if isinstance(items[0], tuple):
        return tuple(np.stack(field) for field in zip(*items))
    return np.stack(items)


def _pickle_safe(e: BaseException) -> BaseException:
    """An exception that survives the mp pickle boundary: the original if
    it round-trips, else a RuntimeError carrying its formatted traceback."""
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(
            "".join(traceback.format_exception(type(e), e, e.__traceback__))
        )


def _service_commands(pipeline, cmd) -> bool:
    """Drain pending parent commands at a worker-process batch boundary.
    Returns True on a stop command (the worker must exit). Every non-stop
    command gets exactly one reply — a state-op failure replies with the
    exception instead of leaving the parent blocked on recv()."""
    while cmd.poll():
        op, arg = cmd.recv()
        if op == "stop":
            return True
        try:
            if op == "state_dict":
                reply = pipeline.state_dict()
            elif op == "save_to_path":
                pipeline.save_to_path(arg)
                reply = "ok"
            elif op == "load_state_dict":
                pipeline.load_state_dict(*arg)
                reply = "ok"
            elif op == "load_from_path":
                pipeline.load_from_path(arg)
                reply = "ok"
            else:
                reply = RuntimeError(f"unknown loader command {op!r}")
        except BaseException as e:  # noqa: BLE001 — forwarded to parent
            reply = _pickle_safe(e)
        cmd.send(reply)
    return False


class LoaderWorkerError(RuntimeError):
    """A loader worker died and the restart budget could not absorb it.
    Typed so the entry points' classified-exit wrapper
    (resilience/exits.py) exits with the ``loader_death`` registry code
    instead of the generic 1 — the run supervisor restarts a dead data
    path differently from an anomaly abort or a lost slice."""


def _worker_fault(widx: int, produced_count: int):
    """``loader_worker`` fault site, shared by every loader path: fired
    after each produced batch (filters: worker=, batch=). ``action=exit``
    hard-kills the process (the OOM or preemption case); the default
    raises, exercising the forwarded-exception path."""
    from fms_fsdp_tpu_torch.resilience.faults import fire_fault

    params = fire_fault("loader_worker", worker=widx, batch=produced_count)
    if params is None:
        return
    if params.get("action") == "exit":
        from fms_fsdp_tpu_torch.resilience.exits import EXIT_CODES

        os._exit(int(params.get("code", EXIT_CODES["loader_death"])))
    raise RuntimeError(
        f"injected loader worker crash (worker {widx}, "
        f"batch {produced_count})"
    )


def _process_worker_loop(pipeline, out_q, cmd, batch_size, produced, widx=0):
    """One worker pipeline in a forked process: produce stacked batches
    into ``out_q``, service state commands from the parent at batch
    boundaries (the process-mode analog of thread mode's per-worker
    lock), and forward exceptions to the consumer. ``produced`` is a
    shared counter of batches built, read by the parent for save-skew
    accounting (and continued across worker restarts)."""
    import signal

    try:
        # the trainer's PreemptionGuard SIGTERM handler (which only sets
        # a flag) is inherited across fork — restore the default so
        # shutdown()'s terminate() actually terminates a stuck worker
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    except (ValueError, OSError):
        pass
    try:
        pipeline.setup()
        it = iter(pipeline)
        while True:
            if _service_commands(pipeline, cmd):
                out_q.cancel_join_thread()
                return
            items = [next(it) for _ in range(batch_size)]
            batch = _stack(items)
            with produced.get_lock():
                produced.value += 1
            _worker_fault(widx, produced.value)
            while True:
                if _service_commands(pipeline, cmd):
                    out_q.cancel_join_thread()
                    return
                try:
                    out_q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
    except BaseException as e:  # noqa: BLE001 — forwarded to consumer
        payload = _pickle_safe(e)
        sent = False
        while True:  # keep servicing state commands until told to stop
            try:
                if _service_commands(pipeline, cmd):
                    out_q.cancel_join_thread()
                    return
            except (EOFError, OSError, BrokenPipeError):
                return  # parent is gone
            if not sent:
                try:
                    out_q.put(payload, timeout=0.1)
                    sent = True
                except queue.Full:
                    continue
            time.sleep(0.05)


class StatefulDataLoader:
    """Batching iterator over one or more pipeline clones ("workers").

    Exposes the wrapped pipeline as ``.dataset`` (parity with
    ``torch_loader.dataset`` access in the reference checkpoint path,
    ref:checkpointing_utils.py:275-278); with num_workers > 1 each worker
    owns an inflated rank and saves its own ``loader_state_<rank>`` file.
    """

    # forwards the empty-path fresh-start marker to its pipelines
    # (get_data_loader always builds CheckpointDataset outermost, which
    # implements it; see data/buffering.py)
    supports_fresh_start = True

    # shutdown escalation budget (seconds): cooperative stop -> join ->
    # SIGTERM -> join -> SIGKILL -> reap. Class attrs so tests (and
    # latency-sensitive callers) can tighten the bounds.
    STOP_JOIN_S = 5.0
    TERM_JOIN_S = 2.0
    KILL_JOIN_S = 2.0

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        num_workers: int = 1,
        prefetch_batches: int = 2,
        worker_mode: str = "thread",
        max_worker_restarts: int = 2,
        restart_backoff_s: float = 1.0,
    ):
        assert worker_mode in ("thread", "process"), worker_mode
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.worker_mode = worker_mode
        # a worker that dies from a transient error is restarted with
        # exponential backoff up to this many times (per worker, per
        # iterator generation) before the error reaches the consumer
        self.max_worker_restarts = max(0, max_worker_restarts)
        self.restart_backoff_s = restart_backoff_s
        self._threads: List[threading.Thread] = []
        self._procs: list = []
        self._cmds: list = []
        self._procs_started = False
        # save-skew accounting: batches built per worker vs consumed by
        # the trainer (explicit state captures log the difference)
        self._produced: list = [[0] for _ in range(self.num_workers)]
        self._consumed = [0] * self.num_workers
        # per-iterator-generation stop event: set-and-abandoned on
        # shutdown, REPLACED (never cleared) when a new iterator spawns
        # workers — a straggler thread that outlives a 5s join timeout
        # still sees ITS generation's event set and can never race a
        # successor over the same pipeline object
        self._stop = threading.Event()
        # one lock per worker, held while that worker advances its
        # pipeline: external state reads (state_dict/save_to_path — the
        # speculator path checkpoints a live loader) grab all locks and
        # observe every pipeline at a batch boundary
        self._locks = [threading.Lock() for _ in range(self.num_workers)]
        if self.num_workers == 1:
            self.pipelines = [dataset]
        else:
            self.pipelines = []
            for worker_id in range(self.num_workers):
                clone = dataset if worker_id == self.num_workers - 1 else deepcopy(
                    dataset
                )
                clone.local_worldsize = self.num_workers
                clone.worldsize = clone.worldsize * self.num_workers
                clone.rank = self.num_workers * clone.rank + worker_id
                self.pipelines.append(clone)

    @property
    def dataset(self):
        return self.pipelines[0]

    @staticmethod
    def _worker_loop(pipeline, out_q, lock, stop, batch_size, produced, widx=0):
        """Produce stacked batches from one worker pipeline into its queue.
        Exceptions are forwarded so the consumer re-raises them. The lock
        is held only while advancing the pipeline (never across the
        blocking put — a full queue must not deadlock a state reader).

        Static on purpose: a bound-method target would keep the loader
        strongly referenced from the thread registry, so an abandoned
        iterator's loader could never be garbage collected and __del__
        could never signal its threads to exit."""
        try:
            it = iter(pipeline)
            while not stop.is_set():
                with lock:
                    items = [next(it) for _ in range(batch_size)]
                    produced[0] += 1
                _worker_fault(widx, produced[0])
                batch = _stack(items)
                while not stop.is_set():
                    try:
                        out_q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            # bounded, stop-aware put: the consumer may already be gone
            # (peer worker's error triggered shutdown, or the generator
            # was abandoned) — never hang a dying worker on a full queue
            while not stop.is_set():
                try:
                    out_q.put(e, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def shutdown(self):
        """Stop worker threads/processes (idempotent), within bounded
        time. Escalation for a process worker that ignores the stop
        command (wedged mid-batch, never reaches its command-servicing
        boundary): cooperative stop -> join -> SIGTERM -> join -> SIGKILL
        -> reap — the parent never hangs on a stuck worker. Call before
        inspecting pipeline state externally while an iterator is live."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=self.STOP_JOIN_S)
        self._threads = []
        for c in self._cmds:
            if c is None:
                continue
            try:
                c.send(("stop", None))
            except (OSError, BrokenPipeError, ValueError):
                pass
        for p in self._procs:
            if p is None:  # spawn loop interrupted mid-way
                continue
            p.join(timeout=self.STOP_JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join(timeout=self.TERM_JOIN_S)
                if p.is_alive():
                    p.kill()
                    # reap: SIGKILL is not ignorable, so this join only
                    # waits out the kernel's teardown (bounded as a
                    # belt-and-braces measure; a daemon zombie would
                    # otherwise linger until interpreter exit)
                    p.join(timeout=self.KILL_JOIN_S)
        self._procs, self._cmds = [], []

    def __del__(self):
        self._stop.set()  # reachable: worker threads don't reference self
        for c in getattr(self, "_cmds", []):
            if c is None:
                continue
            try:
                c.send(("stop", None))
            except (OSError, BrokenPipeError, ValueError):
                pass

    def _workers_alive(self) -> bool:
        return bool(self._procs) and any(
            p is not None and p.is_alive() for p in self._procs
        )

    def _log_skew(self, op: str):
        """ADVICE r3: prefetching workers run ahead of consumption, so a
        state capture includes up to num_workers*(prefetch_batches+1)
        batches the trainer never saw — a resume skips them. Surface the
        actual skew whenever state is captured from live workers."""
        produced = [
            p.value if hasattr(p, "value") else p[0] for p in self._produced
        ]
        skew = [p - c for p, c in zip(produced, self._consumed)]
        if any(s > 0 for s in skew):
            # the inflated worker rank // num_workers recovers the data
            # rank, so merged multi-host logs attribute each skew list
            rank = self.pipelines[0].rank // self.num_workers
            print(
                f"loader {op} [rank {rank}]: worker prefetch ran {skew} "
                f"batches ahead of consumption (per worker); resume will "
                f"skip those batches"
            )

    def __iter__(self):
        if self.worker_mode == "process":
            yield from self._iter_process()
            return
        # Top-level setup propagates the (possibly worker-inflated)
        # rank/worldsize down the wrapper stack before any layer iterates.
        for p in self.pipelines:
            p.setup()
        if self.num_workers == 1:
            # workerless path: same generation contract as the worker
            # paths — a later __iter__ (or shutdown) supersedes this
            # iterator, which must raise rather than keep drawing from
            # the shared pipeline interleaved with its successor.
            # Consumption advances the pipeline INLINE, so this path is
            # zero-skew by construction: a state capture at a step
            # boundary equals exactly the consumed position, and a
            # resume replays nothing and skips nothing — the property
            # chaos certification leans on (feed_prefetch=0 ahead of
            # it). The batch is built under the worker lock, as in the
            # thread mode: with a prefetching feed this generator runs
            # in the feed's thread, and a state capture on the trainer's
            # thread must see the pipeline at a batch boundary.
            self.shutdown()
            stop = self._stop = threading.Event()
            self._produced = [[0]]
            self._consumed = [0]
            it = iter(self.pipelines[0])
            while True:
                if stop.is_set():
                    raise RuntimeError(
                        "stale loader iterator: the loader was shut down "
                        "or re-iterated; this generation's stream has "
                        "ended"
                    )
                with self._locks[0]:
                    items = [next(it) for _ in range(self.batch_size)]
                batch = _stack(items)
                self._produced[0][0] += 1
                self._consumed[0] += 1
                # the workers' fault site: in workerless mode the trainer
                # is the worker, so action=exit ends this process with
                # the classified loader_death code
                _worker_fault(0, self._produced[0][0])
                yield batch

        self.shutdown()
        # fresh generation (see __init__); the local binding lets THIS
        # generator detect it was superseded — shutdown() (including the
        # one a later __iter__ issues) sets the event, and a stale
        # iterator must raise, not block forever on queues nobody fills
        stop = self._stop = threading.Event()
        self._produced = [[0] for _ in range(self.num_workers)]
        self._consumed = [0] * self.num_workers
        queues = [
            queue.Queue(maxsize=self.prefetch_batches) for _ in self.pipelines
        ]
        self._threads = [
            threading.Thread(
                target=self._worker_loop,
                args=(p, q, lk, self._stop, self.batch_size, prod, i),
                daemon=True,
            )
            for i, (p, q, lk, prod) in enumerate(
                zip(self.pipelines, queues, self._locks, self._produced)
            )
        ]
        for t in self._threads:
            t.start()
        restarts = [0] * self.num_workers
        w = 0
        while True:
            while True:
                # checked BEFORE the get: a superseded iterator must not
                # serve leftover prefetched batches either — the stream
                # has moved to the new generation, and the skipped-
                # prefetch contract says those batches are dropped, not
                # delivered late interleaved with the successor's
                if stop.is_set():
                    raise RuntimeError(
                        "stale loader iterator: the loader was shut down "
                        "or re-iterated; this generation's stream has "
                        "ended"
                    )
                try:
                    batch = queues[w].get(timeout=1.0)
                    break
                except queue.Empty:
                    continue
            if isinstance(batch, BaseException):
                if self._can_restart(batch, restarts, w):
                    # the pipeline object (and its position) lives in this
                    # process: a restarted thread resumes the stream from
                    # where the crashed one left it (minus the partial
                    # batch in flight)
                    t = threading.Thread(
                        target=self._worker_loop,
                        args=(
                            self.pipelines[w],
                            queues[w],
                            self._locks[w],
                            stop,
                            self.batch_size,
                            self._produced[w],
                            w,
                        ),
                        daemon=True,
                    )
                    self._threads[w] = t
                    t.start()
                    continue
                self.shutdown()
                if isinstance(batch, (StopIteration, CorpusLossError)):
                    # CorpusLossError stays typed: the entry wrapper
                    # exits corpus_loss, not loader_death — the
                    # supervisor restarts dead DATA differently from a
                    # dead worker
                    raise batch
                # restart budget exhausted: surface typed so the entry's
                # classified-exit wrapper exits loader_death (the
                # supervisor's restart policy keys on the cause)
                raise LoaderWorkerError(
                    f"loader worker {w} failed and the restart budget "
                    f"({self.max_worker_restarts}) is exhausted: {batch}"
                ) from batch
            self._consumed[w] += 1
            yield batch
            w = (w + 1) % self.num_workers

    def _can_restart(self, err, restarts, w) -> bool:
        """Worker-restart budget check + backoff sleep. StopIteration
        (stream genuinely ended) and CorpusLossError (the data itself is
        gone below the survivable floor — a worker restart rereads the
        same dead corpora) are never restarted; anything else gets
        ``max_worker_restarts`` attempts per worker per generation with
        exponential backoff before the error surfaces to the consumer."""
        if isinstance(err, (StopIteration, CorpusLossError)):
            return False
        if restarts[w] >= self.max_worker_restarts:
            return False
        restarts[w] += 1
        delay = self.restart_backoff_s * (2 ** (restarts[w] - 1))
        print(
            f"loader worker {w} died ({type(err).__name__}: {err}); "
            f"restart {restarts[w]}/{self.max_worker_restarts} "
            f"in {delay:.2f}s"
        )
        time.sleep(delay)
        return True

    def _iter_process(self):
        """Process-mode consumer: forked worker processes (the reference's
        torch DataLoader worker-process model, ref:dataloader_utils.py:
        144-146) feed bounded mp queues; state commands are serviced at
        worker batch boundaries via per-worker pipes. Fork (not spawn)
        so resumed/rescaled pipeline state built in the parent — e.g.
        load_from_path before iteration — is inherited without pickling.

        Fork caveat (same one torch DataLoader accepts with its fork
        default): the parent is multithreaded by the time the loader
        iterates (the device feed, the checkpoint writer, CUDA's own
        threads), and fork() snapshots mutex state — a child could
        inherit a held allocator lock and deadlock. The workers never
        touch torch or CUDA (pure numpy/pyarrow/tokenizers), which keeps
        the inherited-lock surface to the allocator; if a worker ever
        hangs before producing its first batch, the thread mode is the
        drop-in alternative."""
        if self._procs_started:
            if not self._workers_alive():
                raise RuntimeError(
                    "worker_mode='process': re-iteration after workers "
                    "exited — their pipeline state is gone. Build a fresh "
                    "loader (resume via load_from_path) instead."
                )
            # capture-then-refork: live workers hold the stream position,
            # so a second __iter__ (an eval loop re-iterating its loader,
            # torch DataLoader's normal contract) pulls each worker's
            # state through the command channel, restores it into the
            # parent's pipeline clones — the same same-size single-shard
            # load the file-resume path uses — and falls through to fork
            # a fresh generation that CONTINUES the stream. Batches the
            # workers prefetched but the consumer never took are skipped,
            # exactly like a checkpoint resume; _log_skew reports them.
            states = self._command_all("state_dict")
            self._log_skew("re-iteration")
            for p, sd in zip(self.pipelines, states):
                p.load_worldsize = p.worldsize
                p.load_state_dict([sd], sharded_input=True)
        self.shutdown()
        # same stale-iterator contract as thread mode: shutdown() (ours
        # above, or a later __iter__'s) sets the old generation's event,
        # and that generation's consumer raises instead of spinning on
        # queues whose producers are gone
        stop = self._stop = threading.Event()
        self._procs_started = True
        ctx = multiprocessing.get_context("fork")
        self._produced = [ctx.Value("q", 0) for _ in range(self.num_workers)]
        self._consumed = [0] * self.num_workers
        queues = [
            ctx.Queue(maxsize=self.prefetch_batches) for _ in self.pipelines
        ]
        self._cmds = [None] * self.num_workers
        self._procs = [None] * self.num_workers
        for i in range(self.num_workers):
            self._spawn_proc_worker(i, ctx, queues)
        procs = self._procs  # generation-local (shutdown() rebinds the attr)
        restarts = [0] * self.num_workers
        w = 0
        while True:
            while True:
                # pre-get staleness check, same contract as thread mode
                if stop.is_set():
                    raise RuntimeError(
                        "stale loader iterator: the loader was shut down "
                        "or re-iterated; this generation's stream has "
                        "ended"
                    )
                try:
                    batch = queues[w].get(timeout=1.0)
                    break
                except queue.Empty:
                    if stop.is_set():
                        # deliberate shutdown/re-iteration, not a worker
                        # crash: loop back so the top-of-loop check
                        # raises the stale-iterator error, not a
                        # misleading "worker died (exit -15)"
                        continue
                    if not procs[w].is_alive():
                        if stop.is_set():
                            # shutdown landed between the check above and
                            # the liveness probe: the dead worker is the
                            # OLD generation's (TERMed by shutdown), not
                            # a crash — loop back to the stale raise
                            continue
                        exitcode = procs[w].exitcode
                        batch = RuntimeError(
                            f"loader worker {w} died (exit {exitcode})"
                        )
                        break
            if isinstance(batch, BaseException):
                if stop.is_set():
                    # a superseded iterator must NEVER call shutdown():
                    # that would kill the NEW generation's workers. The
                    # stream has moved on — raise the stale error instead
                    raise RuntimeError(
                        "stale loader iterator: the loader was shut down "
                        "or re-iterated; this generation's stream has "
                        "ended"
                    )
                if self._can_restart(batch, restarts, w):
                    # refork from the parent's pipeline clone. The dead
                    # worker's stream position died with it, so the
                    # restarted worker resumes from the parent's last
                    # captured state (construction or the last
                    # load_from_path/re-iteration capture) — batches
                    # consumed since then are REPLAYED; flag it.
                    print(
                        f"loader worker {w} restarting from the parent's "
                        f"last captured pipeline state; batches consumed "
                        f"since that capture will repeat"
                    )
                    # FRESH queue: a worker killed mid-put (SIGKILL/OOM)
                    # can die holding the mp.Queue's shared write lock,
                    # which would wedge the replacement worker's first
                    # put forever. Prefetched batches in the old queue
                    # are dropped — already covered by replay semantics.
                    queues[w] = ctx.Queue(maxsize=self.prefetch_batches)
                    self._spawn_proc_worker(w, ctx, queues)
                    continue
                self.shutdown()
                if isinstance(batch, (StopIteration, CorpusLossError)):
                    raise batch
                raise LoaderWorkerError(
                    f"loader worker {w} failed and the restart budget "
                    f"({self.max_worker_restarts}) is exhausted: {batch}"
                ) from batch
            self._consumed[w] += 1
            yield batch
            w = (w + 1) % self.num_workers

    def _spawn_proc_worker(self, w, ctx, queues):
        """(Re)fork worker ``w``: fresh pipe, fresh process over the
        parent's pipeline clone, shared produced counter (so save-skew
        accounting and batch-numbered fault filters survive restarts)."""
        old = self._cmds[w]
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        parent_conn, child_conn = ctx.Pipe()
        proc = ctx.Process(
            target=_process_worker_loop,
            args=(
                self.pipelines[w],
                queues[w],
                child_conn,
                self.batch_size,
                self._produced[w],
                w,
            ),
            daemon=True,
        )
        proc.start()
        child_conn.close()
        self._cmds[w] = parent_conn
        self._procs[w] = proc

    # -- state (delegates to every worker pipeline) -----------------------

    class _AllLocks:
        def __init__(self, locks):
            self.locks = locks

        def __enter__(self):
            for lk in self.locks:
                lk.acquire()

        def __exit__(self, *exc):
            for lk in reversed(self.locks):
                lk.release()

    def _command_all(self, op: str, arg=None):
        """Send a state command to every live worker process and collect
        the replies (each worker answers at its next batch boundary — the
        process-mode analog of grabbing all thread locks). A worker that
        died or whose state op failed raises here instead of blocking the
        trainer's checkpoint path forever — but only after EVERY live
        worker's reply has been drained, so a partial failure can't leave
        a stale reply queued in a pipe to be mis-attributed to the next
        command."""
        out, errs, sent = [], [], []
        for c, p in zip(self._cmds, self._procs):
            try:
                c.send((op, arg))
                sent.append(True)
            except (OSError, BrokenPipeError, ValueError):
                errs.append(
                    RuntimeError(
                        f"loader worker (pid {p.pid}) unreachable for "
                        f"{op!r} (exit {p.exitcode})"
                    )
                )
                sent.append(False)
        for c, p, ok in zip(self._cmds, self._procs, sent):
            if not ok:
                out.append(None)
                continue
            reply = None
            try:
                while not c.poll(timeout=1.0):
                    if not p.is_alive():
                        raise RuntimeError(
                            f"loader worker (pid {p.pid}) died during "
                            f"{op!r} (exit {p.exitcode})"
                        )
                reply = c.recv()
            except (RuntimeError, EOFError, OSError) as e:
                errs.append(e)
            if isinstance(reply, BaseException):
                errs.append(reply)
                reply = None
            out.append(reply)
        if errs:
            raise errs[0]
        return out

    def _check_not_stale(self, op: str):
        """worker_mode='process': all data-position state lives in the
        forked workers — the parent's pipeline copies never advance.
        Refuse to serve state from them once workers have run (a silent
        batch-0 checkpoint would replay the whole consumed stream on
        resume); capture state while workers are live instead (the
        production paths do: CheckpointDataset auto-saves inside workers,
        explicit saves go through the command channel)."""
        if (
            self.worker_mode == "process"
            and self._procs_started
            and not self._workers_alive()
        ):
            raise RuntimeError(
                f"loader.{op} after process workers exited: their pipeline "
                f"state is gone; capture state while workers are live"
            )

    def state_dict(self) -> List[dict]:
        self._check_not_stale("state_dict")
        if self._workers_alive():
            out = self._command_all("state_dict")
            self._log_skew("state_dict")
            return out
        with self._AllLocks(self._locks):
            self._log_skew("state_dict")
            return [p.state_dict() for p in self.pipelines]

    def load_state_dict(self, state_dicts, sharded_input=False):
        self._check_not_stale("load_state_dict")
        if self._workers_alive():
            self._command_all("load_state_dict", (state_dicts, sharded_input))
            return
        with self._AllLocks(self._locks):
            for p in self.pipelines:
                p.load_state_dict(state_dicts, sharded_input)

    def save_to_path(self, path: str):
        self._check_not_stale("save_to_path")
        if self._workers_alive():
            self._command_all("save_to_path", path)
            self._log_skew("save_to_path")
            return
        with self._AllLocks(self._locks):
            self._log_skew("save_to_path")
            for p in self.pipelines:
                p.save_to_path(path)

    def load_from_path(self, path: str):
        self._check_not_stale("load_from_path")
        if self._workers_alive():
            self._command_all("load_from_path", path)
            return
        with self._AllLocks(self._locks):
            for p in self.pipelines:
                p.load_from_path(path)


class SteadyCounter:
    """Dummy stream: incrementing counts of constant length l mod vocab v
    (ref:dataloader_utils.py:41-54). Used for benchmarking / dummy runs."""

    def __init__(self, l: int, v: int):
        self.i = 0
        self.l = l
        self.v = v

    def __iter__(self):
        while True:
            out = np.arange(self.i, self.i + self.l, dtype=np.int32) % self.v
            yield out, out
            self.i += self.l


class _SimpleLoader:
    """Minimal batching loader for non-stateful iterables (dummy data)."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __iter__(self):
        it = iter(self.dataset)
        while True:
            yield _stack([next(it) for _ in range(self.batch_size)])


def get_dummy_loader(cfg, rank, world_size):
    return _SimpleLoader(SteadyCounter(cfg.seq_length, cfg.vocab_size), cfg.batch_size)


def elastic_batch_size(cfg, resume_topology, data_extent, rank=0) -> int:
    """Per-rank rows for an elastic resume: preserve the checkpoint's
    *global* batch across a topology change (docs/checkpointing.md
    "Elastic resume").

    ``resume_topology`` is the fingerprint stamped into the checkpoint a
    restart will restore (``checkpointer.resume_topology()``); the
    global row count it records divided by the new data-parallel extent
    gives the per-rank batch size that keeps tokens-per-step — and with
    it tokens_seen, the LR schedule, and the loss trajectory —
    meaningful across the rescale. Recomputation only ever covers the
    launch-script case (same per-rank ``--batch_size``, different
    world): when the data-parallel extent is UNCHANGED, a differing
    global batch can only be a deliberate ``--batch_size`` edit, and
    that — like a global batch the new extent cannot divide — is a hard
    error; ``--allow_batch_change=True`` is the escape hatch (the
    configured batch_size is then used as-is, with a loud notice).
    Returns ``cfg.batch_size`` unchanged on a fresh start or a
    same-batch resume."""
    if not resume_topology:
        return cfg.batch_size
    old_rows = int(resume_topology.get("global_batch_rows") or 0)
    if old_rows <= 0:
        return cfg.batch_size
    if cfg.batch_size * data_extent == old_rows:
        return cfg.batch_size
    old_dc = int(resume_topology.get("device_count") or 0)
    old_extent = old_dc // max(
        1, int(resume_topology.get("tensor_parallel_size") or 1)
    ) // max(1, int(resume_topology.get("context_parallel_size") or 1))
    deliberate = old_dc > 0 and old_extent == data_extent
    if deliberate and not getattr(cfg, "allow_batch_change", False):
        raise ValueError(
            f"elastic resume: batch_size was changed on an unchanged "
            f"data-parallel extent ({data_extent}), moving the global "
            f"batch {old_rows} -> {cfg.batch_size * data_extent} rows "
            f"(tokens_seen and the LR schedule shift). Restore "
            f"--batch_size={old_rows // data_extent}, or pass "
            f"--allow_batch_change=True to accept the change."
        )
    if getattr(cfg, "allow_batch_change", False):
        if rank == 0:
            print(
                f"WARNING: elastic resume changes the global batch "
                f"({old_rows} -> {cfg.batch_size * data_extent} rows; "
                f"allow_batch_change=True): tokens-per-step, the LR "
                f"schedule, and the loss trajectory shift from here."
            )
        return cfg.batch_size
    if old_rows % data_extent != 0:
        raise ValueError(
            f"elastic resume: the checkpoint's global batch is "
            f"{old_rows} rows but the new data-parallel extent "
            f"{data_extent} does not divide it, so the global batch "
            f"cannot be preserved. Restart on a chip count whose "
            f"data-parallel extent divides {old_rows}, or pass "
            f"--allow_batch_change=True to accept a changed global "
            f"batch (tokens_seen / LR schedule shift)."
        )
    resolved = old_rows // data_extent
    if rank == 0:
        print(
            f"elastic resume: preserving the global batch of {old_rows} "
            f"rows across the rescale — per-rank batch_size "
            f"{cfg.batch_size} -> {resolved}"
        )
    return resolved


def get_data_loader(cfg, rank, world_size, postprocess=None, batch_multiplier=1):
    """Build the full 7-layer pipeline
    (ref:dataloader_utils.py:60-146): streaming docs -> logical-shard
    rescaling -> weighted multi-dataset sampling -> fixed-length packing ->
    reservoir shuffle -> tensorize -> task postprocess -> auto-checkpoint,
    wrapped in the batching loader.

    ``batch_multiplier``: loader batches consumed per trainer step by this
    process (the ``rebatch`` factor — data-parallel shards per process).
    It keeps CheckpointDataset's auto-save step numbering aligned with
    trainer steps, preserving the reference invariant that loader state
    lands in the same ``step_N_ckp`` dirs as model checkpoints
    (ref:dataloader_utils.py:137-143 counts its interval in trainer
    batches; one torch batch = one trainer step there, but here one
    trainer step consumes batch_multiplier loader batches spread
    round-robin over num_workers workers). When num_workers does not
    divide the per-step row count the worker step clock diverges from the
    trainer's (by up to num_workers/rows_per_step when workers outnumber
    per-step rows) — a warning is printed, and resume still works because
    both checkpoint validators scan for the newest directory of their own
    kind.
    """
    if postprocess is None:
        postprocess = [causal_lm]

    datasets, weights = parse_data_args(cfg.datasets, cfg.weights)

    droplist = [
        int(x.strip()) for x in cfg.strip_tokens.split(",") if len(x.strip()) > 0
    ]
    droplist = droplist + [cfg.bos_token, cfg.eos_token, cfg.bol_token, cfg.eol_token]
    assert cfg.file_type in _HANDLER_BUILDERS, (
        f"File type {cfg.file_type} is not recognized "
        f"({list(_HANDLER_BUILDERS.keys())})"
    )
    filehandler = _HANDLER_BUILDERS[cfg.file_type](cfg)
    # transient shard-read errors retry with bounded backoff; exhaustion
    # surfaces OSError to StreamingDocDataset, which quarantines the
    # shard instead of killing the run (resilience layer)
    from fms_fsdp_tpu_torch.resilience.retry import RetryingShardHandler

    filehandler = RetryingShardHandler(
        filehandler,
        retries=max(0, getattr(cfg, "shard_read_retries", 3)),
        backoff_s=getattr(cfg, "shard_read_backoff_s", 0.5),
    )

    data = StreamingDocDataset(
        cfg.data_path,
        rank,
        world_size,
        filehandler,
        cfg.eos_token,
        bos_token=cfg.bos_token,
        strip_tokens=set(droplist),
        min_length=3,
        seed=cfg.seed,
    )
    data = ScalableShardDataset(
        data,
        cfg.eos_token,
        n_logical_shards=cfg.logical_shards,
    )
    data = SamplingDataset(
        cfg.data_path,
        data,
        cfg.eos_token,
        datasets=datasets,
        weights=weights,
        # fault-isolation floor: a run survives corpus loss (weights
        # renormalized over survivors) down to this many live corpora;
        # below it the classified corpus_loss exit fires
        min_live_corpora=int(getattr(cfg, "min_live_corpora", 1) or 1),
        allow_corpus_change=bool(getattr(cfg, "allow_corpus_change", False)),
        verbose=(rank == 0),
    )
    # +1 token so the causal shift still yields seq_length-long examples
    data = BufferDataset(
        data,
        cfg.seq_length if causal_lm not in postprocess else cfg.seq_length + 1,
        bos_token=cfg.bol_token,
        eos_token=cfg.eol_token,
        pack_hard=True,
    )
    # Reservoir-shuffle window. NOTE for tests/small corpora: while the
    # reservoir fills it pulls ~2 rows from the packer per emitted row,
    # so the underlying document walk runs up to (window + consumed)
    # rows ahead of consumption — on a corpus smaller than ~2x the
    # window's token footprint the walk wraps into its SECOND epoch
    # almost immediately, and a resume will (correctly) re-serve
    # epoch-1 documents. Size the window below the corpus for
    # deterministic walk tests (tests/_elastic_child.py does).
    data = PreloadBufferDataset(
        data, int(getattr(cfg, "loader_shuffle_window", 10000) or 10000)
    )

    data = PreprocessDataset(data, lambda x: np.asarray(x, dtype=np.int32))
    for p in postprocess:
        data = PreprocessDataset(data, p)

    # rows one worker emits per trainer step (see batch_multiplier above)
    rows_per_step = cfg.batch_size * max(1, batch_multiplier)
    steps_per_batch = max(1, rows_per_step // max(1, cfg.num_workers))
    if rank == 0 and rows_per_step % max(1, cfg.num_workers) != 0:
        # worst case (num_workers > rows_per_step) the worker step clock
        # runs num_workers/rows_per_step times SLOW, not "slightly off"
        print(
            f"WARNING: num_workers={cfg.num_workers} does not divide the "
            f"per-step row count {rows_per_step}; loader auto-save step "
            f"numbering will drift from trainer steps (resume still works "
            f"— both checkpoint scanners pick the newest dir of their own "
            f"kind — but on-disk step numbers won't correlate)"
        )
    # the fast-local checkpoint tier (docs/checkpointing.md) is another
    # root the trainer may resolve a restart from; the loader must
    # honor a trainer-resolved step dir under it exactly like one under
    # the durable root (model-loader consistency)
    local_dir = str(getattr(cfg, "ckpt_local_dir", "") or "")
    data = CheckpointDataset(
        data,
        cfg.ckpt_load_path if cfg.resuming_dataset else cfg.ckpt_save_path,
        cfg.checkpoint_interval,
        steps_per_batch,
        cfg.ckpt_save_path,
        extra_roots=(
            (os.path.join(local_dir, "checkpoints"),) if local_dir else ()
        ),
    )
    return StatefulDataLoader(
        data,
        batch_size=cfg.batch_size,
        num_workers=cfg.num_workers,
        worker_mode=getattr(cfg, "worker_mode", "thread"),
        max_worker_restarts=getattr(cfg, "loader_worker_restarts", 2),
        restart_backoff_s=getattr(cfg, "loader_restart_backoff_s", 1.0),
    )


def rebatch(loader, local_batch: int, batch_size: int):
    """Concatenate per-rank batches (of ``batch_size`` rows) into
    process-local device batches of ``local_batch`` rows — the bridge from
    the reference's per-GPU batch_size to a per-process multi-chip batch."""
    if local_batch == batch_size:
        return loader

    def gen():
        it = iter(loader)
        n = local_batch // batch_size
        while True:
            parts = [next(it) for _ in range(n)]
            if isinstance(parts[0], tuple):
                yield tuple(np.concatenate(f) for f in zip(*parts))
            else:
                yield np.concatenate(parts)

    return gen()


def _find_layer(pipeline, cls):
    """Walk a wrapper pipeline's ``.dataset`` chain for a layer type."""
    d = pipeline
    while d is not None:
        if isinstance(d, cls):
            return d
        d = getattr(d, "dataset", None)
    return None


def loader_mix_stats(loader):
    """Aggregate per-corpus mixing stats from a live loader, or None.

    Walks every worker pipeline's wrapper chain to the SamplingDataset
    and sums per-corpus ``tokens_seen`` (racy int reads — gauge
    accuracy, not exactness). Returns ``{"tokens": {corpus: int},
    "weights": {corpus: float}, "quarantined": [corpus, ...]}``.
    None when the loader carries no mixing layer (dummy loader), the
    pipeline is not set up yet (fresh un-iterated start), or
    worker_mode="process" has started its workers (the parent's
    pipeline copies never advance — their numbers would be frozen at
    the fork point)."""
    pipelines = getattr(loader, "pipelines", None)
    if not pipelines:
        return None
    if (
        getattr(loader, "worker_mode", "thread") == "process"
        and getattr(loader, "_procs_started", False)
    ):
        return None
    samplers = [
        s
        for s in (_find_layer(p, SamplingDataset) for p in pipelines)
        if s is not None and s.is_setup
    ]
    if not samplers:
        return None
    names = list(samplers[0].datasets)
    tokens = {n: 0 for n in names}
    quarantined = set()
    for s in samplers:
        for n, t in zip(s.datasets, s.tokens_seen):
            tokens[n] = tokens.get(n, 0) + int(t)
        quarantined.update(s.quarantined_corpora)
    return {
        "tokens": tokens,
        "weights": {n: float(w) for n, w in zip(names, samplers[0].weights)},
        "quarantined": sorted(quarantined),
    }


def parse_data_args(datas, weights):
    """csv strings -> lists (ref:dataloader_utils.py:149-163)."""

    def splitstrip(x):
        if isinstance(x, str):
            return [item.strip() for item in x.split(",")]
        elif isinstance(x, (list, tuple)):
            return list(x)
        elif isinstance(x, (int, float, complex)):
            return [x]
        else:
            raise ValueError(f"arg input {x} cannot be parsed.")

    datas = splitstrip(datas)
    weights = [float(x) for x in splitstrip(weights)]
    return datas, weights
