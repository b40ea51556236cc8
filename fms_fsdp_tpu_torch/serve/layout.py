"""A serving replica over a group of ranks: rank 0 leads, the others follow.

JAX's sharded replica is one process over several devices; here one
process drives one device, so a ``serve_layout`` replica is T x F
processes (``parallel/sharding.py::ServeMesh``). Every rank builds the
same :class:`~fms_fsdp_tpu_torch.serve.engine.ServingEngine` on its
blocks of the weights and its KV heads. Rank 0, the leader, runs the
engine: the scheduler, admission, the clock, sampling, the stats and the
handoff wire. Its family adapter sits behind a :class:`LeaderAdapter`:
each adapter call that writes state or launches work (:data:`SENT`) is
broadcast as ``(engine key, method, args)`` to the other ranks before
the leader runs it. The followers sit in :func:`follow`, which runs the
same call on their own adapter and drops the result, until the leader
calls :func:`release_followers`. So the scheduler decides once, the ranks
cannot drift on the clock or on an admission race, and the collectives
inside the model meet in one order on every rank.

The leader samples; the next step's tokens reach the followers in
``decode``'s arguments (its generator is not sent: a follower's sampled
tokens are dropped). Calls that touch only the host-side page allocator
(:data:`DEFERRED`: ``grow``, ``release``) ride with the next message
rather than costing a broadcast each. Messages go over a gloo group of
their own over the world (``utils/dist.py::aux_group("serve")``).
Engines are keyed in build order, which is the same on every rank, so
several layout engines of one world (a prefill and a decode replica)
share one follower loop.

The message group waits :data:`SERVE_TIMEOUT_S` for the other side of
each message. A serving replica can sit idle far longer than that, so a
daemon thread of the leader sends an empty message whenever none went
out for :data:`KEEPALIVE_S` while the followers are in :func:`follow`
(from the first layout engine's build, or the first message after a
release, to the next release). It sends under the lock of every other
message, so the group's messages keep one order. A follower whose leader
is gone (its receive fails or times out) raises out of :func:`follow`.
A fleet replica over a group of ranks (``serve/replica.py``) is a leader
process that starts, watches and releases its followers.
"""

import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Tuple

import torch.distributed as dist

from fms_fsdp_tpu_torch.utils.dist import aux_group

# the adapter calls that write state or launch work: the leader sends each
# before it runs it
SENT = ("prefill", "prefill_start", "prefill_chunk", "grow", "release", "decode",
        "decode_spec", "export_handoff", "import_handoff", "defrag")
# of those, the ones that touch only the host-side allocator: they are
# sent with the next message
DEFERRED = ("grow", "release")
_STOP = "stop"
# each operation of the message group waits this long for the other side;
# read when the group is made
SERVE_TIMEOUT_S = 600.0
# the leader's keep-alive: an empty message when none went out for this
# long while the followers follow (0: off)
KEEPALIVE_S = 30.0

# this process's layout adapters by engine key (build order)
_ADAPTERS: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()
_KEYS = {"next": 0}
# the leader's live LeaderAdapters, whose pending calls a release sends
_LEADERS: "weakref.WeakSet[LeaderAdapter]" = weakref.WeakSet()
# messages broadcast since the last reset (the leader's count)
MESSAGES = {"sent": 0, "calls": 0, "keepalive": 0}
# the calls a follower ran since the last reset, by name
CALLS: Dict[str, int] = {}
# the leader's wire: whether the followers are in follow() (``open``),
# when the last message went out, the keep-alive thread; every send holds
# the lock
_LOCK = threading.Lock()
_WIRE = {"open": False, "last": 0.0, "keepalive": None}


def register(adapter) -> int:
    """Key ``adapter`` for the follower loop; every rank registers its
    layout engines' adapters in the same order. The first registration
    makes the message group, at one point of every rank's sequence of
    collective group creations."""
    _group()
    key = _KEYS["next"]
    _KEYS["next"] += 1
    _ADAPTERS[key] = adapter
    return key


def _group():
    return aux_group("serve", timeout_s=SERVE_TIMEOUT_S)


def _broadcast(calls: List[Tuple]) -> List[Tuple]:
    box = [calls if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=_group())
    return box[0]


def _send(calls: List[Tuple]) -> None:
    """The leader: one message, under the wire's lock; the followers are
    in follow() from here to the next release."""
    with _LOCK:
        _broadcast(calls)
        _WIRE["open"], _WIRE["last"] = True, time.monotonic()


def _keepalive() -> None:
    while True:
        time.sleep(min(1.0, (KEEPALIVE_S or 4.0) / 4))
        with _LOCK:
            if not (KEEPALIVE_S and _WIRE["open"] and dist.is_initialized()
                    and time.monotonic() - _WIRE["last"] >= KEEPALIVE_S):
                continue
            try:
                _broadcast([])
            except Exception as e:  # noqa: BLE001 — a follower is gone: the next send fails too
                sys.stderr.write(f"serving layout keep-alive: {e}\n")
                _WIRE["open"] = False
                continue
            MESSAGES["keepalive"] += 1
            _WIRE["last"] = time.monotonic()


class LeaderAdapter:
    """The leader's view of a layout adapter: reads pass through; each
    call of :data:`SENT` is sent to the followers, then run here."""

    def __init__(self, adapter, key: int):
        self._adapter = adapter
        self._key = key
        self._pending: List[Tuple] = []
        _LEADERS.add(self)
        # the followers build this engine too, then follow
        with _LOCK:
            _WIRE["open"], _WIRE["last"] = True, time.monotonic()
            if KEEPALIVE_S and _WIRE["keepalive"] is None:
                _WIRE["keepalive"] = threading.Thread(target=_keepalive, daemon=True,
                                                      name="serve-keepalive")
                _WIRE["keepalive"].start()

    def __getattr__(self, name):
        attr = getattr(self._adapter, name)
        if name not in SENT:
            return attr

        def call(*args):
            sent = args[:3] + (None,) if name == "decode" else args  # no generator
            self._pending.append((self._key, name, sent))
            if name not in DEFERRED:
                self.flush()
            return attr(*args)

        return call

    def flush(self) -> None:
        """Send the pending calls now."""
        if self._pending:
            MESSAGES["sent"] += 1
            MESSAGES["calls"] += len(self._pending)
            _send(self._pending)
            self._pending = []


def follow() -> int:
    """A follower's loop: run each call the leader sends on this
    process's adapter of the same key, until :func:`release_followers`.
    Returns the number of calls run (by name in :data:`CALLS`). A
    ``HandoffError`` ends the call as it ends the leader's, which fails
    the request typed. A receive that fails (the leader is gone, or sent
    nothing, not even a keep-alive, for :data:`SERVE_TIMEOUT_S`) raises."""
    from fms_fsdp_tpu_torch.serve.disagg.handoff import HandoffError

    if dist.get_rank() == 0:
        raise RuntimeError("rank 0 leads the replica: drive its engine, do not follow")
    n = 0
    while True:
        try:
            calls = _broadcast(None)
        except RuntimeError as e:
            raise RuntimeError(f"rank {dist.get_rank()} of a serving layout lost its "
                               f"leader: {e}") from e
        for key, name, args in calls:
            if name == _STOP:
                return n
            try:
                getattr(_ADAPTERS[key], name)(*args)
            except HandoffError:
                pass
            n += 1
            CALLS[name] = CALLS.get(name, 0) + 1


def release_followers() -> None:
    """The leader's end of :func:`follow`: every adapter's pending calls,
    then the stop message, so each follower's state is the leader's when
    its :func:`follow` returns. A no-op when the followers were released
    and nothing was sent since (a replica that releases on drain, then on
    exit)."""
    with _LOCK:
        if not _WIRE["open"]:
            return
        calls = []
        for lead in list(_LEADERS):
            calls += lead._pending
            lead._pending = []
        _broadcast(calls + [(-1, _STOP, ())])
        _WIRE["open"] = False


def reset_messages() -> None:
    for key in MESSAGES:
        MESSAGES[key] = 0
    CALLS.clear()
