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
"""

import weakref
from typing import Any, List, Tuple

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

# this process's layout adapters by engine key (build order)
_ADAPTERS: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()
_KEYS = {"next": 0}
# the leader's live LeaderAdapters, whose pending calls a release sends
_LEADERS: "weakref.WeakSet[LeaderAdapter]" = weakref.WeakSet()
# messages broadcast since the last reset (the leader's count)
MESSAGES = {"sent": 0, "calls": 0}


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
    return aux_group("serve")


def _broadcast(calls: List[Tuple]) -> List[Tuple]:
    box = [calls if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=_group())
    return box[0]


class LeaderAdapter:
    """The leader's view of a layout adapter: reads pass through; each
    call of :data:`SENT` is sent to the followers, then run here."""

    def __init__(self, adapter, key: int):
        self._adapter = adapter
        self._key = key
        self._pending: List[Tuple] = []
        _LEADERS.add(self)

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
            _broadcast(self._pending)
            self._pending = []


def follow() -> int:
    """A follower's loop: run each call the leader sends on this
    process's adapter of the same key, until :func:`release_followers`.
    Returns the number of calls run. A ``HandoffError`` ends the call
    as it ends the leader's, which fails the request typed."""
    from fms_fsdp_tpu_torch.serve.disagg.handoff import HandoffError

    if dist.get_rank() == 0:
        raise RuntimeError("rank 0 leads the replica: drive its engine, do not follow")
    n = 0
    while True:
        for key, name, args in _broadcast(None):
            if name == _STOP:
                return n
            try:
                getattr(_ADAPTERS[key], name)(*args)
            except HandoffError:
                pass
            n += 1


def release_followers() -> None:
    """The leader's end of :func:`follow`: every adapter's pending calls,
    then the stop message, so each follower's state is the leader's when
    its :func:`follow` returns."""
    calls = []
    for lead in list(_LEADERS):
        calls += lead._pending
        lead._pending = []
    _broadcast(calls + [(-1, _STOP, ())])


def reset_messages() -> None:
    for key in MESSAGES:
        MESSAGES[key] = 0
