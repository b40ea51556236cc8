"""Chunked, resumable state-transfer transport for PageHandoff frames.

Counterpart of ``fms_fsdp_tpu/serve/disagg/transport.py``, with the same
wire bytes. A frame is split into fixed-size chunks, each carried in a
``FMSC`` wire frame ``(kind, rid, transfer_id, seq, total, payload,
crc32)``:

* the receiver acks each chunk; a corrupt chunk (CRC mismatch) is
  dropped without an ack, so the sender's retransmit timer heals it;
* the sender retries unacked chunks with bounded exponential backoff
  (``resilience/retry.py::backoff_delay``) off non-blocking timers:
  ``pump()`` never sleeps, so the caller's loop keeps heartbeating;
* an in-flight-bytes cap holds back new chunks while too much data is
  unacknowledged;
* a sender built with a pre-acked seq set (replayed from the router's
  chunk journal) resumes a partial transfer, retransmitting only the
  unacked chunks.

Data moves on a dedicated per-replica channel (a socketpair made at
spawn, the child's end passed by fd) wrapped in :class:`DataChannel`, a
non-blocking framed byte stream; stdio carries only the control messages.

Fault sites (``resilience/faults.py``, ``transport=`` filter key):
``handoff_chunk_corrupt`` flips a payload byte after the CRC is computed
and ``handoff_chunk_drop`` skips the send (both take ``every=N``);
``transport_stall`` parks a channel for ``seconds=S`` without blocking.

The module imports neither torch nor numpy: the router and the replica
child both use it.
"""

import itertools
import socket
import struct
import time
import zlib
from typing import Callable, Dict, Iterable, List, Optional

from fms_fsdp_tpu_torch.resilience.faults import fire_fault
from fms_fsdp_tpu_torch.resilience.retry import backoff_delay

# wire kinds
KIND_DATA = 0
KIND_ACK = 1

CHUNK_MAGIC = b"FMSC"
# magic | kind u8 | rid u32 | transfer_id u32 | seq u32 | total u32 |
# payload_len u32, then payload bytes, then crc32(payload) u32.
_HEADER = struct.Struct("<4sBIIIII")
_CRC = struct.Struct("<I")

# A corrupted header could decode an absurd payload_len and stall the
# stream waiting for bytes that never come; anything above this bound
# is treated as desync and the scanner resyncs on the next magic.
MAX_PAYLOAD_BYTES = 1 << 26

DEFAULT_CHUNK_BYTES = 64 * 1024
DEFAULT_MAX_INFLIGHT_BYTES = 256 * 1024
DEFAULT_RETRIES = 5
DEFAULT_BACKOFF_S = 0.05
DEFAULT_MAX_BACKOFF_S = 1.0

_transfer_ids = itertools.count(1)


def next_transfer_id() -> int:
    """Process-local transfer id; unique per (channel, rid) stream."""
    return next(_transfer_ids)


def ensure_transfer_ids_above(tid: int) -> None:
    """Advance the id counter past ``tid``. Journal replay: ids issued
    by a previous router process must not be reissued, or a resumed
    transfer would collide with a fresh one in the chunk journal."""
    global _transfer_ids
    _transfer_ids = itertools.count(int(tid) + 1)


class TransportError(RuntimeError):
    """A transfer failed permanently: a chunk exhausted its retry
    budget, or the underlying channel closed mid-transfer."""


def split_payload(data: bytes, chunk_bytes: int) -> List[bytes]:
    """Fixed-size chunks; a final short chunk carries the remainder."""
    assert chunk_bytes > 0
    if not data:
        return [b""]
    return [data[i : i + chunk_bytes] for i in range(0, len(data), chunk_bytes)]


def encode_chunk(
    kind: int, rid: int, transfer_id: int, seq: int, total: int,
    payload: bytes = b"",
) -> bytes:
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return (
        _HEADER.pack(CHUNK_MAGIC, kind, rid, transfer_id, seq, total,
                     len(payload))
        + payload
        + _CRC.pack(crc)
    )


def decode_frames(buf: bytes):
    """Parse as many complete frames as ``buf`` holds.

    Returns ``(msgs, consumed)`` — the caller keeps ``buf[consumed:]``
    for the next read. A frame whose payload fails its CRC is still
    returned (with ``corrupt=True``) so the receiver can count the drop;
    a frame with a nonsense payload length is treated as desync and the
    scanner advances to the next magic.
    """
    msgs = []
    off = 0
    n = len(buf)
    while True:
        if n - off < _HEADER.size:
            break
        if buf[off : off + 4] != CHUNK_MAGIC:
            idx = buf.find(CHUNK_MAGIC, off + 1)
            if idx < 0:
                off = max(off, n - 3)  # keep a tail that could start a magic
                break
            off = idx
            continue
        _, kind, rid, tid, seq, total, plen = _HEADER.unpack_from(buf, off)
        if plen > MAX_PAYLOAD_BYTES:
            off += 1
            continue
        end = off + _HEADER.size + plen + _CRC.size
        if n < end:
            break
        payload = bytes(buf[off + _HEADER.size : end - _CRC.size])
        (crc,) = _CRC.unpack_from(buf, end - _CRC.size)
        msgs.append({
            "kind": kind,
            "rid": rid,
            "transfer_id": tid,
            "seq": seq,
            "total": total,
            "payload": payload,
            "corrupt": (zlib.crc32(payload) & 0xFFFFFFFF) != crc,
        })
        off = end
    return msgs, off


class DataChannel:
    """Non-blocking framed byte channel over a connected socket.

    ``send`` queues a frame and flushes what the socket accepts;
    ``pump`` flushes the rest and returns every complete frame that has
    arrived. Neither blocks — the router calls ``pump`` from its poll
    loop between heartbeats, the replica from its serve loop between
    decode steps. Hosts the ``transport_stall`` fault site: while
    stalled the channel neither reads nor writes (frames queue), which
    models a network stall without blocking either process.
    """

    def __init__(self, sock: socket.socket, label: str = "",
                 clock: Callable[[], float] = time.monotonic):
        sock.setblocking(False)
        self.sock = sock
        self.label = label
        self.clock = clock
        self.closed = False
        self.bytes_sent = 0
        self.bytes_received = 0
        self.stalls = 0
        self._outbuf = bytearray()
        self._inbuf = bytearray()
        self._stalled_until = 0.0

    @classmethod
    def from_fd(cls, fd: int, label: str = "") -> "DataChannel":
        return cls(socket.socket(fileno=fd), label=label)

    @property
    def outbuf_bytes(self) -> int:
        return len(self._outbuf)

    def fileno(self) -> int:
        return self.sock.fileno()

    def send(self, frame: bytes) -> None:
        self._outbuf += frame
        if not self._stalled():
            self._flush()

    def _stalled(self) -> bool:
        now = self.clock()
        if now < self._stalled_until:
            return True
        p = fire_fault("transport_stall", transport=self.label)
        if p is not None:
            self._stalled_until = now + float(p.get("seconds", 5.0))
            self.stalls += 1
            return True
        return False

    def _flush(self) -> None:
        while self._outbuf and not self.closed:
            try:
                sent = self.sock.send(self._outbuf)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self.closed = True
                return
            if sent <= 0:
                return
            self.bytes_sent += sent
            del self._outbuf[:sent]

    def pump(self) -> List[dict]:
        """Flush pending sends, read what has arrived, return frames."""
        if self._stalled():
            return []
        self._flush()
        while not self.closed:
            try:
                data = self.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self.closed = True
                break
            if not data:
                self.closed = True
                break
            self.bytes_received += len(data)
            self._inbuf += data
        msgs, consumed = decode_frames(bytes(self._inbuf))
        if consumed:
            del self._inbuf[:consumed]
        return msgs

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                self.sock.close()
            except OSError:
                pass


class ChunkSender:
    """Send one frame as acked chunks; retransmit on timer, never block.

    ``pump(now)`` sends whatever is due — first-attempt chunks in order
    (subject to the in-flight-bytes cap) and retransmits whose backoff
    timer expired — and returns immediately. ``on_ack`` retires a
    chunk. A chunk that exhausts ``retries`` resends raises
    ``TransportError`` from the next ``pump``.

    ``acked`` seeds the resume path: a sender rebuilt after a relaunch
    passes the seq set replayed from the chunk journal and only the
    remaining chunks ever touch the wire.
    """

    def __init__(
        self,
        channel: DataChannel,
        rid: int,
        transfer_id: int,
        payload: bytes,
        *,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        max_inflight_bytes: int = DEFAULT_MAX_INFLIGHT_BYTES,
        retries: int = DEFAULT_RETRIES,
        backoff_s: float = DEFAULT_BACKOFF_S,
        max_backoff_s: float = DEFAULT_MAX_BACKOFF_S,
        label: str = "",
        acked: Iterable[int] = (),
        clock: Callable[[], float] = time.monotonic,
    ):
        self.channel = channel
        self.rid = rid
        self.transfer_id = transfer_id
        self.chunks = split_payload(payload, chunk_bytes)
        self.total = len(self.chunks)
        self.nbytes = len(payload)
        self.max_inflight_bytes = max_inflight_bytes
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.label = label
        self.clock = clock
        self.acked = {s for s in acked if 0 <= s < self.total}
        # resumed-from-journal transfers never re-send what was acked
        self.resumed_from = len(self.acked)
        self.chunks_sent = 0
        self.chunks_resent = 0
        self.chunks_corrupted = 0
        self.chunks_dropped = 0
        self.interrupted = False  # any resend happened (stall/loss/...)
        self._attempts = [0] * self.total
        self._deadline = [0.0] * self.total
        self._inflight_bytes = 0
        self._fault_hits: Dict[str, int] = {}

    @property
    def done(self) -> bool:
        return len(self.acked) == self.total

    @property
    def resumed(self) -> bool:
        """True if this transfer continued past an interruption — it
        was rebuilt over journaled acks or it had to retransmit —
        rather than streaming clean end to end."""
        return self.resumed_from > 0 or self.interrupted

    def _fault_acts(self, site: str, seq: int) -> bool:
        p = fire_fault(site, transport=self.label, step=seq)
        if p is None:
            return False
        hits = self._fault_hits.get(site, 0) + 1
        self._fault_hits[site] = hits
        every = int(float(p.get("every", 1)))
        return every <= 1 or hits % every == 0

    def on_ack(self, msg: dict) -> bool:
        """Retire a chunk. Returns True if the ack was new."""
        if msg.get("transfer_id") != self.transfer_id:
            return False
        seq = msg["seq"]
        if seq in self.acked or not (0 <= seq < self.total):
            return False
        self.acked.add(seq)
        if self._attempts[seq] > 0:
            self._inflight_bytes -= len(self.chunks[seq])
        return True

    def pump(self, now: Optional[float] = None) -> int:
        """Send every due chunk; return how many frames were emitted
        (dropped-by-fault sends count — they consumed an attempt)."""
        if self.done:
            return 0
        if self.channel.closed:
            raise TransportError(
                f"transfer {self.transfer_id} rid={self.rid}: "
                "channel closed mid-transfer"
            )
        now = self.clock() if now is None else now
        sent = 0
        for seq in range(self.total):
            if seq in self.acked:
                continue
            attempt = self._attempts[seq]
            if attempt == 0:
                # first attempt: in-order, backpressured by unacked bytes
                if (self._inflight_bytes + len(self.chunks[seq])
                        > self.max_inflight_bytes and self._inflight_bytes):
                    break
            elif now < self._deadline[seq]:
                continue
            elif attempt > self.retries:
                raise TransportError(
                    f"transfer {self.transfer_id} rid={self.rid}: chunk "
                    f"{seq}/{self.total} unacked after {self.retries} "
                    "retries"
                )
            frame = encode_chunk(KIND_DATA, self.rid, self.transfer_id,
                                 seq, self.total, self.chunks[seq])
            if self._fault_acts("handoff_chunk_corrupt", seq):
                # flip a payload byte after the CRC was computed: the
                # receiver detects the mismatch and withholds the ack
                mut = bytearray(frame)
                mut[_HEADER.size + seq % max(1, len(self.chunks[seq]))] ^= 0xFF
                frame = bytes(mut)
                self.chunks_corrupted += 1
            if self._fault_acts("handoff_chunk_drop", seq):
                self.chunks_dropped += 1  # consumed an attempt, no wire
            else:
                self.channel.send(frame)
            if attempt == 0:
                self._inflight_bytes += len(self.chunks[seq])
            else:
                self.chunks_resent += 1
                self.interrupted = True
            self._attempts[seq] = attempt + 1
            self._deadline[seq] = now + backoff_delay(
                attempt, self.backoff_s, self.max_backoff_s
            )
            self.chunks_sent += 1
            sent += 1
        return sent


class ChunkReceiver:
    """Reassemble a chunked transfer, acking each chunk on arrival.

    Corrupt chunks are dropped unacked (the sender's timer resends
    them); duplicates are re-acked (the first ack may have raced a
    retransmit) but stored once. ``assemble()`` is only valid once
    ``complete``.
    """

    def __init__(self, rid: int, transfer_id: int, total: int,
                 label: str = ""):
        self.rid = rid
        self.transfer_id = transfer_id
        self.total = total
        self.label = label
        self.chunks: Dict[int, bytes] = {}
        self.corrupt_dropped = 0
        self.duplicates = 0

    @property
    def complete(self) -> bool:
        return len(self.chunks) == self.total

    def on_chunk(self, msg: dict, channel: DataChannel) -> bool:
        """Ingest a DATA frame; returns True if it was new payload."""
        if msg.get("transfer_id") != self.transfer_id:
            return False
        if msg["corrupt"]:
            self.corrupt_dropped += 1
            return False
        seq = msg["seq"]
        fresh = seq not in self.chunks
        if fresh:
            self.chunks[seq] = msg["payload"]
        else:
            self.duplicates += 1
        channel.send(encode_chunk(KIND_ACK, self.rid, self.transfer_id,
                                  seq, self.total))
        return fresh

    def assemble(self) -> bytes:
        assert self.complete, (
            f"transfer {self.transfer_id}: {len(self.chunks)}/{self.total} "
            "chunks"
        )
        return b"".join(self.chunks[i] for i in range(self.total))
