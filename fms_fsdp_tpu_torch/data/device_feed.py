"""Host batches onto the card, pulled by a background thread.

Counterpart of ``fms_fsdp_tpu/data/device_feed.py::DeviceFeed`` on one
card (no mesh to shard over). A worker thread pulls numpy batches from
the loader (the stateful pipeline runs in that thread when the loader has
no workers of its own), stages each one and puts it on a queue of depth
``prefetch``; the consumer gets batches that are already on their device.
``prefetch=0`` stages synchronously in the consumer's thread: the
pipeline then advances exactly with consumption, so a checkpoint's loader
state is the consumed position.

Staging makes each array an int64 tensor; for a CUDA device it goes
through pinned host memory and ``non_blocking=True``. The copy is issued
on the thread's current stream, which is the default stream, so every
kernel the consumer enqueues after it receives the batch is ordered after
the copy. ``pin_memory()`` takes its buffer from PyTorch's caching host
allocator, which records the copy and does not hand the buffer out again
before the copy has completed.

A clean end of the loader reaches the consumer as the end of iteration,
and an error in the pipeline is raised again in the consumer. Closing the
iterator stops the thread. ``wait_s`` sums the time the consumer spent
waiting for a batch, and ``served`` counts the batches it got.
"""

import queue
import threading
import time

import numpy as np
import torch

_END = object()


class DeviceFeed:
    def __init__(self, loader, device, prefetch: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.prefetch = prefetch
        self.wait_s = 0.0
        self.served = 0

    def _stage(self, batch):
        out = []
        for a in batch:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.int64)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return tuple(out)

    def _serve(self, item, t0):
        self.wait_s += time.monotonic() - t0
        self.served += 1
        return item

    def __iter__(self):
        if self.prefetch <= 0:
            it = iter(self.loader)
            while True:
                t0 = time.monotonic()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                yield self._serve(self._stage(batch), t0)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded, stop-aware: the consumer may already be gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                it = iter(self.loader)
                while not stop.is_set():
                    try:
                        batch = next(it)
                    except StopIteration:
                        put(_END)
                        return
                    if not put(self._stage(batch)):
                        return
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True, name="device-feed")
        t.start()
        try:
            while True:
                t0 = time.monotonic()
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield self._serve(item, t0)
        finally:
            stop.set()
