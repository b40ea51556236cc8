"""Host batches onto the card, one step ahead.

Stands in for ``fms_fsdp_tpu/data/device_feed.py::DeviceFeed`` on one
card (no mesh to shard over): each numpy batch becomes int64 tensors in
pinned host memory and is copied to the card with ``non_blocking=True``
before the previous batch is handed out, so the copy is queued ahead of
the step that consumes it and the host never waits on it. On the CPU the
batch is wrapped as it is.
"""

import numpy as np
import torch


class DeviceFeed:
    def __init__(self, batches, device):
        self.batches = batches
        self.device = torch.device(device)

    def _stage(self, batch):
        out = []
        for a in batch:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.int64)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return tuple(out)

    def __iter__(self):
        it = iter(self.batches)
        try:
            ahead = self._stage(next(it))
        except StopIteration:
            return
        while True:
            current = ahead
            try:
                ahead = self._stage(next(it))
            except StopIteration:
                ahead = None
            yield current
            if ahead is None:
                return
