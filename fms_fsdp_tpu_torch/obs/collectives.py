"""Report-cadence collective probe: the within-slice and cross-slice split.

Counterpart of ``fms_fsdp_tpu/obs/collectives.py``. On more than one
slice (the mesh's dcn axis) a step's collective time has two transports
in it: the sums inside a slice and the one sum across slices. The step
cannot split them from the host, so the Observer runs this probe once a
report window:

- one all-reduce over the slice's data group (``parallel/mesh.py::
  slice_data_groups``; none when this rank is alone in its slice), timed
  into the timer's ``ici_collective`` phase;
- all-reduces over the dcn group, timed into ``dcn_collective``: one a
  bucket of the step's DCN-overlap plan (``parallel/overlap.py::
  plan_summary``), fp32 and sized to the bucket's wire bytes (one buffer
  a distinct size), or one small ping without a plan.

Each phase ends with a device sync, so a card's time is inside it.
Every buffer is reduced once before the first window (a warm-up outside
the timed phases), and refilled outside them before each probe. The
probe is a latency signal at the report cadence, not a bytes model.

One slice gets no probe (``make_collective_split_probe`` returns None),
and ``ici_collective_s`` / ``dcn_collective_s`` stay 0.0. The probe is a
collective: every rank runs ``Observer.report`` at the same steps, so it
stays rank-consistent.
"""

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from fms_fsdp_tpu_torch.parallel.mesh import num_mesh_slices, slice_data_groups

# the ping's and the in-slice probe's fp32 elements
_LANES = 128


def make_collective_split_probe(mesh, timer, schedule: Optional[Dict] = None
                                ) -> Optional[Callable[[], None]]:
    """The probe of ``mesh`` (the run's ``DeviceMesh``), recording into
    ``timer``'s ``ici_collective`` / ``dcn_collective`` phases; None on
    one slice. ``schedule`` is the step's bucket plan summary
    (``plan_summary()``): with one, the cross-slice probe reduces one
    buffer a bucket at the bucket's wire bytes; without, a ping."""
    if mesh is None or num_mesh_slices(mesh) <= 1:
        return None
    inner, across = slice_data_groups(mesh)
    device = torch.device(mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    def buffer(n):
        return torch.ones((max(1, int(n)),), dtype=torch.float32, device=device)

    bucket_bytes = list((schedule or {}).get("bytes_per_bucket", []) or [])
    if bucket_bytes:
        by_size = {int(b): buffer(int(b) // 4) for b in sorted(set(bucket_bytes))}
        dcn_bufs = [by_size[int(b)] for b in bucket_bytes]
    else:
        dcn_bufs = [buffer(_LANES)]
    ici_buf = buffer(_LANES) if inner is not None else None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def refill():
        for x in dcn_bufs + ([ici_buf] if ici_buf is not None else []):
            x.fill_(1.0)
        sync()

    # warm every reduce outside the timed phases: the first window times
    # the reduces, not their first-call set-up
    for x in dcn_bufs:
        dist.all_reduce(x, group=across)
    if ici_buf is not None:
        dist.all_reduce(ici_buf, group=inner)

    def probe() -> None:
        refill()
        if ici_buf is not None:
            with timer.phase("ici_collective"):
                dist.all_reduce(ici_buf, group=inner)
                sync()
        with timer.phase("dcn_collective"):
            for x in dcn_bufs:
                dist.all_reduce(x, group=across)
            sync()

    return probe
