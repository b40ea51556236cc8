"""One rank of a gloo world that runs every multi-slice case of
tests/test_torch_multislice.py in one process: the trainers' entry with
``num_slices``, one case after another, on the process group the first
one opens.

Run as a script, one process per rank, with torchrun's environment set
by the test (tests/torch_mp_child.py's launch). It imports the port and
torch only, never JAX. Usage:

    python tests/torch_slice_child.py SPEC_JSON

SPEC_JSON holds ``out`` (this rank writes ``<out>/rank<R>.json``, one
result per case name) and ``cases``: the cases of
tests/torch_context_child.py (``kind`` train, ``main``, ``batches``,
``record_rows``), each result with the step's bucket plan
(``plan_summary()``), the cross-slice bucket reduces it started
(``DCN_REDUCES``), whether its layout made a dcn group and a
within-slice group, and the final state's hash; optionally

- ``drop_dcn`` (the control): ``DataParallel.dcn_reduce`` does nothing,
  so each slice keeps its own gradients;
- ``count_collectives``: every collective each step ran, by name and
  group size, in order.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_context_child import run_case  # noqa: E402
from torch_mp_child import state_hash  # noqa: E402

from fms_fsdp_tpu_torch import main_training_llama as entry  # noqa: E402
from fms_fsdp_tpu_torch.parallel import overlap  # noqa: E402
from fms_fsdp_tpu_torch.parallel.sharding import DataParallel  # noqa: E402
from fms_fsdp_tpu_torch.resilience.exits import classified_exit  # noqa: E402

_COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
                "all_gather", "broadcast", "barrier")


def _counting(steps, live):
    """dist's collectives wrapped to append [name, group size] to
    ``steps[-1]`` while ``live[0]``; returns the originals."""
    saved = {name: getattr(dist, name) for name in _COLLECTIVES}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            if live[0]:
                steps[-1].append([name, dist.get_world_size(kwargs.get("group"))])
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    return saved


def slice_case(case):
    saved_main, saved_make = entry.main, entry.make_train_step
    saved_reduce = DataParallel.dcn_reduce
    saved_dist = None
    captured, steps, live = {}, [], [False]
    try:
        def main(*args, **kwargs):
            captured["res"] = saved_main(*args, **kwargs)
            return captured["res"]

        entry.main = main
        if case.get("drop_dcn"):
            DataParallel.dcn_reduce = lambda self, flat, async_op=False: None
        if case.get("count_collectives"):
            saved_dist = _counting(steps, live)

            def make_counting(*args, **kwargs):
                step = saved_make(*args, **kwargs)

                def counted(state, batch):
                    steps.append([])
                    live[0] = True
                    try:
                        return step(state, batch)
                    finally:
                        live[0] = False
                return counted

            entry.make_train_step = make_counting
        overlap.reset_dcn_reduces()
        out = run_case(case)
        if case.get("count_collectives"):
            out["collectives"] = steps
        res = captured["res"]
        dp = res["state"]["dp"]
        out.update(
            plan=overlap.plan_summary(),
            dcn_reduces=overlap.DCN_REDUCES["bucket"],
            dcn_group=dp is not None and dp.dcn_group is not None,
            slice_group=dp is not None and dp.slice_group is not None,
            final_hash=state_hash(res["state"]),
        )
        return out
    finally:
        entry.main, entry.make_train_step = saved_main, saved_make
        DataParallel.dcn_reduce = saved_reduce
        if saved_dist is not None:
            for name, fn in saved_dist.items():
                setattr(dist, name, fn)


def main():
    spec = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    results = {"rank": rank, "world": int(os.environ["WORLD_SIZE"])}
    with classified_exit():
        for case in spec["cases"]:
            results[case["name"]] = slice_case(case)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
