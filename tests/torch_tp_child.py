"""One rank of a gloo world that runs every tensor-parallel case of
tests/test_torch_tp_worlds.py in one process: the entry points with a
tensor axis, one after another, on the process group the first one
opens.

Run as a script, one process per rank, with torchrun's environment set
by the test (tests/torch_mp_child.py's launch). It imports the port and
torch only, never JAX. Usage:

    python tests/torch_tp_child.py SPEC_JSON

SPEC_JSON holds ``out`` (this rank writes ``<out>/rank<R>.json``, one
result per case name) and ``cases``: the cases of
tests/torch_context_child.py (``kind`` train or speculator, ``main``,
``batches``, ``record_rows``), and optionally

- ``world_sums`` (a control): the label count, the loss and the
  gradients of the leaves not split over fsdp summed over the whole
  world instead of the data group, so tensor peers' shared rows count
  tp times;
- ``drop_reduce`` (a control): the forward's row-parallel reduces over
  tensor dropped (the vocabulary-row embedding lookup's, wo's and
  w2's), so each rank keeps its partial sums.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_context_child import run_case  # noqa: E402

from fms_fsdp_tpu_torch.parallel import tensor  # noqa: E402
from fms_fsdp_tpu_torch.resilience.exits import classified_exit  # noqa: E402


def _world_groups(mesh):
    tp, _ = _SAVED["tensor_groups"](mesh)
    return tp, None  # the "data group" is the world


_SAVED = {"tensor_groups": tensor.tensor_groups}


def tp_case(case):
    saved = (tensor.tensor_groups, tensor.TensorParallel.reduce)
    try:
        if case.get("world_sums"):
            tensor.tensor_groups = _world_groups
        if case.get("drop_reduce"):
            tensor.TensorParallel.reduce = lambda self, x: x
        return run_case(case)
    finally:
        tensor.tensor_groups, tensor.TensorParallel.reduce = saved


def main():
    spec = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    results = {"rank": rank, "world": int(os.environ["WORLD_SIZE"])}
    with classified_exit():
        for case in spec["cases"]:
            results[case["name"]] = tp_case(case)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
