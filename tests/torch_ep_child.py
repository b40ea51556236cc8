"""One rank of a gloo world that runs every expert-parallel case of
tests/test_torch_expert_parallel.py in one process: the MoE dispatch's
all-to-all alone, then the entry points with an expert axis, one after
another, on the process group the first one opens.

Run as a script, one process per rank, with torchrun's environment set
by the test (tests/torch_mp_child.py's launch). It imports the port and
torch only, never JAX. Usage:

    python tests/torch_ep_child.py SPEC_JSON

SPEC_JSON holds ``out`` (this rank writes ``<out>/rank<R>.json``, one
result per case name) and ``cases``:

- ``kind`` ``a2a``: ``models/mixtral.py::_moe_ffn_dispatch_a2a`` over an
  expert group of the whole world (``ep`` ranks) on this rank's rows of
  the ``.npz`` ``inputs`` (h, and the layer's gate, w1, w3, w2, whole)
  and its experts, ``sum(y ** 2)`` plus the balance term of the route
  sums summed over the world (``DataParallel.sum_route``) as the
  objective; writes ``<out>/<name>_rank<R>.npz`` with y, the stats and
  the gradients of h, the gate and the rank's experts;
- the cases of tests/torch_context_child.py (``kind`` train or eval,
  ``main``, ``batches``, ``record_rows``), each train result with the
  exchanges the run made (``EXPERT_A2A``), the local shape of ``w1``,
  the DCP placements of ``w1`` and ``wq`` (``DataParallel.dcp_view``),
  whether the fallback warned, and the final state's hash; optionally
- ``drop_expert_sum`` (a control): every gradient summed as a leaf split
  over expert is, so the leaves not split over it miss the sum over the
  expert axis;
- ``break_exchange`` (a control): the all-to-all keeps each rank's own
  chunks in place of its peer's.
"""

import json
import os
import sys
import types
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_context_child import run_case  # noqa: E402
from torch_mp_child import state_hash  # noqa: E402

from fms_fsdp_tpu_torch import main_training_llama as entry  # noqa: E402
from fms_fsdp_tpu_torch.models import mixtral  # noqa: E402
from fms_fsdp_tpu_torch.models.configs import MixtralConfig  # noqa: E402
from fms_fsdp_tpu_torch.parallel import expert  # noqa: E402
from fms_fsdp_tpu_torch.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from fms_fsdp_tpu_torch.parallel.sharding import DataParallel  # noqa: E402
from fms_fsdp_tpu_torch.resilience.exits import classified_exit  # noqa: E402
from fms_fsdp_tpu_torch.utils.dist import init_distributed  # noqa: E402

FALLBACK = "not divisible by the expert axis"


def a2a_case(case, out_dir, rank):
    init_distributed(torch.device("cpu"))
    mesh = build_mesh(MeshConfig(sharding_strategy="fsdp", expert_parallel_size=case["ep"]),
                      device_type="cpu")
    ep = expert.ExpertParallel(mesh.get_group("expert"), case["ep"],
                               mesh.get_local_rank("expert"))
    cfg = MixtralConfig(**case["model"])
    data = np.load(case["inputs"])
    rows = data["h"].shape[0] // ep.size
    experts = cfg.num_experts // ep.size
    h = torch.from_numpy(data["h"][ep.rank * rows:(ep.rank + 1) * rows]).requires_grad_(True)
    lp = {"gate": torch.from_numpy(data["gate"]).requires_grad_(True)}
    for k in ("w1", "w3", "w2"):
        lp[k] = torch.from_numpy(
            data[k][ep.rank * experts:(ep.rank + 1) * experts]).requires_grad_(True)
    expert.reset_exchanges()
    y, route = mixtral._moe_ffn_dispatch_a2a(h, lp, cfg, ep)
    world = types.SimpleNamespace(data_group=None)
    stats = mixtral.moe_stats(DataParallel.sum_route(world, route), cfg)
    grads = torch.autograd.grad((y ** 2).sum() + stats["balance"],
                                [h, lp["gate"], lp["w1"], lp["w3"], lp["w2"]])
    np.savez(os.path.join(out_dir, f"{case['name']}_rank{rank}.npz"),
             y=y.detach().numpy(), balance=stats["balance"].detach().numpy(),
             drop_frac=stats["drop_frac"].numpy(),
             **{f"g_{k}": g.numpy() for k, g in zip(("h", "gate", "w1", "w3", "w2"), grads)})
    return {"exchanges": expert.EXPERT_A2A["all_to_all"]}


def _placements(dp, params, key):
    """The DCP placements of the params leaf ``key`` (None when whole)."""
    from fms_fsdp_tpu_torch.ckpt.state import flatten

    flat = {key: flatten("params", params, {})[key]}
    view = dp.dcp_view(flat)[key]
    return [str(p) for p in view.placements] if hasattr(view, "placements") else None


def ep_case(case):
    saved_main = entry.main
    saved = (DataParallel.reduce_grads, expert.ExpertParallel.exchange)
    captured = {}
    try:
        def main(*args, **kwargs):
            captured["res"] = saved_main(*args, **kwargs)
            return captured["res"]

        entry.main = main
        if case.get("drop_expert_sum"):
            # every leaf summed as one split over expert is
            DataParallel.reduce_grads = (
                lambda self, grads, split, esplit=None: saved[0](
                    self, grads, split, [True] * len(grads)))
        if case.get("break_exchange"):
            expert.ExpertParallel.exchange = lambda self, t: t.contiguous().clone()
        expert.reset_exchanges()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = run_case(case)
        out["fallback_warned"] = any(FALLBACK in str(w.message) for w in caught)
        if case["kind"] != "train":
            return out
        res = captured["res"]
        state, dp = res["state"], res["state"]["dp"]
        out.update(
            exchanges=expert.EXPERT_A2A["all_to_all"],
            w1_shape=list(state["params"]["layers"]["w1"].shape),
            placements={k: _placements(dp, state["params"], k) if dp is not None else None
                        for k in ("params.layers.w1", "params.layers.wq")},
            final_hash=state_hash(state),
        )
        return out
    finally:
        entry.main = saved_main
        DataParallel.reduce_grads, expert.ExpertParallel.exchange = saved


def main():
    spec = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    results = {"rank": rank, "world": int(os.environ["WORLD_SIZE"])}
    with classified_exit():
        for case in spec["cases"]:
            results[case["name"]] = (a2a_case(case, spec["out"], rank)
                                     if case["kind"] == "a2a" else ep_case(case))
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
