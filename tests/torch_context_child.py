"""One rank of a gloo world that runs every long-context case of
tests/test_torch_context_worlds.py in one process: the entry points with
a context axis, one after another, on the process group the first one
opens.

Run as a script, one process per rank, with torchrun's environment set
by the test (tests/torch_mp_child.py's launch). It imports the port and
torch only, never JAX. Usage:

    python tests/torch_context_child.py SPEC_JSON

SPEC_JSON holds ``out`` (this rank writes ``<out>/rank<R>.json``, one
result per case name) and ``cases``, a list of dicts with ``name``,
``kind`` (``train``: ``main_training_llama.main``, which serves every
family by ``model_variant``; ``eval``: ``eval_ppl.main``; ``speculator``:
the speculator entry), the ``main`` keyword arguments, and optionally
``batches`` (a .npz of global ``inputs``/``labels`` batches that replace
the dummy stream: each data index takes its contiguous rows of each),
``chunk_local`` (Mixtral's routing chunk by chunk, each chunk with its
own counts and the capacity of its own length: the control) and
``record_rows`` (every row the feed served, and the train state's hash
at the first step and at the end).
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_mp_child import state_hash  # noqa: E402

from fms_fsdp_tpu_torch import eval_ppl as eval_entry  # noqa: E402
from fms_fsdp_tpu_torch import main_training_llama as entry  # noqa: E402
from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed  # noqa: E402
from fms_fsdp_tpu_torch.models import mixtral  # noqa: E402
from fms_fsdp_tpu_torch.resilience.exits import classified_exit  # noqa: E402
from fms_fsdp_tpu_torch.speculator import train_speculator as spec_entry  # noqa: E402
from fms_fsdp_tpu_torch.train import step as step_mod  # noqa: E402

_LOADERS = (entry, eval_entry, spec_entry)


def _rows_loader(path):
    data = np.load(path)
    inputs, labels = data["inputs"], data["labels"]

    class RankRows:
        def __init__(self, r, w):
            self.r, self.per = r, inputs.shape[1] // w

        def __iter__(self):
            lo, hi = self.r * self.per, (self.r + 1) * self.per
            for x, y in zip(inputs, labels):
                yield (x[lo:hi], y[lo:hi])

    return lambda cfg, r, w: RankRows(r, w)


def _chunk_local(top_idx, ring, E, C):
    """The control's routing: each chunk's own priority slots at the
    capacity of its own length, ceil(C / cp) (``moe_capacity`` of S / cp:
    a ceiling of a ceiling over an integer is the ceiling)."""
    return [mixtral._priority_slots(t, E, -(-C // ring.cp)) for t in top_idx]


def run_case(case):
    saved = {m: m.get_dummy_loader for m in _LOADERS}
    saved_slots, saved_stats = mixtral.context_slots, step_mod.moe_stats
    saved_stage, saved_make = DeviceFeed._stage, entry.make_train_step
    out = {}
    try:
        if case.get("batches"):
            for m in _LOADERS:
                m.get_dummy_loader = _rows_loader(case["batches"])
        if case.get("chunk_local"):
            mixtral.context_slots = _chunk_local
        balances = []

        def recorded(route, cfg):
            stats = saved_stats(route, cfg)
            balances.append(float(stats["balance"]))
            return stats

        step_mod.moe_stats = recorded
        if case["kind"] == "eval":
            return {"eval": eval_entry.main(device="cpu", **case["main"])}
        if case["kind"] == "speculator":
            res = spec_entry.main(device="cpu", **case["main"])
            return {"per_head": [r["per_head"] for r in res["reports"]],
                    "gnorms": [r["gnorm"] for r in res["reports"]],
                    "chips": [r["chips"] for r in res["reports"]],
                    "tokens_seen": [r["tokens_seen"] for r in res["reports"]]}
        rows, hashes = [], []
        if case.get("record_rows"):
            def record(feed, batch):
                rows.append(np.asarray(batch[0]).tolist())
                return saved_stage(feed, batch)

            DeviceFeed._stage = record

            def make_hashing(*a, **k):
                step = saved_make(*a, **k)

                def first_hashed(state, batch):
                    if not hashes:
                        hashes.append(state_hash(state))
                    return step(state, batch)

                return first_hashed

            entry.make_train_step = make_hashing
        res = entry.main(device="cpu", **case["main"])
        reports = res["reports"]
        out.update(
            losses=[r["loss"] for r in reports], gnorms=[r["gnorm"] for r in reports],
            drop_frac=[r.get("moe_drop_frac") for r in reports],
            steps=[r["step"] for r in reports],
            tokens_seen=[r["tokens_seen"] for r in reports],
            balance=balances, start_step=res["start_step"],
            batch_size=res["cfg"].batch_size, rows=rows,
            first_step_hash=hashes[0] if hashes else None,
        )
        if case.get("record_rows"):
            out["final_hash"] = state_hash(res["state"])
        return out
    finally:
        for m, fn in saved.items():
            m.get_dummy_loader = fn
        mixtral.context_slots, step_mod.moe_stats = saved_slots, saved_stats
        DeviceFeed._stage, entry.make_train_step = saved_stage, saved_make


def main():
    spec = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    results = {"rank": rank, "world": int(os.environ["WORLD_SIZE"])}
    with classified_exit():
        for case in spec["cases"]:
            results[case["name"]] = run_case(case)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
