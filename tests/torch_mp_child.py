"""One rank of a multi-process run of the port's trainer, for
tests/test_torch_multiprocess.py.

Run as a script by the test, one process per rank, with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) set
by the test. It imports the port and torch only, never JAX (pytest's
conftest imports JAX into its own process; a child is a fresh
interpreter). Usage:

    python tests/torch_mp_child.py SPEC_JSON

SPEC_JSON holds ``out`` (this rank writes ``<out>/rank<R>.json``), the
``main`` keyword arguments, and optionally ``batches`` (a .npz of global
``inputs``/``labels`` batches that replace the dummy stream: each rank
takes its contiguous rows of each), ``record_rows`` (keep every row the
feed served and hash the train state at the first step) and
``speculator`` (run the speculator entry instead of the Llama trainer,
with ``fp32_base`` its frozen base in fp32) or ``eval`` (run
``eval_ppl.main`` and write its result).
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fms_fsdp_tpu_torch import eval_ppl as eval_entry  # noqa: E402
from fms_fsdp_tpu_torch import main_training_llama as entry  # noqa: E402
from fms_fsdp_tpu_torch.ckpt.state import checkpoint_state  # noqa: E402
from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed  # noqa: E402
from fms_fsdp_tpu_torch.parallel import sharding  # noqa: E402
from fms_fsdp_tpu_torch.resilience.exits import classified_exit  # noqa: E402
from fms_fsdp_tpu_torch.speculator import train_speculator as spec_entry  # noqa: E402


def state_hash(state) -> str:
    """sha256 over the whole train state, its split leaves gathered, in
    key order (a collective under a sharded state)."""
    flat = checkpoint_state(state)
    dp = state.get("dp")
    if dp is not None and dp.sharded:
        flat = dp.unshard(flat)
    h = hashlib.sha256()
    for key in sorted(flat):
        t = flat[key].detach().cpu().contiguous()
        h.update(key.encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def local_bytes(tree) -> int:
    from fms_fsdp_tpu_torch.ckpt.state import flatten

    return sum(t.numel() * t.element_size() for t in flatten("p", tree, {}).values())


def main():
    spec = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    out = {"rank": rank, "world": world}

    if spec.get("batches"):
        data = np.load(spec["batches"])
        inputs, labels = data["inputs"], data["labels"]
        per = inputs.shape[1] // world

        class RankRows:
            def __iter__(self):
                for x, y in zip(inputs, labels):
                    yield (x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per])

        entry.get_dummy_loader = lambda cfg, r, w: RankRows()
        spec_entry.get_dummy_loader = entry.get_dummy_loader
        eval_entry.get_dummy_loader = entry.get_dummy_loader

    if spec.get("eval"):
        out["eval"] = eval_entry.main(device="cpu", **spec["main"])
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        return

    if spec.get("speculator"):
        if spec.get("fp32_base"):
            # the frozen base (bf16 in the entry) in fp32, so the speculator
            # runs in fp32 too
            load = spec_entry.load_base
            spec_entry.load_base = lambda *a, **k: {
                n: (w.float() if torch.is_tensor(w) else {m: t.float() for m, t in w.items()})
                for n, w in load(*a, **k).items()}
            base_api = spec_entry.get_base_api

            def fp32_api(arch):
                api = base_api(arch)
                hidden = api.forward_hidden
                api.forward_hidden = lambda *a, **k: hidden(*a, compute_dtype=torch.float32,
                                                            **k)
                return api

            spec_entry.get_base_api = fp32_api
        with classified_exit():
            res = spec_entry.main(device="cpu", **spec["main"])
        reports = res["reports"]
        flat = checkpoint_state(res["state"])
        out.update(
            per_head=[r["per_head"] for r in reports], gnorms=[r["gnorm"] for r in reports],
            steps=[r["step"] for r in reports], tokens_seen=[r["tokens_seen"] for r in reports],
            param_sums={k: float(t.double().sum()) for k, t in flat.items()
                        if k.startswith("params.")},
        )
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        return

    rows = []
    hashes = []
    if spec.get("record_rows"):
        stage = DeviceFeed._stage

        def record(feed, batch):
            rows.append(np.asarray(batch[0]).tolist())
            return stage(feed, batch)

        DeviceFeed._stage = record
        make = entry.make_train_step

        def make_hashing(*a, **k):
            step = make(*a, **k)

            def first_hashed(state, batch):
                if not hashes:
                    hashes.append(state_hash(state))
                return step(state, batch)

            return first_hashed

        entry.make_train_step = make_hashing

    gathers = []
    if spec.get("count_gathers"):
        make = entry.make_train_step

        def make_counting(*a, **k):
            step = make(*a, **k)

            def counted(state, batch):
                sharding.reset_gathers()
                m = step(state, batch)
                gathers.append(dict(sharding.GATHERS))
                return m

            return counted

        entry.make_train_step = make_counting

    with classified_exit():
        res = entry.main(device="cpu", **spec["main"])
    state = res["state"]
    out.update(
        losses=[r["loss"] for r in res["reports"]],
        gnorms=[r["gnorm"] for r in res["reports"]],
        steps=[r["step"] for r in res["reports"]],
        tokens_seen=[r["tokens_seen"] for r in res["reports"]],
        start_step=res["start_step"],
        batch_size=res["cfg"].batch_size,
        gathers=gathers,
        rows=rows,
        first_step_hash=hashes[0] if hashes else None,
        final_hash=state_hash(state),
        param_bytes=local_bytes(state["params"]),
        moment_bytes=local_bytes(state["moments"]),
        sharded=bool(state["dp"] is not None and state["dp"].sharded),
    )
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
