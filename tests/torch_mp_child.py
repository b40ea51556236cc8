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
``inputs``/``labels`` batches that replace the dummy stream: each data
rank takes its contiguous rows of each, the rank and the data world the
entry passes to ``get_dummy_loader``), ``record_rows`` (keep every row the
feed served and hash the train state at the first step) and
``speculator`` (run the speculator entry instead of the Llama trainer)
or ``eval`` (run
``eval_ppl.main`` and write its result) or ``wire`` (the quantized
reduce on seeded gradients of a TINY Llama split over fsdp: each mode's
round trip, and the same with every row amax kept local, gathered whole
into ``<out>/wire.npz`` by rank 0).
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


def wire_inputs(model_cfg):
    """Seeded whole params of ``model_cfg`` and seeded whole gradients
    for them ({checkpoint key: tensor}), their rows of unlike scales, so
    that half a row's absmax is often not the row's."""
    from fms_fsdp_tpu_torch.ckpt.state import flatten
    from fms_fsdp_tpu_torch.models.llama import init_llama_params

    params = init_llama_params(torch.Generator().manual_seed(0), model_cfg)
    gen = torch.Generator().manual_seed(1)
    grads = {k: torch.randn(t.shape, generator=gen) * torch.rand(t.shape, generator=gen) ** 4
             for k, t in flatten("params", params, {}).items()}
    return params, grads


def wire_check(spec, rank):
    """The quantized reduce on this rank's parts of seeded whole
    gradients (the same on every rank: one seed), each mode through the
    fsdp group's amax and with local amaxes (``dp=None``), every result
    gathered whole: ``<mode>.<i>`` and ``<mode>.local.<i>`` for the i-th
    per-layer leaf of ``train/step.py::_per_layer``."""
    from fms_fsdp_tpu_torch.ckpt.state import flatten, unflatten
    from fms_fsdp_tpu_torch.config import TrainConfig
    from fms_fsdp_tpu_torch.models.configs import LlamaConfig
    from fms_fsdp_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from fms_fsdp_tpu_torch.parallel.sharding import DataParallel, init_amax_state
    from fms_fsdp_tpu_torch.train.step import _per_layer, quant_leaves
    from fms_fsdp_tpu_torch.utils.dist import init_distributed

    world = init_distributed(torch.device("cpu"))
    cfg = TrainConfig(sharding_strategy="fsdp")
    mesh = build_mesh(MeshConfig.from_train_config(cfg), device_type="cpu",
                      local_world=world.local_size)
    model_cfg = LlamaConfig(**spec["model"])
    params, grads = wire_inputs(model_cfg)
    dp = DataParallel.for_params(mesh, params, model_cfg)
    local = unflatten(dp.shard(flatten("params", params, {})), "params")
    local_grads = _per_layer(unflatten(dp.shard(grads), "params"), lambda w, *_: w)[1]
    leaves = quant_leaves(local, dp)
    out = {}
    for mode in spec["wire"]:
        for tag, group in (("", dp), (".local", None)):
            quant = init_amax_state(local, 4)
            got, _ = sharding.quantized_grad_reduce(local_grads, mode, quant, leaves, group)
            for i, (g, leaf) in enumerate(zip(got, leaves)):
                whole = g if leaf.split is None else dp.all_gather([g], [leaf.split], None)[0]
                out[f"{mode}{tag}.{i}"] = whole.numpy()
    if rank == 0:
        np.savez(os.path.join(spec["out"], "wire.npz"), **out)


def main():
    spec = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    out = {"rank": rank, "world": world}

    if spec.get("batches"):
        data = np.load(spec["batches"])
        inputs, labels = data["inputs"], data["labels"]

        class RankRows:
            def __init__(self, r, w):
                self.r, self.per = r, inputs.shape[1] // w

            def __iter__(self):
                lo, hi = self.r * self.per, (self.r + 1) * self.per
                for x, y in zip(inputs, labels):
                    yield (x[lo:hi], y[lo:hi])

        entry.get_dummy_loader = lambda cfg, r, w: RankRows(r, w)
        spec_entry.get_dummy_loader = entry.get_dummy_loader
        eval_entry.get_dummy_loader = entry.get_dummy_loader

    if spec.get("eval"):
        out["eval"] = eval_entry.main(device="cpu", **spec["main"])
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        return

    if spec.get("wire"):
        wire_check(spec, rank)
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        return

    if spec.get("speculator"):
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
        quant_rows={k: v.tolist() for k, v in
                    (state.get("quant") or {}).get("amax_history", {}).items()},
    )
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
