"""One rank of a gloo world that runs every serving-layout case of
tests/test_torch_serve_layout.py in one process.

Run as a script, one process per rank, with torchrun's environment set by
the test. It imports the port and torch only, never JAX. Usage:

    python tests/torch_layout_child.py SPEC_JSON

SPEC_JSON holds ``out`` (rank R writes ``<out>/rank<R>.json``),
``params`` (family -> a numpy params pickle, ``bridge.py``'s layout),
``speculator`` (a ``save_speculator`` file) and ``world``. Every rank
builds each case's engines; rank 0 drives them and the others follow
(``serve/layout.py``). Rank 0 also runs the one-card engines the cases
are held against, with no group. The module's constants (the TINY
configs, the prompts, the engine knobs) are the test's too.

With ``idle`` in SPEC_JSON (``timeout_s``, ``keepalive_s``, ``idle_s``)
the world of 2 runs only the idle case (tests/test_torch_fleet_layout.py):
the message group's timeout and the leader's keep-alive set to those,
a wave, an idle spell, the same wave again.
"""

import hashlib
import json
import os
import pickle
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fms_fsdp_tpu_torch.bridge import params_from_numpy  # noqa: E402
from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MixtralConfig  # noqa: E402
from fms_fsdp_tpu_torch.parallel import sharding, tensor  # noqa: E402
from fms_fsdp_tpu_torch.resilience.exits import classified_exit  # noqa: E402
from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine  # noqa: E402
from fms_fsdp_tpu_torch.serve import layout as layout_wire  # noqa: E402
from fms_fsdp_tpu_torch.serve.disagg import pack_handoff, unpack_handoff  # noqa: E402
from fms_fsdp_tpu_torch.utils.dist import init_distributed  # noqa: E402

# the TINY models of tests/test_serving.py:47 and tests/test_disagg.py
LLAMA_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                max_expected_seq_len=256)
MIXTRAL_KW = dict(LLAMA_KW, hidden_dim=128, num_experts=4, top_k=2, max_expected_seq_len=64)
CFG = {"llama": LlamaConfig(**LLAMA_KW), "mixtral": MixtralConfig(**MIXTRAL_KW)}
PROMPTS = [[3, 5, 7], [11, 13, 17, 19], [2]]  # tests/test_disagg.py's
# chunked prefill's: longer than its 4-token chunks
CHUNK_PROMPTS = [[9, 4, 31, 77, 2, 50, 61, 8, 19], [5, 5, 90, 1, 44, 3], [120, 7, 66, 13, 2]]
MAX_NEW = 6
# every prompt admitted in the first step and decoded to the same length,
# so every decode step's rows are the prompts' (the logits compared)
SCFG = dict(max_batch=4, max_seq_len=64, compute_dtype="float32", attn_impl="reference",
            page_size=8, max_prefill_per_step=4)
# (case, family, layout, ServeConfig overrides, flags): the world of 2's
CASES_2 = (
    ("llama_tp2", "llama", "tp=2", {}, {}),
    ("mixtral_tp2_dense", "mixtral", "tp=2", {"moe_impl": "dense"}, {}),
    ("mixtral_tp2_routed", "mixtral", "tp=2", {"moe_impl": "routed"}, {}),
    ("llama_tp2_int8", "llama", "tp=2", {"kv_quant": "int8"}, {"one_card": True}),
    ("llama_tp2_chunked", "llama", "tp=2", {"prefill_chunk_tokens": 4},
     {"one_card": True, "prompts": CHUNK_PROMPTS}),
    ("llama_tp2_spec", "llama", "tp=2", {"speculator_path": None}, {"one_card": True}),
    ("control_drop_reduce", "llama", "tp=2", {}, {"drop_reduce": True}),
)
CASES_4 = (("llama_tp2_fsdp2", "llama", "tp=2,fsdp=2", {}, {}),)


def scfg(**kw) -> ServeConfig:
    return ServeConfig(**dict(SCFG, **kw))


def drive(eng, prompts, max_new=MAX_NEW):
    """Serve ``prompts`` to the end: (tokens, the last decode step's
    logits rows of the prompts' slots)."""
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    return ([list(map(int, r.generated)) for r in reqs],
            eng.last_logits[:len(prompts)].tolist())


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _layout_case(params, name, family, layout, over, flags, spec_path, leader):
    over = {k: (spec_path if k == "speculator_path" else v) for k, v in over.items()}
    prompts = flags.get("prompts", PROMPTS)
    saved = tensor.TensorParallel.reduce
    if flags.get("drop_reduce"):
        tensor.TensorParallel.reduce = lambda self, x: x
    try:
        sharding.reset_gathers()
        eng = ServingEngine(params[family], CFG[family], scfg(serve_layout=layout, **over),
                            device="cpu")
        out = {"wq": list(eng.params["layers"]["wq"].shape),
               "pool": list(eng.cache.pools["k"].shape)}
        if not leader:
            out["calls"] = eng.follow()
            return out
        out["tokens"], out["logits"] = drive(eng, prompts)
        out.update(stats=eng.serving_stats(), decode_steps=eng.decode_steps,
                   gathers=dict(sharding.GATHERS))
        if flags.get("one_card"):
            # the same mode on one card, while the followers wait
            one = ServingEngine(params[family], CFG[family], scfg(**over), device="cpu")
            out["one_card_tokens"], _ = drive(one, prompts)
        eng.release_followers()
        return out
    finally:
        tensor.TensorParallel.reduce = saved


def _handoff_case(params, leader):
    """tp 2 prefill -> tp 2 decode and -> one card; one card -> tp 2
    decode. The tp 2 prefill's wires against a one-card prefill's, and
    the one-card wires' round trip through the tp 2 pools."""
    pe = ServingEngine(params["llama"], CFG["llama"], scfg(serve_layout="tp=2", role="prefill"),
                       device="cpu")
    de = ServingEngine(params["llama"], CFG["llama"], scfg(serve_layout="tp=2", role="decode"),
                       device="cpu")
    if not leader:
        return {"calls": pe.follow()}
    preqs = [pe.submit(p, MAX_NEW) for p in PROMPTS]
    pe.run()
    wires = [r.handoff_out for r in preqs]

    def decode(engine, frames):
        reqs = [engine.submit_handoff(w) for w in frames]
        engine.run()
        return [list(map(int, r.generated)) for r in reqs]

    one_pe = ServingEngine(params["llama"], CFG["llama"], scfg(role="prefill"), device="cpu")
    one_reqs = [one_pe.submit(p, MAX_NEW) for p in PROMPTS]
    one_pe.run()
    one_wires = [r.handoff_out for r in one_reqs]
    out = {"tp_to_tp": decode(de, wires), "one_to_tp": decode(de, one_wires),
           "prefill_stats": pe.serving_stats(), "decode_stats": de.serving_stats(),
           "wires": [_compare_wires(a, b) for a, b in zip(wires, one_wires)]}
    # a one-card wire written into the tp 2 pools and read back out: the
    # same bytes (each rank's heads in, the gathered heads out)
    out["round_trip"] = []
    for w in one_wires:
        header, arrays = unpack_handoff(w)
        de.adapter.import_handoff(-1, 3, header, arrays)
        back, back_arrays = de.adapter.export_handoff(-1, 3)
        de.adapter.release(-1, 3)
        back.update({k: header[k] for k in ("prompt", "generated", "seq_len", "max_new_tokens")})
        out["round_trip"].append(digest(pack_handoff(back, back_arrays)) == digest(w))
    pe.release_followers()
    one_de = ServingEngine(params["llama"], CFG["llama"], scfg(role="decode"), device="cpu")
    out["tp_to_one"] = decode(one_de, wires)
    return out


def _defrag_case(params, leader):
    """Requests of unequal lengths (the first ends early and leaves a hole
    in the pool), the pool compacted through the adapter mid-wave, which
    the followers run too: a one-card engine's tokens and page moves."""
    lengths = (2, MAX_NEW, MAX_NEW)

    def run(engine):
        reqs = [engine.submit(p, n) for p, n in zip(PROMPTS, lengths)]
        for _ in range(4):
            engine.step()
        moved = engine.adapter.defrag()
        engine.run()
        return [list(map(int, r.generated)) for r in reqs], moved

    eng = ServingEngine(params["llama"], CFG["llama"], scfg(serve_layout="tp=2"), device="cpu")
    if not leader:
        return {"calls": eng.follow(), "moved": eng.cache.defrag_moves}
    out = dict(zip(("tokens", "moved"), run(eng)))
    one = ServingEngine(params["llama"], CFG["llama"], scfg(), device="cpu")
    out["one_card_tokens"], out["one_card_moved"] = run(one)
    eng.release_followers()
    return out


def _idle_case(params, leader, idle):
    """A tp 2 engine that serves, sits idle for ``idle_s`` (the followers
    waiting in follow()), then serves the same prompts again. The leader
    records the second wave's tokens, or the error that ended it."""
    layout_wire.SERVE_TIMEOUT_S = idle["timeout_s"]
    layout_wire.KEEPALIVE_S = idle["keepalive_s"]
    eng = ServingEngine(params["llama"], CFG["llama"], scfg(serve_layout="tp=2"), device="cpu")
    if not leader:
        return {"calls": eng.follow()}
    out = {"before": drive(eng, PROMPTS)[0]}
    time.sleep(idle["idle_s"])
    try:
        out["after"] = drive(eng, PROMPTS)[0]
        eng.release_followers()
    except RuntimeError as e:
        out["error"] = repr(e)
    out["keepalives"] = layout_wire.MESSAGES["keepalive"]
    return out


def _compare_wires(tp_wire: bytes, one_wire: bytes):
    """A tp 2 prefill's wire against a one-card prefill's for the same
    request: their headers, leaf names, shapes and dtypes, and the
    largest difference of the page values (rounding only: the tp
    replica's row-split products sum in another order)."""
    (h1, a1), (h2, a2) = unpack_handoff(tp_wire), unpack_handoff(one_wire)
    return {"header_equal": h1 == h2, "length_equal": len(tp_wire) == len(one_wire),
            "leaves_equal": {n: (tuple(a.shape), a.dtype) for n, a in a1.items()}
            == {n: (tuple(a.shape), a.dtype) for n, a in a2.items()},
            "max_abs_diff": max((a1[n].float() - a2[n].float()).abs().max().item()
                                for n in a1)}


def main():
    spec = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    params = {}
    for family, path in spec["params"].items():
        with open(path, "rb") as f:
            params[family] = params_from_numpy(pickle.load(f))
    results = {"rank": rank}
    with classified_exit():
        init_distributed(torch.device("cpu"))
        leader = rank == 0
        if "idle" in spec:
            results["idle"] = _idle_case(params, leader, spec["idle"])
        else:
            for name, family, layout, over, flags in (CASES_2 if spec["world"] == 2
                                                      else CASES_4):
                results[name] = _layout_case(params, name, family, layout, over, flags,
                                             spec["speculator"], leader)
        if spec["world"] == 2 and "idle" not in spec:
            results["handoff"] = _handoff_case(params, leader)
            results["defrag"] = _defrag_case(params, leader)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
