"""PyTorch port, checkpoint and resume: held against the JAX package on CPU.

The TINY config of tests/test_serving.py. The same scenarios run through
JAX's ``Checkpointer`` / ``AsyncCheckpointManager`` (Orbax payloads) and
the port's (``torch.distributed.checkpoint`` payloads), each on its own
train state made from the same numpy values; both must reach the same
decisions: which checkpoint loads, with what step and tokens, which step
dirs retention keeps, and which ``metadata.json`` keys a save writes.
Manifests must match byte for byte. Payloads differ by design and are
never compared across packages.
"""

import json
import os
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from fms_fsdp_tpu.ckpt import build_checkpoint_manager as j_build_manager
from fms_fsdp_tpu.ckpt import manager as j_manager
from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.resilience import integrity as j_integrity
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu.utils import ckpt_paths as j_paths
from fms_fsdp_tpu.utils.checkpointing import Checkpointer as JCheckpointer
from fms_fsdp_tpu_torch.bridge import (
    params_from_numpy,
    params_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from fms_fsdp_tpu_torch.ckpt import build_checkpoint_manager
from fms_fsdp_tpu_torch.ckpt import manager as t_manager
from fms_fsdp_tpu_torch.ckpt.state import checkpoint_state
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.models.configs import LlamaConfig
from fms_fsdp_tpu_torch.models.configs import MambaAttnConfig, MambaConfig
from fms_fsdp_tpu_torch.resilience import integrity as t_integrity
from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
from fms_fsdp_tpu_torch.train.step import make_train_step, state_from_params
from fms_fsdp_tpu_torch.utils import checkpointing as t_checkpointing
from fms_fsdp_tpu_torch.utils import ckpt_paths as t_paths
from fms_fsdp_tpu_torch.utils.checkpointing import Checkpointer, load_params_only

_TINY_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                max_expected_seq_len=256)
J_TINY = JLlamaConfig(**_TINY_KW)
TINY = LlamaConfig(**_TINY_KW)
# tests/test_torch_mamba.py's TINY
_MAMBA_KW = dict(d_model=64, d_intermediate=128, n_layer=3, vocab_size=256,
                 attn_layer_idx=(1,), d_state=16, d_conv=4, expand=2, headdim=16,
                 chunk_size=16, pad_vocab_size_multiple=16)
_MAMBA_ATTN_KW = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)


def _dotted(tree):
    """JAX tree paths as the port's checkpoint keys."""
    return {keystr(p, simple=True, separator="."): np.asarray(leaf)
            for p, leaf in tree_flatten_with_path(tree)[0]}


def _j_init(model_cfg):
    cfg = JTrainConfig(sharding_strategy="fsdp")
    mesh = build_mesh(MeshConfig.from_train_config(cfg))
    opt = j_step.make_optimizer(cfg)
    state, _ = j_step.init_train_state(jax.random.PRNGKey(0), model_cfg, cfg, mesh, opt)
    return state


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop this module's JAX traces when it ends: a later module in the
    same process that traces the same step on an equal mesh would
    otherwise reuse them, and a compiled program's metadata names the
    stack that traced it."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def j_base():
    return _j_init(J_TINY)


def _j_state(base, k):
    """JAX's TINY state with every float leaf moved by k, Adam's count and
    the step at k: a checkpoint's values tell which state it holds."""
    shift = lambda t: jax.tree.map(lambda x: x + k, t)  # noqa: E731
    opt = base["opt_state"]
    adam = opt.inner_state[0]._replace(
        count=jnp.asarray(k, jnp.int32), mu=shift(opt.inner_state[0].mu),
        nu=shift(opt.inner_state[0].nu))
    opt = opt._replace(count=jnp.asarray(k, jnp.int32),
                       inner_state=(adam,) + tuple(opt.inner_state[1:]))
    return {"params": shift(base["params"]), "opt_state": opt,
            "step": jnp.asarray(k, jnp.int32)}


class _Jax:
    name = "jax"

    def __init__(self, base):
        self.base = base

    def state(self, k):
        return _j_state(self.base, k)

    def ckptr(self, root, keep=5):
        return JCheckpointer(str(root), keep, "fsdp", rank=0)

    def mgr(self, tmp, local_interval=0, durable_interval=4, keep=1000):
        return j_build_manager(JTrainConfig(
            ckpt_save_path=str(tmp / "durable"), checkpoint_interval=durable_interval,
            ckpt_local_dir=str(tmp / "local") if local_interval else "",
            ckpt_local_interval=local_interval, ckpt_local_keep=2, ckpt_keep=keep,
            sharding_strategy="fsdp"), rank=0)

    def params_pickle(self, path, k):
        with open(path, "wb") as f:
            pickle.dump({"model_state": jax.tree.map(np.asarray, self.state(k)["params"])}, f)

    def load(self, ck, **kw):
        state, _, step, ntok, resuming = ck.load(self.state(0), None, **kw)
        return {"step": step, "tokens": ntok, "resuming": resuming,
                "params": float(state["params"]["norm"][0]) - 1.0,
                "mu": float(state["opt_state"].inner_state[0].mu["norm"][0]),
                "state_step": int(state["step"])}

    def crash_commit(self, monkeypatch, tier_name, step):
        real = j_manager.AsyncCheckpointManager._commit_tier_io

        def commit(mgr, tier, save_name, step_, meta):
            if tier.name == tier_name and step_ == step:
                raise RuntimeError("writer crash")
            return real(mgr, tier, save_name, step_, meta)

        monkeypatch.setattr(j_manager.AsyncCheckpointManager, "_commit_tier_io", commit)


class _Port:
    name = "port"

    def __init__(self, base):
        self.base = base
        self.cfg = TrainConfig(sharding_strategy="fsdp")

    def state(self, k):
        # JAX's state carried across whole: params, moments, count, step
        return train_state_from_numpy(_dotted(_j_state(self.base, k)), self.cfg)

    def ckptr(self, root, keep=5):
        return Checkpointer(str(root), keep, "fsdp", rank=0)

    def mgr(self, tmp, local_interval=0, durable_interval=4, keep=1000):
        return build_checkpoint_manager(TrainConfig(
            ckpt_save_path=str(tmp / "durable"), checkpoint_interval=durable_interval,
            ckpt_local_dir=str(tmp / "local") if local_interval else "",
            ckpt_local_interval=local_interval, ckpt_local_keep=2, ckpt_keep=keep,
            sharding_strategy="fsdp"), rank=0)

    def params_pickle(self, path, k):
        with open(path, "wb") as f:
            pickle.dump({"model_state": params_to_numpy(self.state(k)["params"])}, f)

    def load(self, ck, **kw):
        state, _, step, ntok, resuming = ck.load(self.state(0), None, **kw)
        return {"step": step, "tokens": ntok, "resuming": resuming,
                "params": float(state["params"]["norm"][0]) - 1.0,
                "mu": float(state["moments"]["mu"]["norm"][0]),
                "state_step": int(state["step"])}

    def crash_commit(self, monkeypatch, tier_name, step):
        real = t_manager.AsyncCheckpointManager._commit_tier_io

        def commit(mgr, tier, save_name, meta, timing):
            if tier.name == tier_name and meta["step"] == step:
                raise RuntimeError("writer crash")
            return real(mgr, tier, save_name, meta, timing)

        monkeypatch.setattr(t_manager.AsyncCheckpointManager, "_commit_tier_io", commit)


def _dirs(root):
    path = os.path.join(root, "checkpoints")
    return sorted(x for x in os.listdir(path) if x.startswith("step_")) \
        if os.path.isdir(path) else []


def _meta_keys(step_dir):
    with open(os.path.join(step_dir, "metadata.json")) as f:
        meta = json.load(f)
    return sorted(meta), sorted(meta.get("topology") or {})


def _truncate_payload(step_dir):
    files = []
    for root, _, names in os.walk(os.path.join(step_dir, "state")):
        files += [os.path.join(root, n) for n in names]
    victim = max(files, key=os.path.getsize)
    with open(victim, "rb+") as f:
        f.truncate(os.path.getsize(victim) // 2)


# ---------------------------------------------------------------------------
# scenarios: each returns what both packages must agree on
# ---------------------------------------------------------------------------


def _sc_resume_newest(pk, tmp, mp):
    ck = pk.ckptr(tmp / "run")
    for step in (2, 4):
        ck.save(step, pk.state(step), None, tokens_seen=10 * step)
    return {"load": pk.load(pk.ckptr(tmp / "run")), "dirs": _dirs(tmp / "run"),
            "meta": _meta_keys(tmp / "run" / "checkpoints" / "step_4_ckp")}


def _sc_torn_newest(pk, tmp, mp):
    ck = pk.ckptr(tmp / "run")
    for step in (2, 4):
        ck.save(step, pk.state(step), None, tokens_seen=10 * step)
    os.remove(tmp / "run" / "checkpoints" / "step_4_ckp" / "metadata.json")
    return {"load": pk.load(pk.ckptr(tmp / "run"))}


def _sc_corrupt_newest(pk, tmp, mp):
    ck = pk.ckptr(tmp / "run")
    for step in (2, 4):
        ck.save(step, pk.state(step), None, tokens_seen=10 * step)
    _truncate_payload(tmp / "run" / "checkpoints" / "step_4_ckp")
    return {"load": pk.load(pk.ckptr(tmp / "run")),
            "quarantined": sorted(os.listdir(tmp / "run" / "checkpoints" / "step_4_ckp"))}


def _sc_all_corrupt(pk, tmp, mp):
    ck = pk.ckptr(tmp / "run")
    for step in (2, 4):
        ck.save(step, pk.state(step), None, tokens_seen=10 * step)
        _truncate_payload(tmp / "run" / "checkpoints" / f"step_{step}_ckp")
    with pytest.raises(RuntimeError, match="refusing to silently restart") as e:
        pk.load(pk.ckptr(tmp / "run"))
    return {"raises": str(e.value).split(";")[0].split(" under ")[0]}


def _sc_external(pk, tmp, mp):
    pk.ckptr(tmp / "old").save(4, pk.state(4), None, tokens_seen=999)
    out = pk.load(pk.ckptr(tmp / "new"), path=str(tmp / "old" / "checkpoints"))
    return {"load": out, "dirs": _dirs(tmp / "new")}


def _sc_pickle(pk, tmp, mp):
    pk.params_pickle(tmp / "model.pkl", 7)
    return {"load": pk.load(pk.ckptr(tmp / "new"), path=str(tmp / "model.pkl"))}


def _sc_retention(pk, tmp, mp):
    ck = pk.ckptr(tmp / "run", keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, pk.state(step), None)
    return {"dirs": _dirs(tmp / "run"), "load": pk.load(pk.ckptr(tmp / "run", keep=2))}


def _sc_tier_cadence(pk, tmp, mp):
    m = pk.mgr(tmp, local_interval=2, durable_interval=4)
    due = [s for s in range(1, 11) if m.save_due(s)]
    for step in (2, 4, 6, 8, 10):
        m.save(step, pk.state(step), None, tokens_seen=step)
    m.finalize()
    return {"due": due, "local": _dirs(tmp / "local"), "durable": _dirs(tmp / "durable"),
            "meta": _meta_keys(tmp / "durable" / "checkpoints" / "step_4_ckp")}


def _sc_resume_across_tiers(pk, tmp, mp):
    m = pk.mgr(tmp, local_interval=2, durable_interval=4)
    m.save(4, pk.state(4), None, tokens_seen=4)
    m.save(6, pk.state(6), None, tokens_seen=6)  # local tier
    m.finalize()
    return {"load": pk.load(pk.mgr(tmp, local_interval=2, durable_interval=4)),
            "local": _dirs(tmp / "local"), "durable": _dirs(tmp / "durable")}


def _sc_kill_mid_write(pk, tmp, mp):
    m = pk.mgr(tmp, local_interval=2, durable_interval=4)
    m.save(2, pk.state(2), None, tokens_seen=2)
    m.save(4, pk.state(4), None, tokens_seen=4)
    m.finalize()
    pk.crash_commit(mp, "local", 6)
    m.save(6, pk.state(6), None, tokens_seen=6)  # local, torn
    with pytest.raises(RuntimeError, match="background checkpoint writer"):
        m.finalize()
    mp.undo()
    torn = tmp / "local" / "checkpoints" / "step_6_ckp"
    return {"torn_marker": (torn / "metadata.json").exists(), "torn_dir": torn.is_dir(),
            "load": pk.load(pk.mgr(tmp, local_interval=2, durable_interval=4))}


def _sc_forced_reasons(pk, tmp, mp):
    m = pk.mgr(tmp, local_interval=2, durable_interval=100)
    m.save(3, pk.state(3), None, reason="final", tokens_seen=3)
    m.save(5, pk.state(5), None, reason="abort", tokens_seen=5, skipped_steps=2)
    m.save(7, pk.state(7), None, reason="preempt", tokens_seen=7)
    m.finalize()
    return {"local": _dirs(tmp / "local"), "durable": _dirs(tmp / "durable"),
            "meta": _meta_keys(tmp / "durable" / "checkpoints" / "step_5_ckp")}


SCENARIOS = {
    "resume_newest": _sc_resume_newest,
    "torn_newest_skipped": _sc_torn_newest,
    "corrupt_newest_falls_back": _sc_corrupt_newest,
    "all_corrupt_raises": _sc_all_corrupt,
    "external_load_resets_step": _sc_external,
    "single_file_pickle_params_only": _sc_pickle,
    "retention_by_step_number": _sc_retention,
    "tier_cadence": _sc_tier_cadence,
    "resume_newest_across_tiers": _sc_resume_across_tiers,
    "kill_mid_write_falls_back_across_tiers": _sc_kill_mid_write,
    "forced_reasons_go_durable": _sc_forced_reasons,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_checkpoint_decisions_match_jax(scenario, j_base, tmp_path, monkeypatch):
    out = {}
    for pk in (_Jax(j_base), _Port(j_base)):
        root = tmp_path / pk.name
        root.mkdir()
        out[pk.name] = SCENARIOS[scenario](pk, root, monkeypatch)
    assert out["port"] == out["jax"]
    load = out["port"].get("load")
    if scenario == "resume_newest":
        assert load == {"step": 4, "tokens": 40, "resuming": True, "params": 4.0,
                        "mu": 4.0, "state_step": 4}
    if scenario in ("torn_newest_skipped", "corrupt_newest_falls_back"):
        assert load["step"] == 2 and load["params"] == 2.0
    if scenario == "external_load_resets_step":
        # moments kept, schedule clock restarted
        assert load == {"step": 0, "tokens": 0, "resuming": False, "params": 4.0,
                        "mu": 4.0, "state_step": 0}
    if scenario == "single_file_pickle_params_only":
        assert load["params"] == 7.0 and load["mu"] == 0.0 and load["step"] == 0
    if scenario == "kill_mid_write_falls_back_across_tiers":
        assert load["step"] == 4 and not out["port"]["torn_marker"]


# ---------------------------------------------------------------------------
# manifests and path helpers: the same bytes and the same answers
# ---------------------------------------------------------------------------


def _ckpt_like_dir(root):
    rng = np.random.default_rng(0)
    files = {"state/.metadata": 321, "state/__0_0.distcp": (1 << 20) + 4097,
             "state/__0_1.distcp": 1 << 20, "extra/small.bin": 7, "empty.bin": 0,
             "loader_state_0.pkl": 33}
    for rel, n in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    return root


@pytest.mark.parametrize("chunk_bytes", [1 << 16, 100_003, 1 << 26])
def test_manifest_bytes_match_jax(tmp_path, chunk_bytes):
    d = _ckpt_like_dir(str(tmp_path))
    man = os.path.join(d, "manifest.json")
    j_integrity.write_manifest(d, chunk_bytes=chunk_bytes)
    jax_bytes = open(man, "rb").read()
    assert j_integrity.verify_manifest(d) == (True, []) == t_integrity.verify_manifest(d)
    t_integrity.write_manifest(d, chunk_bytes=chunk_bytes)
    assert open(man, "rb").read() == jax_bytes
    assert j_integrity.verify_manifest(d) == (True, [])
    doc = json.loads(jax_bytes)
    assert "loader_state_0.pkl" not in doc["files"]
    assert set(doc["chunks"]) == {"state/__0_0.distcp"}
    assert t_integrity.write_manifest(d, full_checksums=False) == man
    assert json.loads(open(man).read())["chunks"] == {}


@pytest.mark.parametrize("damage", ["truncate", "flip", "stray", "torn_manifest"])
def test_manifest_verifiers_reject_alike(tmp_path, damage):
    d = _ckpt_like_dir(str(tmp_path))
    j_integrity.write_manifest(d, chunk_bytes=1 << 16)
    victim = os.path.join(d, "state", "__0_0.distcp")
    if damage == "truncate":
        with open(victim, "rb+") as f:
            f.truncate(1000)
    elif damage == "flip":
        with open(victim, "rb+") as f:
            f.seek(300_000)
            b = f.read(1)
            f.seek(300_000)
            f.write(bytes([b[0] ^ 0xFF]))
    elif damage == "stray":
        open(os.path.join(d, "state", "stray.bin"), "wb").write(b"x")
    else:
        with open(os.path.join(d, "manifest.json"), "r+") as f:
            f.truncate(40)
    ok_j, problems_j = j_integrity.verify_manifest(d)
    ok_t, problems_t = t_integrity.verify_manifest(d)
    assert not ok_j and not ok_t
    if damage != "torn_manifest":  # the parse error's text is the interpreter's
        assert problems_t == problems_j
    if damage == "flip":
        assert problems_t == ["checksum mismatch state/__0_0.distcp (chunk 5/17, offset 262144)"]


def _tree(root):
    cp = os.path.join(root, "checkpoints")
    for name in ("step_1_ckp", "step_10_ckp", "step_2_ckp", "step_best_ckp", "stepx_3_ckp",
                 "notes"):
        os.makedirs(os.path.join(cp, name))
    for name in ("step_10_ckp", "step_2_ckp"):
        open(os.path.join(cp, name, "metadata.json"), "w").write("{}")
    open(os.path.join(cp, "step_7_ckp"), "wb").write(b"pickle")
    return cp


def test_path_helpers_match_jax(tmp_path):
    cp = _tree(str(tmp_path))
    names = sorted(os.listdir(cp))
    for mod in (j_paths, t_paths):
        assert mod.safe_listdir(os.path.join(cp, "missing")) == []
        assert mod.safe_listdir(os.path.join(cp, "step_7_ckp")) == []
    assert [t_paths.is_step_ckp(n) for n in names] == [j_paths.is_step_ckp(n) for n in names]
    steps = [n for n in names if t_paths.is_step_ckp(n)]
    assert [t_paths.step_number(n) for n in steps] == [j_paths.step_number(n) for n in steps]
    committed = lambda p: "metadata.json" in j_paths.safe_listdir(p)  # noqa: E731
    for kw in ({"qualifier": j_paths.is_step_ckp, "key": j_paths.step_number},
               {"qualifier": committed, "key": j_paths.step_number}, {}):
        assert t_paths.get_latest(cp, **kw) == j_paths.get_latest(cp, **kw)
        assert t_paths.get_oldest(cp, **kw) == j_paths.get_oldest(cp, **kw)
    assert t_paths.get_latest(os.path.join(cp, "notes")) is None
    assert t_paths.get_latest(cp, qualifier=committed, key=t_paths.step_number).endswith(
        "step_10_ckp")
    # the candidate walk: committed dirs and files, newest step first
    assert Checkpointer(str(tmp_path), 5, "fsdp")._candidate_ckp_paths(cp) == \
        JCheckpointer(str(tmp_path), 5, "fsdp", rank=0)._candidate_ckp_paths(cp)


# ---------------------------------------------------------------------------
# the train state as a checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["llama", "mamba"])
def test_checkpoint_keys_are_jax_tree_paths(family):
    if family == "llama":
        j_cfg, t_cfg = J_TINY, TINY
    else:
        j_cfg = JMambaConfig(**_MAMBA_KW, attn_cfg=JMambaAttnConfig(**_MAMBA_ATTN_KW))
        t_cfg = MambaConfig(**_MAMBA_KW, attn_cfg=MambaAttnConfig(**_MAMBA_ATTN_KW))
    j_flat = _dotted(_j_init(j_cfg))
    state = state_from_params(params_from_numpy(_params_tree(j_flat)), TrainConfig())
    flat = checkpoint_state(state)
    assert sorted(flat) == sorted(j_flat)
    for key, t in flat.items():
        assert tuple(t.shape) == j_flat[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(j_flat[key].dtype), key
    if family == "mamba":
        assert "params.layers.2.mixer.A_log" in flat
        assert "opt_state.inner_state.0.nu.layers.1.mixer.wq" in flat


def _params_tree(flat):
    from fms_fsdp_tpu_torch.ckpt.state import unflatten

    return unflatten(flat, "params")


def _trained_state(np_params, steps=2, seed=0):
    cfg = TrainConfig(seq_length=16, batch_size=2, vocab_size=128, attention_kernel="xla",
                      mixed_precision=False, learning_rate=1e-2)
    state = state_from_params(params_from_numpy(np_params), cfg)
    step = make_train_step(TINY, cfg)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        toks = torch.from_numpy(rng.integers(0, 128, size=(2, 17)))
        step(state, (toks[:, :-1], toks[:, 1:]))
    return state, step, cfg


@pytest.fixture(scope="module")
def np_params(j_base):
    return jax.tree.map(np.asarray, j_base["params"])


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


@pytest.mark.parametrize("route", ["checkpointer", "manager", "bridge"])
def test_round_trip_is_bitwise_and_updates_still_land(np_params, tmp_path, route):
    state, step, cfg = _trained_state(np_params)
    saved = {k: v.clone() for k, v in checkpoint_state(state).items()}
    fresh = state_from_params(params_from_numpy(jax.tree.map(lambda a: a * 0.5, np_params)),
                              cfg)
    if route == "bridge":
        fresh = train_state_from_numpy(train_state_to_numpy(state), cfg)
    else:
        ck = (Checkpointer(str(tmp_path), 2, "fsdp") if route == "checkpointer" else
              build_checkpoint_manager(TrainConfig(ckpt_save_path=str(tmp_path),
                                                   sharding_strategy="fsdp")))
        ck.save(2, state, None, tokens_seen=64)
        ck.finalize()
        _, _, at, ntok, resuming = ck.load(fresh, None)
        assert (at, ntok, resuming) == (2, 64, True)
    loaded = checkpoint_state(fresh)
    assert sorted(loaded) == sorted(saved)
    for key, t in saved.items():
        assert t.dtype == loaded[key].dtype and torch.equal(_bits(t), _bits(loaded[key])), key
    assert fresh["step"] == 2
    assert all(float(s["step"]) == 2.0 for s in fresh["optimizer"].state.values())
    # the optimizer's leaves still alias the loaded stacked tensors
    wq = fresh["params"]["layers"]["wq"].clone()
    mu = fresh["moments"]["mu"]["layers"]["wq"].clone()
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 128, size=(2, 17)))
    step(fresh, (toks[:, :-1], toks[:, 1:]))
    assert not torch.equal(wq, fresh["params"]["layers"]["wq"])
    assert not torch.equal(mu, fresh["moments"]["mu"]["layers"]["wq"])
    assert fresh["step"] == 3


# ---------------------------------------------------------------------------
# the async contract
# ---------------------------------------------------------------------------


def _slow_writes(monkeypatch, delay=0.3, fail_steps=()):
    """write_state that sleeps, counts writes in flight, and raises for
    the step dirs named."""
    real = t_checkpointing.write_state
    live = {"now": 0, "max": 0, "threads": set()}
    lock = threading.Lock()

    def write(path, flat):
        with lock:
            live["now"] += 1
            live["max"] = max(live["max"], live["now"])
            live["threads"].add(threading.current_thread().name)
        try:
            time.sleep(delay)
            if any(f"step_{s}_ckp" in path for s in fail_steps):
                raise OSError(28, "No space left on device")
            real(path, flat)
        finally:
            with lock:
                live["now"] -= 1

    monkeypatch.setattr(t_manager, "write_state", write)
    return live


def test_async_at_most_one_save_in_flight(np_params, tmp_path, monkeypatch):
    live = _slow_writes(monkeypatch, delay=1.0)
    state, _, _ = _trained_state(np_params, steps=1)
    m = build_checkpoint_manager(TrainConfig(ckpt_save_path=str(tmp_path),
                                             checkpoint_interval=1, sharding_strategy="fsdp"))
    t0 = time.perf_counter()
    m.save(1, state, None)
    assert time.perf_counter() - t0 < 0.5  # the write is off the caller's thread
    m.save(2, state, None)  # joins the first writer before its snapshot
    assert time.perf_counter() - t0 >= 1.0
    m.finalize()
    assert live["max"] == 1 and live["threads"] == {"ckpt-writer"}
    assert [r["step"] for r in m.save_log] == [1, 2]
    assert all(r["bytes"] > 0 and r["write_s"] >= 1.0 for r in m.save_log)


def test_async_snapshot_isolated_from_later_writes(np_params, tmp_path, monkeypatch):
    _slow_writes(monkeypatch)
    state, _, cfg = _trained_state(np_params, steps=1)
    before = {k: v.clone() for k, v in checkpoint_state(state).items()}
    m = build_checkpoint_manager(TrainConfig(ckpt_save_path=str(tmp_path),
                                             sharding_strategy="fsdp"))
    m.save(1, state, None)
    # in-place writes while the writer sleeps, as the next AdamW step makes
    state["params"]["layers"]["wq"].add_(1.0)
    state["moments"]["nu"]["embedding"].mul_(3.0)
    m.finalize()
    fresh = state_from_params(params_from_numpy(np_params), cfg)
    m.load(fresh, None)
    for key, t in checkpoint_state(fresh).items():
        assert torch.equal(_bits(t), _bits(before[key])), key


@pytest.mark.parametrize("surfaces_at", ["save", "finalize"])
def test_async_writer_error_reaches_next_call(np_params, tmp_path, monkeypatch, surfaces_at):
    _slow_writes(monkeypatch, delay=0.0, fail_steps=(1,))
    state, _, _ = _trained_state(np_params, steps=1)
    m = build_checkpoint_manager(TrainConfig(ckpt_save_path=str(tmp_path),
                                             sharding_strategy="fsdp"))
    m.save(1, state, None)
    with pytest.raises(RuntimeError, match="background checkpoint writer") as e:
        m.save(2, state, None) if surfaces_at == "save" else m.finalize()
    assert isinstance(e.value.__cause__, OSError)
    assert not os.path.exists(tmp_path / "checkpoints" / "step_1_ckp" / "metadata.json")
    m.finalize()  # raised once, not again
    if surfaces_at == "save":
        assert _dirs(tmp_path) == ["step_1_ckp"]  # the failed save's torn dir only


def test_sync_manager_commits_inside_save(np_params, tmp_path, monkeypatch):
    """``ckpt_async=False``: the payload, manifest and marker are written
    on the caller's thread before ``save`` returns."""
    live = _slow_writes(monkeypatch, delay=0.0)
    state, _, _ = _trained_state(np_params, steps=1)
    m = build_checkpoint_manager(TrainConfig(ckpt_save_path=str(tmp_path), ckpt_async=False,
                                             sharding_strategy="fsdp"))
    m.save(1, state, None, tokens_seen=7)
    assert (tmp_path / "checkpoints" / "step_1_ckp" / "metadata.json").exists()
    assert live["threads"] == {threading.current_thread().name}
    assert [r["step"] for r in m.save_log] == [1]


def test_durable_commit_failure_degrades_to_local_tier(np_params, tmp_path, monkeypatch):
    """A durable commit that still fails after its retries leaves that
    step dir uncommitted and keeps the writer alive; the next durable
    save goes to the local tier too, and the first durable commit that
    lands ends the degraded mode."""
    real = t_checkpointing.commit_metadata
    fail = {"durable": True}

    def commit(save_name, meta):
        if fail["durable"] and "durable" in save_name:
            raise OSError(5, "Input/output error")
        return real(save_name, meta)

    monkeypatch.setattr(t_checkpointing, "commit_metadata", commit)
    state, _, _ = _trained_state(np_params, steps=1)
    m = build_checkpoint_manager(TrainConfig(
        ckpt_save_path=str(tmp_path / "durable"), checkpoint_interval=4,
        ckpt_local_dir=str(tmp_path / "local"), ckpt_local_interval=2,
        ckpt_durable_retries=1, ckpt_durable_backoff_s=0.0, sharding_strategy="fsdp"))
    m.save(4, state, None)
    m.finalize()  # no error: the failure degraded, it did not kill the writer
    assert not (tmp_path / "durable" / "checkpoints" / "step_4_ckp" / "metadata.json").exists()
    fail["durable"] = False
    m.save(8, state, None)
    m.finalize()
    assert [(r["step"], r["tier"]) for r in m.save_log] == [(8, "local"), (8, "durable")]
    m.save(12, state, None)  # degraded mode over: durable only
    m.finalize()
    assert [(r["step"], r["tier"]) for r in m.save_log][-1] == (12, "durable")
    assert _dirs(tmp_path / "local") == ["step_8_ckp"]


# ---------------------------------------------------------------------------
# serving from a training checkpoint
# ---------------------------------------------------------------------------


def _greedy(eng, prompts, n=5):
    reqs = [eng.submit(p, n) for p in prompts]
    eng.run()
    return [list(r.generated) for r in reqs]


def test_engine_serves_from_training_checkpoint(np_params, tmp_path):
    state, _, _ = _trained_state(np_params)
    m = build_checkpoint_manager(TrainConfig(ckpt_save_path=str(tmp_path / "run"),
                                             sharding_strategy="fsdp"))
    m.save(2, state, None, reason="final")
    m.finalize()
    # a torn newer dir and a loader-only dir are skipped by the root read
    os.makedirs(tmp_path / "run" / "checkpoints" / "step_9_ckp" / "state")
    os.makedirs(tmp_path / "run" / "checkpoints" / "step_11_ckp")
    open(tmp_path / "run" / "checkpoints" / "step_11_ckp" / "loader_state_0.pkl", "wb").close()
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(params_to_numpy(state["params"]), f)
    scfg = ServeConfig(max_batch=2, max_seq_len=64, compute_dtype="float32", page_size=16)
    prompts = [[5, 9, 2], [7, 1, 4, 4, 8]]
    live = _greedy(ServingEngine(state["params"], TINY, scfg, device="cpu"), prompts)
    for path in (tmp_path / "run" / "checkpoints" / "step_2_ckp",
                 tmp_path / "run" / "checkpoints", tmp_path / "params.pkl"):
        eng = ServingEngine.from_checkpoint(str(path), TINY, scfg, device="cpu")
        assert _greedy(eng, prompts) == live, path
    params, nbytes = load_params_only(str(tmp_path / "run" / "checkpoints"), with_bytes=True)
    flat = checkpoint_state(state)
    want = sum(t.numel() * t.element_size() for k, t in flat.items() if k.startswith("params."))
    assert want <= nbytes < 2 * want  # the params only, not the moments
    assert torch.equal(params["layers"]["w1"], state["params"]["layers"]["w1"])
    with pytest.raises(AssertionError, match="no checkpoint"):
        load_params_only(str(tmp_path / "run" / "missing"))
