"""PyTorch port, training slice: held against the JAX package on CPU.

Inputs come from numpy seeds and go through both packages; weights are
initialised by JAX and moved into the port with the bridge. Tolerances:
fp32 ops at 2e-5 (tests/test_llama.py), the learning rate at 1e-6
relative (JAX evaluates the schedule in fp32), and the train step as
stated on its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init
from fms_fsdp_tpu.models.llama import llama_forward as j_forward
from fms_fsdp_tpu.ops.fused_ce import fused_linear_cross_entropy as j_fused_ce
from fms_fsdp_tpu.parallel.ac import selective_ac_mask as j_ac_mask
from fms_fsdp_tpu.parallel.mesh import MeshConfig, build_mesh
from fms_fsdp_tpu.train import step as j_step
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.main_training_llama import main
from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MambaAttnConfig
from fms_fsdp_tpu_torch.models.llama import llama_forward
from fms_fsdp_tpu_torch.ops.fused_ce import (
    cross_entropy_loss,
    fused_linear_cross_entropy,
)
from fms_fsdp_tpu_torch.parallel.ac import selective_ac_mask
from fms_fsdp_tpu_torch.resilience.guards import AnomalyGuard
from fms_fsdp_tpu_torch.train.step import (
    check_supported,
    get_lr_schedule,
    init_train_state,
    make_train_step,
    state_from_params,
)
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config
from fms_fsdp_tpu_torch.utils.train_utils import state_device, train
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# head dim 128, the flash kernels' width
_SMALL_KW = dict(src_vocab_size=512, emb_dim=256, nheads=2, kvheads=1, nlayers=2,
                 max_expected_seq_len=256)
J_SMALL = JLlamaConfig(**_SMALL_KW)
SMALL = LlamaConfig(**_SMALL_KW)
SEQ = 256

_ENTRY_OVERRIDES = {
    "LlamaConfig.nlayers": 2, "LlamaConfig.emb_dim": 256, "LlamaConfig.nheads": 2,
    "LlamaConfig.kvheads": 1, "LlamaConfig.src_vocab_size": 512,
}


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop this module's JAX traces when it ends: a later module in the
    same process that traces the same step on an equal mesh would
    otherwise reuse them, and a compiled program's metadata names the
    stack that traced it."""
    yield
    jax.clear_caches()


def _err(port, ref):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max())


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), J_SMALL))


def _tokens(seed, rows, seq=SEQ, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(rows, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0, 1, 0.5, "1/3", "2/3"])
def test_selective_ac_mask_matches_jax(p):
    for n in range(1, 13):
        assert selective_ac_mask(n, p) == j_ac_mask(n, p), (n, p)


@pytest.mark.parametrize("stage,num_steps,start", [("initial", 200, 0),
                                                   ("initial", 60000, 0),
                                                   ("initial", 200, 37),
                                                   ("annealing", 200, 0)])
def test_lr_schedule_matches_jax(stage, num_steps, start):
    kw = dict(num_steps=num_steps, learning_rate=3e-4, training_stage=stage)
    port = get_lr_schedule(TrainConfig(**kw), start)
    ref = j_step.get_lr_schedule(JTrainConfig(**kw), start)
    counts = range(num_steps + 1 - start) if num_steps <= 200 else range(0, num_steps, 97)
    for c in counts:
        assert port(c) == pytest.approx(float(ref(c)), rel=1e-6, abs=1e-12), c


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 5))
    labels[0, 0] = labels[1, 3] = -100
    jl, jg = jax.value_and_grad(j_step.cross_entropy_loss)(jnp.asarray(logits),
                                                            jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_()
    loss = cross_entropy_loss(t, torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 2e-6
    assert _err(t.grad, jg) <= 2e-6
    # every label ignored: 0, as JAX
    zero = cross_entropy_loss(torch.zeros(1, 3, 7), torch.full((1, 3), -100))
    assert zero.item() == 0.0


def test_fused_linear_cross_entropy_matches_jax():
    """A chunk of 4 rows does not divide the 14 tokens."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 11))).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 7))
    labels[1, 2] = -100

    def j_loss(x, w):
        return j_fused_ce(x, w, jnp.asarray(labels), 4)

    jl, (jdx, jdw) = jax.value_and_grad(j_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = fused_linear_cross_entropy(tx, tw, torch.from_numpy(labels), 4)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 2e-5
    assert _err(tx.grad, jdx) <= 2e-5
    assert _err(tw.grad, jdw) <= 2e-5
    # the same loss as logits then CE
    ref = cross_entropy_loss(torch.from_numpy(x) @ torch.from_numpy(w),
                             torch.from_numpy(labels))
    assert abs(loss.item() - ref.item()) <= 2e-5


def test_llama_forward_matches_jax(np_params):
    inputs, _ = _tokens(2, 2)
    ref = j_forward(np_params, jnp.asarray(inputs), J_SMALL,
                    compute_dtype=jnp.float32, attn_impl="xla")
    params = params_from_numpy(np_params)
    out = llama_forward(params, torch.from_numpy(inputs).long(), SMALL,
                        compute_dtype=torch.float32, attn_impl="xla")
    assert _err(out, ref) <= 2e-5
    hidden = llama_forward(params, torch.from_numpy(inputs).long(), SMALL,
                           compute_dtype=torch.float32, attn_impl="xla",
                           return_hidden=True)
    jh = j_forward(np_params, jnp.asarray(inputs), J_SMALL, compute_dtype=jnp.float32,
                   attn_impl="xla", return_hidden=True)
    assert _err(hidden, jh) <= 2e-5


def test_llama_forward_ac_mask_changes_nothing(np_params):
    """A mixed remat mask gives the same logits and grads as none."""
    inputs, labels = _tokens(3, 2)
    outs = []
    for mask in (None, [True, False]):
        params = params_from_numpy(np_params)
        leaves = [params["lm_head"], params["layers"]["wq"], params["layers"]["w2"]]
        for t in leaves:
            t.requires_grad_()
        logits = llama_forward(params, torch.from_numpy(inputs).long(), SMALL,
                               compute_dtype=torch.float32, attn_impl="xla", ac_mask=mask)
        cross_entropy_loss(logits, torch.from_numpy(labels)).backward()
        outs.append([logits.detach()] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        assert torch.allclose(a, b, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _j_setup(cfg_kw):
    cfg = JTrainConfig(**cfg_kw)
    mesh = build_mesh(MeshConfig.from_train_config(cfg))
    opt = j_step.make_optimizer(cfg)
    state, _ = j_step.init_train_state(jax.random.PRNGKey(0), J_SMALL, cfg, mesh, opt)
    return state, j_step.make_train_step(J_SMALL, cfg, mesh, opt)


_STEP_KW = dict(seq_length=SEQ, batch_size=8, num_steps=20, vocab_size=512,
                attention_kernel="xla", sharding_strategy="fsdp", learning_rate=1e-3)


def _run_both(cfg_kw, n_steps):
    jstate, jfn = _j_setup(cfg_kw)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]))
    tstate = state_from_params(params, TrainConfig(**cfg_kw))
    tfn = make_train_step(SMALL, TrainConfig(**cfg_kw))
    rows = []
    for i in range(n_steps):
        inputs, labels = _tokens(10 + i, 8)
        jstate, jm = jfn(jstate, (jnp.asarray(inputs), jnp.asarray(labels)))
        tm = tfn(tstate, (torch.from_numpy(inputs).long(), torch.from_numpy(labels).long()))
        rows.append(({k: float(jm[k]) for k in ("loss", "gnorm", "lr")},
                     {k: float(tm[k]) for k in ("loss", "gnorm", "lr")}))
    return rows


def test_train_step_matches_jax_fp32():
    """Three fp32 steps from the same weights and tokens. JAX's step runs
    over the 8-device CPU mesh of tests/conftest.py, so its sums go in
    another order, and Adam's first update (lr is 0 at step 0 of the
    warmup, so step 1) moves each weight by about lr * sign(g), where a
    gradient element near zero could take the other sign. Measured: loss
    within 1e-7 and gnorm within 6e-7 relative over the three steps, so
    1e-5 relative holds either effect with room; the loss itself moves
    1.3e-3 relative over the steps."""
    rows = _run_both(dict(_STEP_KW, mixed_precision=False), 3)
    for i, (j, t) in enumerate(rows):
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6, abs=1e-12), i
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5), (i, j, t)
        assert t["gnorm"] == pytest.approx(j["gnorm"], rel=1e-5), (i, j, t)
    assert rows[-1][1]["loss"] < rows[0][1]["loss"]


def test_train_step_matches_jax_bf16_policy():
    """One bfSixteen step (fp32 params, bf16 forward and grads). bf16
    rounds at other places in the two frameworks (silu, the norm products,
    the matmul outputs): measured 1.6e-5 (loss) and 3e-5 (gnorm)
    relative; 1e-3 relative, about an eighth of a bf16 ulp of the loss."""
    (j, t), = _run_both(dict(_STEP_KW, mixed_precision=True), 1)
    assert t["loss"] == pytest.approx(j["loss"], rel=1e-3)
    assert t["gnorm"] == pytest.approx(j["gnorm"], rel=1e-3)


def test_nonfinite_guard_skips_the_update_bit_identically(np_params):
    cfg = TrainConfig(**dict(_STEP_KW, mixed_precision=False))
    state = state_from_params(params_from_numpy(np_params), cfg)
    step = make_train_step(SMALL, cfg)
    inputs, labels = _tokens(20, 2)
    batch = (torch.from_numpy(inputs).long(), torch.from_numpy(labels).long())
    assert step(state, batch)["nonfinite"] == 0.0  # moments exist now
    # poison: the embedding row of a token the clean batch lacks makes
    # every batch holding it NaN
    tok = next(t for t in range(512) if t not in set(inputs.ravel().tolist()))
    state["params"]["embedding"][tok] = float("nan")
    poisoned = (batch[0].clone(), batch[1])
    poisoned[0][0, 0] = tok
    opt = state["optimizer"]

    def snapshot():
        params = [t.clone() for t in (state["params"]["embedding"], state["params"]["lm_head"],
                                      *state["params"]["layers"].values())]
        moments = [{k: v.clone() for k, v in s.items()} for s in opt.state.values()]
        return params, moments

    before = snapshot()
    m = step(state, poisoned)
    after = snapshot()
    assert m["nonfinite"] == 1.0 and not np.isfinite(float(m["loss"]))
    assert state["step"] == 2
    for a, b in zip(before[0], after[0]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for sa, sb in zip(before[1], after[1]):
        for k in sa:
            assert torch.equal(sa[k].view(torch.int32) if sa[k].dim() else sa[k],
                               sb[k].view(torch.int32) if sb[k].dim() else sb[k]), k
    assert all(float(s["step"]) == 1.0 for s in opt.state.values())  # Adam's count
    # a clean batch updates again, and the loop counts the one skipped batch
    guard = AnomalyGuard(max_consecutive=2)
    assert guard.observe([0.0, 1.0, 0.0]) == 1 and guard.skipped_batches == 1
    summary = train(cfg, state, step, 0, iter([batch, poisoned, batch]), start_step=2,
                    tokens_seen=0)
    assert summary["skipped_batches"] == 1 and summary["steps"] == 3
    assert np.isfinite(summary["final_loss"])


@pytest.mark.parametrize("family", ["llama", "mamba", "mixtral"])
def test_train_step_frees_its_compute_copy(family):
    """With the garbage collector off, a step leaves no tensor behind: the
    compute-dtype copy it differentiates is freed when the step returns,
    not at the next collection (a reference cycle held it, 6.3 GB a step
    at mixtral_8x7b width and 2 layers)."""
    import gc

    from fms_fsdp_tpu_torch.models.configs import MambaAttnConfig, MambaConfig, MixtralConfig
    from fms_fsdp_tpu_torch.train.step import init_train_state

    model = {
        "llama": SMALL,
        "mamba": MambaConfig(d_model=64, d_intermediate=128, n_layer=2, vocab_size=128,
                             attn_layer_idx=(1,), d_state=16, headdim=16, chunk_size=8,
                             attn_cfg=MambaAttnConfig(head_dim=16, num_heads=4,
                                                      num_heads_kv=2, rotary_emb_dim=8)),
        "mixtral": MixtralConfig(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2,
                                 nlayers=2, hidden_dim=96, num_experts=4),
    }[family]
    cfg = TrainConfig(seq_length=32, batch_size=2, vocab_size=128, attention_kernel="xla",
                      mamba_kernel="xla", fsdp_activation_checkpointing=True,
                      selective_checkpointing=0.5)
    state = init_train_state(torch.Generator().manual_seed(0), model, cfg)
    step = make_train_step(model, cfg)
    inputs, labels = _tokens(40, 2, seq=32, vocab=128)
    batch = (torch.from_numpy(inputs).long(), torch.from_numpy(labels).long())

    def live():
        return sum(1 for o in gc.get_objects() if isinstance(o, torch.Tensor))

    step(state, batch)
    gc.collect()
    gc.disable()
    try:
        counts = []
        for _ in range(3):
            step(state, batch)
            counts.append(live())
    finally:
        gc.enable()
    assert counts[0] == counts[1] == counts[2], counts


def test_train_takes_the_device_from_the_state():
    """Without ``device=``, ``train`` takes the device of the state's
    parameters (a card state then gets its synchronize before each window's
    clock and its MFU); Llama's stacked layer dict and Mamba's layer list
    alike."""
    meta = torch.empty(2, device="meta")
    assert state_device({"params": {"embedding": meta, "layers": {}}}) == meta.device
    assert state_device({"params": {"layers": [{"mixer": {"A": meta}}]}}) == meta.device
    cpu = torch.zeros(1)
    assert state_device({"params": {"layers": {"wq": cpu}}}) == torch.device("cpu")

    cfg = TrainConfig(num_steps=2, report_interval=1)
    batches = iter([None] * 3)

    def step_fn(state, batch):
        state["step"] += 1
        one = torch.ones((), device=state_device(state))
        return {"loss": one, "gnorm": one, "lr": one, "nonfinite": one * 0}

    state = {"params": {"embedding": cpu}, "step": 0}
    out = train(cfg, state, step_fn, 1, batches, model_cfg=LlamaConfig())
    assert out["steps"] == 2 and state["step"] == 2
    assert all(r["mfu"] is None for r in out["reports"])  # a CPU state


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_entry_trains_on_cpu(capsys, tmp_path):
    out = main(device="cpu", model_variant="llama3_194m_4k", use_dummy_dataset=True,
               ckpt_save_path=str(tmp_path), ckpt_load_path=str(tmp_path),
               num_steps=4, report_interval=2, batch_size=2, seq_length=SEQ,
               vocab_size=512, learning_rate=1e-3, fsdp_activation_checkpointing=True,
               selective_checkpointing=0.5, **_ENTRY_OVERRIDES)
    losses = [r["loss"] for r in out["reports"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert out["skipped_batches"] == 0
    printed = capsys.readouterr().out
    assert "step: 4" in printed and "current token per chip per sec:" in printed


# JAX's report lines, in its order (tests/test_obs.py:737-741)
_JAX_REPORT_LABELS = [
    "step:", "loss:", "LR:", "tokens seen:", "gradient norm:",
    "reserved memory:", "allocated memory:", "current step time:",
    "overall step time:", "current token per chip per sec:",
    "overall token per chip per sec:", "overall token per day:",
]


def _report_labels(printed):
    return [lbl for ln in printed.splitlines() for lbl in _JAX_REPORT_LABELS
            if ln.startswith(lbl)]


def test_entry_report_lines_match_jax(capsys, tmp_path):
    """Three steps at report interval 2: a boundary window and the drain of
    the last step, each printing JAX's labels in JAX's order."""
    out = main(device="cpu", model_variant="llama3_194m_4k", use_dummy_dataset=True,
               ckpt_save_path=str(tmp_path), ckpt_load_path=str(tmp_path),
               num_steps=3, report_interval=2, batch_size=1, seq_length=SEQ,
               vocab_size=512, **_ENTRY_OVERRIDES)
    printed = capsys.readouterr().out
    assert len(out["reports"]) == 2
    assert _report_labels(printed) == 2 * _JAX_REPORT_LABELS, printed
    assert "report window poisoned" not in printed
    rates = [int(ln.split(":")[1]) for ln in printed.splitlines()
             if ln.startswith(("overall token per chip per sec:", "overall token per day:"))]
    assert len(rates) == 4 and all(r > 0 for r in rates)


def test_poisoned_first_window_prints_minus_one(capsys):
    """A first window whose every step is non-finite has no clean loss to
    carry: JAX prints -1.0 for loss and gradient norm, and the poisoned
    line before the step."""
    cfg = TrainConfig(num_steps=4, report_interval=2)

    def step_fn(state, batch):
        bad = torch.tensor(float(batch))
        return {"loss": torch.tensor(2.5) if not batch else bad * float("nan"),
                "gnorm": torch.tensor(1.5), "lr": torch.tensor(1e-3), "nonfinite": bad}

    state = {"params": {"embedding": torch.zeros(1)}, "step": 0}
    out = train(cfg, state, step_fn, 0, iter([1, 1, 0, 0]))
    printed = capsys.readouterr().out.splitlines()
    first = printed.index("step: 2")
    assert printed[first - 1] == ("report window poisoned: all 2 step(s) non-finite; "
                                  "carrying last clean loss")
    assert printed[first + 1] == "loss: -1.0"
    assert "gradient norm: -1.0" in printed
    assert out["reports"][0]["loss"] == -1.0
    assert out["reports"][1]["loss"] == 2.5 and out["final_loss"] == 2.5
    assert printed.count("report window poisoned: all 2 step(s) non-finite; "
                         "carrying last clean loss") == 1
    assert _report_labels("\n".join(printed)) == 2 * _JAX_REPORT_LABELS


def test_entry_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would train on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(use_dummy_dataset=True, num_steps=1, **_ENTRY_OVERRIDES)


@pytest.mark.parametrize("overrides,item", [
    ({"tensor_parallel_size": 2}, "A.6b"),
    ({"expert_parallel_size": 2}, "A.4b"),
    ({"sharding_strategy": "tp"}, "A.6b"),
    ({"model_variant": "mamba_9.8b", "tensor_parallel_size": 2}, "A.6b"),
    ({"num_slices": 2}, "A.6b"),
])
def test_unported_options_raise(overrides, item, tmp_path):
    """Options the port does not run yet raise naming their ROADMAP.md
    item. Tensor parallelism runs: a tensor axis of 2 needs a world it
    divides (a world of one raises JAX's mesh error), and ``"tp"`` at
    ``tensor_parallel_size=1`` trains as fsdp."""
    kw = dict(use_dummy_dataset=True, num_steps=4, **_ENTRY_OVERRIDES)
    kw.update(overrides)
    if kw.get("tensor_parallel_size", 1) > 1:
        with pytest.raises(ValueError, match="not divisible by tensor"):
            main(device="cpu", **kw)
        return
    if kw.get("sharding_strategy") == "tp":
        from fms_fsdp_tpu_torch.parallel.mesh import axis_sizes

        res = main(device="cpu", **dict(kw, seq_length=64, batch_size=2, vocab_size=512,
                                         attention_kernel="xla",
                                         ckpt_save_path=str(tmp_path / "ck"),
                                         ckpt_load_path=str(tmp_path / "ck")))
        assert axis_sizes(res["mesh"])["tensor"] == 1 and res["steps"] == 4
        return
    with pytest.raises(NotImplementedError, match=item):
        main(device="cpu", **kw)


@pytest.mark.parametrize("variant", ["llama2_7b", "mamba_9.8b"])
def test_entry_accepts_context_parallel(variant):
    """Llama and Mamba take ``context_parallel_size=2``: no refusal; on a
    world of one the mesh then says, in JAX's words, that two context
    ranks do not fit (tests/test_torch_multiprocess.py trains them on two
    and four gloo ranks), and a step on a state without a context group
    raises rather than train the whole sequence on each rank."""
    check_supported(TrainConfig(model_variant=variant, context_parallel_size=2))
    kw = dict(use_dummy_dataset=True, num_steps=1, **_ENTRY_OVERRIDES)
    if variant != "llama2_7b":
        kw = {k: v for k, v in kw.items() if not k.startswith("LlamaConfig.")}
        kw.update(_MAMBA_ENTRY, vocab_size=128)
    with pytest.raises(ValueError, match="not divisible by tensor\\*context\\*expert = 2"):
        main(device="cpu", model_variant=variant, context_parallel_size=2, **kw)
    if variant == "llama2_7b":
        cfg = TrainConfig(context_parallel_size=2, attention_kernel="xla")
        model_cfg = LlamaConfig(nlayers=1, emb_dim=32, nheads=2, kvheads=1,
                                src_vocab_size=64, multiple_of=16)
        state = init_train_state(torch.Generator().manual_seed(0), model_cfg, cfg)
        step = make_train_step(model_cfg, cfg)
        batch = (torch.zeros(1, 8, dtype=torch.long), torch.zeros(1, 8, dtype=torch.long))
        with pytest.raises(ValueError, match="context axis has 2 ranks"):
            step(state, batch)


_MAMBA_ENTRY = {"MambaConfig.d_model": 64, "MambaConfig.d_intermediate": 128,
                "MambaConfig.n_layer": 2, "MambaConfig.vocab_size": 128,
                "MambaConfig.attn_layer_idx": (1,), "MambaConfig.d_state": 16,
                "MambaConfig.headdim": 16, "MambaConfig.chunk_size": 8,
                "MambaConfig.attn_cfg": MambaAttnConfig(head_dim=16, num_heads=4,
                                                        num_heads_kv=2, rotary_emb_dim=8)}
_MIXTRAL_ENTRY = {"MixtralConfig.nlayers": 2, "MixtralConfig.emb_dim": 64,
                  "MixtralConfig.nheads": 4, "MixtralConfig.kvheads": 2,
                  "MixtralConfig.hidden_dim": 96, "MixtralConfig.num_experts": 4,
                  "MixtralConfig.src_vocab_size": 128}


@pytest.mark.parametrize("family,overrides", [
    ("llama", {"quantized_matmuls": "int8"}),
    ("llama", {"quantized_matmuls": "fp8_dgrad"}),
    ("llama", {"quantized_reduce": "fp8_delayed"}),
    ("mamba", {"quantized_matmuls": "int8"}),
    ("mixtral", {"quantized_matmuls": "fp8", "quantized_reduce": "int8"}),
])
def test_entry_trains_quantized(family, overrides, tmp_path):
    """The quantized modes once refused here (ROADMAP.md A.7) train
    through each family's entry on the CPU: two finite steps, and the
    records name the modes that ran."""
    import json

    from fms_fsdp_tpu_torch import main_training_mamba, main_training_mixtral

    entry, model = {
        "llama": (main, dict(model_variant="llama3_194m_4k", vocab_size=512,
                             seq_length=64, **_ENTRY_OVERRIDES)),
        "mamba": (main_training_mamba.main, dict(model_variant="mamba_9.8b", vocab_size=128,
                                                 seq_length=32, mamba_kernel="xla",
                                                 **_MAMBA_ENTRY)),
        "mixtral": (main_training_mixtral.main, dict(model_variant="mixtral_8x7b",
                                                     vocab_size=128, seq_length=32,
                                                     **_MIXTRAL_ENTRY)),
    }[family]
    out = entry(device="cpu", use_dummy_dataset=True, num_steps=2, report_interval=1,
                batch_size=2, attention_kernel="xla", ckpt_save_path=str(tmp_path),
                ckpt_load_path=str(tmp_path), obs_dir=str(tmp_path / "obs"),
                **model, **overrides)
    losses = [r["loss"] for r in out["reports"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    with open(tmp_path / "obs" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records and all(
        r["quantized_matmuls"] == overrides.get("quantized_matmuls", "none")
        and r["quantized_reduce"] == overrides.get("quantized_reduce", "none")
        for r in records)
    if overrides.get("quantized_reduce") == "fp8_delayed":
        rows = out["state"]["quant"]["amax_history"]
        assert "g.layers.wq" in rows and all(float(r[0]) > 0 for r in rows.values())


def test_cli_and_overrides_match_jax():
    from fms_fsdp_tpu.utils.cli import parse_cli_args as j_parse
    from fms_fsdp_tpu.utils.config_utils import get_model_config as j_get
    from fms_fsdp_tpu.utils.config_utils import update_config as j_update

    argv = ["--model_variant=llama3_8b_4k", "--LlamaConfig.nlayers=8", "--batch_size", "2",
            "--use_dummy_dataset=True", "--selective_checkpointing=1/2", "--tracker=none"]
    kw = parse_cli_args(argv)
    assert kw == j_parse(argv)
    cfg, jcfg = TrainConfig(), JTrainConfig()
    update_config(cfg, **kw)
    j_update(jcfg, **kw)
    assert vars(cfg) == vars(jcfg)
    m, jm = get_model_config(cfg.model_variant), j_get(cfg.model_variant)
    update_config(m, **kw)
    j_update(jm, **kw)
    assert vars(m) == vars(jm) and m.nlayers == 8 and m.hidden_dim == 14336
