"""PyTorch port, native eval slice (``eval_ppl.py``): held against the JAX
package on the CPU.

The eval step against JAX's ``make_eval_step`` for Llama, the Mamba
hybrid and Mixtral (dense) on the same weights (JAX's init, bridged) and
the same numpy-seeded batch: summed NLL within fp32 rtol 1e-5 and the
token counts equal. The entry mirrors tests/test_eval_ppl.py and
tests/test_eval_arrow.py on checkpoints the port's Llama trainer wrote,
and a 2-rank gloo world (tests/torch_mp_child.py) returns the 1-rank
sums.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval_ppl as j_eval
from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init_llama
from fms_fsdp_tpu.models.mamba import init_mamba_params as j_init_mamba
from fms_fsdp_tpu.models.mixtral import init_mixtral_params as j_init_mixtral
from fms_fsdp_tpu_torch import eval_ppl, main_training_llama
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.models.configs import (
    LlamaConfig,
    MambaAttnConfig,
    MambaConfig,
    MixtralConfig,
)

_MAMBA_ATTN = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_FAMILIES = {
    "llama": (JLlamaConfig, LlamaConfig, j_init_llama, 128,
              dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                   multiple_of=16, max_expected_seq_len=64)),
    "mamba": (JMambaConfig, MambaConfig, j_init_mamba, 256,
              dict(d_model=64, d_intermediate=128, n_layer=3, vocab_size=256,
                   attn_layer_idx=(1,), d_state=16, headdim=16, chunk_size=16)),
    "mixtral": (JMixtralConfig, MixtralConfig, j_init_mixtral, 128,
                dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                     hidden_dim=96, num_experts=4, top_k=2, max_expected_seq_len=64)),
}

# the Llama entry runs of tests/test_eval_ppl.py
TINY = {
    "LlamaConfig.nlayers": 2, "LlamaConfig.emb_dim": 64, "LlamaConfig.nheads": 4,
    "LlamaConfig.kvheads": 2, "LlamaConfig.src_vocab_size": 256,
    "LlamaConfig.multiple_of": 16, "LlamaConfig.max_expected_seq_len": 64,
}
COMMON = dict(model_variant="llama2_7b", use_dummy_dataset=True, seq_length=64,
              vocab_size=256, batch_size=2, attention_kernel="xla", **TINY)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _batch(vocab, seed=0, b=2, s=32):
    """Inputs and labels (the next token), a quarter of the labels ignored."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s + 1))
    labels = toks[:, 1:].copy()
    labels[rng.random(labels.shape) < 0.25] = -100
    return toks[:, :-1], labels


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_eval_step_matches_jax_fp32(family):
    jcls, tcls, j_init, vocab, kw = _FAMILIES[family]
    if family == "mamba":
        jcfg = jcls(**kw, attn_cfg=JMambaAttnConfig(**_MAMBA_ATTN))
        cfg = tcls(**kw, attn_cfg=MambaAttnConfig(**_MAMBA_ATTN))
    else:
        jcfg, cfg = jcls(**kw), tcls(**kw)
    run = dict(mixed_precision=False, attention_kernel="xla")
    np_params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
    inputs, labels = _batch(vocab)
    j_step = j_eval.make_eval_step(jcfg, JTrainConfig(**run), None)
    want_nll, want_count = j_step(jax.tree.map(jnp.asarray, np_params),
                                  (jnp.asarray(inputs), jnp.asarray(labels)))
    step = eval_ppl.make_eval_step(cfg, TrainConfig(**run))
    params = params_from_numpy(np_params)
    nll, count = step(params, (torch.from_numpy(inputs), torch.from_numpy(labels)))
    assert int(count) == int(want_count) == int((labels != -100).sum())
    assert float(nll) == pytest.approx(float(want_nll), rel=1e-5)


def test_eval_step_saves_nothing_for_backward():
    """Params that require grad still give a result with no graph: the
    step runs under no_grad."""
    jcls, tcls, j_init, vocab, kw = _FAMILIES["llama"]
    params = params_from_numpy(jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcls(**kw))))
    params["embedding"].requires_grad_(True)
    step = eval_ppl.make_eval_step(tcls(**kw), TrainConfig(attention_kernel="xla"))
    inputs, labels = _batch(vocab)
    nll, _ = step(params, (torch.from_numpy(inputs), torch.from_numpy(labels)))
    assert nll.grad_fn is None and not nll.requires_grad


def test_eval_ppl_from_entry_checkpoint(tmp_path, capsys):
    """tests/test_eval_ppl.py on the port: a checkpoint the Llama trainer
    wrote scores better than uniform and clearly better than a fresh init
    on the same stream; a load path without a checkpoint raises."""
    ckpt = str(tmp_path / "ckpt")
    main_training_llama.main(device="cpu", num_steps=30, report_interval=10,
                             checkpoint_interval=30, ckpt_save_path=ckpt,
                             ckpt_load_path=ckpt, **COMMON)
    capsys.readouterr()
    trained = eval_ppl.main(device="cpu", ckpt_load_path=ckpt, eval_batches=4, **COMMON)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == trained
    assert sorted(trained) == ["model_variant", "nll", "ppl", "tokens"]
    assert trained["tokens"] == 4 * 2 * 64
    assert 0 < trained["ppl"] < 256
    fresh = eval_ppl.main(device="cpu", ckpt_load_path="", eval_batches=4, **COMMON)
    assert fresh["ppl"] > trained["ppl"] * 1.5, (fresh, trained)
    # the step dir itself loads the same params
    step_dir = str(tmp_path / "ckpt" / "checkpoints" / "step_30_ckp")
    again = eval_ppl.main(device="cpu", ckpt_load_path=step_dir, eval_batches=4, **COMMON)
    assert again == trained
    with pytest.raises(AssertionError, match="no checkpoint"):
        eval_ppl.main(device="cpu", ckpt_load_path=str(tmp_path / "nowhere"),
                      eval_batches=1, **COMMON)


def test_eval_ppl_falls_after_training_on_arrow(tmp_path):
    """tests/test_eval_arrow.py on the port: a real arrow corpus through
    the streaming loader, the trainer and eval; perplexity falls against
    the fresh init on the same stream."""
    from fms_fsdp_tpu_torch.data.synth import build_arrow_corpus

    corpus = build_arrow_corpus(tmp_path / "data", n_shards=2, docs_per_shard=80)
    data = dict(COMMON, use_dummy_dataset=False, data_path=corpus, datasets="dataset_1",
                weights="1", file_type="arrow", logical_shards=8)
    fresh = eval_ppl.main(device="cpu", eval_batches=8, ckpt_load_path="", **data)
    assert fresh["tokens"] > 0
    ckpt = str(tmp_path / "ckpt")
    main_training_llama.main(device="cpu", num_steps=80, learning_rate=1e-3,
                             report_interval=40, checkpoint_interval=80,
                             ckpt_save_path=ckpt, ckpt_load_path=ckpt, **data)
    trained = eval_ppl.main(device="cpu", eval_batches=8, ckpt_load_path=ckpt, **data)
    assert trained["ppl"] < 0.9 * fresh["ppl"], (fresh, trained)


def test_eval_ppl_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_ppl.main(ckpt_load_path="", eval_batches=1, **COMMON)


def test_eval_two_ranks_return_the_one_rank_sums(tmp_path):
    """2 gloo ranks, each evaluating its 2 rows of every 4-row batch (the
    ranks' shares of ignored labels unlike), all-reduce to the sums of one
    process over the whole batches: equal token counts and nll."""
    from test_torch_multiprocess import _run

    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, size=(3, 4, 64))
    labels = rng.integers(0, 256, size=(3, 4, 64))
    labels[:, :2][rng.random((3, 2, 64)) < 0.6] = -100
    np.savez(tmp_path / "batches.npz", inputs=toks, labels=labels)
    results = {}
    for world in (1, 2):
        spec = {"out": str(tmp_path / f"out{world}"), "eval": True,
                "batches": str(tmp_path / "batches.npz"),
                "main": dict(COMMON, batch_size=4 // world, eval_batches=3,
                             ckpt_load_path="", mixed_precision=False)}
        results[world], _ = _run(world, spec, tmp_path)
    one = results[1][0]["eval"]
    assert one["tokens"] == int((labels != -100).sum())
    for r in results[2]:
        assert r["eval"]["tokens"] == one["tokens"]
        assert r["eval"]["nll"] == pytest.approx(one["nll"], rel=1e-6)

