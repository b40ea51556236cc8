"""PyTorch port, HF interop slice: held against the JAX package and
transformers on the CPU.

The TINY configs of tests/test_hf_import.py and tests/test_converters.py.
Weights come from JAX's init (or a seeded transformers model) and reach
the port through the bridge. Tolerances: the exporters' state dicts and
the importers' trees bitwise equal to JAX's on the same weights; the
``*_config_from_hf`` configs equal field by field; ``gpt_bigcode_forward``
2e-5 against JAX's at fp32 and 2e-4 against transformers (JAX's own,
tests/test_hf_import.py:93); the export -> ``save_pretrained`` ->
``load_hf_base`` round trip bitwise in the params and 1e-5 in the logits;
Llama and Mixtral 2e-4 against transformers. transformers is imported
inside each test, never by the port at module level.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fms_to_hf_llama as j_to_llama
import fms_to_hf_mamba as j_to_mamba
import fms_to_hf_mixtral as j_to_mixtral
from fms_fsdp_tpu.models import gpt_bigcode as jgb
from fms_fsdp_tpu.models import hf_import as jhf
from fms_fsdp_tpu.models.configs import LlamaConfig as JLlamaConfig
from fms_fsdp_tpu.models.configs import MambaAttnConfig as JMambaAttnConfig
from fms_fsdp_tpu.models.configs import MambaConfig as JMambaConfig
from fms_fsdp_tpu.models.configs import MixtralConfig as JMixtralConfig
from fms_fsdp_tpu.models.llama import init_llama_params as j_init_llama
from fms_fsdp_tpu.models.mamba import init_mamba_params as j_init_mamba
from fms_fsdp_tpu.models.mixtral import init_mixtral_params as j_init_mixtral
from fms_fsdp_tpu_torch import fms_to_hf_llama as t_to_llama
from fms_fsdp_tpu_torch import fms_to_hf_mamba as t_to_mamba
from fms_fsdp_tpu_torch import fms_to_hf_mixtral as t_to_mixtral
from fms_fsdp_tpu_torch.bridge import params_from_numpy, params_to_numpy
from fms_fsdp_tpu_torch.ckpt.state import flatten
from fms_fsdp_tpu_torch.models import gpt_bigcode as tgb
from fms_fsdp_tpu_torch.models import hf_import as thf
from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MambaAttnConfig, MambaConfig
from fms_fsdp_tpu_torch.models.configs import MixtralConfig
from fms_fsdp_tpu_torch.models.llama import llama_forward
from fms_fsdp_tpu_torch.models.mixtral import mixtral_forward
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_LLAMA_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                 multiple_of=16, max_expected_seq_len=64)
_MIX_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
               hidden_dim=96, num_experts=4, top_k=2, max_expected_seq_len=64)
_MAMBA_KW = dict(d_model=64, d_intermediate=128, n_layer=3, vocab_size=256,
                 attn_layer_idx=(1,), d_state=16, headdim=16, chunk_size=16)
_MAMBA_ATTN = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_BIGCODE_KW = dict(src_vocab_size=96, emb_dim=64, nheads=4, nlayers=2,
                   max_expected_seq_len=64)
_HF_BIGCODE = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4,
                   n_inner=128, multi_query=True, attn_pdrop=0.0, resid_pdrop=0.0,
                   embd_pdrop=0.0)
_HF_MIXTRAL = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   num_local_experts=4, num_experts_per_tok=2, max_position_embeddings=64,
                   rope_theta=10000.0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _np_tree(tree):
    """A JAX tree as numpy fp32 (bf16 widens exactly)."""
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), tree)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten("p", tree, {}).items()}


def _assert_bitwise(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _llama_params(dtype=np.float32):
    j = j_init_llama(jax.random.PRNGKey(0), JLlamaConfig(**_LLAMA_KW))
    return jax.tree.map(lambda a: np.asarray(a).astype(dtype), j)


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


# ---------------------------------------------------------------------------
# the exporters: bitwise against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_state_dict_bitwise_vs_jax(dtype):
    np_params = _llama_params()
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype=dtype), np_params)
    want = j_to_llama.params_to_hf_state_dict(jparams, JLlamaConfig(**_LLAMA_KW))
    got = t_to_llama.params_to_hf_state_dict(
        params_from_numpy(np_params, dtype=getattr(torch, dtype)), LlamaConfig(**_LLAMA_KW))
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in got.values())
    _assert_bitwise({k: v.numpy() for k, v in got.items()}, want)


def test_mixtral_state_dict_bitwise_vs_jax():
    jcfg, cfg = JMixtralConfig(**_MIX_KW), MixtralConfig(**_MIX_KW)
    np_params = jax.tree.map(np.asarray, j_init_mixtral(jax.random.PRNGKey(0), jcfg))
    want = j_to_mixtral.params_to_hf_state_dict(np_params, jcfg)
    got = t_to_mixtral.params_to_hf_state_dict(params_from_numpy(np_params), cfg)
    _assert_bitwise({k: v.numpy() for k, v in got.items()}, want)


def _mamba_cfgs():
    jcfg = JMambaConfig(**_MAMBA_KW, attn_cfg=JMambaAttnConfig(**_MAMBA_ATTN))
    cfg = MambaConfig(**_MAMBA_KW, attn_cfg=MambaAttnConfig(**_MAMBA_ATTN))
    return jcfg, cfg


def test_mamba_state_dict_bitwise_vs_jax(tmp_path):
    """The mamba_ssm export: bitwise JAX's, fc1 in [up; gate] row order,
    the fused attention in_proj, the (channels, 1, width) conv weight, the
    parameter count equal to the params'; save_pretrained's two files."""
    jcfg, cfg = _mamba_cfgs()
    np_params = jax.tree.map(np.asarray, j_init_mamba(jax.random.PRNGKey(0), jcfg))
    params = params_from_numpy(np_params)
    want = j_to_mamba.params_to_mamba_ssm_state_dict(np_params, jcfg)
    got = t_to_mamba.params_to_mamba_ssm_state_dict(params, cfg)
    _assert_bitwise({k: v.numpy() for k, v in got.items()}, want)
    fc1 = got["backbone.layers.0.mlp.fc1.weight"].numpy()
    np.testing.assert_array_equal(fc1[:128], np_params["layers"][0]["mlp"]["w3"].T)
    np.testing.assert_array_equal(fc1[128:], np_params["layers"][0]["mlp"]["w1"].T)
    assert got["backbone.layers.1.mixer.in_proj.weight"].shape == ((4 + 4) * 16, 64)
    assert got["backbone.layers.0.mixer.conv1d.weight"].ndim == 3
    assert sum(v.numel() for v in got.values()) == sum(
        t.numel() for t in flatten("p", params, {}).values())

    t_to_mamba.save_pretrained(params, cfg, str(tmp_path / "t"))
    j_to_mamba.save_pretrained(np_params, jcfg, str(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == ["config.json", "pytorch_model.bin"]
    with open(tmp_path / "t" / "config.json") as f, open(tmp_path / "j" / "config.json") as g:
        assert json.load(f) == json.load(g)
    saved = torch.load(tmp_path / "t" / "pytorch_model.bin")
    _assert_bitwise({k: v.numpy() for k, v in saved.items()}, want)


# ---------------------------------------------------------------------------
# the importers: bitwise against JAX's on the same transformers model
# ---------------------------------------------------------------------------


def _hf_model(arch):
    import transformers

    torch.manual_seed(0)
    if arch == "llama":
        return t_to_llama.convert_to_hf(params_from_numpy(_llama_params()),
                                        LlamaConfig(**_LLAMA_KW))
    if arch == "gpt_bigcode":
        cfg = transformers.GPTBigCodeConfig(**_HF_BIGCODE)
        return transformers.GPTBigCodeForCausalLM(cfg).eval()
    cfg = transformers.MixtralConfig(**_HF_MIXTRAL)
    return transformers.MixtralForCausalLM(cfg).eval()


_IMPORTERS = {
    "llama": ("llama_config_from_hf", "hf_to_llama_params"),
    "gpt_bigcode": ("gpt_bigcode_config_from_hf", "hf_to_gpt_bigcode_params"),
    "mixtral": ("mixtral_config_from_hf", "hf_to_mixtral_params"),
}


@pytest.mark.parametrize("arch", sorted(_IMPORTERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hf_to_params_bitwise_vs_jax(arch, dtype):
    model = _hf_model(arch)
    cfg_fn, map_fn = _IMPORTERS[arch]
    jcfg = getattr(jhf, cfg_fn)(model.config)
    cfg = getattr(thf, cfg_fn)(model.config)
    want = _np_tree(getattr(jhf, map_fn)(model, jcfg, dtype=getattr(jnp, dtype)))
    got = getattr(thf, map_fn)(model, cfg, dtype=getattr(torch, dtype))
    assert all(t.dtype == getattr(torch, dtype) and t.is_contiguous()
               for t in flatten("p", got, {}).values())
    _assert_bitwise(params_to_numpy(got), want)


# ---------------------------------------------------------------------------
# the configs, field by field
# ---------------------------------------------------------------------------


def _hf_configs():
    import transformers

    return {
        # 113 / 100 truncates to 112 without the +0.5 rule
        "llama_gqa": transformers.LlamaConfig(
            vocab_size=128, hidden_size=100, intermediate_size=113, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
            rms_norm_eps=1e-6, rope_theta=5e5),
        "llama_mha": transformers.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=171, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=32),
        "gpt_bigcode": transformers.GPTBigCodeConfig(**_HF_BIGCODE),
        "gpt_bigcode_default_inner": transformers.GPTBigCodeConfig(
            **dict(_HF_BIGCODE, n_inner=None, layer_norm_epsilon=1e-6)),
        "mixtral": transformers.MixtralConfig(**dict(_HF_MIXTRAL, router_aux_loss_coef=0.05)),
    }


_CONFIG_CASES = {"llama_gqa": "llama", "llama_mha": "llama", "gpt_bigcode": "gpt_bigcode",
                 "gpt_bigcode_default_inner": "gpt_bigcode", "mixtral": "mixtral"}


@pytest.mark.parametrize("case", sorted(_CONFIG_CASES))
def test_config_from_hf_matches_jax(case):
    hf_cfg = _hf_configs()[case]
    cfg_fn = _IMPORTERS[_CONFIG_CASES[case]][0]
    want = getattr(jhf, cfg_fn)(hf_cfg)
    got = getattr(thf, cfg_fn)(hf_cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if case == "llama_gqa":
        assert got.hidden_dim == want.hidden_dim == 113
        assert int(100 * (113 / 100)) == 112  # the truncation the rule avoids
    if case.startswith("gpt"):
        assert got.hidden_dim == want.hidden_dim == (128 if case == "gpt_bigcode" else 256)


def test_gpt_bigcode_full_mha_refused_as_jax():
    import transformers

    hf_cfg = transformers.GPTBigCodeConfig(**dict(_HF_BIGCODE, multi_query=False))
    for fn in (jhf.gpt_bigcode_config_from_hf, thf.gpt_bigcode_config_from_hf):
        with pytest.raises(ValueError, match="multi_query=True"):
            fn(hf_cfg)


def test_load_hf_base_refuses_unsupported_arch(tmp_path):
    import transformers

    transformers.GPT2Config(n_embd=32, n_layer=1, n_head=2).save_pretrained(tmp_path)
    assert thf.is_hf_checkpoint(str(tmp_path))
    assert not thf.is_hf_checkpoint(str(tmp_path / "config.json"))
    with pytest.raises(ValueError, match="unsupported HF base architecture 'gpt2'"):
        thf.load_hf_base(str(tmp_path))


# ---------------------------------------------------------------------------
# GPTBigCode
# ---------------------------------------------------------------------------


def _bigcode_params():
    jcfg, cfg = jgb.GPTBigCodeConfig(**_BIGCODE_KW), tgb.GPTBigCodeConfig(**_BIGCODE_KW)
    np_params = jax.tree.map(np.asarray, jgb.init_gpt_bigcode_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, np_params


def test_gpt_bigcode_config_and_init_match_jax():
    jcfg, cfg, np_params = _bigcode_params()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.head_dim, cfg.hidden_dim) == (jcfg.head_dim, jcfg.hidden_dim)
    assert dataclasses.asdict(tgb.GPTBigCodeConfig()) == dataclasses.asdict(jgb.GPTBigCodeConfig())
    got = tgb.init_gpt_bigcode_params(torch.Generator().manual_seed(0), cfg)
    want = _flat(np_params)
    for key, t in flatten("p", got, {}).items():
        assert tuple(t.shape) == want[key].shape and t.dtype == torch.float32, key
    assert sorted(flatten("p", got, {})) == sorted(want)
    for name in ("ln1_w", "ln2_w"):
        assert bool((got["layers"][name] == 1).all())
    assert abs(float(got["layers"]["c_fc"].std()) - 0.02) < 3e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_gpt_bigcode_tree(dtype):
    """JAX's GPTBigCode tree (wte, wpe, stacked layers.*, ln_f_*) crosses
    the bridge and back bitwise, leaf for leaf, in its dtype."""
    jcfg, _, _ = _bigcode_params()
    jparams = jgb.init_gpt_bigcode_params(jax.random.PRNGKey(0), jcfg,
                                          dtype=getattr(jnp, dtype))
    params = params_from_numpy(_np_tree(jparams), dtype=getattr(torch, dtype))
    assert sorted(params) == ["layers", "ln_f_b", "ln_f_w", "wpe", "wte"]
    assert tuple(params["layers"]["c_attn"].shape) == (2, 64, 64 + 2 * 16)
    assert all(t.dtype == getattr(torch, dtype) for t in flatten("p", params, {}).values())
    _assert_bitwise(params_to_numpy(params), _np_tree(jparams))


def test_gpt_bigcode_forward_matches_jax_fp32():
    jcfg, cfg, np_params = _bigcode_params()
    ids = _tokens((2, 12), 96)
    jp = jax.tree.map(jnp.asarray, np_params)
    want_logits, want_embeds = jgb.gpt_bigcode_forward(
        jp, jnp.asarray(ids), jcfg, compute_dtype=jnp.float32, return_embeds=True)
    params, tokens = params_from_numpy(np_params), torch.from_numpy(ids)
    logits, embeds = tgb.gpt_bigcode_forward(params, tokens, cfg, compute_dtype=torch.float32,
                                             return_embeds=True, attn_impl="pallas")
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=2e-5)
    np.testing.assert_allclose(embeds.numpy(), np.asarray(want_embeds), atol=2e-5)
    hidden = tgb.gpt_bigcode_forward(params, tokens, cfg, compute_dtype=torch.float32,
                                     return_hidden=True)
    np.testing.assert_array_equal(hidden.numpy(), embeds.numpy())
    with pytest.raises(AssertionError, match="max_expected_seq_len"):
        tgb.gpt_bigcode_forward(params, torch.zeros((1, 65), dtype=torch.long), cfg)


def test_gpt_bigcode_matches_transformers(tmp_path):
    """load_hf_base on a saved transformers GPTBigCode, the port's forward
    against transformers' at fp32 (JAX's test and tolerance)."""
    model = _hf_model("gpt_bigcode")
    path = str(tmp_path / "hf_bigcode")
    model.save_pretrained(path, safe_serialization=True)
    arch, cfg, params = thf.load_hf_base(path, dtype=torch.float32)
    assert arch == "gpt_bigcode" and isinstance(cfg, tgb.GPTBigCodeConfig)
    ids = np.arange(24).reshape(2, 12) % 96
    ours = tgb.gpt_bigcode_forward(params, torch.from_numpy(ids), cfg,
                                   compute_dtype=torch.float32)
    with torch.no_grad():
        theirs = model(torch.from_numpy(ids)).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=2e-4)


def test_gpt_bigcode_generate_simple_matches_prefix():
    """As JAX's test_generate_simple_matches_prefix: the prompt kept, the
    embeds of the positions that predicted each generated token; and the
    greedy tokens equal to JAX's at fp32."""
    jcfg, cfg, _ = _bigcode_params()
    jcfg = dataclasses.replace(jcfg, src_vocab_size=64, emb_dim=32, nheads=2,
                               max_expected_seq_len=32)
    cfg = tgb.GPTBigCodeConfig(**dataclasses.asdict(jcfg))
    np_params = jax.tree.map(np.asarray, jgb.init_gpt_bigcode_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_numpy(np_params)
    prompt = torch.arange(8)[None, :]

    def fwd(p, t, c, **kw):
        return tgb.gpt_bigcode_forward(p, t, c, compute_dtype=torch.float32, **kw)

    toks, embeds = tgb.generate_simple(params, prompt, cfg, fwd, max_new_tokens=4,
                                       include_embeds=True)
    assert tuple(toks.shape) == (1, 12) and tuple(embeds.shape) == (1, 4, 32)
    np.testing.assert_array_equal(toks[:, :8].numpy(), prompt.numpy())
    _, full = fwd(params, toks, cfg, return_embeds=True)
    np.testing.assert_allclose(embeds.numpy(), full[:, 7:11].numpy(), atol=1e-6)

    def jfwd(p, t, c, **kw):
        return jgb.gpt_bigcode_forward(p, t, c, compute_dtype=jnp.float32, **kw)

    jtoks = jgb.generate_simple(jax.tree.map(jnp.asarray, np_params),
                                jnp.arange(8, dtype=jnp.int32)[None, :], jcfg, jfwd,
                                key=jax.random.PRNGKey(1), max_new_tokens=4)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


# ---------------------------------------------------------------------------
# round trips and transformers parity
# ---------------------------------------------------------------------------


def test_llama_export_save_load_round_trip(tmp_path):
    """export -> save_pretrained -> load_hf_base: the params bitwise, the
    logits within 1e-5 (JAX's test_hf_llama_roundtrip_exact); the config
    back field by field."""
    params, cfg = params_from_numpy(_llama_params()), LlamaConfig(**_LLAMA_KW)
    path = str(tmp_path / "hf_llama")
    t_to_llama.convert_to_hf(params, cfg).save_pretrained(path, safe_serialization=True)
    assert thf.is_hf_checkpoint(path)
    arch, cfg2, params2 = thf.load_hf_base(path, dtype=torch.float32)
    assert arch == "llama"
    assert (cfg2.hidden_dim, cfg2.n_kv_heads, cfg2.nheads, cfg2.nlayers) == (
        cfg.hidden_dim, cfg.n_kv_heads, cfg.nheads, cfg.nlayers)
    _assert_bitwise(params_to_numpy(params2), params_to_numpy(params))
    tokens = torch.from_numpy(_tokens((2, 16), 128))
    a = llama_forward(params, tokens, cfg, compute_dtype=torch.float32, attn_impl="xla")
    b = llama_forward(params2, tokens, cfg2, compute_dtype=torch.float32, attn_impl="xla")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    # bf16 by default, the speculator base's dtype
    _, _, params_bf16 = thf.load_hf_base(path)
    assert params_bf16["embedding"].dtype == torch.bfloat16


def test_llama_matches_transformers():
    params, cfg = params_from_numpy(_llama_params()), LlamaConfig(**_LLAMA_KW)
    tokens = _tokens((2, 12), 128)
    ours = llama_forward(params, torch.from_numpy(tokens), cfg, attn_impl="xla",
                         compute_dtype=torch.float32)
    model = t_to_llama.convert_to_hf(params, cfg).eval()
    with torch.no_grad():
        theirs = model(torch.from_numpy(tokens)).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=2e-4)


def test_mixtral_matches_transformers_and_round_trips(tmp_path):
    """The port's dense mix against transformers' sparse block at fp32
    (2e-4), on the exported model and on a transformers model loaded back
    through load_hf_base; export -> import recovers the tree bitwise."""
    cfg = MixtralConfig(**_MIX_KW)
    np_params = jax.tree.map(np.asarray, j_init_mixtral(jax.random.PRNGKey(0),
                                                        JMixtralConfig(**_MIX_KW)))
    params = params_from_numpy(np_params)
    tokens = _tokens((2, 12), 128)
    ours = mixtral_forward(params, torch.from_numpy(tokens), cfg, attn_impl="xla",
                           compute_dtype=torch.float32, moe_impl="dense")
    model = t_to_mixtral.convert_to_hf(params, cfg).eval()
    with torch.no_grad():
        theirs = model(torch.from_numpy(tokens)).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=2e-4)
    assert thf.mixtral_config_from_hf(model.config) == cfg
    _assert_bitwise(params_to_numpy(thf.hf_to_mixtral_params(model, cfg, dtype=torch.float32)),
                    np_params)

    hf = _hf_model("mixtral")
    path = str(tmp_path / "hf_mixtral")
    hf.save_pretrained(path, safe_serialization=True)
    arch, cfg2, params2 = thf.load_hf_base(path, dtype=torch.float32)
    assert arch == "mixtral"
    ids = np.arange(24).reshape(2, 12) % 96
    ours = mixtral_forward(params2, torch.from_numpy(ids), cfg2, compute_dtype=torch.float32,
                           attn_impl="xla")
    with torch.no_grad():
        theirs = hf(torch.from_numpy(ids)).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=2e-4)


# ---------------------------------------------------------------------------
# the entries, from checkpoints the port's trainers wrote
# ---------------------------------------------------------------------------


def _train(main, tmp_path, model_kw, **run):
    ck = str(tmp_path / "ck")
    res = main(device="cpu", **model_kw, use_dummy_dataset=True, batch_size=2, seq_length=32,
               num_steps=2, report_interval=1, attention_kernel="xla", mixed_precision=False,
               ckpt_save_path=ck, ckpt_load_path=ck, **run)
    return ck, params_to_numpy(res["state"]["params"])


def _local_tokenizer(path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["<eos>", "a", "b", "c"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<eos>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<eos>").save_pretrained(path)


def test_fms_to_hf_llama_main_from_port_checkpoint(tmp_path, capsys):
    """The Llama trainer's checkpoint -> main -> transformers reads the
    directory back with the trained weights; a loader-only step dir with a
    higher number does not shadow the model checkpoint; the tokenizer is
    copied; load_hf_base gives the trained params bitwise."""
    from transformers import AutoTokenizer, LlamaForCausalLM

    from fms_fsdp_tpu_torch import main_training_llama

    model_kw = {f"LlamaConfig.{k}": v for k, v in _LLAMA_KW.items()}
    ck, want = _train(main_training_llama.main, tmp_path, model_kw, vocab_size=128)
    lo = os.path.join(ck, "checkpoints", "step_99_ckp")
    os.makedirs(lo)
    with open(os.path.join(lo, "loader_state_0.pkl"), "w") as f:
        f.write("x")
    _local_tokenizer(str(tmp_path / "tok"))
    out = str(tmp_path / "hf")
    t_to_llama.main(model_variant="llama2_7b", load_path=os.path.join(ck, "checkpoints"),
                    save_path=out, tokenizer_name_or_path=str(tmp_path / "tok"), **model_kw)
    printed = capsys.readouterr().out
    assert f"HF model saved to {out}" in printed and "Tokenizer copied." in printed
    assert any(name.endswith(".safetensors") for name in os.listdir(out))
    model = LlamaForCausalLM.from_pretrained(out, torch_dtype=torch.float32)
    np.testing.assert_array_equal(model.model.norm.weight.detach().numpy(), want["norm"])
    np.testing.assert_array_equal(model.lm_head.weight.detach().numpy(), want["lm_head"].T)
    assert AutoTokenizer.from_pretrained(out).convert_tokens_to_ids("b") == 2
    _, _, params = thf.load_hf_base(out, dtype=torch.float32)
    _assert_bitwise(params_to_numpy(params), want)


def test_fms_to_hf_mamba_and_mixtral_main_from_port_checkpoints(tmp_path):
    """Both other exporters' ``main`` on checkpoints the port's Mamba and
    Mixtral trainers wrote: the mamba_ssm files hold the trained weights
    under JAX's names (the count equal to the params'); the Mixtral HF
    directory loads back bitwise."""
    from fms_fsdp_tpu_torch import main_training_mamba, main_training_mixtral

    mamba_kw = {f"MambaConfig.{k}": v for k, v in _MAMBA_KW.items()}
    mamba_kw["MambaConfig.attn_cfg"] = MambaAttnConfig(**_MAMBA_ATTN)
    ck, want = _train(main_training_mamba.main, tmp_path / "m", mamba_kw, vocab_size=256)
    out = str(tmp_path / "mamba_out")
    t_to_mamba.main(load_path=ck + "/checkpoints", save_path=out, **mamba_kw)
    sd = torch.load(os.path.join(out, "pytorch_model.bin"))
    _, cfg = _mamba_cfgs()
    _assert_bitwise({k: v.numpy() for k, v in sd.items()},
                    {k: v.numpy() for k, v in t_to_mamba.params_to_mamba_ssm_state_dict(
                        params_from_numpy(want), cfg).items()})
    assert sum(v.numel() for v in sd.values()) == sum(a.size for a in _flat(want).values())
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == t_to_mamba.mamba_ssm_config_dict(cfg)

    mix_kw = {f"MixtralConfig.{k}": v for k, v in _MIX_KW.items()}
    ck, want = _train(main_training_mixtral.main, tmp_path / "x", mix_kw, vocab_size=128)
    out = str(tmp_path / "mixtral_out")
    t_to_mixtral.main(load_path=ck + "/checkpoints", save_path=out, **mix_kw)
    arch, cfg, params = thf.load_hf_base(out, dtype=torch.float32)
    assert arch == "mixtral" and cfg == MixtralConfig(**_MIX_KW)
    _assert_bitwise(params_to_numpy(params), want)


# ---------------------------------------------------------------------------
# transformers 5: the rotary base in rope_parameters,
# Mixtral's experts fused in the model
# ---------------------------------------------------------------------------


def test_rope_theta_read_and_written_where_transformers_keeps_it():
    """4.x keeps the rotary base in ``rope_theta``; 5 in
    ``rope_parameters`` (where its ``rope_theta`` keyword is not applied):
    the importers read, and the exporters write, both."""
    from types import SimpleNamespace

    assert thf.rope_theta_of(SimpleNamespace(rope_theta=5e5)) == 5e5
    assert thf.rope_theta_of(SimpleNamespace()) == 10000.0
    v5 = SimpleNamespace(rope_theta=5e5, rope_parameters={"rope_type": "default",
                                                          "rope_theta": 10000.0})
    assert thf.rope_theta_of(v5) == 10000.0
    assert t_to_llama.with_rope_theta(v5, 5e5) is v5
    assert thf.rope_theta_of(v5) == 5e5
    cfg = LlamaConfig(**dict(_LLAMA_KW, rope_theta=5e5))
    assert thf.llama_config_from_hf(t_to_llama.hf_config(cfg)).rope_theta == 5e5
    mix = MixtralConfig(**_MIX_KW)
    assert thf.mixtral_config_from_hf(t_to_mixtral.hf_config(mix)).rope_theta == mix.rope_theta


def test_hf_to_mixtral_params_reads_fused_experts():
    """A transformers-5 Mixtral state dict (experts fused: gate_up_proj
    (E, 2H, D) rows [w1; w3], down_proj (E, D, H), the router at
    mlp.gate) gives the tree of the 4.x per-expert one, bitwise."""
    model = _hf_model("mixtral")
    cfg = thf.mixtral_config_from_hf(model.config)
    legacy = model.state_dict()
    fused = {k: v for k, v in legacy.items() if "block_sparse_moe" not in k}
    for i in range(cfg.nlayers):
        ex = f"model.layers.{i}.block_sparse_moe"
        fused[f"model.layers.{i}.mlp.gate.weight"] = legacy[f"{ex}.gate.weight"]
        fused[f"model.layers.{i}.mlp.experts.gate_up_proj"] = torch.stack([torch.cat(
            [legacy[f"{ex}.experts.{e}.w1.weight"], legacy[f"{ex}.experts.{e}.w3.weight"]])
            for e in range(cfg.num_experts)])
        fused[f"model.layers.{i}.mlp.experts.down_proj"] = torch.stack(
            [legacy[f"{ex}.experts.{e}.w2.weight"] for e in range(cfg.num_experts)])

    class Fused:
        def state_dict(self):
            return fused

    want = thf.hf_to_mixtral_params(model, cfg, dtype=torch.float32)
    got = thf.hf_to_mixtral_params(Fused(), cfg, dtype=torch.float32)
    _assert_bitwise(params_to_numpy(got), params_to_numpy(want))


def test_hf_model_with_is_strict():
    """The exporters build transformers' model through its state-dict
    path and refuse a state dict with a key missing or left over."""
    from transformers import LlamaForCausalLM

    cfg = LlamaConfig(**_LLAMA_KW)
    sd = t_to_llama.params_to_hf_state_dict(params_from_numpy(_llama_params()), cfg)
    model = t_to_llama.hf_model_with(LlamaForCausalLM, t_to_llama.hf_config(cfg), sd)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    assert next(model.parameters()).dtype == torch.float32
    short = {k: v for k, v in sd.items() if k != "model.norm.weight"}
    with pytest.raises(KeyError, match="model.norm.weight"):
        t_to_llama.hf_model_with(LlamaForCausalLM, t_to_llama.hf_config(cfg), short)
    with pytest.raises(KeyError, match="extra"):
        t_to_llama.hf_model_with(LlamaForCausalLM, t_to_llama.hf_config(cfg),
                                 dict(sd, extra=torch.zeros(2)))
