"""PyTorch port, flash attention: held against JAX's Pallas kernels.

Inputs come from numpy seeds and go through both packages on CPU. The JAX
side runs its Pallas kernels in interpret mode, as tests/test_flash_attention.py
does, under both kernel families (``_VARIANT`` "resident" and "kvgrid",
Pallas kernels 1-4); the port runs the plain versions its wrappers take for
CPU tensors, through the same ``torch.autograd.Function`` the card uses.
Tolerances are those of tests/test_flash_attention.py: fp32 outputs 2e-5,
fp32 grads 1e-5 (the port's plain backward and the Pallas kernels both
recompute p from lse; only the order of fp32 sums differs), bf16 2e-2 for
the output and 4e-2 for the grads (a few bf16 ulps at |x| ~ 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.ops import flash_attention as j_fa
from fms_fsdp_tpu.ops.attention import xla_attention as j_xla_attention
from fms_fsdp_tpu_torch.ops import attention as t_attention
from fms_fsdp_tpu_torch.ops import flash_attention as t_fa
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _qkv(seed, b, sq, sk, nq, nkv, h=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, nq, h)).astype(np.float32),
            rng.standard_normal((b, sk, nkv, h)).astype(np.float32),
            rng.standard_normal((b, sk, nkv, h)).astype(np.float32))


def _j_flash(q, k, v, causal=True, return_lse=False):
    return j_fa.flash_attention(q, k, v, causal=causal, block_q=128, block_k=128,
                                interpret=True, return_lse=return_lse)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype).requires_grad_()


def _err(port, ref):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max())


@pytest.mark.parametrize("variant", ["resident", "kvgrid"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (4, 1)])
def test_forward_matches_jax(monkeypatch, nq, nkv, causal, variant):
    """o and lse of the port's forward against both JAX kernel families."""
    monkeypatch.setattr(j_fa, "_VARIANT", variant)
    monkeypatch.setattr(t_fa, "_VARIANT", variant)
    q, k, v = _qkv(0, 2, 256, 256, nq, nkv)
    jo, jlse = _j_flash(q, k, v, causal=causal, return_lse=True)
    to, tlse = t_fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                    return_lse=True)
    assert _err(to, jo) <= 2e-5
    assert _err(tlse, jlse) <= 2e-5


@pytest.mark.parametrize("variant", ["resident", "kvgrid"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (4, 1)])
def test_grads_match_jax(monkeypatch, nq, nkv, causal, variant):
    """dq, dk, dv of the autograd Function (the plain flash_dq / flash_dkv,
    not autograd through the forward) against jax.grad through the
    interpret-mode dq and dk/dv kernels."""
    monkeypatch.setattr(j_fa, "_VARIANT", variant)
    monkeypatch.setattr(t_fa, "_VARIANT", variant)
    q, k, v = _qkv(1, 1, 256, 256, nq, nkv)

    def j_loss(q, k, v):
        return (_j_flash(q, k, v, causal=causal) ** 2).mean()

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q), _t(k), _t(v)
    (t_fa.flash_attention(tq, tk, tv, causal=causal) ** 2).mean().backward()
    for port, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        assert _err(port, ref) <= 1e-5


def test_return_lse_cotangent():
    """lse as a differentiable output: its cotangent enters as delta - dlse
    (tests/test_flash_attention.py:84)."""
    q, k, v = _qkv(7, 1, 256, 256, 4, 2)

    def j_loss(q, k, v):
        o, lse = _j_flash(q, k, v, return_lse=True)
        return (o**2).mean() + (lse**2).mean()

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q), _t(k), _t(v)
    o, lse = t_fa.flash_attention(tq, tk, tv, return_lse=True)
    assert lse.shape == (1, 256, 4, 1)
    ((o**2).mean() + (lse**2).mean()).backward()
    for port, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        assert _err(port, ref) <= 3e-5


def test_cross_length_causal_zero_dkv():
    """Sk > Sq, causal: keys past the last query get exactly zero dk/dv,
    and the rest match JAX (tests/test_flash_attention.py:120)."""
    q, k, v = _qkv(3, 1, 256, 512, 4, 4)

    def j_loss(q, k, v):
        return (_j_flash(q, k, v) ** 2).mean()

    jg = jax.grad(j_loss, argnums=(1, 2))(q, k, v)
    tq, tk, tv = _t(q), _t(k), _t(v)
    (t_fa.flash_attention(tq, tk, tv) ** 2).mean().backward()
    for port, ref in zip((tk.grad, tv.grad), jg):
        assert _err(port, ref) <= 2e-5
        assert torch.count_nonzero(port[:, 256:]) == 0


def test_bf16_parity():
    """bf16 end to end against the JAX kernel on the same bf16 inputs
    (tests/test_flash_attention.py:34)."""
    q, k, v = _qkv(11, 2, 256, 256, 4, 2)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))

    def j_loss(q, k, v):
        o = j_fa.flash_attention(q, k, v, causal=True, block_q=128, block_k=64,
                                 interpret=True)
        return jnp.sum(o.astype(jnp.float32) * (o.shape[-1] ** -0.5)), o

    (_, jo), jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(qb, kb, vb)
    tq, tk, tv = (_t(np.asarray(x, np.float32), torch.bfloat16) for x in (qb, kb, vb))
    o = t_fa.flash_attention(tq, tk, tv)
    assert o.dtype == torch.bfloat16
    assert _err(o, jo.astype(jnp.float32)) <= 2e-2
    (o.float() * (o.shape[-1] ** -0.5)).sum().backward()
    for port, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        assert port.dtype == torch.bfloat16
        assert _err(port, np.asarray(ref, np.float32)) <= 4e-2


_SHAPES = [
    ((2, 4096, 32, 128), (2, 4096, 8, 128)),
    ((2, 4096, 32, 64), (2, 4096, 8, 64)),
    ((2, 100, 4, 128), (2, 100, 4, 128)),
    ((1, 32768, 8, 128), (1, 32768, 2, 128)),
    ((1, 256, 6, 128), (1, 512, 4, 128)),
    ((1, 512, 8, 256), (1, 512, 8, 256)),
    ((1, 384, 4, 128), (1, 384, 4, 128)),
]
# where the CUDA kernels' limits differ from the TPU kernel's: the port's
# answer (head dim 128 only; lengths multiples of 64, not of 256)
_KERNEL_DIFFERS = {5: False, 6: True}


@pytest.mark.parametrize("variant", [None, "resident", "kvgrid"])
def test_supports_matches_jax(monkeypatch, variant):
    """The port's eligibility is its kernels' own; it gives JAX's answers,
    the resident 8192 cap included, except on the shapes where the
    kernels' limits differ from the TPU kernel's."""
    monkeypatch.setattr(j_fa, "_VARIANT", variant)
    monkeypatch.setattr(t_fa, "_VARIANT", variant)
    for i, (qs, ks) in enumerate(_SHAPES):
        jax_says = j_fa.supports(qs, ks)
        if i in _KERNEL_DIFFERS:
            assert jax_says != _KERNEL_DIFFERS[i], (qs, ks)
        assert t_fa.supports(qs, ks) == _KERNEL_DIFFERS.get(i, jax_says), (qs, ks)


@pytest.mark.parametrize("variant", [None, "auto", "resident", "kvgrid"])
def test_launch_contract_selection(monkeypatch, variant):
    """Which Pallas contract a launch is counted under: the same family
    JAX dispatches for seq_k on both sides of MAX_KERNEL_SEQ, with the
    variant pinned by set_kernel_variant as JAX's."""
    monkeypatch.setattr(t_fa, "_VARIANT", None)
    j_fa_variant = j_fa._VARIANT
    try:
        j_fa.set_kernel_variant(variant if variant is not None else "auto")
        t_fa.set_kernel_variant(variant)
        for seq_k in (256, 8192, 8448, 16384):
            assert t_fa._use_kvgrid(seq_k) == j_fa._use_kvgrid(seq_k), seq_k
    finally:
        j_fa._VARIANT = j_fa_variant
    assert t_fa.MAX_KERNEL_SEQ == j_fa.MAX_KERNEL_SEQ
    with pytest.raises(ValueError, match="variant"):
        t_fa.set_kernel_variant("blocked")


def test_attention_pallas_raises_where_jax_does():
    """impl="pallas" raises on ineligible shapes (as JAX, ops/attention.py:
    131-137) and on CPU tensors, which have no kernel; "auto" on CPU is the
    einsum path."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 16, 16, 4, 2, h=16))
    with pytest.raises(NotImplementedError):
        t_attention.attention(q, k, v, impl="pallas")
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 256, 256, 4, 2))
    with pytest.raises(NotImplementedError, match="CUDA"):
        t_attention.attention(q, k, v, impl="pallas")
    out = t_attention.attention(q, k, v, impl="auto")
    ref = j_xla_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True)
    assert _err(out, ref) <= 2e-5
    with pytest.raises(ValueError, match="impl"):
        t_attention.attention(q, k, v, impl="cudnn")


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_card_dispatch_launches_or_raises(monkeypatch, impl):
    """For CUDA tensors "auto" is "pallas": the kernels on the shapes they
    take, a raise on any other (a head of 256, a length of 100, the
    resident contract past 8192 keys); never the einsum path. Only "xla"
    and CPU tensors under "auto" take the einsum path."""
    monkeypatch.setattr(t_fa, "_VARIANT", None)
    use = t_attention.use_kernel
    ok_q, ok_k = (2, 4096, 32, 128), (2, 4096, 8, 128)
    assert use(impl, ok_q, ok_k, "cuda") is True
    assert use(impl, (1, 384, 4, 128), (1, 384, 4, 128), "cuda") is True
    for qs, ks in (((1, 512, 8, 256), (1, 512, 8, 256)),
                   ((2, 100, 4, 128), (2, 100, 4, 128)),
                   ((1, 256, 6, 128), (1, 256, 4, 128))):
        with pytest.raises(NotImplementedError, match="xla"):
            use(impl, qs, ks, "cuda")
    long_q, long_k = (1, 16384, 8, 128), (1, 16384, 2, 128)
    assert use(impl, long_q, long_k, "cuda") is True
    t_fa.set_kernel_variant("resident")
    with pytest.raises(NotImplementedError, match="resident"):
        use(impl, long_q, long_k, "cuda")
    assert use("xla", ok_q, ok_k, "cuda") is False
    assert use("auto", ok_q, ok_k, "cpu") is False
    with pytest.raises(NotImplementedError, match="CUDA"):
        use("pallas", ok_q, ok_k, "cpu")


def test_wrappers_refuse_other_devices():
    q, k, v = (torch.from_numpy(x).to("meta") for x in _qkv(0, 1, 64, 64, 2, 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_fa.flash_fwd(q, k, v)
    t_fa.reset_launches()
    assert all(n == 0 for n in t_fa.LAUNCHES.values())
