"""PyTorch port, the chunked state-transfer transport: held against JAX.

- Every wire, journal-replay and router case of JAX's
  tests/test_transport.py (up to its engine-level section) runs unchanged
  on the port's classes (``tests/torch_jax_cases.py``): retransmit of
  corrupt and dropped chunks, the in-flight cap, retry exhaustion,
  channel loss, the stall site, resume from journaled acks, journal replay
  with a torn tail, handoff_error re-prefill, preempt-and-migrate.
- The encoded frames equal JAX's byte for byte, and one faulted transfer
  schedule puts the same bytes on the wire through both packages.
- Engine level (TINY, fp32, CPU): a Mamba hybrid stream migrated
  mid-decode through the slab codec finishes with the uninterrupted
  engine's tokens (and JAX's); version skew is typed; an import that
  fails after allocation frees what it took.
"""

import socket

import jax
import numpy as np
import pytest
import torch

from fms_fsdp_tpu.resilience import faults as j_faults
from fms_fsdp_tpu.serve.disagg import transport as j_transport
from fms_fsdp_tpu_torch.bridge import params_from_numpy
from fms_fsdp_tpu_torch.models.configs import LlamaConfig, MambaAttnConfig, MambaConfig
from fms_fsdp_tpu_torch.resilience import faults as t_faults
from fms_fsdp_tpu_torch.serve import ServeConfig, ServingEngine
from fms_fsdp_tpu_torch.serve.disagg import handoff as t_handoff
from fms_fsdp_tpu_torch.serve.disagg import transport as t_transport
from fms_fsdp_tpu_torch.serve.disagg.handoff import HandoffError
from torch_jax_cases import export_tests, port_cases
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_NS = port_cases("test_transport.py", end="jax = pytest.importorskip")
JAX_CASES = export_tests(_NS, globals(), fixtures=("_clear_faults",))


@pytest.fixture(autouse=True)
def _clear_both_registries():
    j_faults.configure_faults("")
    yield
    j_faults.configure_faults("")


def test_jax_cases_replayed():
    """The replayed cases are the wire, journal and router ones."""
    assert len(JAX_CASES) >= 20
    assert "test_resume_retransmits_only_unacked_chunks" in JAX_CASES
    assert "test_router_preempt_migrates_streams_without_double_requeue" in JAX_CASES


# ---------------------------------------------------------------------------
# wire bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,payload", [
    (0, bytes(range(256)) * 3), (0, b""), (1, b""), (0, b"\x00FMSC\xff" * 9),
])
def test_encoded_frames_equal_jax(kind, payload):
    args = (kind, 7, 123456, 3, 11, payload)
    frame = t_transport.encode_chunk(*args)
    assert frame == j_transport.encode_chunk(*args)
    buf = b"junk" + frame + frame[:-5]
    assert t_transport.decode_frames(buf) == j_transport.decode_frames(buf)
    bad = bytearray(frame)
    bad[t_transport._HEADER.size] ^= 0xFF if payload else 0
    got, used = t_transport.decode_frames(bytes(bad))
    assert (got, used) == j_transport.decode_frames(bytes(bad))
    assert got[0]["corrupt"] == bool(payload)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _wire_log(mod, faults, spec):
    """Drive one faulted transfer to completion over a socketpair on a
    fake clock; returns (every frame the sender put on the wire, its
    counters, the reassembled payload)."""
    faults.configure_faults(spec)
    clk = _Clock()
    a, b = socket.socketpair()
    tx = mod.DataChannel(a, label="t", clock=clk)
    rx = mod.DataChannel(b, label="r", clock=clk)
    payload = bytes(range(251)) * 40
    s = mod.ChunkSender(tx, 3, 99, payload, chunk_bytes=1000, max_inflight_bytes=3000,
                        backoff_s=0.1, label="rtr1.tx", clock=clk)
    frames, receiver = [], mod.ChunkReceiver(3, 99, s.total)
    for _ in range(400):
        s.pump()
        try:
            data = b.recv(1 << 20)
        except BlockingIOError:  # nothing reached the wire this tick
            data = b""
        frames.append(data)
        for m in mod.decode_frames(data)[0]:
            receiver.on_chunk(m, rx)
        for m in tx.pump():
            s.on_ack(m)
        if s.done:
            break
        clk.t += 0.05
    a.close()
    b.close()
    faults.configure_faults("")
    counters = (s.chunks_sent, s.chunks_resent, s.chunks_corrupted, s.chunks_dropped)
    return frames, counters, receiver.assemble()


def test_faulted_schedule_puts_jax_bytes_on_the_wire():
    """Corrupt every 3rd and drop every 5th matched send: both packages
    emit the same frames tick by tick, heal the same way, and reassemble
    the payload."""
    spec = "handoff_chunk_corrupt:transport=rtr:every=3;handoff_chunk_drop:transport=rtr:every=5"
    t_frames, t_counts, t_data = _wire_log(t_transport, t_faults, spec)
    j_frames, j_counts, j_data = _wire_log(j_transport, j_faults, spec)
    assert t_frames == j_frames and t_counts == j_counts
    assert t_data == j_data == bytes(range(251)) * 40
    assert t_counts[1] >= 1 and t_counts[2] >= 1 and t_counts[3] >= 1


def test_transport_stall_site_fires_by_label():
    t_faults.configure_faults("transport_stall:transport=slow:seconds=2")
    clk = _Clock()
    a, b = socket.socketpair()
    slow = t_transport.DataChannel(a, label="slow", clock=clk)
    fast = t_transport.DataChannel(b, label="fast", clock=clk)
    slow.send(t_transport.encode_chunk(0, 1, 1, 0, 1, b"x"))
    assert slow.stalls == 1 and slow.outbuf_bytes > 0 and fast.pump() == []
    clk.t = 2.5
    t_faults.configure_faults("")
    assert slow.pump() == [] and slow.outbuf_bytes == 0
    assert [m["payload"] for m in fast.pump()] == [b"x"]
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# engine level: the slab codec under drain-and-migrate, typed failures
# ---------------------------------------------------------------------------

_HYBRID_KW = dict(d_model=64, n_layer=3, vocab_size=128, d_state=16, headdim=16,
                 chunk_size=8, attn_layer_idx=(1,), d_intermediate=128)
_ATTN_KW = dict(head_dim=16, num_heads=4, num_heads_kv=2, rotary_emb_dim=8)
_LLAMA_KW = dict(src_vocab_size=128, emb_dim=64, nheads=4, kvheads=2, nlayers=2,
                 max_expected_seq_len=256)
TINY_HYBRID = MambaConfig(attn_cfg=MambaAttnConfig(**_ATTN_KW), **_HYBRID_KW)
TINY_LLAMA = LlamaConfig(**_LLAMA_KW)


@pytest.fixture(scope="module")
def np_params():
    from fms_fsdp_tpu.models import configs as jc
    from fms_fsdp_tpu.models.llama import init_llama_params
    from fms_fsdp_tpu.models.mamba import init_mamba_params

    j_hybrid = jc.MambaConfig(attn_cfg=jc.MambaAttnConfig(**_ATTN_KW), **_HYBRID_KW)
    j_llama = jc.LlamaConfig(**_LLAMA_KW)
    out = {
        "hybrid": jax.tree.map(np.asarray, init_mamba_params(jax.random.PRNGKey(1), j_hybrid)),
        "llama": jax.tree.map(np.asarray, init_llama_params(jax.random.PRNGKey(0), j_llama)),
        "j_hybrid": j_hybrid,
    }
    yield out
    jax.clear_caches()


def _engine(np_tree, cfg, max_batch=2, max_seq=64, **kw):
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("attn_impl", "reference")
    kw.setdefault("page_size", 16)
    kw.setdefault("max_prefill_per_step", max_batch)
    scfg = ServeConfig(max_batch=max_batch, max_seq_len=max_seq, **kw)
    return ServingEngine(params_from_numpy(np_tree), cfg, scfg, device="cpu")


def test_mamba_slab_drain_migrate_token_parity(np_params):
    """A hybrid stream packed MID-DECODE resumes on a sibling with the
    uninterrupted engine's greedy tokens, which equal JAX's."""
    from fms_fsdp_tpu.serve import ServeConfig as JServeConfig
    from fms_fsdp_tpu.serve import ServingEngine as JServingEngine

    prompt, max_new = [3, 5, 7, 11], 10
    ref = _engine(np_params["hybrid"], TINY_HYBRID)
    rref = ref.submit(prompt, max_new)
    ref.run()
    jeng = JServingEngine(jax.tree.map(jax.numpy.asarray, np_params["hybrid"]),
                          np_params["j_hybrid"],
                          JServeConfig(max_batch=2, max_seq_len=64, compute_dtype="float32",
                                       attn_impl="reference", page_size=16,
                                       max_prefill_per_step=2))
    jr = jeng.submit(prompt, max_new)
    jeng.run()
    assert rref.generated == jr.generated and len(rref.generated) == max_new

    src = _engine(np_params["hybrid"], TINY_HYBRID)
    req = src.submit(prompt, max_new)
    for _ in range(4):
        src.step()
    assert req in src.live_requests() and 0 < len(req.generated) < max_new
    data = src.pack_stream(req)
    header, arrays = t_handoff.unpack_handoff(data)
    assert header["codec"] == "mamba_slab"
    assert {"slab.0000.conv", "slab.0000.ssd", "slab.0002.conv", "slab.0002.ssd",
            "kv.k", "kv.v"} == set(arrays)
    assert arrays["slab.0000.ssd"].dtype == torch.float32
    dst = _engine(np_params["hybrid"], TINY_HYBRID)
    r2 = dst.submit_handoff(data)
    dst.run()
    assert r2.generated == rref.generated
    assert dst.serving_stats()["role"] == 0.0  # a unified engine resumes too


def test_slab_version_skew_is_typed_naming_both_versions(np_params):
    src = _engine(np_params["hybrid"], TINY_HYBRID)
    req = src.submit([2, 4, 6], 8)
    for _ in range(2):
        src.step()
    header, arrays = t_handoff.unpack_handoff(src.pack_stream(req))
    header["codec_version"] = 99
    dst = _engine(np_params["hybrid"], TINY_HYBRID)
    with pytest.raises(HandoffError, match=r"version 99, this replica speaks version 1"):
        dst.submit_handoff(t_handoff.pack_handoff(header, arrays))


def _tamper_import(engine, wire, leaf):
    """Admit ``wire``, then swap one leaf for a tensor of the right shape
    and dtype on the meta device: every check before allocation passes
    and the write itself fails — the free-on-failure path."""
    req = engine.submit_handoff(wire)
    header, arrays, nbytes = req.handoff_in
    arrays = dict(arrays)
    arrays[leaf] = torch.empty(arrays[leaf].shape, dtype=arrays[leaf].dtype, device="meta")
    req.handoff_in = (header, arrays, nbytes)
    return req


def test_import_failure_frees_pages_typed_reject(np_params):
    pe = _engine(np_params["llama"], TINY_LLAMA, role="prefill")
    preq = pe.submit([3, 5, 7], 6)
    pe.run()
    wire = preq.handoff_out
    de = _engine(np_params["llama"], TINY_LLAMA, role="decode")
    free_before = de.cache.pages_free
    req = _tamper_import(de, wire, "k")
    de.step()
    failed = de.take_failed()
    assert [r.rid for r in failed] == [req.rid]
    assert req.state == "failed" and req.fail_reason.startswith("handoff_error")
    assert "pages freed" in req.fail_reason
    assert de.cache.pages_free == free_before
    r2 = de.submit_handoff(wire)
    de.run()
    assert len(r2.generated) == 6


def test_slab_import_failure_frees_pages_and_zeroes_slab(np_params):
    src = _engine(np_params["hybrid"], TINY_HYBRID)
    req = src.submit([5, 10, 15], 8)
    for _ in range(3):
        src.step()
    wire = src.pack_stream(req)
    dst = _engine(np_params["hybrid"], TINY_HYBRID)
    free_before = dst.cache.pages_free
    bad = _tamper_import(dst, wire, "slab.0000.conv")
    dst.step()
    assert [r.rid for r in dst.take_failed()] == [bad.rid]
    assert "slab import failed" in bad.fail_reason
    assert dst.cache.pages_free == free_before
    for layer in dst.adapter.slab_slice(0):
        for part in layer.values():
            assert not part.any()
