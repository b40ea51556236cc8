"""PyTorch port, the streaming loader: each layer of the port's data
pipeline against the JAX package's, on arrow shards this file writes.

The same datadir, seeds and (rank, worldsize) go through the JAX class
and the port's; their output sequences and ``state_dict``s must be
equal, bitwise, and the state of one loads in the other. The rescale
cases of tests/test_datasets.py run through both packages, as do the
sampler's rates, corpus quarantine and re-arm (a shard handler whose
opens fail stands in for a dead corpus), ``get_data_loader`` with 1 and
2 workers in both worker modes, and ``loader_state_<rank>.pkl`` files
written by one package and continued by the other. ``DeviceFeed`` is
checked on the CPU.
"""

import os
from copy import deepcopy

import numpy as np
import pyarrow as pa
import pytest
import torch

import fms_fsdp_tpu.data as J
import fms_fsdp_tpu.data.loader as j_loader
import fms_fsdp_tpu.data.streaming as j_streaming
import fms_fsdp_tpu.data.synth as j_synth
import fms_fsdp_tpu_torch.data.buffering as p_buffering
import fms_fsdp_tpu_torch.data.handlers as p_handlers
import fms_fsdp_tpu_torch.data.loader as p_loader
import fms_fsdp_tpu_torch.data.stateful as p_stateful
import fms_fsdp_tpu_torch.data.streaming as p_streaming
import fms_fsdp_tpu_torch.data.synth as p_synth
from fms_fsdp_tpu.config import TrainConfig as JTrainConfig
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
from fms_fsdp_tpu_torch.resilience.retry import RetryingShardHandler


class _Pkg:
    """One package's pipeline classes under common names."""

    def __init__(self, name, **classes):
        self.name = name
        self.__dict__.update(classes)


JAX = _Pkg("jax", Arrow=J.ArrowHandler, Streaming=J.StreamingDocDataset,
           Scalable=J.ScalableShardDataset, Sampling=J.SamplingDataset,
           Buffer=J.BufferDataset, Preload=J.PreloadBufferDataset, streaming=j_streaming)
PORT = _Pkg("port", Arrow=p_handlers.ArrowHandler, Streaming=p_streaming.StreamingDocDataset,
            Scalable=p_streaming.ScalableShardDataset, Sampling=p_streaming.SamplingDataset,
            Buffer=p_buffering.BufferDataset, Preload=p_buffering.PreloadBufferDataset,
            streaming=p_streaming)


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    """The layout of tests/test_datasets.py: dataset_1, one 100-doc shard
    (doc i = [100i .. 100i+99]); dataset_2, two 50-doc shards (one
    nested); and the meta counts csv."""
    root = tmp_path_factory.mktemp("data")
    schema = pa.schema([pa.field("tokens", pa.uint32())])
    os.makedirs(root / "dataset_1")
    os.makedirs(root / "dataset_2" / "subfolder")
    with pa.ipc.new_file(str(root / "dataset_1" / "fullshard.arrow"), schema) as w:
        for i in range(100):
            w.write(pa.record_batch([list(range(i * 100, i * 100 + 100))], schema))
    with pa.ipc.new_file(str(root / "dataset_2" / "quartershard_1.arrow"), schema) as w:
        for i in range(50):
            w.write(pa.record_batch([list(range(i * 50, i * 50 + 50))], schema))
    with pa.ipc.new_file(str(root / "dataset_2" / "subfolder" / "quartershard_2.arrow"),
                         schema) as w:
        for i in range(50):
            w.write(pa.record_batch([list(range(2500 + i * 50, 2500 + i * 50 + 50))], schema))
    os.makedirs(root / "meta")
    with open(root / "meta" / "combined_counts.csv", "w") as f:
        f.write("dataset/filename,documents,tokens\n")
        f.write("/dataset_1/fullshard.arrow,100,10000\n")
        f.write("/dataset_2/quartershard_1.arrow,50,2500\n")
        f.write("/dataset_2/subfolder/quartershard_2.arrow,50,2500\n")
    return str(root)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Two corpora of log-uniform document lengths (8..300 tokens)."""
    root, _ = p_synth.build_mixed_corpus(
        tmp_path_factory.mktemp("mixed"), {"corpus_a": 3, "corpus_b": 2},
        docs_per_shard=40, min_len=8, max_len=300, vocab=1000, seed=3)
    return root


def _same(a, b, where="state"):
    """Recursive bitwise equality of pipeline outputs and states: dicts,
    lists and tuples of builtins and numpy arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert np.array_equal(a, b), where
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _pull(it, n):
    return [next(it) for _ in range(n)]


# ---------------------------------------------------------------------------
# each layer: equal walks and states, states cross-loaded
# ---------------------------------------------------------------------------


def _streaming(pkg, datadir, rank, world, corpus="dataset_1", **kw):
    kw.setdefault("max_chunksize", 40)
    return pkg.Streaming(os.path.join(datadir, corpus), rank, world, pkg.Arrow(), -1, **kw)


def _layer(pkg, layer, datadir, rank=0, world=1):
    if layer == "streaming":
        return _streaming(pkg, datadir, rank, world, bos_token=-2)
    if layer == "streaming_multi_file":
        return _streaming(pkg, datadir, rank, world, corpus="dataset_2")
    if layer == "scalable":
        return pkg.Scalable(_streaming(pkg, datadir, rank, world), -1, n_logical_shards=8)
    sampler = pkg.Sampling(
        datadir, pkg.Scalable(_streaming(pkg, datadir, rank, world), -1, n_logical_shards=8),
        -1, datasets=["dataset_1", "dataset_2"], weights=[3, 1])
    if layer == "sampling":
        return sampler
    packed = pkg.Buffer(sampler, 64, pack_hard=True, bos_token=-3, eos_token=-4)
    if layer == "buffer":
        return packed
    return pkg.Preload(packed, 16)


LAYERS = ["streaming", "streaming_multi_file", "scalable", "sampling", "buffer", "preload"]


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
@pytest.mark.parametrize("layer", LAYERS)
def test_layer_walk_and_state_match_jax(datadir, layer, rank, world):
    """N items and the state after them are equal; each package's state
    loaded into a fresh instance of the other continues identically."""
    j, p = _layer(JAX, layer, datadir, rank, world), _layer(PORT, layer, datadir, rank, world)
    ji, pi = iter(j), iter(p)
    _same(_pull(ji, 37), _pull(pi, 37), "items")
    # deep copies: a state_dict holds the layers' live lists
    js, ps = deepcopy(j.state_dict()), deepcopy(p.state_dict())
    _same(js, ps)
    ref = _pull(ji, 41)
    _same(ref, _pull(pi, 41), "items")
    for state, dst in ((js, _layer(PORT, layer, datadir, rank, world)),
                       (ps, _layer(JAX, layer, datadir, rank, world))):
        dst.load_state_dict([state], sharded_input=True)
        _same(ref, _pull(iter(dst), 41), f"continued in {type(dst).__module__}")


def test_stateful_helpers_match_jax():
    items = list(range(23))
    for world in (1, 2, 3, 4, 7):
        for rank in range(world):
            assert p_stateful.shard_partition(items, rank, world) == \
                J.stateful.shard_partition(items, rank, world)
            assert p_stateful.shard_inclusive(items, rank, world) == \
                J.stateful.shard_inclusive(items, rank, world)


def test_scalable_shard_reload_scale(datadir):
    """tests/test_datasets.py::test_scalable_shard_reload_scale through
    both packages: 2 workers -> reload at 4, no revisits, and the port's
    streams equal JAX's throughout."""
    streams = {}
    for pkg in (JAX, PORT):
        ds = [pkg.Scalable(_streaming(pkg, datadir, i, 2), -1, 8) for i in range(2)]
        its = [iter(d) for d in ds]
        ins = [next(its[0])[0] for _ in range(50)] + [next(its[1])[0] for _ in range(50)]
        states = [d.state_dict() for d in ds]
        ds2 = [pkg.Scalable(_streaming(pkg, datadir, i, 4), -1, 8) for i in range(4)]
        for d in ds2:
            d.load_state_dict(deepcopy(states))

        def unseen(d):
            total = 0
            for nrem, ld in zip(d.n_docs_remaining, d.data):
                total += nrem * 3 - (ld.chunk_index + 1 if 0 <= ld.chunk_index < 2 else 0)
            return total

        its2 = [iter(d) for d in ds2]
        outs = []
        for _ in range(min(unseen(d) for d in ds2)):
            for i in range(4):
                out = next(its2[i])
                assert out[0] not in ins, (pkg.name, out[0])
                outs.append(out)
        streams[pkg.name] = (ins, outs)
    _same(streams["jax"], streams["port"], "rescaled walk")


def test_scalable_sampler_reload_scale(datadir):
    """tests/test_datasets.py::test_scalable_sampler_reload_scale through
    both packages: full coverage after the 2 -> 4 reload, equal streams."""
    streams = {}
    for pkg in (JAX, PORT):
        def bss(i, w):
            return pkg.Sampling(datadir, pkg.Scalable(_streaming(pkg, datadir, i, w), -1, 8),
                                -1, ["dataset_1"], [1])
        ds = [bss(i, 2) for i in range(2)]
        its = [iter(d) for d in ds]
        ins = [next(its[0])[0] for _ in range(50)] + [next(its[1])[0] for _ in range(50)]
        states = [d.state_dict() for d in ds]
        ds2 = [bss(i, 4) for i in range(4)]
        for d in ds2:
            d.load_state_dict(deepcopy(states))
        its2 = [iter(d) for d in ds2]
        for i in range(4):
            steps = sum(ds2[i].data[0].n_docs_remaining) * 3 + 5
            ins += [next(its2[i])[0] for _ in range(steps)]
        for suf in (0, 40, 80):
            for i in range(100):
                assert i * 100 + suf in ins, (pkg.name, i * 100 + suf)
        streams[pkg.name] = ins
    _same(streams["jax"], streams["port"], "rescaled walk")


def test_sampler_rates_match_jax(datadir):
    """Weighted mixing by tokens seen: equal chunk streams and per-corpus
    tokens, which follow the 3:1 target."""
    seen = {}
    for pkg in (JAX, PORT):
        d = pkg.Sampling(datadir, _streaming(pkg, datadir, 0, 1, max_chunksize=1000), -1,
                         ["dataset_1", "dataset_2"], [3, 1])
        it = iter(d)
        outs = _pull(it, 300)
        share = d.tokens_seen[0] / sum(d.tokens_seen)
        assert abs(share - 0.75) < 0.02, (pkg.name, d.tokens_seen)
        seen[pkg.name] = (outs, list(d.tokens_seen))
    _same(seen["jax"], seen["port"], "sampler")


# ---------------------------------------------------------------------------
# corpus quarantine, re-arm and the min_live_corpora floor
# ---------------------------------------------------------------------------


class _Outage:
    """Shared by every deepcopy of a pipeline: the first ``fails`` opens
    of a path containing ``corpus`` raise (every one when None)."""

    def __init__(self, corpus, fails=None):
        self.corpus, self.left = corpus, fails

    def __deepcopy__(self, memo):
        return self

    def hit(self, path):
        if self.corpus in path and (self.left is None or self.left > 0):
            if self.left is not None:
                self.left -= 1
            raise OSError(f"injected outage: {path}")


class _FlakyArrow:
    """An arrow handler whose opens fail during an outage."""

    def __init__(self, inner, outage):
        self.inner, self.outage = inner, outage

    def is_legal(self, path):
        return self.inner.is_legal(path)

    def open(self, path):
        self.outage.hit(path)
        return self.inner.open(path)

    def length(self, path):
        return self.inner.length(path)

    def get(self, reader, index, drop):
        return self.inner.get(reader, index, drop)

    def slice(self, doc, index, n):
        return self.inner.slice(doc, index, n)


def _flaky_sampler(pkg, datadir, outage, **kw):
    reader = pkg.Streaming(os.path.join(datadir, "dataset_1"), 0, 1,
                           _FlakyArrow(pkg.Arrow(), outage), -1, max_chunksize=1000)
    return pkg.Sampling(datadir, reader, -1, datasets=["dataset_1", "dataset_2"],
                        weights=[1, 1], **kw)


@pytest.mark.parametrize("fails,pulls", [(None, 40), (2, 120)])
def test_corpus_quarantine_and_rearm_match_jax(datadir, fails, pulls):
    """dataset_2's shards fail to open: it is quarantined and the mix
    serves dataset_1 alone. With a transient outage (2 failed opens) the
    survivor's epoch wrap re-probes it and it rejoins the mix. Streams,
    states and the buffered mix events are equal in both packages."""
    seen = {}
    for pkg in (JAX, PORT):
        pkg.streaming.drain_mix_events()
        d = _flaky_sampler(pkg, datadir, _Outage("dataset_2", fails))
        outs = _pull(iter(d), pulls)
        if fails is None:
            assert d.quarantined_corpora == ["dataset_2"] and d.tokens_seen[1] == 0
            assert sum(len(o) for o in outs) == d.tokens_seen[0]
        else:
            assert d.quarantined_corpora == [] and d.tokens_seen[1] > 0, d.tokens_seen
        seen[pkg.name] = (outs, d.state_dict(), pkg.streaming.drain_mix_events())
    assert seen["port"][2] == {"corpus_quarantined": 1, "corpus_rearmed": int(fails is not None)}
    _same(seen["jax"], seen["port"], "quarantine")


def test_min_live_corpora_floor(datadir):
    """Losing a corpus below min_live_corpora raises CorpusLossError."""
    for pkg in (JAX, PORT):
        d = _flaky_sampler(pkg, datadir, _Outage("dataset_2"), min_live_corpora=2)
        with pytest.raises(pkg.streaming.CorpusLossError, match="min_live_corpora"):
            _pull(iter(d), 10)


# ---------------------------------------------------------------------------
# handlers, retry, synth
# ---------------------------------------------------------------------------


def test_arrow_handler_matches_jax(datadir):
    path = os.path.join(datadir, "dataset_2", "quartershard_1.arrow")
    jh, ph = J.ArrowHandler(), p_handlers.ArrowHandler()
    assert ph.length(path) == jh.length(path) == 50
    jr, pr = jh.open(path), ph.open(path)
    for i in (0, 7, 49):
        drop = {i * 50, i * 50 + 49}  # strips both edges
        jd, pd = jh.get(jr, i, drop), ph.get(pr, i, drop)
        assert len(pd) == len(jd) == 48
        _same(jh.slice(jd, 3, 20), ph.slice(pd, 3, 20), "slice")
    assert ph.is_legal("x.arrow") and not ph.is_legal("x.parquet")


def test_parquet_handler_matches_jax(tmp_path):
    """ParquetHandler tokenizes on access with a tokenizer the test
    builds and saves locally (nothing is downloaded)."""
    import pyarrow.parquet as pq
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["<eos>", "the", "cat", "sat", "on", "mat", "a", "dog"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<eos>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<eos>").save_pretrained(
        str(tmp_path / "tok"))
    texts = ["the cat sat on the mat", "a dog", "<eos> the dog sat <eos>"]
    path = str(tmp_path / "docs.parquet")
    pq.write_table(pa.table({"text": texts}), path)
    jh = J.ParquetHandler(str(tmp_path / "tok"))
    ph = p_handlers.ParquetHandler(str(tmp_path / "tok"))
    auto = p_handlers.AutoHandler(str(tmp_path / "tok"))
    assert ph.length(path) == jh.length(path) == auto.length(path) == 3
    jr, pr, ar = jh.open(path), ph.open(path), auto.open(path)
    for i in range(3):
        want = jh.get(jr, i, {0})
        assert ph.get(pr, i, {0}) == auto.get(ar, i, {0}) == want
        _same(jh.slice(want, 1, 3), ph.slice(want, 1, 3), "slice")
    assert ph.get(pr, 2, {0}) == [1, 7, 3]


def test_retrying_handler_retries_then_raises(datadir):
    path = os.path.join(datadir, "dataset_1", "fullshard.arrow")
    h = RetryingShardHandler(_FlakyArrow(p_handlers.ArrowHandler(), _Outage("fullshard", 2)),
                             retries=2, backoff_s=0.0)
    h.open(path)  # two failed opens absorbed
    assert h.length(path) == 100
    dead = RetryingShardHandler(_FlakyArrow(p_handlers.ArrowHandler(), _Outage("fullshard")),
                                retries=1, backoff_s=0.0)
    with pytest.raises(OSError, match="injected outage"):
        dead.open(path)


def test_build_arrow_corpus_matches_jax(tmp_path):
    j_synth.build_arrow_corpus(tmp_path / "j", n_shards=2, docs_per_shard=5)
    p_synth.build_arrow_corpus(tmp_path / "p", n_shards=2, docs_per_shard=5)
    for rel in ("dataset_1/shard_0.arrow", "dataset_1/shard_1.arrow",
                "meta/combined_counts.csv"):
        assert (tmp_path / "p" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()


# ---------------------------------------------------------------------------
# get_data_loader, and loader state across packages
# ---------------------------------------------------------------------------


def _cfgs(datadir, tmp_path, **kw):
    fields = dict(use_dummy_dataset=False, data_path=datadir, datasets="corpus_a,corpus_b",
                  weights="3,1", file_type="arrow", seq_length=32, batch_size=2,
                  logical_shards=8, loader_shuffle_window=8, checkpoint_interval=1000,
                  seed=7, **kw)
    out = []
    for name, cls in (("jax", JTrainConfig), ("port", TrainConfig)):
        ck = str(tmp_path / name)
        out.append(cls(**dict(fields, ckpt_save_path=ck, ckpt_load_path=ck)))
    return out


@pytest.mark.parametrize("workers,mode", [(1, "thread"), (1, "process"), (2, "thread"),
                                          (2, "process")])
def test_get_data_loader_matches_jax(mixed, tmp_path, workers, mode):
    jcfg, pcfg = _cfgs(mixed, tmp_path, num_workers=workers, worker_mode=mode)
    jl, pl = j_loader.get_data_loader(jcfg, 0, 1), p_loader.get_data_loader(pcfg, 0, 1)
    try:
        jb, pb = _pull(iter(jl), 12), _pull(iter(pl), 12)
    finally:
        jl.shutdown()
        pl.shutdown()
    assert pb[0][0].shape == (2, 32) and pb[0][0].dtype == np.int32
    _same(jb, pb, "batches")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_loader_state_files_cross_packages(mixed, tmp_path, direction):
    """``loader_state_<rank>.pkl`` files (2 workers) written by one
    package's loader load in the other's, and the continuation is
    bitwise the writer's own."""
    jcfg, pcfg = _cfgs(mixed, tmp_path, num_workers=2)
    src_cfg, src_mod, dst_cfg, dst_mod = (
        (jcfg, j_loader, pcfg, p_loader) if direction == "jax_to_port"
        else (pcfg, p_loader, jcfg, j_loader))
    src = src_mod.get_data_loader(src_cfg, 0, 1)
    it = iter(src)
    _pull(it, 5)
    src.shutdown()  # quiesce the workers: the state is the consumed position
    state_dir = str(tmp_path / "state")
    src.save_to_path(state_dir)
    assert sorted(os.listdir(state_dir)) == ["loader_state_0.pkl", "loader_state_1.pkl"]
    ref = src_mod.get_data_loader(src_cfg, 0, 1)
    ref.load_from_path(state_dir)
    dst = dst_mod.get_data_loader(dst_cfg, 0, 1)
    dst.load_from_path(state_dir)
    try:
        _same(_pull(iter(ref), 9), _pull(iter(dst), 9), "continuation")
    finally:
        ref.shutdown()
        dst.shutdown()


def test_loader_helpers_match_jax(mixed, tmp_path):
    """causal_lm, rebatch, _find_layer and loader_mix_stats."""
    seq = np.arange(10)
    _same(j_loader.causal_lm(seq, 2), p_loader.causal_lm(seq, 2), "causal_lm")
    batches = [(np.full((2, 3), i), np.full((2, 3), -i)) for i in range(4)]
    _same(next(j_loader.rebatch(batches, 4, 2)), next(p_loader.rebatch(batches, 4, 2)),
          "rebatch")
    assert p_loader.rebatch(batches, 2, 2) is batches
    jcfg, pcfg = _cfgs(mixed, tmp_path, num_workers=2)
    jl, pl = j_loader.get_data_loader(jcfg, 0, 1), p_loader.get_data_loader(pcfg, 0, 1)
    assert p_loader.loader_mix_stats(pl) is None  # not set up yet
    _pull(iter(jl), 6)
    _pull(iter(pl), 6)
    jl.shutdown()
    pl.shutdown()
    assert p_loader._find_layer(pl.dataset, p_streaming.SamplingDataset) is not None
    assert p_loader.loader_mix_stats(pl) == j_loader.loader_mix_stats(jl)
    assert set(p_loader.loader_mix_stats(pl)["tokens"]) == {"corpus_a", "corpus_b"}


# ---------------------------------------------------------------------------
# DeviceFeed on the CPU
# ---------------------------------------------------------------------------


def _np_batches(n):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 9, (2, 5)).astype(np.int32),) * 2 for _ in range(n)]


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_feed_serves_loader_batches_in_order(prefetch):
    batches = _np_batches(7)
    feed = DeviceFeed(batches, "cpu", prefetch=prefetch)
    got = list(feed)
    assert len(got) == 7 and feed.served == 7 and feed.wait_s >= 0
    for (x, y), (a, b) in zip(got, batches):
        assert x.dtype == torch.int64 and x.device.type == "cpu"
        assert np.array_equal(x.numpy(), a) and np.array_equal(y.numpy(), b)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_feed_raises_pipeline_error(prefetch):
    def broken():
        yield from _np_batches(2)
        raise ValueError("pipeline broke")

    it = iter(DeviceFeed(broken(), "cpu", prefetch=prefetch))
    assert len(_pull(it, 2)) == 2
    with pytest.raises(ValueError, match="pipeline broke"):
        next(it)


def test_feed_close_stops_its_thread():
    def endless():
        while True:
            yield from _np_batches(1)

    it = iter(DeviceFeed(endless(), "cpu", prefetch=2))
    _pull(it, 3)
    it.close()
    import threading
    import time

    deadline = time.monotonic() + 5
    while any(t.name == "device-feed" for t in threading.enumerate()):
        assert time.monotonic() < deadline, "feed thread still running"
        time.sleep(0.01)
