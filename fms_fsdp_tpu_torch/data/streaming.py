"""Streaming document readers: the distribution-aware base of the pipeline.

Three layers (ref:fms_fsdp/utils/dataset_utils.py:797-1417):

- ``StreamingDocDataset`` — walks one dataset directory, partitions shard
  files into worldsize fragments per worker (contiguous spans to limit
  file churn), pulls documents via an LCG bijection shuffle (no doc-list
  materialization), yields documents in chunks <= max_chunksize with
  delimiter/bos placement, and tracks epoch/token/doc progress with
  mid-document resume.
- ``ScalableShardDataset`` — rescalability: clones the reader into
  ``n_logical_shards`` logical workers; each physical rank owns
  n/worldsize of them and samples among its logicals proportional to
  docs remaining, so checkpoints reshard onto any world size dividing
  the logical count.
- ``SamplingDataset`` — multi-dataset weighted mixing by *tokens seen*:
  always draws from the most under-target subdataset, holding it to a
  document boundary.

A copy of ``fms_fsdp_tpu/data/streaming.py``, with its ``corpus_kill``
fault site; ``CorpusLossError`` exits classified ``corpus_loss``
(resilience/exits.py).
"""

import csv
import logging
import math
import os
import random
from copy import deepcopy
from typing import Any, List, Optional, Set, Union

import numpy as np

from fms_fsdp_tpu_torch.data.handlers import ShardFileHandler
from fms_fsdp_tpu_torch.data.stateful import (
    StatefulDataset,
    WrapperDataset,
    shard_partition,
)

logger = logging.getLogger(__name__)


class CorpusUnreadableError(RuntimeError):
    """One corpus's document stream died: every owned shard of the
    corpus is quarantined (or the corpus held no readable documents to
    begin with). Raised by the per-corpus reader stack and caught by
    ``SamplingDataset``, which quarantines the corpus and degrades the
    mix over the survivors instead of killing the run."""


class CorpusLossError(RuntimeError):
    """The weighted mix dropped below its survivable floor: losing a
    corpus left fewer than ``min_live_corpora`` live corpora (losing the
    LAST corpus always breaches the implicit floor of 1). Typed so the
    entry points' classified-exit wrapper (resilience/exits.py) exits
    with the ``corpus_loss`` registry code and the run supervisor
    applies the corpus-loss restart policy rather than the generic
    crash policy."""


# Mix lifecycle events buffered for the observer (obs/): the
# SamplingDataset lives deep inside the loader pipeline — possibly in a
# worker thread — with no registry handle, so it bumps these module
# counters (GIL-atomic int +=) and the train loop drains them into the
# metric registry at report cadence (``data.corpus_quarantined`` /
# ``data.corpus_rearmed``). Forked process-mode workers keep their own
# copy; their events are visible in logs but not in the parent's
# metrics (docs/dataloader.md "Multi-corpus mixing").
_MIX_EVENTS = {"corpus_quarantined": 0, "corpus_rearmed": 0}


def drain_mix_events() -> dict:
    """Return and consume the buffered mix lifecycle events. Decrements
    by the drained amount rather than resetting to zero: a worker-thread
    increment landing between the copy and the reset must not be
    silently discarded (it stays buffered for the next drain)."""
    out = dict(_MIX_EVENTS)
    for k, n in out.items():
        _MIX_EVENTS[k] -= n
    return out


class StreamingDocDataset(StatefulDataset):
    """Base reader for one dataset directory (need not be flat).

    Document order: shard files are deterministically shuffled per worker;
    within each owned shard fragment, documents are visited via an LCG
    random bijection (a=5, c=(rank+seed)*2+1, power-of-2 modulus — Knuth
    3.2.1.3) so shuffled traversal needs O(1) state and resumes exactly.
    Documents stream out as chunks of at most ``max_chunksize`` tokens with
    the delimiter appended at document end (and optional bos prepended),
    so downstream layers can detect document boundaries.

    Shard-file lengths come from a ``meta/*counts*.csv`` in the parent
    directory when present, else each owned file is touched once.
    """

    def __init__(
        self,
        datapath: str,
        rank: int,
        worldsize: int,
        filehandler: ShardFileHandler,
        delimiter_token: Any,
        bos_token: Optional[Any] = None,
        strip_tokens: Optional[Set[Any]] = set(),
        seed: int = 42,
        min_length: int = 1,
        max_chunksize: int = 1024,
        verbose: bool = False,
    ):
        super().__init__(datapath, rank, worldsize)
        self.seed = seed
        self.datapath = datapath
        self.filehandler = filehandler
        self.min_length = min_length
        assert max_chunksize > 0, "Max chunksize must be a nonzero positive integer"
        self.chunksize = max_chunksize
        self.eos = delimiter_token
        self.bos = bos_token
        self.drop = strip_tokens
        self.verbose = verbose

        # docset: list of (shard-relpath, min docid, max docid) owned spans
        self.docset: List[Any] = []
        self.docset_index = 0
        self.chunk_index = -1

        # progress stats
        self.epochs_seen = -1
        self.tokens_seen = 0
        self.docs_seen = 0
        self.percent_seen = 0

        # shards whose reads kept failing after bounded retries: skipped
        # (not fatal) and carried in the state_dict so a resume doesn't
        # rediscover the same bad file the hard way. Shards unreadable at
        # SETUP (length probe failed; zero-doc span for the whole run)
        # are tracked separately so the epoch-boundary re-probe doesn't
        # pointlessly clear them — AND persisted in the state_dict: the
        # docset is built around their zero-doc spans, so a resume on a
        # healed shard must re-apply the set before rebuilding the
        # docset, or the restored docset_index/lcg_state would walk a
        # silently shifted document order (replays/skips for the rest of
        # the epoch).
        self.quarantined_shards: List[str] = []
        self.setup_quarantined: List[str] = []

        self.state_params = [
            "dataset",
            "docset_index",
            "chunk_index",
            "epochs_seen",
            "tokens_seen",
            "docs_seen",
            "percent_seen",
            "lcg_state",
            "quarantined_shards",
            "setup_quarantined",
        ]

        self.is_setup = False
        self._len = 0
        self.dataset = ""
        self.lcg_state = 0

    # -- setup ------------------------------------------------------------

    def _walk_shards(self) -> List[str]:
        shards = [
            os.path.join(root, name)[len(self.datapath) + 1 :]
            for root, dirs, files in os.walk(self.datapath, topdown=False)
            for name in files
            if self.filehandler.is_legal(os.path.join(root, name))
        ]
        shards.sort()  # identical ordering on every worker
        return shards

    def _load_doc_counts(self, pardir: str, dataset: str, shardfrags) -> dict:
        """Document count per shard file: from the meta csv when present,
        else by touching each owned file once."""
        countfiles = []
        metadir = os.path.join(pardir, "meta")
        if os.path.exists(metadir):
            countfiles = [
                x for x in os.listdir(metadir) if "counts" in x and "csv" in x
            ]
        if countfiles:
            doc_counts = {}
            with open(os.path.join(metadir, countfiles[0]), "r") as csvfile:
                for row in csv.DictReader(csvfile):
                    fullpath = row["dataset/filename"]
                    prefix = fullpath.find("/" + dataset) + 1
                    if prefix > 0:
                        key = fullpath[prefix + len(dataset) + 1 :]
                        doc_counts[key] = int(row["documents"])
            return doc_counts
        doc_counts = {}
        for shard in set(shard for shard, frag in shardfrags):
            try:
                doc_counts[shard] = self.filehandler.length(
                    os.path.join(self.datapath, shard)
                )
            except OSError as e:
                # unreadable at setup (after the retry layer gave up):
                # quarantine and contribute zero docs — the run starts on
                # the readable shards instead of dying in setup
                self._quarantine(shard, e)
                if shard not in self.setup_quarantined:
                    self.setup_quarantined.append(shard)
                doc_counts[shard] = 0
        return doc_counts

    def setup(self):
        if self.is_setup:
            return
        super().setup()
        self._build_docset()
        self.lcg_state = self.seed + self.rank

    def _build_docset(self):
        """(Re)build the owned docset spans. Shards listed in
        ``setup_quarantined`` are forced to zero docs even when their
        length probe succeeds now — called once at setup, and again on
        resume when the checkpoint carries setup-quarantined shards that
        have healed since (the restored walk position is only valid over
        the docset it was saved against)."""
        # dataset name = final path component (robust to trailing slashes)
        pathsplit = (self.datapath, "")
        while len(pathsplit[1]) == 0:
            pathsplit = os.path.split(pathsplit[0])
        pardir, dataset = pathsplit
        self.dataset = dataset

        # Fragment ownership: every shard file splits into worldsize
        # fragments; the global fragment list (ordered by shard, then
        # fragment) is cut into worldsize contiguous spans.
        shards = self._walk_shards()
        n = len(shards)
        shardfrags = [
            (shards[i // self.worldsize], i % self.worldsize)
            for i in range(self.rank * n, (self.rank + 1) * n)
        ]

        doc_counts = self._load_doc_counts(pardir, dataset, shardfrags)
        # setup-time quarantine (this run's probe failures plus any
        # persisted from the checkpoint): zero-doc spans, always
        for shard in self.setup_quarantined:
            if shard in doc_counts:
                doc_counts[shard] = 0

        # Aggregate owned fragments into per-shard [min, max] doc spans.
        spans = {}
        for shard, frag in shardfrags:
            ndocs = doc_counts[shard]
            doc_start = (ndocs * frag) // self.worldsize
            doc_end = (ndocs * frag + ndocs) // self.worldsize - 1  # inclusive
            if shard not in spans:
                spans[shard] = [doc_start, doc_end]
            else:
                spans[shard][0] = min(spans[shard][0], doc_start)
                spans[shard][1] = max(spans[shard][1], doc_end)

        self.docset = []
        doccount = 0
        for shardid, (min_d, max_d) in spans.items():
            self.docset.append((shardid, min_d, max_d))
            doccount += max_d - min_d + 1
        self._len = doccount

        if self.verbose:
            logger.info(
                f"    Worker {self.rank} ingested {len(shardfrags)} shard "
                f"fragments from {dataset}"
            )

        # Shard-file order shuffle, distinct per worker.
        random.Random(self.seed + self.rank).shuffle(self.docset)

    # -- doc addressing ---------------------------------------------------

    def _get_docid(self, i):
        """Map a worker-global doc index to (shard, span length, span min)."""
        cur = 0
        assert i <= self._len, (
            f"You have requested an illegal doc index {i}, "
            f"docset length is {self._len}"
        )
        for shardid, min_d, max_d in self.docset:
            cur += max_d - min_d + 1
            if cur > i:
                return shardid, max_d - min_d + 1, min_d

    def _random_map_docid(self, size):
        """Next within-span shuffled index from the LCG walk; states >= size
        are skipped, giving a bijection over [0, size)."""
        m = 2 ** math.ceil(math.log2(size))  # power-of-2 modulus
        a = 5
        c = (self.rank + self.seed) * 2 + 1
        state = self.lcg_state
        while True:
            state = (a * state + c) % m
            if state < size:
                return state

    # -- iteration --------------------------------------------------------

    def _open_if_new(self, path, newpath, reader):
        if newpath != path:
            del reader
            if self.verbose:
                logger.info(f"Worker {self.rank} opening new file {newpath}")
            return newpath, self.filehandler.open(newpath)
        return path, reader

    def _emit_chunk(self, j, doc, n_chunks):
        """Chunk j of the doc, with bos on the first chunk and the delimiter
        closing the last; accounts for the bos offset in slicing. Chunks are
        int64 numpy arrays end-to-end (see ShardFileHandler.slice)."""
        start_index = j * self.chunksize
        n_pull = self.chunksize
        if self.bos is not None:
            if j == 0:
                n_pull -= 1
            else:
                start_index -= 1
        chunk = self.filehandler.slice(doc, start_index, n_pull)
        self.tokens_seen += len(chunk)
        parts = [np.asarray(chunk, dtype=np.int64)]
        if self.bos is not None and j == 0:
            parts.insert(0, np.array([self.bos], dtype=np.int64))
        if j == n_chunks - 1:
            parts.append(np.array([self.eos], dtype=np.int64))
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _quarantine(self, shardid, err) -> None:
        """Mark ``shardid`` unreadable: its reads kept failing after the
        retry layer gave up. The shard's remaining docs are skipped (the
        run survives); the set rides in the state_dict. If EVERY owned
        shard is quarantined the stream would go silent — that is fatal."""
        if shardid not in self.quarantined_shards:
            self.quarantined_shards.append(shardid)
            logger.error(
                "Worker %d quarantining shard %s after exhausted retries "
                "(%s); its remaining documents will be skipped",
                self.rank,
                shardid,
                err,
            )
        owned = set(s for s, _, _ in self.docset)
        if owned and owned.issubset(set(self.quarantined_shards)):
            # typed: under a SamplingDataset this degrades the MIX
            # (corpus quarantined, weights renormalized over survivors)
            # instead of killing the run; a single-corpus pipeline still
            # surfaces it fatally
            raise CorpusUnreadableError(
                f"worker {self.rank}: all {len(owned)} owned shards are "
                f"quarantined; no readable data remains"
            ) from err

    def __iter__(self):
        if not self.is_setup:
            self.setup()
        docset_offset = self.docset_index
        lcg_offset = self.lcg_state
        # chunks of the offset doc already emitted before checkpoint; they
        # are replayed at the END of the epoch so the epoch stays exact
        residual_chunks = self.chunk_index + 1
        ndocs = self._len
        if ndocs == 0:
            raise CorpusUnreadableError(
                f"worker {self.rank}: no readable documents in "
                f"{self.datapath}"
                + (
                    f" ({len(self.quarantined_shards)} shard(s) "
                    f"quarantined: {self.quarantined_shards})"
                    if self.quarantined_shards
                    else ""
                )
            )
        path = ""
        reader = None
        first_pass = True
        while True:
            # Epoch boundary (and resume start): re-probe quarantined
            # shards. A transient storage outage outlasting the retry
            # budget must not exclude data for the rest of a multi-week
            # run — each new pass retries the shard once (one bounded
            # retry cycle per epoch if it is still dead, after which it
            # re-quarantines). Shards unreadable at SETUP contribute zero
            # docs for the whole run (their docset spans are fixed); only
            # iteration-time quarantine heals here.
            if self.quarantined_shards and not first_pass:
                logger.info(
                    "Worker %d re-probing %d quarantined shard(s) at the "
                    "epoch boundary: %s",
                    self.rank,
                    len(self.quarantined_shards),
                    self.quarantined_shards,
                )
                self.quarantined_shards = [
                    s
                    for s in self.quarantined_shards
                    if s in self.setup_quarantined
                ]
            first_pass = False
            for i in range(ndocs):
                doc_index = (docset_offset + i) % ndocs
                if doc_index == 0:
                    self.epochs_seen += 1
                self.docset_index = doc_index
                shardid, docrange, mindoc = self._get_docid(doc_index)

                doclcg = self._random_map_docid(docrange)
                if shardid in self.quarantined_shards:
                    self.lcg_state = doclcg  # keep the walk deterministic
                    continue
                docid = doclcg + mindoc
                try:
                    newpath = os.path.join(self.datapath, shardid)
                    path, reader = self._open_if_new(path, newpath, reader)
                    doc = self.filehandler.get(reader, docid, self.drop)
                except OSError as e:
                    # retries exhausted inside the handler: quarantine the
                    # shard and move on instead of killing the run
                    path, reader = "", None
                    self._quarantine(shardid, e)
                    self.lcg_state = doclcg
                    continue
                if len(doc) == 0:
                    continue
                doclen = len(doc) + 1 if self.bos is None else len(doc) + 2
                if doclen >= self.min_length:
                    n_chunks = math.ceil(doclen / self.chunksize)
                    for j in range(n_chunks):
                        if i == 0 and j < residual_chunks:
                            continue  # skipped now, replayed at epoch end
                        self.chunk_index = j
                        if j == n_chunks - 1:
                            self.docs_seen += 1
                            self.percent_seen = (
                                self.docs_seen * 100 / (self._len + 1e-9)
                            )
                        yield self._emit_chunk(j, doc, n_chunks)

                self.lcg_state = doclcg

            # Epoch complete except the skipped residual chunks: rewind to
            # the offset doc and emit them now.
            self.docset_index = docset_offset
            self.lcg_state = lcg_offset
            shardid, docrange, mindoc = self._get_docid(docset_offset)
            docid = self._random_map_docid(docrange) + mindoc
            if shardid in self.quarantined_shards:
                continue
            try:
                newpath = os.path.join(self.datapath, shardid)
                path, reader = self._open_if_new(path, newpath, reader)
                doc = self.filehandler.get(reader, docid, self.drop)
            except OSError as e:
                path, reader = "", None
                self._quarantine(shardid, e)
                continue
            if len(doc) == 0:
                continue
            doclen = len(doc) + 1 if self.bos is None else len(doc) + 2
            if doclen >= self.min_length:
                n_chunks = math.ceil(doclen / self.chunksize)
                for j in range(residual_chunks):
                    self.chunk_index = j
                    yield self._emit_chunk(j, doc, n_chunks)

    def load_state_dict(self, state_dicts, sharded_input=False):
        self.setup()
        if self.load_worldsize != self.worldsize:
            # a real diagnostic, not a bare assert: this is where an
            # illegal elastic resume lands when the checkpoint-side
            # topology gate was bypassed (direct pipeline construction,
            # hand-copied loader state)
            raise RuntimeError(
                f"StreamingDocDataset does not support rescaling: the "
                f"checkpoint holds {self.load_worldsize} reader state(s) "
                f"but this world expects {self.worldsize}. A bare reader "
                f"resumes only at its save world size — wrap it in "
                f"ScalableShardDataset (n_logical_shards divisible by "
                f"every process x worker product you may restart on, "
                f"the production get_data_loader layout), or restart "
                f"with the original world size."
            )
        d = self.dataset
        # this run's own setup-time probe failures, before the restored
        # state overwrites the attribute
        own_setup_q = set(self.setup_quarantined)
        out = super().load_state_dict(state_dicts, sharded_input)
        assert d == self.dataset, (
            f"Dataset mismatch: checkpoint contains {self.dataset}, expected {d}"
        )
        # the restored state replaced both quarantine lists wholesale;
        # THIS run's own setup-probe failures must merge back in (the
        # live docset already zeroes them, and dropping them here would
        # persist a checkpoint without them — re-creating the shifted-
        # walk bug one save later, when that checkpoint is resumed on a
        # healed shard)
        ckpt_setup_q = set(self.setup_quarantined)
        merged = own_setup_q | ckpt_setup_q
        ckpt_added = merged - own_setup_q
        newly_broken = own_setup_q - ckpt_setup_q
        self.setup_quarantined = sorted(merged)
        for s in self.setup_quarantined:
            if s not in self.quarantined_shards:
                self.quarantined_shards.append(s)
        if newly_broken:
            # the reverse direction is NOT fixable: these shards held
            # readable docs when the checkpoint was written, and this
            # run cannot serve them — the restored docset_index/
            # lcg_state index a shrunk docset, so the walk position is
            # approximate (documents near the boundary may replay or
            # skip for the rest of the epoch). Say so loudly instead of
            # resuming as if nothing changed.
            logger.warning(
                "Worker %d: %d shard(s) readable at checkpoint time "
                "failed this run's setup probe (%s); their documents "
                "are unavailable and the restored stream position is "
                "approximate for the rest of the epoch",
                self.rank,
                len(newly_broken),
                sorted(newly_broken),
            )
        if ckpt_added:
            # the checkpoint carries setup-quarantined shards this run's
            # probe succeeded on (healed since the save): the saved
            # docset_index/lcg_state walk a docset where those shards
            # had zero docs, so rebuild ours to match — a heal must wait
            # for the natural epoch boundary, not shift the walk under a
            # restored position. (Own-only shards need no rebuild: the
            # docset built at setup already zeroes them.)
            logger.info(
                "Worker %d re-applying %d setup-quarantined shard(s) from "
                "the checkpoint before the docset rebuild: %s",
                self.rank,
                len(ckpt_added),
                sorted(ckpt_added),
            )
            self._build_docset()
        return out


class ScalableShardDataset(WrapperDataset):
    """Rescaling layer: the wrapped reader is cloned into ``n_logical_shards``
    logical workers (rank i of n_logicals); this physical rank owns
    n/worldsize of them and draws one document at a time from a logical
    chosen ∝ docs-remaining, so data seen this epoch stays un-revisited
    under any future world size dividing n_logicals."""

    def __init__(
        self,
        dataset: StreamingDocDataset,
        delimiter_token: Any,
        n_logical_shards: int = 2048,
        verbose=False,
    ):
        super().__init__(dataset)
        assert n_logical_shards % self.worldsize == 0, (
            f"World size {self.worldsize} must divide n_logical_shards "
            f"{n_logical_shards} evenly"
        )
        assert (
            n_logical_shards > 0
        ), f"n_logical_shards {n_logical_shards} must be a positive integer"
        self.total_shards = n_logical_shards
        self.delimiter = delimiter_token
        self.verbose = verbose

        self.data: List[StreamingDocDataset] = []
        self.logicals_owned: List[int] = []
        self.n_logicals = 0
        self.n_docs_remaining: List[int] = []
        self.generator: Optional[np.random.Generator] = None

        # Position state is meaningful only at unchanged world size; on
        # rescale it is dropped with the other state_params.
        self.current_reader = None
        self.logical_shard_states = None
        self.g_state = None

        self.state_params = ["current_reader", "g_state"]
        self.reshard_params = ["n_docs_remaining", "logical_shard_states"]

    def setup(self):
        if self.is_setup:
            return
        StatefulDataset.setup(self)
        if self.total_shards % self.worldsize != 0:
            # checked at setup (not just __init__) because the loader's
            # worker inflation multiplies worldsize after construction
            raise RuntimeError(
                f"n_logical_shards {self.total_shards} is not divisible "
                f"by the loader world size {self.worldsize} (= process "
                f"count x num_workers): logical shards cannot be "
                f"partitioned evenly. Adjust --logical_shards or "
                f"--num_workers (or the host count) so the product "
                f"divides {self.total_shards}."
            )
        logicals = list(range(self.total_shards))
        self.logicals_owned = shard_partition(logicals, self.rank, self.worldsize)
        self.n_logicals = self.total_shards // self.worldsize
        assert (
            len(self.logicals_owned) == self.n_logicals
        ), "(world size * num workers) does not divide logical shards evenly"

        for i in range(self.n_logicals):
            shard = deepcopy(self.dataset)
            shard.worldsize = self.total_shards
            shard.load_worldsize = self.total_shards
            shard.rank = self.logicals_owned[i]
            shard.local_worldsize = 1
            shard.datapath = self.datapath
            shard.verbose = self.rank == 0
            self.data.append(shard)
            if self.verbose:
                logger.info(
                    f"Worker {self.rank} assembled logical shard "
                    f"{self.logicals_owned[i]}, {i + 1} of {self.n_logicals}"
                )
        for d in self.data:
            d.setup()
        self.n_docs_remaining = [d._len for d in self.data]
        self.generator = np.random.default_rng(self.rank)

    def _sample_logical(self) -> int:
        weights = np.asarray(self.n_docs_remaining, dtype=np.float64)
        total = weights.sum()
        assert total > 0, f"No documents detected in {self.datapath}"
        return int(self.generator.choice(len(weights), p=weights / total))

    def __iter__(self):
        self.setup()
        data = [iter(d) for d in self.data]
        while True:
            if self.current_reader is not None:
                ind = self.current_reader
            else:
                ind = self._sample_logical()
            self.current_reader = ind
            # stream one full document from the chosen logical
            out = next(data[ind])
            while out[-1] != self.delimiter:
                yield out
                out = next(data[ind])
            self.current_reader = None
            self.n_docs_remaining[ind] -= 1
            if sum(self.n_docs_remaining) == 0:
                # epoch boundary: reset counts and the sampling stream
                self.n_docs_remaining = [d._len for d in self.data]
                self.generator = np.random.default_rng(self.rank)
            yield out

    def state_dict(self):
        self.setup()
        self.g_state = self.generator.bit_generator.state
        self.logical_shard_states = [d.state_dict() for d in self.data]
        return StatefulDataset.state_dict(self)

    def load_state_dict(self, state_dicts, sharded_input=False):
        self.setup()
        sharded_dicts = StatefulDataset.load_state_dict(
            self, state_dicts, sharded_input
        )
        if self.g_state is not None:
            self.generator = np.random.default_rng()
            self.generator.bit_generator.state = self.g_state
        for i in range(self.n_logicals):
            self.data[i].load_state_dict([self.logical_shard_states[i]], True)
        return sharded_dicts


class SamplingDataset(WrapperDataset):
    """Multi-dataset weighted mixing by tokens seen: each draw picks the
    subdataset furthest below its target share and holds it through a full
    document (delimiter detection).

    Production hardening (docs/dataloader.md "Multi-corpus mixing"):

    - resume state pairs subdatasets by corpus NAME, not list index —
      adding/reordering a corpus cannot silently misassign another
      corpus's walk position; a changed corpus SET is an actionable
      error unless ``allow_corpus_change`` accepts it;
    - corpus-granular fault isolation: when a corpus's whole reader
      stack dies (``CorpusUnreadableError`` — every owned shard
      quarantined), the corpus is quarantined and the mix degrades
      gracefully (weights renormalized over survivors) instead of
      killing the run; survivor epoch boundaries re-arm a quarantined
      corpus. Dropping below ``min_live_corpora`` live corpora (or
      losing the last corpus) raises ``CorpusLossError``, which the
      entry points classify as the ``corpus_loss`` supervisor exit;
    - a max-held-chunks guard releases the document hold if a
      subdataset emits chunks whose last token never equals the
      delimiter (zero-length/undelimited tail documents previously
      pinned ``current_iterator`` forever, starving every other corpus).
    """

    def __init__(
        self,
        datapath: str,
        dataset: Union[ScalableShardDataset, StreamingDocDataset],
        delimiter_token: Any,
        datasets=None,
        weights=None,
        min_live_corpora: int = 1,
        allow_corpus_change: bool = False,
        max_held_chunks: int = 4096,
        verbose=False,
    ):
        super().__init__(dataset)
        self.datapath = datapath
        self.delimiter = delimiter_token
        self.verbose = verbose
        # auto-discovery is SORTED: os.listdir order is filesystem-
        # dependent, and different ranks/hosts disagreeing on corpus
        # order would diverge the mix (and misassign per-index state)
        self.datasets = (
            list(datasets)
            if datasets is not None
            else sorted(
                f
                for f in os.listdir(datapath)
                if not os.path.isfile(os.path.join(datapath, f)) and "meta" not in f
            )
        )
        assert len(self.datasets) > 0, "You must specify at least one dataset"
        assert len(set(self.datasets)) == len(self.datasets), (
            f"Duplicate corpus names in {self.datasets}: resume state "
            f"pairs by name and requires unique names"
        )

        if weights is not None:
            assert len(weights) == len(self.datasets), (
                f"Number of oversample weights {len(weights)} must match "
                f"number of datasets {len(self.datasets)}"
            )
            for w in weights:
                assert w > 0, f"Sampling rate {w} must be positive"
        self.weights = [1] * len(self.datasets) if weights is None else weights
        self.weights = [w / sum(self.weights) for w in self.weights]

        self.min_live_corpora = max(1, int(min_live_corpora))
        self.allow_corpus_change = bool(allow_corpus_change)
        self.max_held_chunks = max(1, int(max_held_chunks))

        self.tokens_seen = [0] * len(self.datasets)
        self.current_iterator = -1
        # corpora whose reader stack died (by NAME); persisted so a
        # resume knows the mix was degraded — the iterator re-probes
        # them at start and at survivor epoch boundaries
        self.quarantined_corpora: List[str] = []
        self.state_params = [
            "tokens_seen",
            "current_iterator",
            "quarantined_corpora",
        ]
        # survivor epoch clock at quarantine time (name -> clock); None
        # = eligible for an immediate re-probe (fresh iterator /
        # resume). Not persisted: a restart is a natural re-probe point.
        self._rearm_snapshot: dict = {}
        self._held_chunks = 0
        self._starve_warned: Set[str] = set()
        self._pending = None  # (corpus index, first chunk) from a re-arm

    def setup(self):
        if self.is_setup:
            return
        StatefulDataset.setup(self)
        self.data = []
        for i, d in enumerate(self.datasets):
            clone = deepcopy(self.dataset)
            clone.datapath = os.path.join(self.datapath, d)
            clone.rank = self.rank
            clone.worldsize = self.worldsize
            clone.local_worldsize = self.local_worldsize
            self.data.append(clone)
            if self.verbose:
                logger.info(
                    f"Worker {self.rank} assembled subdataset iterator for "
                    f"{d}, {i + 1} of {len(self.datasets)}"
                )
        for d in self.data:
            d.setup()

    # -- fault isolation ---------------------------------------------------

    def _live_indices(self) -> List[int]:
        return [
            i
            for i, n in enumerate(self.datasets)
            if n not in self.quarantined_corpora
        ]

    def _survivor_epochs(self) -> int:
        """Monotonic epoch clock over the LIVE corpora: advances as their
        readers wrap epochs (per logical shard under
        ScalableShardDataset). Quarantined corpora re-probe when this
        clock has advanced past their quarantine snapshot — the corpus-
        level analog of the shard-level epoch-boundary re-probe."""
        total = 0
        for i in self._live_indices():
            sub = self.data[i]
            readers = getattr(sub, "data", None)
            if isinstance(readers, list) and readers:
                total += sum(getattr(r, "epochs_seen", 0) for r in readers)
            else:
                total += getattr(sub, "epochs_seen", 0)
        return total

    def _quarantine_corpus(self, i: int, err) -> None:
        """Quarantine corpus ``i``: the mix degrades to the survivors
        with weights renormalized, or — below the ``min_live_corpora``
        floor — raises the classified ``CorpusLossError``."""
        name = self.datasets[i]
        if name not in self.quarantined_corpora:
            self.quarantined_corpora.append(name)
            self._rearm_snapshot[name] = self._survivor_epochs()
            _MIX_EVENTS["corpus_quarantined"] += 1
        live = self._live_indices()
        if len(live) < self.min_live_corpora:
            raise CorpusLossError(
                f"worker {self.rank}: corpus {name!r} is unreadable and "
                f"only {len(live)} of {len(self.datasets)} corpora remain "
                f"live — below min_live_corpora={self.min_live_corpora} "
                f"(quarantined: {self.quarantined_corpora}). Restore the "
                f"corpus data and restart (the supervisor classifies "
                f"this exit as corpus_loss), or lower --min_live_corpora "
                f"to accept training on the surviving mix."
            ) from err
        wsum = sum(self.weights[j] for j in live)
        renorm = {
            self.datasets[j]: round(self.weights[j] / wsum, 4) for j in live
        }
        logger.error(
            "worker %d: corpus %r quarantined (%s); mix degrades to %d "
            "live corpora with weights renormalized over survivors: %s "
            "— survivor epoch boundaries re-probe and re-arm it if it "
            "heals",
            self.rank,
            name,
            err,
            len(live),
            renorm,
        )

    def _injected_kill(self, i: int) -> bool:
        """``corpus_kill`` fault site (resilience/faults.py): every owned
        shard of one corpus dies at once. Filter: ``corpus=`` (a
        substring). Consulted at document boundaries and re-probes."""
        from fms_fsdp_tpu_torch.resilience.faults import fire_fault

        return fire_fault("corpus_kill", corpus=self.datasets[i]) is not None

    def _maybe_rearm(self, data) -> None:
        """Re-probe quarantined corpora whose snapshot the survivor
        epoch clock has passed (at most one re-arm per document
        boundary). A successful probe pulls the corpus's next chunk —
        stashed in ``_pending`` and served immediately, so the probe
        never skips data."""
        if not self.quarantined_corpora:
            return
        clock = self._survivor_epochs()
        for name in list(self.quarantined_corpora):
            snap = self._rearm_snapshot.get(name)
            if snap is not None and clock <= snap:
                continue
            i = self.datasets.index(name)
            if self._injected_kill(i):
                self._rearm_snapshot[name] = clock
                continue
            it = iter(self.data[i])
            try:
                out = next(it)
            except CorpusUnreadableError:
                self._rearm_snapshot[name] = clock
                continue
            data[i] = it
            self.quarantined_corpora.remove(name)
            self._rearm_snapshot.pop(name, None)
            _MIX_EVENTS["corpus_rearmed"] += 1
            logger.info(
                "worker %d: corpus %r healed; re-armed into the mix "
                "(weights restored to their configured shares)",
                self.rank,
                name,
            )
            self._pending = (i, out)
            return

    def _select_corpus(self) -> int:
        """Most-undertarget LIVE subdataset next (ties -> higher index),
        with weights renormalized over the live set."""
        while True:
            live = self._live_indices()
            total = sum(self.tokens_seen[j] for j in live) + 1e-9
            wsum = sum(self.weights[j] for j in live)
            choice = max(
                (self.weights[j] / wsum - self.tokens_seen[j] / total, j)
                for j in live
            )[1]
            if self._injected_kill(choice):
                self._quarantine_corpus(
                    choice,
                    CorpusUnreadableError(
                        f"injected corpus_kill: {self.datasets[choice]}"
                    ),
                )
                continue
            return choice

    def __iter__(self):
        self.setup()
        data = [iter(d) for d in self.data]
        self._held_chunks = 0
        self._pending = None
        # restored quarantine: eligible for an immediate re-probe (a
        # restart is a natural heal point)
        for name in self.quarantined_corpora:
            self._rearm_snapshot.setdefault(name, None)
        while True:
            out = None
            if self.current_iterator == -1:
                # document boundary: re-probe quarantined corpora, then
                # pick the most-undertarget live subdataset
                self._maybe_rearm(data)
                if self._pending is not None:
                    i, out = self._pending
                    self._pending = None
                else:
                    i = self._select_corpus()
                self.current_iterator = i
            else:
                i = self.current_iterator
            if out is None:
                try:
                    out = next(data[i])
                except CorpusUnreadableError as e:
                    # the corpus's reader stack is dead: quarantine it
                    # (or raise CorpusLossError below the floor) and
                    # release any mid-document hold — the partial
                    # document is lost with its corpus
                    self._quarantine_corpus(i, e)
                    self.current_iterator = -1
                    self._held_chunks = 0
                    continue
            self.tokens_seen[i] += len(out)
            self._held_chunks += 1
            if out[-1] == self.delimiter:
                self.current_iterator = -1
                self._held_chunks = 0
            elif self._held_chunks >= self.max_held_chunks:
                # starvation guard: a chunk stream that never closes
                # with the delimiter (zero-length/undelimited tail
                # document, or a delimiter mismatch between pipeline
                # layers) would otherwise pin current_iterator forever
                # and starve every other corpus
                name = self.datasets[i]
                if name not in self._starve_warned:
                    self._starve_warned.add(name)
                    logger.warning(
                        "worker %d: corpus %r emitted %d chunks without "
                        "a document delimiter (%r); releasing the "
                        "document hold so other corpora keep serving — "
                        "check the corpus's delimiter/eos configuration",
                        self.rank,
                        name,
                        self._held_chunks,
                        self.delimiter,
                    )
                self.current_iterator = -1
                self._held_chunks = 0
            yield out

    # -- state (keyed by corpus name) --------------------------------------

    def state_dict(self):
        self.setup()
        out = {
            self.statename("sample_iterator_states"): [
                d.state_dict() for d in self.data
            ],
            # the pairing key for resume: state follows the corpus NAME,
            # never the config-list index
            self.statename("corpus_names"): list(self.datasets),
            self.statename("mix_weights"): list(self.weights),
        }
        out.update(StatefulDataset.state_dict(self))
        return out

    def _pair_by_name(self, saved_names: List[str]) -> dict:
        """live index -> saved index for corpora present in both; gate
        corpus-set changes behind ``allow_corpus_change``."""
        added = [n for n in self.datasets if n not in saved_names]
        removed = [n for n in saved_names if n not in self.datasets]
        if (added or removed) and not self.allow_corpus_change:
            raise RuntimeError(
                f"worker {self.rank}: the corpus set changed across the "
                f"resume — checkpoint has {saved_names}, this run mixes "
                f"{self.datasets} (added: {added or 'none'}, removed: "
                f"{removed or 'none'}). Per-corpus mix state pairs by "
                f"name and cannot follow a changed set. Restart with "
                f"--datasets={','.join(saved_names)}, or pass "
                f"--allow_corpus_change=True to accept it (removed "
                f"corpora drop their stream position; new corpora start "
                f"cold at zero tokens_seen)."
            )
        if added or removed:
            logger.warning(
                "worker %d: resuming across a corpus-set change "
                "(allow_corpus_change=True): added %s start cold, "
                "removed %s drop their stream position",
                self.rank,
                added or "none",
                removed or "none",
            )
        return {
            li: saved_names.index(n)
            for li, n in enumerate(self.datasets)
            if n in saved_names
        }

    def load_state_dict(self, state_dicts, sharded_input=False):
        self.setup()
        sharded_dicts = StatefulDataset.load_state_dict(
            self, state_dicts, sharded_input
        )
        states_key = self.statename("sample_iterator_states")
        names_key = self.statename("corpus_names")
        saved_names = sharded_dicts[0].get(names_key)
        legacy = saved_names is None
        if legacy:
            # pre-name-keyed checkpoint: index pairing is all there is,
            # and it is only sound when the corpus COUNT matches
            if any(
                len(sd.get(states_key, [])) != len(self.data)
                for sd in sharded_dicts
            ):
                raise RuntimeError(
                    f"worker {self.rank}: legacy (un-named) mix state "
                    f"holds a different corpus count than this run's "
                    f"{len(self.data)} — index pairing would misassign "
                    f"corpus state. Restart with the save-time "
                    f"--datasets list."
                )
            logger.warning(
                "worker %d: mix state predates name-keyed resume; "
                "pairing %d corpora by index — verify the --datasets "
                "order matches the save",
                self.rank,
                len(self.data),
            )
            saved_names = list(self.datasets)
        pair = self._pair_by_name(list(saved_names))

        saved_weights = sharded_dicts[0].get(self.statename("mix_weights"))
        if saved_weights is not None and any(
            si < len(saved_weights)
            and abs(float(saved_weights[si]) - float(self.weights[li])) > 1e-9
            for li, si in pair.items()
        ):
            # a weight change is LEGAL (docs/dataloader.md): the token-
            # share controller simply steers toward the new targets —
            # but say so, because the realized mix shifts from here
            logger.info(
                "worker %d: mixing weights changed across the resume "
                "(saved %s -> live %s); the token-share controller "
                "steers toward the new targets from here, no stream "
                "position is lost",
                self.rank,
                [round(float(w), 4) for w in saved_weights],
                [round(float(w), 4) for w in self.weights],
            )

        same_size = self.load_worldsize == self.worldsize
        if same_size:
            # the base class restored the scalar state in SAVED order;
            # remap it onto the live corpus order by name
            saved_tokens = list(self.tokens_seen)
            saved_current = self.current_iterator
            saved_quarantined = list(self.quarantined_corpora or [])
            self.tokens_seen = [
                (
                    saved_tokens[pair[li]]
                    if li in pair and pair[li] < len(saved_tokens)
                    else 0
                )
                for li in range(len(self.datasets))
            ]
            self.current_iterator = -1
            if saved_current is not None and 0 <= saved_current < len(
                saved_names
            ):
                held = saved_names[saved_current]
                if held in self.datasets:
                    self.current_iterator = self.datasets.index(held)
                else:
                    logger.warning(
                        "worker %d: the checkpoint held corpus %r "
                        "mid-document but it is not in this run's mix; "
                        "releasing the hold",
                        self.rank,
                        held,
                    )
            self.quarantined_corpora = [
                n for n in saved_quarantined if n in self.datasets
            ]
        else:
            # rescale: scalar mix state was dropped by the base class —
            # the token-share controller re-converges to the target mix
            # from zero while every corpus's document walk reshards
            # exactly (zero replays) through its own sub-state below
            self.tokens_seen = [0] * len(self.datasets)
            self.current_iterator = -1
            self.quarantined_corpora = []
            logger.info(
                "worker %d: elastic rescale (%d -> %d loader ranks) "
                "resets per-corpus tokens_seen; the mix re-converges to "
                "its target shares (document walks reshard exactly)",
                self.rank,
                self.load_worldsize,
                self.worldsize,
            )
        self._rearm_snapshot = {n: -1 for n in self.quarantined_corpora}

        for li, si in pair.items():
            subdata = self.data[li]
            subdata.load_worldsize = self.load_worldsize
            subdata.load_state_dict(
                [sd[states_key][si] for sd in sharded_dicts],
                True,
            )
        return sharded_dicts
