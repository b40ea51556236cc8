"""Pipeline post-processing layers: packing, shuffling, mapping, and
auto-checkpointing (ref:fms_fsdp/utils/dataset_utils.py:463-794).

A copy of ``fms_fsdp_tpu/data/buffering.py``; ``CheckpointDataset``
resolves step dirs with the port's ``utils/ckpt_paths.py``.
"""

import logging
import os
import time
from typing import Any, Callable, List

import numpy as np

from fms_fsdp_tpu_torch.data.stateful import StatefulDataset, WrapperDataset
from fms_fsdp_tpu_torch.utils.ckpt_paths import (
    get_latest,
    is_step_ckp,
    safe_listdir,
    step_number,
)

_EMPTY = np.empty(0, dtype=np.int64)

logger = logging.getLogger(__name__)


class PreprocessDataset(WrapperDataset):
    """Apply a map function to every item of the wrapped stream."""

    def __init__(self, dataset: StatefulDataset, aug_fn: Callable):
        super().__init__(dataset)
        self.aug_fn = aug_fn

    def __iter__(self):
        dataset = iter(self.dataset)
        while True:
            yield self.aug_fn(next(dataset))


class BufferDataset(WrapperDataset):
    """Pack variable-length sequences into fixed ``seq_len`` lines.

    Greedy packing: pull until the line would overrun, split hard
    (``pack_hard``) or pad out. Optionally injects bos at line start and eos
    at line end, avoiding duplicates; a split token displaced by an injected
    eos is pushed back onto the buffer. Rescales by dropping buffer state.
    """

    def __init__(
        self,
        dataset: StatefulDataset,
        seq_len: int,
        pack_hard: bool,
        bos_token=None,
        eos_token=None,
        pad_token=None,
    ):
        super().__init__(dataset)
        self.len = seq_len
        self.buffer: List = []
        self.bos = bos_token
        self.eos = eos_token
        self.pad = pad_token
        self.pack_hard = pack_hard
        if not pack_hard:
            assert (
                pad_token is not None
            ), "Error: if using pads, you must supply a pad_token"
        self.state_params = ["buffer"]

    def _assemble_line(self, iterable, length, buffer):
        """Return (line, leftover_buffer). All segments are int64 numpy
        arrays — per-token list surgery was a top loader hotspot; the
        concatenation count per line is the same as the old list version
        but each is one vectorized copy."""
        cat = np.concatenate
        new = _EMPTY
        while len(buffer) + len(new) < length:
            buffer = cat([buffer, new]) if len(new) else buffer
            new = np.asarray(next(iterable), dtype=np.int64)

        if self.bos is not None and (len(buffer) == 0 or buffer[0] != self.bos):
            buffer = cat([[self.bos], buffer])

        if len(buffer) >= length:
            # split the overfull buffer at the line boundary
            out = buffer[:length].copy()
            buffer = buffer[length:]
            if self.eos is not None and out[-1] != self.eos:
                buffer = cat([out[-1:], buffer])  # displaced token survives
                out[-1] = self.eos
            buffer = cat([buffer, new])
        elif self.pack_hard:
            # pack in as much of the new sequence as fits
            buffer = cat([buffer, new])
            out = buffer[:length].copy()
            buffer = buffer[length:]
            if self.eos is not None and out[-1] != self.eos:
                buffer = cat([out[-1:], buffer])
                out[-1] = self.eos
        else:
            # pad out the line
            if self.eos is not None and buffer[-1] != self.eos:
                buffer = cat([buffer, [self.eos]])
            if self.pad is not None:
                out = cat([buffer, np.full(length - len(buffer), self.pad)])
            else:
                out = buffer
            buffer = new
        return out, buffer

    def __iter__(self):
        dataset = iter(self.dataset)
        while True:
            # tolerate list-typed buffer state from older checkpoints
            buffer = np.asarray(self.buffer, dtype=np.int64)
            out, buffer = self._assemble_line(dataset, self.len, buffer)
            self.buffer = buffer
            yield out


class PreloadBufferDataset(WrapperDataset):
    """Shuffle via a ``window_size`` reservoir: fill the buffer, then emit a
    uniformly random slot and refill it from the stream. Consecutive inputs
    emerge ~window_size steps apart in expectation. Buffers reshard; an
    oversized buffer (after down-scaling) drains back to window_size by
    popping the tail into emitted slots."""

    def __init__(self, dataset: StatefulDataset, window_size: int):
        super().__init__(dataset)
        assert window_size > 1, (
            f"Window size {window_size} must be greater than 1 for shuffling"
            " to occur"
        )
        self.window_size = window_size
        self.g_state = None
        self.generator = np.random.default_rng(self.rank)
        self.buffer: List[List[Any]] = []
        self.buffer_size = 0
        self.state_params = ["g_state"]
        self.reshard_params = ["buffer"]

    def _pad_buffer(self):
        if self.buffer_size < self.window_size:
            self.buffer += [[]] * (self.window_size - self.buffer_size)

    def __iter__(self):
        dataset = iter(self.dataset)
        while True:
            self._pad_buffer()
            # grow an undersized buffer
            if self.buffer_size < self.window_size:
                self.buffer[self.buffer_size] = next(dataset)
                self.buffer_size += 1

            i = int(self.generator.integers(self.buffer_size))
            out = self.buffer[i]
            if self.buffer_size > self.window_size:
                # shrink an oversized (post-rescale) buffer
                self.buffer[i] = self.buffer[self.buffer_size - 1]
                self.buffer_size -= 1
            else:
                self.buffer[i] = next(dataset)
            yield out

    def state_dict(self):
        self.g_state = self.generator.bit_generator.state
        self.buffer = self.buffer[: self.buffer_size]
        return super().state_dict()

    def load_state_dict(self, state_dicts, sharded_input=False):
        sharded_dicts = super().load_state_dict(state_dicts, sharded_input)
        if self.g_state is not None:
            self.generator = np.random.default_rng()
            self.generator.bit_generator.state = self.g_state
        self.buffer_size = len(self.buffer)
        return sharded_dicts


class CheckpointDataset(WrapperDataset):
    """Auto-save the full pipeline state every ``interval`` complete batches
    to ``<save_path>/checkpoints/step_N_ckp/loader_state_<rank>.pkl``, and
    auto-load the newest valid checkpoint at setup (preferring the save
    directory — a restarted job resumes itself; an external load path
    resets the step count)."""

    # advertises the empty-path fresh-start marker contract to
    # Checkpointer.load (load_from_path("") = "the trainer resolved a
    # from-scratch start"); loaders without this flag are left untouched
    # exactly as before the marker existed
    supports_fresh_start = True

    def __init__(
        self,
        dataset: StatefulDataset,
        load_path: str,
        interval: int,
        steps_per_batch: int = 1,
        save_path: str = "",
        extra_roots=(),
    ):
        super().__init__(dataset)
        self.interval = interval
        self.spb = steps_per_batch
        load_path = os.path.join(load_path, "checkpoints")
        if len(save_path) == 0:
            save_path = load_path
        else:
            save_path = os.path.join(save_path, "checkpoints")
        self.load_path = load_path
        self.path = save_path
        # additional checkpoint roots the trainer may resolve a restart
        # from (the async manager's fast-local tier): a step dir under
        # any of these is a trainer-resolved restore, same as the
        # primary roots (see load_from_path)
        self.extra_roots = tuple(extra_roots)
        self.step = 0
        self.ministep = 0

    def setup(self):
        if not self.is_setup:
            super().setup()
            if not getattr(self, "_explicit_restore", False):
                self.load_from_path(self.load_path)

    def __iter__(self):
        self.setup()
        dataset = iter(self.dataset)
        while True:
            out = next(dataset)
            # count (and save) eagerly before yielding: without worker
            # prefetch running ahead, a lazy post-yield count would delay
            # the interval-N save until batch N+1 is pulled
            self.ministep += 1
            if self.ministep == self.spb:
                self.ministep = 0
                self.step += 1
                if self.step % self.interval == 0:
                    newpath = os.path.join(self.path, f"step_{self.step}_ckp")
                    self.save_to_path(newpath)
            yield out

    def report(self, msg):
        if self.rank == 0:
            print(msg)

    def _validate_ckp_path(self, path: str, verbose: bool = False):
        """Resolve path to the newest checkpoint dir CONTAINING loader
        state, or ''. Scans step dirs newest-first rather than inspecting
        only the single newest: the checkpoints folder interleaves model
        checkpoints (Checkpointer.save) with loader auto-saves, and when
        their step numbering drifts (see get_data_loader's
        batch_multiplier note) the newest dir may be model-only."""
        if not os.path.exists(path) or len(os.listdir(path)) == 0:
            if verbose:
                self.report(
                    f"  Dataset: No valid checkpoint detected at {path}, "
                    "dataset starting from scratch."
                )
            return ""
        candidates = sorted(
            (
                os.path.join(path, x)
                for x in os.listdir(path)
                if is_step_ckp(x)
            ),
            key=step_number,
            reverse=True,
        )
        for cand in candidates:
            if os.path.isdir(cand) and any(
                "loader" in x for x in safe_listdir(cand)
            ):
                if verbose:
                    self.report(f"Checkpoint detected at {cand}")
                self.step = step_number(cand)
                return cand
        if verbose:
            self.report(
                f"  Dataset: Checkpoints exist under {path} but none "
                "contain dataset state. Dataset starting from scratch."
            )
        return ""

    def save_to_path(self, path: str):
        self.report(f"Saving dataset to {path}")
        start = time.time()
        super().save_to_path(path)
        self.report(
            f"Dataset successfully saved to {path}! "
            f"Save time: {time.time() - start}"
        )

    def load_from_path(self, path: str):
        # The trainer's RESOLVED restart checkpoint — a step dir inside
        # this run's own checkpoints folder, holding loader state — is
        # authoritative: the model restored exactly from it, and the
        # auto-detect below would instead pick the NEWEST loader state
        # on disk, which after a fallback resume (torn newest
        # checkpoint skipped, supervisor relaunch after a mid-commit
        # kill) can be a loader auto-save AHEAD of the model — silently
        # skipping every batch between the two positions (model@N +
        # loader@M>N). Restoring the committed pair keeps the resumed
        # stream exactly the committed stream (scripts/chaos_soak.py
        # pins bit-identity on this). The flag suppresses setup()'s
        # auto-load, which would clobber the explicit restore.
        #
        # An EMPTY path is the same contract's other verdict: the
        # trainer resolved NO restorable checkpoint (every candidate
        # torn, quarantined, or absent) and the model starts from
        # scratch — so must the walk THROUGH THIS RUN'S OWN SAVE DIR.
        # Loader auto-saves land there on the dataset's own interval
        # cadence whether or not the model commit ever completed, so
        # without this marker setup()'s auto-load would resume the walk
        # from a stale auto-save under fresh model state (model@0 +
        # loader@N), shifting the consumed stream of the entire
        # restarted run. An EXTERNAL load root (resuming_dataset=True,
        # continued pretraining) is still honored below: that loader
        # state belongs to a different run and cannot outrun this run's
        # model state.
        if path == "":
            self._explicit_restore = True
            self.setup()
            self.report(
                "  Dataset: trainer resolved a from-scratch start; "
                "ignoring loader auto-saves in the save directory."
            )
            if os.path.abspath(self.load_path) != os.path.abspath(self.path):
                self._load_external()
            return
        resolved = os.path.abspath(path)
        own_roots = {
            os.path.abspath(p)
            for p in (self.path, self.load_path, *self.extra_roots)
        }
        if (
            os.path.dirname(resolved) in own_roots
            and os.path.isdir(resolved)
            and any("loader" in x for x in safe_listdir(resolved))
        ):
            # flag BEFORE setup(): it suppresses setup()'s auto-load, and
            # setup() must run first — it propagates the (possibly
            # worker-inflated) rank/worldsize down the wrapper stack,
            # which the restore's shard partitioning depends on (the
            # auto-load path gets this ordering from __iter__)
            self._explicit_restore = True
            self.setup()
            self.step = step_number(resolved)
            start = time.time()
            self.dataset.load_from_path(resolved)
            self.report(
                f"Dataset checkpoint loaded (trainer-resolved "
                f"{resolved})! Load time: {time.time() - start}"
            )
            return
        # a checkpoint in the save dir means this job restarted: prefer it
        save_path = self._validate_ckp_path(self.path, False)
        if len(save_path) > 0:
            self.report(
                f"  Dataset: Detected a checkpoint in the save directory "
                f"{save_path}. Restoring from this checkpoint."
            )
            start = time.time()
            self.dataset.load_from_path(save_path)
            self.report(
                f"Dataset checkpoint loaded! Load time: {time.time() - start}"
            )
            return
        self._load_external()

    def _load_external(self):
        """Restore from the EXTERNAL load root (``resuming_dataset=True``
        continued pretraining): that loader state belongs to a different
        run, so the step count restarts. Shared by the auto-detect path
        and the fresh-start marker (which only rules out this run's own
        save dir)."""
        load_path = self._validate_ckp_path(self.load_path, True)
        if len(load_path) == 0:
            return
        self.step = 0  # external checkpoint: step restarts
        start = time.time()
        self.dataset.load_from_path(load_path)
        self.report(f"Dataset checkpoint loaded! Load time: {time.time() - start}")
