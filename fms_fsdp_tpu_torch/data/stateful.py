"""Stateful, rescalable iterator pipeline — base layer.

A copy of ``fms_fsdp_tpu/data/stateful.py``. Design principles carried
over from the reference dataloader (ref:fms_fsdp/utils/dataset_utils.py:
19-42):

1. workers never communicate — distribution is parameterized by
   (rank, worldsize) integers only;
2. the pipeline is a stack of wrapped iterators;
3. every layer checkpoints itself via recursive state_dict/load_state_dict;
4. state splits into ``state_params`` (scalars, droppable on rescale) and
   ``reshard_params`` (lists, redistributed by fractional ownership when the
   world size changes) — the mechanism behind restart-on-different-card-count
   (ref:dataset_utils.py:136-161).

Values are python lists / numpy arrays and per-rank state files are
stdlib pickles of builtins and numpy only, with the same class-qualified
keys as the JAX package, so a ``loader_state_<rank>.pkl`` written by
either package loads in the other. ``num_workers`` is realized as logical
sub-ranks by the loader (see loader.py), so the worker-id rank inflation
the reference performs inside worker processes (ref:dataset_utils.py:
108-119) happens at construction instead.
"""

import logging
import math
import os
import pickle
from typing import Any, List

logger = logging.getLogger(__name__)


def shard_partition(itemlist: List[Any], rank: int, worldsize: int) -> List[Any]:
    """Contiguous 1/worldsize slice of itemlist owned by rank (exact
    partition; uneven remainders spread by integer flooring)."""
    n = len(itemlist)
    return itemlist[(rank * n) // worldsize : ((rank + 1) * n) // worldsize]


def shard_inclusive(itemlist: List[Any], rank: int, worldsize: int) -> List[Any]:
    """Like shard_partition but with fractional ownership: include any item
    partially owned by rank (floor/ceil bounds)."""
    n = len(itemlist)
    start = math.floor(n * rank / worldsize)
    end = math.ceil(n * (rank + 1) / worldsize)
    return itemlist[start:end]


class StatefulDataset:
    """Iterable with recursive checkpoint state and rescaling support.

    Subclasses declare ``state_params`` (per-worker scalars, dropped when the
    world size changes) and ``reshard_params`` (lists redistributed across
    the new world size).
    """

    def __init__(self, datapath, rank: int, worldsize: int):
        assert rank >= 0, f"Rank {rank} must be a non-negative integer"
        assert worldsize > rank, f"Worldsize {worldsize} must exceed rank {rank}"
        assert datapath is None or (
            os.path.isdir(datapath) and len(os.listdir(datapath)) > 0
        ), f"Data path {datapath} must be a non-empty folder or None"
        self.state_params: List[str] = []
        self.reshard_params: List[str] = []

        self.datapath = datapath
        self.rank = rank
        self.worldsize = worldsize
        self.local_worldsize = -1

        self.load_worldsize = worldsize
        self.is_setup = False

    # -- setup ------------------------------------------------------------

    def setup(self):
        """Rank/path-dependent setup, deferred so that wrapper layers can
        re-target rank/datapath after construction."""
        if not self.is_setup:
            self.is_setup = True
            if self.local_worldsize == -1:
                self.local_worldsize = 1

    def __iter__(self):
        raise NotImplementedError

    # -- state ------------------------------------------------------------

    def statename(self, x: str) -> str:
        # Class-qualified keys; implicitly disallows repeating a layer type
        # within one pipeline.
        return self.__class__.__name__ + "." + x

    def state_dict(self):
        self.setup()
        return {
            self.statename(flag): getattr(self, flag)
            for flag in self.state_params + self.reshard_params
        }

    def _reshard(self, sharded_list):
        """Flatten the (inclusively owned) per-checkpoint-shard lists and
        slice out exactly the fraction this worker owns.

        ``sharded_list`` is a list of equal-length shard sublists spanning
        this worker's inclusive ownership range.
        """
        shard_offset = math.floor(self.load_worldsize * self.rank / self.worldsize)
        shard_len = len(sharded_list[0])
        for i, shard in enumerate(sharded_list):
            assert (
                len(shard) == shard_len
            ), f"Shard {i} length {len(shard)} != expected {shard_len}"
        item_offset = shard_len * shard_offset
        n_items = self.load_worldsize * shard_len
        my_items = range(
            int(n_items * self.rank / self.worldsize) - item_offset,
            int(n_items * (self.rank + 1) / self.worldsize) - item_offset,
        )
        return [sharded_list[i // shard_len][i % shard_len] for i in my_items]

    def load_state_dict(self, state_dicts, sharded_input=False):
        """Load from a list of per-worker state dicts.

        Same-size world: adopt both state and reshard params from own shard.
        Different size: drop state params, reassemble reshard params by
        fractional ownership.
        """
        self.setup()
        if not sharded_input:
            self.load_worldsize = len(state_dicts)
            state_dicts = shard_inclusive(state_dicts, self.rank, self.worldsize)
        if self.load_worldsize == self.worldsize:
            for flag in self.state_params + self.reshard_params:
                # keys absent from the checkpoint (state params added in
                # a later version, e.g. quarantined_shards) keep their
                # constructed defaults instead of failing the resume —
                # but LOUDLY: a partial dict can also mean a torn loader
                # state file, and a silently-defaulted position key would
                # replay data with no trace
                key = self.statename(flag)
                if key in state_dicts[0]:
                    setattr(self, flag, state_dicts[0][key])
                else:
                    logger.warning(
                        "loader state for %s is missing key %r; keeping "
                        "the constructed default (new-version state "
                        "param, or a torn/partial checkpoint)",
                        type(self).__name__,
                        key,
                    )
        else:
            for flag in self.reshard_params:
                if self.statename(flag) not in state_dicts[0]:
                    logger.warning(
                        "loader state for %s is missing reshard key %r; "
                        "keeping the constructed default",
                        type(self).__name__,
                        self.statename(flag),
                    )
                    continue
                setattr(
                    self,
                    flag,
                    self._reshard([sd[self.statename(flag)] for sd in state_dicts]),
                )
        return state_dicts

    # -- disk -------------------------------------------------------------

    def load_from_path(self, path: str):
        """Find this worker's overlap among the checkpoint's per-rank state
        files and load only those."""
        assert os.path.exists(path), "Specified checkpoint does not exist"
        assert not os.path.isfile(path), "Checkpoint should be a folder of shard states"
        fileshards = [x for x in os.listdir(path) if "loader" in x]
        fileshards = sorted(fileshards, key=lambda x: int(x.split("_")[2][:-4]))
        if not fileshards:
            raise RuntimeError(
                f"checkpoint {path} contains no loader_state files: the "
                f"document-walk position cannot be restored. The "
                f"checkpoint is either model-only (saved without a "
                f"dataloader) or an incomplete copy — resume from a "
                f"checkpoint holding every per-rank loader_state_<N>.pkl "
                f"the save wrote."
            )
        # elastic resume: load_worldsize is the SAVE world (process
        # count x num_workers then); when it differs from this world,
        # each rank reads every old file that fractionally owns its
        # logical shards and load_state_dict reshards (docs/dataloader.md)
        self.load_worldsize = len(fileshards)
        my_fileshards = shard_inclusive(fileshards, self.rank, self.worldsize)
        states = []
        for x in my_fileshards:
            with open(os.path.join(path, x), "rb") as f:
                states.append(pickle.load(f))
        self.load_state_dict(states, True)

    def save_to_path(self, path: str):
        os.makedirs(path, exist_ok=True)
        state = self.state_dict()
        with open(os.path.join(path, f"loader_state_{self.rank}.pkl"), "wb") as f:
            pickle.dump(state, f)


class WrapperDataset(StatefulDataset):
    """A pipeline layer holding one wrapped StatefulDataset; state calls
    recurse through it, rank/path retargeting propagates down at setup."""

    def __init__(self, dataset: StatefulDataset):
        self.dataset = dataset
        super().__init__(dataset.datapath, dataset.rank, dataset.worldsize)

    def setup(self):
        if not self.is_setup:
            super().setup()
            self.dataset.datapath = self.datapath
            self.dataset.rank = self.rank
            self.dataset.worldsize = self.worldsize
            self.dataset.local_worldsize = self.local_worldsize
            self.dataset.setup()

    def state_dict(self):
        self.setup()
        out = self.dataset.state_dict()
        out.update(StatefulDataset.state_dict(self))
        return out

    def load_state_dict(self, state_dicts, sharded_input=False):
        self.setup()
        sharded_dicts = StatefulDataset.load_state_dict(
            self, state_dicts, sharded_input
        )
        self.dataset.load_worldsize = self.load_worldsize
        self.dataset.load_state_dict(sharded_dicts, True)
        return sharded_dicts
