"""Parallelism: the device mesh (``mesh``), the placement of the train
state over it and the data-parallel step's collectives (``sharding``),
dtype policies and the selective activation-checkpointing mask.

The submodules import lazily (PEP 562): ``parallel.mesh`` imports no
torch, so a process can read a serving layout before it pays for torch
(``serve/replica.py`` starts a layout's followers first)."""

__all__ = ["mesh", "sharding"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
