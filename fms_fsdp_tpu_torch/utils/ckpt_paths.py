"""Checkpoint-directory path helpers (ref:fms_fsdp/utils/checkpointing_utils.py:23-64).

A copy of ``fms_fsdp_tpu/utils/ckpt_paths.py``: the port's Checkpointer,
its tiered manager and the serving engine's params-only reader scan
``step_<N>_ckp`` dirs with the same rules as the JAX package.
"""

import os


def safe_listdir(path) -> list:
    """listdir that treats a concurrently-deleted (or not-a-dir) entry as
    empty. Checkpoint-folder scanners enumerate candidate step dirs and
    then inspect each; rank-0 retention pruning can rmtree a candidate
    between those two steps, and the scanner must skip it, not crash."""
    try:
        return os.listdir(path)
    except (FileNotFoundError, NotADirectoryError):
        return []


def is_step_ckp(path) -> bool:
    """True for the step_<N>_ckp names Checkpointer.save writes. The
    middle must be numeric: a parked 'step_best_ckp' must be ignored by
    every scanner, not crash its step_number sort."""
    name = os.path.basename(str(path))
    return (
        name.startswith("step_")
        and name.endswith("_ckp")
        and name.split("_")[1].isdigit()
    )


def step_number(path) -> int:
    """Parse N out of .../step_<N>_ckp."""
    return int(os.path.basename(str(path)).split("_")[1])


def get_latest(targdir, qualifier=lambda x: True, key=os.path.getctime):
    """Full path of the newest qualifying entry in targdir, or None."""
    if os.path.exists(targdir) and len(os.listdir(targdir)) > 0:
        candidates = [
            os.path.join(targdir, x)
            for x in os.listdir(targdir)
            if qualifier(os.path.join(targdir, x))
        ]
        if candidates:
            return max(candidates, key=key)
    return None


def get_oldest(targdir, qualifier=lambda x: True, key=os.path.getctime):
    """Full path of the oldest qualifying entry in targdir, or None."""
    if os.path.exists(targdir) and len(os.listdir(targdir)) > 0:
        candidates = [
            os.path.join(targdir, x)
            for x in os.listdir(targdir)
            if qualifier(os.path.join(targdir, x))
        ]
        if candidates:
            return min(candidates, key=key)
    return None
