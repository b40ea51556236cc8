"""The device an entry point runs on.

Every entry point of the port (``ServingEngine``, ``PagedKVCache``,
``main_training_llama.main``) runs on ``cuda`` unless its caller passes
``device="cpu"``; without a card and without that request it raises,
never a silent CPU run. Under ``torchrun`` the card is ``cuda:LOCAL_RANK``
(one card per process), or, when the host runs more ranks than it has
cards, the card ``utils/dist.py::local_device_index`` maps the rank to
(ranks sharing a card form a gloo world), made the thread's current
device before anything is allocated on it.
"""

import torch

from fms_fsdp_tpu_torch.utils.dist import launched_by_torchrun, local_device_index


def resolve_device(device=None) -> torch.device:
    """``cuda`` (under torchrun the rank's card: ``cuda:LOCAL_RANK``, or
    the shared card of ``local_device_index``) unless the caller names a
    device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run "
                "on the CPU"
            )
        if not launched_by_torchrun():
            return torch.device("cuda")
        device = torch.device("cuda", local_device_index())
        torch.cuda.set_device(device)
        return device
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
