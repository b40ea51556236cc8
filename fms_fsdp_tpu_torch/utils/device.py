"""The device an entry point runs on.

Every entry point of the port (``ServingEngine``, ``PagedKVCache``,
``main_training_llama.main``) runs on ``cuda`` unless its caller passes
``device="cpu"``; without a card and without that request it raises,
never a silent CPU run.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run "
                "on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
