"""Device selection: the card unless the caller names another device."""

import torch


def default_device() -> torch.device:
    """The CUDA card.  Raises when there is none — no silent CPU fallback;
    callers that want the CPU (the tests) pass ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' explicitly to "
            "run on the host")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> ``torch.device``."""
    if device is None:
        return default_device()
    return torch.device(device)
