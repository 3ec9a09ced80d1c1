"""Device selection: the card unless the caller names another device."""

import time

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


def timer(device):
    """``(lap, timing)``: ``lap(name)`` adds the host seconds since the
    last lap — taken after the device has finished — to ``timing[name]``
    (a few calls per setup or run, never inside a loop)."""
    tick = [time.perf_counter()]
    timing = {}

    def lap(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        timing[name] = timing.get(name, 0.0) + now - tick[0]
        tick[0] = now

    return lap, timing
