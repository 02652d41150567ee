"""Device policy: the card by default, the CPU only when asked for; and
stage timing that waits for the card."""
from __future__ import annotations

import time
from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device; it raises when there is none.
    The CPU is used only when the caller names it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def tick(times: Optional[dict], name: Optional[str], t0: float,
         device) -> float:
    """Add the seconds since ``t0`` to ``times[name]`` once ``device`` has
    finished its work; returns the new time.  Without ``times`` it neither
    waits nor measures and returns ``t0``."""
    if times is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    if name is not None:
        times[name] = times.get(name, 0.0) + (t - t0)
    return t
