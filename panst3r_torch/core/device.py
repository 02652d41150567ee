"""Device policy: the card by default, the CPU only when asked for."""
from __future__ import annotations

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
