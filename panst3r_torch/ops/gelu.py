"""GELU policy (counterpart of panst3r_tpu/models/blocks.py:36-59 and
panst3r_tpu/ops/gelu.py).

f32 uses the exact erf form.  Half precision uses the tanh approximation
unless ``PANST3R_EXACT_GELU=1`` is set when the function is called; then it
uses the exact form.  The JAX package's ``fast_gelu`` is bit-identical to
erf-GELU for every bf16 input, so ``F.gelu(approximate="none")`` serves
that branch.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    if x.dtype in (torch.bfloat16, torch.float16) \
            and os.environ.get("PANST3R_EXACT_GELU", "0") != "1":
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)
