"""Seeded random generators (counterpart of panst3r_tpu/core/rng.py).

The JAX package splits one root key by (epoch, step, name); here each such
path seeds its own ``torch.Generator`` through numpy's ``SeedSequence``, so
a step's draws depend only on (seed, epoch, step), never on what ran
before.  The bits differ from JAX's: the tests pass JAX's draws in
explicitly where they compare the two.
"""
from __future__ import annotations

import numpy as np
import torch


def path_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the (seed, *path) node of the key tree."""
    state = np.random.SeedSequence([seed, *path]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def generator(seed: int, *path: int, device=None) -> torch.Generator:
    """A generator on ``device`` for the (seed, *path) node, e.g.
    ``generator(seed, epoch, step)`` for one train step."""
    return torch.Generator(device=device).manual_seed(path_seed(seed, *path))

