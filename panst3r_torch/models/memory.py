"""Cross-view token memory: fixed-capacity per-layer KV banks (counterpart of
panst3r_tpu/models/memory.py).

- ``y``     (L, B, capacity, C): per-decoder-layer banks of pre-normalized
            tokens ("norm_y" memory mode);
- ``pos``   (B, capacity, 2) int32 patch positions of the banked tokens;
- ``valid`` (B, capacity) bool slot validity (invalid slots are masked out
            of the cross-attention, and K2 skips key tiles with no valid
            slot);
- ``count`` the write cursor (a Python int): the number of occupied slots,
  except inside a ring-reuse window (``begin_overwrite`` moves it to the
  freed slots, ``end_overwrite`` restores it).

Unlike the JAX version, which returns a new immutable pytree, ``insert``
and the edits below (``evict``, ``insert_at``, ``begin_overwrite``,
``end_overwrite``) write in place into the preallocated banks (no copy of
the whole memory per update) and return the same object; only tokens that
carry a gradient (a decoder being trained) are inserted out of place.
Eviction only clears validity: the dead slots stay in the banks, masked
out of the cross-attention (K2 skips their key tiles), until a later
insert reuses them.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TokenMemory:
    y: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor
    count: int = 0

    @property
    def capacity(self) -> int:
        return self.y.shape[2]


def init_memory(num_layers: int, batch: int, capacity: int, dim: int,
                dtype=torch.float32, device=None) -> TokenMemory:
    return TokenMemory(
        y=torch.zeros((num_layers, batch, capacity, dim), dtype=dtype,
                      device=device),
        pos=torch.zeros((batch, capacity, 2), dtype=torch.int32,
                        device=device),
        valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
        count=0)


def insert(mem: TokenMemory, y_new: torch.Tensor,
           pos_new: torch.Tensor) -> TokenMemory:
    """Append tokens for all layers at the write offset, in place.
    y_new (L, B, n, C); pos_new (B, n, 2)."""
    n = y_new.shape[2]
    s = mem.count
    if s + n > mem.capacity:
        raise ValueError(f"memory full: {s} + {n} > {mem.capacity}")
    y_new = y_new.to(mem.y.dtype)
    if y_new.requires_grad:
        # a trained decoder: the banks stay out of place for autograd
        mem.y = torch.cat([mem.y[:, :, :s], y_new, mem.y[:, :, s + n:]], 2)
    else:
        mem.y[:, :, s:s + n] = y_new
    mem.pos[:, s:s + n] = pos_new.to(mem.pos.dtype)
    mem.valid[:, s:s + n] = True
    mem.count = s + n
    return mem


def _check_window(mem: TokenMemory, start: int, n: int) -> None:
    if start < 0 or start + n > mem.capacity:
        raise ValueError(f"slots [{start}, {start + n}) outside the "
                         f"memory's {mem.capacity}")


def evict(mem: TokenMemory, start: int, n: int) -> TokenMemory:
    """Invalidate ``n`` slots from ``start``, in place.  Protection (which
    views are never evicted) is the caller's policy."""
    _check_window(mem, start, n)
    mem.valid[:, start:start + n] = False
    return mem


def insert_at(mem: TokenMemory, y_new: torch.Tensor, pos_new: torch.Tensor,
              start: int) -> TokenMemory:
    """Overwrite ``n`` slots at ``start`` in place (ring reuse after
    ``evict``); the cursor moves to the window's end if that is further."""
    n = y_new.shape[2]
    _check_window(mem, start, n)
    mem.y[:, :, start:start + n] = y_new.to(mem.y.dtype)
    mem.pos[:, start:start + n] = pos_new.to(mem.pos.dtype)
    mem.valid[:, start:start + n] = True
    mem.count = max(mem.count, start + n)
    return mem


def begin_overwrite(mem: TokenMemory, start: int, n: int) -> TokenMemory:
    """Open a ring-reuse window: invalidate ``n`` slots from ``start`` and
    move the write cursor there, so that the next ``insert`` (a decoder
    update) lands in the freed window.  Close it with ``end_overwrite``."""
    evict(mem, start, n)
    mem.count = int(start)
    return mem


def end_overwrite(mem: TokenMemory, occupancy: int) -> TokenMemory:
    """Close a ring-reuse window: the write cursor back at the occupancy,
    so that later appends go to the end again."""
    mem.count = int(occupancy)
    return mem
