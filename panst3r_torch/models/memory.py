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
  freed slots, ``end_overwrite`` restores it);
- ``group`` the mesh's ``mem`` axis the banks are split over along their
  capacity (None: whole).  Each rank then holds slots ``[r·c, (r+1)·c)``
  of ``c = capacity / n`` in ``y``, ``pos`` and ``valid``, the writes
  below keep only the slots of this rank (slot numbers, ``count`` and
  ``capacity`` stay global), and ``whole`` all-gathers a bank for the
  decoder's cross-attention, which runs over all of it.

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
from typing import Optional

import torch

from panst3r_torch.core.mesh import (Group, gather_slices, group_index,
                                     group_size)


@dataclasses.dataclass
class TokenMemory:
    y: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor
    count: int = 0
    group: Optional[Group] = None

    @property
    def capacity(self) -> int:
        return self.y.shape[2] * group_size(self.group)

    def whole(self, bank: torch.Tensor) -> torch.Tensor:
        """``bank`` (``pos``, ``valid`` or one layer of ``y``: capacity at
        dim 1) with every rank's slots."""
        return gather_slices(bank, 1, self.group)


def init_memory(num_layers: int, batch: int, capacity: int, dim: int,
                dtype=torch.float32, device=None,
                group: Optional[Group] = None) -> TokenMemory:
    """Empty banks of ``capacity`` slots, split over ``group`` when one is
    given (the capacity must divide by its size)."""
    n = group_size(group)
    if capacity % n:
        raise ValueError(f"a memory of {capacity} slots does not split "
                         f"over {n} ranks")
    capacity //= n
    return TokenMemory(
        y=torch.zeros((num_layers, batch, capacity, dim), dtype=dtype,
                      device=device),
        pos=torch.zeros((batch, capacity, 2), dtype=torch.int32,
                        device=device),
        valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
        count=0, group=group)


def _window(mem: TokenMemory, start: int, n: int) -> tuple[slice, slice]:
    """The global slots [start, start + n) that this rank holds: (their
    columns in the ``n`` written, their local slots)."""
    if start < 0 or start + n > mem.capacity:
        raise ValueError(f"slots [{start}, {start + n}) outside the "
                         f"memory's {mem.capacity}")
    size = mem.y.shape[2]
    off = group_index(mem.group) * size
    lo = max(start, off)
    hi = max(lo, min(start + n, off + size))
    return slice(lo - start, hi - start), slice(lo - off, hi - off)


def insert(mem: TokenMemory, y_new: torch.Tensor,
           pos_new: torch.Tensor) -> TokenMemory:
    """Append tokens for all layers at the write offset, in place.
    y_new (L, B, n, C); pos_new (B, n, 2)."""
    n = y_new.shape[2]
    s = mem.count
    if s + n > mem.capacity:
        raise ValueError(f"memory full: {s} + {n} > {mem.capacity}")
    src, dst = _window(mem, s, n)
    y_new = y_new[:, :, src].to(mem.y.dtype)
    if y_new.requires_grad:
        # a trained decoder: the banks stay out of place for autograd
        mem.y = torch.cat([mem.y[:, :, :dst.start], y_new,
                           mem.y[:, :, dst.stop:]], 2)
    else:
        mem.y[:, :, dst] = y_new
    mem.pos[:, dst] = pos_new[:, src].to(mem.pos.dtype)
    mem.valid[:, dst] = True
    mem.count = s + n
    return mem


def evict(mem: TokenMemory, start: int, n: int) -> TokenMemory:
    """Invalidate ``n`` slots from ``start``, in place.  Protection (which
    views are never evicted) is the caller's policy."""
    mem.valid[:, _window(mem, start, n)[1]] = False
    return mem


def insert_at(mem: TokenMemory, y_new: torch.Tensor, pos_new: torch.Tensor,
              start: int) -> TokenMemory:
    """Overwrite ``n`` slots at ``start`` in place (ring reuse after
    ``evict``); the cursor moves to the window's end if that is further."""
    n = y_new.shape[2]
    src, dst = _window(mem, start, n)
    mem.y[:, :, dst] = y_new[:, :, src].to(mem.y.dtype)
    mem.pos[:, dst] = pos_new[:, src].to(mem.pos.dtype)
    mem.valid[:, dst] = True
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
