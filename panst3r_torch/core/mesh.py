"""The (data, mem, model) process mesh (counterpart of
panst3r_tpu/core/mesh.py).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` and lets
GSPMD place the collectives; here the ranks of the default process group
are laid out the same way and each axis gets one subgroup per slice:

- ``data``  — data parallelism: the batch (or the scenes) split over it,
              the gradients summed over it;
- ``mem``   — the memory axis: the decoder's KV banks split along their
              capacity (render), the fusion's views, BA's observations;
- ``model`` — tensor parallelism (``core/tp.py``): attention heads and
              MLP hidden units split Megatron-style; innermost, as in the
              JAX package, since it is the chattiest (one all-reduce per
              block).

There is no ``NamedSharding``: ``local_slice`` hands a rank its slice of a
tensor along one dimension and ``all_gather_cat`` is its inverse.
``reduce_from`` / ``copy_to`` / ``gather_slices`` are the collectives with
the gradients a replicated computation needs (Megatron's g and f, and a
sharded tensor made whole).  ``None`` (``build_mesh``'s group for
an axis of one rank) makes every helper the identity, with no collective;
a ``Group`` of one rank still runs its collectives (the backend's code
path, on one device).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from panst3r_torch.core import distributed

DATA_AXIS = "data"
MEM_AXIS = "mem"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MEM_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """``data`` / ``mem`` / ``model`` axis sizes; ``-1`` means "all the
    remaining ranks".  Defaults to a single-axis data mesh."""

    data: int = -1
    mem: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        data, mem, model = self.data, self.mem, self.model
        if (data, mem, model).count(-1) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if mem == -1:
            mem = n_devices // (max(data, 1) * max(model, 1))
        if model == -1:
            model = n_devices // (max(data, 1) * max(mem, 1))
        if data == -1:
            data = n_devices // (max(mem, 1) * max(model, 1))
        if data * mem * model != n_devices:
            raise ValueError(
                f"mesh {data}x{mem}x{model} does not cover "
                f"{n_devices} devices")
        return data, mem, model


@dataclasses.dataclass(frozen=True)
class Group:
    """One slice of a mesh axis: its process group, its global ranks, and
    this rank's index in it."""

    pg: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data, mem, model) mesh: the axis sizes,
    its coordinates and the group of its slice along each axis (None for
    an axis of size 1)."""

    shape: tuple
    coords: tuple
    groups: dict

    def size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, axis: str) -> Optional[Group]:
        return self.groups[axis]


def build_mesh(spec: MeshSpec | None = None) -> Mesh:
    """The mesh over every rank of the default group (one rank when there
    is none), ``model`` innermost, then ``mem``: rank r sits at
    ``np.arange(world).reshape(data, mem, model)``'s index of r.  Every
    rank must call this with the same spec: each axis slice is made with
    ``dist.new_group`` (in the default group's backend) on all ranks in
    the same order.  Raises ``ValueError`` when the mesh does not cover
    the world."""
    spec = spec or MeshSpec()
    world = distributed.process_count()
    rank = distributed.process_index()
    shape = spec.resolve(world)
    grid = np.arange(world).reshape(shape)
    coords = tuple(int(c) for c in np.argwhere(grid == rank)[0])
    groups = {}
    for ax, name in enumerate(AXES):
        if shape[ax] == 1:
            groups[name] = None
            continue
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        mine = None
        for line in lines:                       # every rank, same order
            ranks = tuple(int(r) for r in line)
            pg = dist.new_group(list(ranks), backend=dist.get_backend())
            if rank in ranks:
                mine = Group(pg, ranks, ranks.index(rank))
        groups[name] = mine
    return Mesh(shape, coords, groups)


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)


def group_size(group: Optional[Group]) -> int:
    return 1 if group is None else group.size


def group_index(group: Optional[Group]) -> int:
    return 0 if group is None else group.index


def local_slice(x: torch.Tensor, dim: int,
                group: Optional[Group]) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim`` (the size must divide
    by the group's)."""
    n = group_size(group)
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over "
                         f"{n} ranks")
    return x.narrow(dim, group.index * (size // n), size // n)


def all_reduce(x: torch.Tensor, group: Optional[Group],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the group, in place (and returned)."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group.pg)
    return x


def all_gather_cat(x: torch.Tensor, dim: int,
                   group: Optional[Group]) -> torch.Tensor:
    """The ranks' tensors (equal shapes) concatenated along ``dim`` in
    rank order: the inverse of ``local_slice``."""
    if group is None:
        return x
    if x.dtype == torch.bool:             # gathered as bytes
        return all_gather_cat(x.to(torch.uint8), dim, group).bool()
    if x.dtype == torch.uint16:           # no collective takes uint16
        return all_gather_cat(x.view(torch.int16), dim,
                              group).view(torch.uint16)
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x.contiguous(), group=group.pg)
    return torch.cat(parts, dim)


class _ReduceFrom(torch.autograd.Function):
    """Forward: the sum over the group; backward: the gradient as is (each
    rank holds the whole replicated loss)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """Forward: the identity; backward: the sum of the ranks' gradients
    (each rank's partial layers saw the replicated input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _GatherSlices(torch.autograd.Function):
    """Forward: the ranks' slices concatenated whole (a sharded operand
    made whole for a kernel that needs all of it); backward: this rank's
    slice of the gradient (every rank computes the same replicated loss
    from the whole tensor)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim, ctx.group), None, None


def gather_slices(x: torch.Tensor, dim: int,
                  group: Optional[Group]) -> torch.Tensor:
    return x if group is None else _GatherSlices.apply(x, dim, group)


def reduce_from(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)
