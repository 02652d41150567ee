"""Tensor parallelism over the mesh's ``model`` axis, Megatron style
(counterpart of panst3r_tpu/core/tp.py).

The JAX package annotates the parameters and lets GSPMD place the
collectives; here ``apply_tp`` keeps each rank's shard of the weights and
swaps the layers for ones that run on it:

- column-parallel (output features split): the q/k/v projections
  (packed ``qkv`` or ``projq``/``projk``/``projv``, ``q_proj``/``k_proj``/
  ``v_proj``), ``fc1`` and ``ffn_fc1*``, biases split alike — a rank
  computes its heads or hidden units;
- row-parallel (input features split): ``proj``/``out_proj``, ``fc2`` and
  ``ffn_fc2*`` — a rank's partial product is summed over the group and
  the (replicated) bias added once;
- everything else replicated, as is a layer whose split dimension does not
  divide by the group's size.

``tp_spec`` is the rule, by parameter name and shape (the port's modules
carry the flax names).  The packed ``qkv`` holds [q | k | v]: a rank keeps
the q, k and v rows of its own heads, not a contiguous third of them.
Attention modules then run ``num_heads / n`` local heads, and the
attention wrappers route by that local shape (K1's gate, else K4).  A
column-parallel input's gradient is summed over the group in the backward
(``core/mesh.py::copy_to``), so the TP model trains too.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from panst3r_torch.core.mesh import (MODEL_AXIS, Group, all_gather_cat,
                                     copy_to, group_size, reduce_from)

_COL_PARALLEL = {"qkv", "projq", "projk", "projv", "q_proj", "k_proj",
                 "v_proj", "fc1"}
_ROW_PARALLEL = {"proj", "out_proj", "fc2"}
# modules whose ``num_heads`` heads sit in their column-parallel outputs
_ATTN_COLS = {"qkv", "projq", "projk", "projv", "q_proj", "k_proj",
              "v_proj"}


def _kind(layer: str) -> Optional[str]:
    if layer in _COL_PARALLEL or layer.startswith("ffn_fc1"):
        return "col"
    if layer in _ROW_PARALLEL or layer.startswith("ffn_fc2"):
        return "row"
    return None


def tp_spec(name: str, shape, model_size: int) -> tuple:
    """The model-axis placement of one parameter, per dimension of its
    torch shape: ``("model", None)`` for a column-parallel weight (out,
    in), ``(None, "model")`` for a row-parallel one, ``("model",)`` for a
    column-parallel bias, all ``None`` when replicated.  The JAX rule on
    the flax kernel (…, in, out) read in torch's (out, in, …) order."""
    parts = name.split(".")
    leaf, layer = parts[-1], (parts[-2] if len(parts) >= 2 else "")
    kind = _kind(layer)
    spec = [None] * len(shape)
    if leaf == "weight" and len(shape) >= 2:
        if kind == "col" and shape[0] % model_size == 0:
            spec[0] = MODEL_AXIS
        elif kind == "row" and shape[1] % model_size == 0:
            spec[1] = MODEL_AXIS
    elif leaf == "bias" and kind == "col" and shape[0] % model_size == 0:
        spec[0] = MODEL_AXIS
    return tuple(spec)


def sharded_dim(name: str, shape, model_size: int) -> Optional[int]:
    spec = tp_spec(name, shape, model_size)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_param(name: str, full: torch.Tensor, group: Optional[Group]
                ) -> torch.Tensor:
    """This rank's shard of a full parameter (the full one when it is
    replicated).  A packed ``qkv`` gives the rank its heads' q, k and v
    rows."""
    n = group_size(group)
    dim = sharded_dim(name, full.shape, n)
    if n == 1 or dim is None:
        return full
    r = group.index
    if name.split(".")[-2] == "qkv":
        three = full.reshape(3, full.shape[0] // 3, *full.shape[1:])
        c = three.shape[1] // n
        return three[:, r * c:(r + 1) * c].reshape(-1, *full.shape[1:])
    size = full.shape[dim] // n
    return full.narrow(dim, r * size, size)


def gather_param(name: str, local: torch.Tensor, full_shape,
                 group: Optional[Group]) -> torch.Tensor:
    """The inverse of ``shard_param``: the full parameter from every rank's
    shard (a collective: every rank of the group calls it)."""
    n = group_size(group)
    dim = sharded_dim(name, full_shape, n)
    if n == 1 or dim is None:
        return local
    if name.split(".")[-2] == "qkv":
        three = local.reshape(3, local.shape[0] // 3, *local.shape[1:])
        return all_gather_cat(three, 1, group).reshape(full_shape)
    return all_gather_cat(local, dim, group)


class ColumnParallelLinear(nn.Linear):
    """A Linear holding this rank's output features; its input's gradient
    is summed over the group."""

    def __init__(self, weight, bias, group: Group):
        super().__init__(weight.shape[1], weight.shape[0],
                         bias=bias is not None, device="meta")
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(
            bias, requires_grad=False)
        self.group = group

    def forward(self, x):
        return F.linear(copy_to(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Linear):
    """A Linear holding this rank's input features.  The partial products
    are kept in f32, summed over the group, the bias added, and the sum
    rounded once to the layer's dtype, as one rank's product rounds its
    f32 accumulator once: operands of the compute dtype (the autocast
    dtype under autocast, else that of ``x`` and the weight) are taken to
    f32 exactly, so only the order of the f32 sum differs."""

    def __init__(self, weight, bias, group: Group):
        super().__init__(weight.shape[1], weight.shape[0],
                         bias=bias is not None, device="meta")
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(
            bias, requires_grad=False)
        self.group = group

    def forward(self, x):
        kind = x.device.type
        dt = (torch.get_autocast_dtype(kind)
              if torch.is_autocast_enabled(kind)
              else torch.promote_types(x.dtype, self.weight.dtype))
        with torch.autocast(kind, enabled=False):
            y = F.linear(x.to(dt).float(), self.weight.to(dt).float())
            y = reduce_from(y, self.group)
            if self.bias is not None:
                y = y + self.bias.to(dt).float()
        return y.to(dt)


def _plan(model: nn.Module, n: int) -> dict:
    """{module name: (module, {child: kind})} of the modules with a split
    layer; raises ValueError, naming the parameters, where a block would
    split one side and not the other, or split a head."""
    plan, bad = {}, []
    for mname, mod in model.named_modules():
        kids = {c: _kind(c) for c, ch in mod.named_children()
                if _kind(c) and isinstance(ch, (nn.Linear, nn.Conv2d))}
        if not kids:
            continue
        split = {c: sharded_dim(f"{c}.weight", getattr(mod, c).weight.shape,
                                n) is not None for c in kids}
        if not any(split.values()):
            continue
        prefix = f"{mname}." if mname else ""
        for c, k in kids.items():
            if not split[c]:
                bad.append(f"{prefix}{c}.weight (kept whole)")
            elif isinstance(getattr(mod, c), nn.Conv2d):
                bad.append(f"{prefix}{c}.weight (a convolution)")
        if {k for c, k in kids.items() if split[c]} != {"col", "row"}:
            bad.append(f"{prefix}{sorted(kids)} (one side of a block)")
        heads = getattr(mod, "num_heads", None)
        if heads is not None and set(kids) & _ATTN_COLS and heads % n:
            bad.append(f"{prefix}{sorted(kids)} ({heads} heads over {n})")
        plan[mname] = (mod, kids)
    if bad:
        raise ValueError("tensor parallelism over "
                         f"{n} ranks cannot split: {bad}")
    return plan


@torch.no_grad()
def apply_tp(model: nn.Module, group: Optional[Group]) -> nn.Module:
    """Keep this rank's shard of every split layer of ``model`` (in place)
    and run it Megatron style over ``group`` (the mesh's ``model`` axis);
    ``model.tp_split`` names the split parameters.  Returns ``model``; a
    group of one rank leaves it as it was."""
    n = group_size(group)
    if n == 1:
        return model
    split = set()
    for mname, (mod, kids) in _plan(model, n).items():
        prefix = f"{mname}." if mname else ""
        for c, kind in kids.items():
            old = getattr(mod, c)
            w = shard_param(f"{prefix}{c}.weight", old.weight, group)
            split.add(f"{prefix}{c}.weight")
            b = old.bias
            if b is not None and kind == "col":
                b = shard_param(f"{prefix}{c}.bias", b, group)
                split.add(f"{prefix}{c}.bias")
            cls = ColumnParallelLinear if kind == "col" else RowParallelLinear
            new = cls(w.clone(), None if b is None else b.clone(), group)
            new.weight.requires_grad_(old.weight.requires_grad)
            if new.bias is not None:
                new.bias.requires_grad_(old.bias.requires_grad)
            setattr(mod, c, new)
        if hasattr(mod, "num_heads") and set(kids) & _ATTN_COLS:
            mod.num_heads //= n
    model.tp_group, model.tp_split = group, split
    return model


def full_shapes(model: nn.Module) -> dict:
    """{parameter name: its full (unsharded) shape} of a TP model."""
    n = group_size(getattr(model, "tp_group", None))
    out = {}
    for name, p in model.named_parameters():
        shape = list(p.shape)
        mod = model.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(mod, ColumnParallelLinear):
            shape[0] *= n
        elif isinstance(mod, RowParallelLinear) and name.endswith("weight"):
            shape[1] *= n
        out[name] = tuple(shape)
    return out


def gather_state(model: nn.Module, tensors: dict) -> dict:
    """``tensors`` (parameter name → this rank's tensor shaped like the
    parameter, e.g. the state dict or an optimizer moment) with the split
    ones gathered whole: what one device would hold.  A collective over
    the model's TP group."""
    group = getattr(model, "tp_group", None)
    if group_size(group) == 1:
        return dict(tensors)
    shapes = full_shapes(model)
    return {k: (gather_param(k, t, shapes[k], group) if k in shapes else t)
            for k, t in tensors.items()}


def shard_state(model: nn.Module, tensors: dict) -> dict:
    """The inverse of ``gather_state``: this rank's shards of full
    tensors keyed by parameter name."""
    group = getattr(model, "tp_group", None)
    if group_size(group) == 1:
        return dict(tensors)
    params = dict(model.named_parameters())
    return {k: (shard_param(k, t, group) if k in params else t)
            for k, t in tensors.items()}
