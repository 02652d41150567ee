"""Carry a flax parameter tree of panst3r_tpu into the port's modules.

``tree`` is the flax tree as nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``; a top-level ``params`` key
is accepted).  The port's parameters carry the flax names, so the mapping
is mechanical:

- Dense ``kernel`` (in, out) → ``Linear.weight`` (out, in);
- Conv ``kernel`` HWIO → ``Conv2d.weight`` OIHW;
- LayerNorm and GroupNorm ``scale`` / ``bias`` → ``weight`` / ``bias``;
- scanned stacks carry a leading layer axis and split into per-layer
  modules: ``blocks/block/*`` → ``blocks.<i>.*`` (encoder, DINO) and
  ``layers/*`` → ``layers.<i>.*`` (memory decoder);
- raw parameters (``cls_token``, ``pos_embed``, ``ls1``/``ls2``,
  ``query_feat``, ``query_embed``, ``level_embed``, ``cls_logit_scale``,
  the v2 head's ``nocls_token`` and LoftUp's Fourier ``biases``) keep
  their shapes.

Any flax leaf without a port parameter, any port parameter left unfilled,
and any shape mismatch raises.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

_STACKS = {("blocks", "block"): "blocks", ("layers",): "layers"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _leaf(name: str, arr: np.ndarray):
    """flax leaf name + array → torch leaf name + array."""
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim}")
    if name == "scale":
        return "weight", arr
    return name, arr


def _convert(path: tuple, arr: np.ndarray):
    """Yield (torch parameter name, array) for one flax leaf."""
    for i in range(len(path)):
        for pat, repl in _STACKS.items():
            if tuple(path[i:i + len(pat)]) == pat:
                head, tail = path[:i], path[i + len(pat):]
                for layer in range(arr.shape[0]):
                    leaf, a = _leaf(tail[-1], arr[layer])
                    yield ".".join(head + (repl, str(layer)) + tail[:-1]
                                   + (leaf,)), a
                return
    leaf, a = _leaf(path[-1], arr)
    yield ".".join(path[:-1] + (leaf,)), a


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: dict,
                    copy: bool = True) -> nn.Module:
    """Fill every parameter of ``model`` from the flax tree ``tree``.
    ``copy=False`` only checks the mapping and the shapes (a model on the
    meta device against a tree of shapes)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    own = dict(model.named_parameters())
    assigned = set()
    for path, arr in _flatten(tree):
        for name, value in _convert(path, arr):
            if name not in own:
                raise KeyError(f"flax leaf {'/'.join(path)} has no port "
                               f"parameter {name}")
            p = own[name]
            if tuple(p.shape) != tuple(value.shape):
                raise ValueError(f"{name}: port shape {tuple(p.shape)} vs "
                                 f"flax {tuple(value.shape)}")
            if copy:
                p.copy_(torch.from_numpy(np.array(value))
                        .to(p.dtype))
            assigned.add(name)
    missing = sorted(set(own) - assigned)
    if missing:
        raise KeyError(f"port parameters not in the flax tree: {missing}")
    return model
