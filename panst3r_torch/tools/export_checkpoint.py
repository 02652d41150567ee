"""Reverse checkpoint port: the flax-named parameter tree (or a port
model) → a reference-named torch state_dict, for the reference code or
for publishing fine-tuned weights (the port of
tools/export_torch_checkpoint.py).

The forward port (``panst3r_torch/port_checkpoint.py``) is an element
permutation: every scalar of the tree it makes comes from exactly one
scalar of the state_dict (transposes, reshapes, per-head row
permutations, qkv splits and concatenations, layer stacking; no
arithmetic).  So the forward port is run on an id-valued copy of a
template state_dict, and each tree leaf then holds, at every position,
the id of the scalar it came from: an exact inverse map by construction,
with no second hand-written mapping to drift from the first.  An id is
int64, ``(key index << 40) | index within the key``, made per key: the
values are scattered straight into one output array per key, with no
global array of every scalar.

The template (the reference checkpoint being round-tripped, or any
reference-named state_dict of the same shapes) gives the key set, shapes
and dtypes.  Keys the forward port does not consume (``mask_token``,
``position_ids``) are copied from the template and listed as
``passthrough``; tree leaves the port makes but the given tree lacks are
listed as ``missing`` (their keys fall back to passthrough).

    python -m panst3r_torch.tools.export_checkpoint \\
        (--params ported_params.npz | --checkpoint run/final) \\
        --template reference.pth --out exported.pth \\
        [--dec-layers N] [--rope-layout half|interleaved] \\
        [--rename-json m.json] [--trust-pickle]

It runs on the host (no card); it prints its peak host memory.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from panst3r_torch.port_checkpoint import (ROPE_LAYOUTS, checkpoint_weights,
                                           flatten, model_heads,
                                           peak_host_gib, port_checkpoint,
                                           read_checkpoint, read_rename,
                                           state_dict_of, unflatten)

KEY_SHIFT = 40                   # ids: (key index << 40) | local index
LOCAL = (1 << KEY_SHIFT) - 1


def _leaf(tree: dict, path: tuple):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def _memory_order(ids: np.ndarray, leaf: np.ndarray):
    """``ids`` and ``leaf`` with their axes in ``ids``' memory order, so
    that a transposed id array (a Dense kernel) walks its memory without
    a copy."""
    order = sorted(range(ids.ndim), key=lambda a: -abs(ids.strides[a]))
    return ids.transpose(order), leaf.transpose(order)


def _scatter(ids, vals, flat, covered) -> None:
    """``flat[key][local] = vals`` for ids ``(key << 40) | local``, key by
    key: the whole array when one key fills it, else along its first
    axis (the layers of a stack, the rows of a concatenated qkv kernel),
    else by runs of one key."""
    first, last = int(ids.min()), int(ids.max())
    lo, hi = first >> KEY_SHIFT, last >> KEY_SHIFT
    if lo == hi:
        run = np.ravel(ids)
        if last - first == run.size - 1 and (run[1:] > run[:-1]).all():
            # one ascending run of a key (distinct ids): a slice, no gather
            local = slice(first & LOCAL, (last & LOCAL) + 1)
        else:
            local = run - (lo << KEY_SHIFT)
        flat[lo][local] = np.ravel(vals)
        covered[lo][local] = True
    elif ids.ndim > 1:
        for i in range(ids.shape[0]):
            _scatter(ids[i], vals[i], flat, covered)
    else:
        keys = ids >> KEY_SHIFT
        cuts = np.flatnonzero(keys[1:] != keys[:-1]) + 1
        for s, e in zip(np.r_[0, cuts], np.r_[cuts, ids.size]):
            _scatter(ids[s:e], vals[s:e], flat, covered)


def export_checkpoint(tree: dict, template_sd: dict,
                      dec_layers: int | None = None,
                      rename: dict | None = None,
                      rope_layout: str = "half",
                      heads: dict | None = None) -> tuple[dict, dict]:
    """Invert the forward port: values from ``tree``, key set, shapes and
    dtypes from ``template_sd`` (numpy arrays).  ``dec_layers``,
    ``rename``, ``rope_layout`` and ``heads`` as ``port_checkpoint``
    takes them.  Returns (state_dict of numpy arrays, report) with
    ``exported_keys``, ``passthrough`` and ``missing``."""
    keys = list(template_sd)
    if len(keys) >= 1 << (63 - KEY_SHIFT):
        raise ValueError(f"{len(keys)} keys: too many for the id layout")
    arrs = [np.asarray(template_sd[k]) for k in keys]
    id_sd = {k: np.arange(i << KEY_SHIFT, (i << KEY_SHIFT) + a.size,
                          dtype=np.int64).reshape(a.shape)
             for i, (k, a) in enumerate(zip(keys, arrs))}
    id_tree, _ = port_checkpoint(id_sd, dec_layers, rename=rename,
                                 rope_layout=rope_layout, heads=heads)
    del id_sd

    flat = [np.empty(a.size, a.dtype) for a in arrs]
    covered = [np.zeros(a.size, bool) for a in arrs]
    missing = []
    for path_s, ids in flatten(id_tree):
        leaf = _leaf(tree, tuple(path_s.split("/")))
        if leaf is None:
            missing.append(path_s)
            continue
        leaf = np.asarray(leaf)
        if leaf.shape != ids.shape:
            raise ValueError(f"{path_s}: tree {leaf.shape} vs template "
                             f"{ids.shape}")
        if ids.size:
            _scatter(*_memory_order(ids, leaf), flat, covered)
    del id_tree

    out, passthrough = {}, []
    for i, k in enumerate(keys):
        if covered[i].all():
            out[k] = flat[i].reshape(arrs[i].shape)
        else:
            out[k] = arrs[i]
            passthrough.append(k)
    report = {"exported_keys": len(out) - len(passthrough),
              "passthrough": sorted(passthrough),
              "missing": sorted(missing)}
    return out, report


def export_model(model, template_sd: dict, dec_layers: int | None = None,
                 rename: dict | None = None,
                 rope_layout: str = "half") -> tuple[dict, dict]:
    """``export_checkpoint`` of a port ``PanSt3R``'s parameters
    (``weights.dump_jax_params``), with the model's own head counts."""
    from panst3r_torch.weights import dump_jax_params

    return export_checkpoint(dump_jax_params(model), template_sd,
                             dec_layers, rename=rename,
                             rope_layout=rope_layout,
                             heads=model_heads(model))


def _tree_of(args):
    if args.params:
        with np.load(args.params) as f:
            return unflatten((k, f[k]) for k in f.files), None
    from pathlib import Path

    import torch

    from panst3r_torch.core.checkpoint import load_checkpoint
    from panst3r_torch.models.panst3r import PanSt3R
    from panst3r_torch.weights import dump_jax_params

    path = Path(args.checkpoint)
    state, cfg, _ = load_checkpoint(path.parent, path.name)
    if cfg is None:
        raise ValueError(f"{path}: no config.json beside its state")
    with torch.device("meta"):
        model = PanSt3R(cfg)
    model.load_state_dict(state, assign=True)
    return dump_jax_params(model), model_heads(model)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Export flax-named weights to a reference-named .pth")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--params",
                     help="ported_params.npz (flat 'a/b/c' keys)")
    src.add_argument("--checkpoint",
                     help="a directory of core/checkpoint.py (run/final)")
    ap.add_argument("--template", required=True,
                    help="reference-named .pth giving keys, shapes, dtypes")
    ap.add_argument("--out", required=True, help="output .pth path")
    ap.add_argument("--dec-layers", type=int, default=None)
    ap.add_argument("--rope-layout", choices=ROPE_LAYOUTS, default="half")
    ap.add_argument("--rename-json", default=None,
                    help="the JSON {regex: replacement} the port was "
                         "given")
    ap.add_argument("--trust-pickle", action="store_true",
                    help="unpickle the template with weights_only=False")
    args = ap.parse_args(argv)

    import torch

    t0 = time.perf_counter()
    tree, heads = _tree_of(args)
    ckpt = read_checkpoint(args.template, args.trust_pickle)
    dtypes = {k: v.dtype for k, v in checkpoint_weights(ckpt).items()
              if torch.is_tensor(v)}
    template = state_dict_of(ckpt)
    del ckpt
    sd, report = export_checkpoint(tree, template, args.dec_layers,
                                   rename=read_rename(args.rename_json),
                                   rope_layout=args.rope_layout,
                                   heads=heads)

    def tensor(k, v):           # back to the template tensor's dtype
        v = torch.from_numpy(np.array(v, order="C"))
        return v.to(dtypes.get(k, v.dtype))

    torch.save({"weights": {k: tensor(k, v) for k, v in sd.items()}},
               args.out)
    print(f"exported {report['exported_keys']} keys "
          f"({len(report['passthrough'])} passthrough, "
          f"{len(report['missing'])} missing) in "
          f"{time.perf_counter() - t0:.1f} s; peak host memory "
          f"{peak_host_gib():.2f} GiB; report:")
    print(json.dumps({k: v[:8] if isinstance(v, list) else v
                      for k, v in report.items()}, indent=2))
    return report


if __name__ == "__main__":
    main()
