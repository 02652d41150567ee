"""Checkpoint I/O for the port's own weights (counterpart of
panst3r_tpu/core/checkpoint.py, which uses orbax).

A checkpoint is a directory ``directory/name`` holding:

- ``state.pt``: the model's ``state_dict`` (``torch.save``, tensors moved
  to the CPU);
- ``config.json``: the model config as ``core/config.py::to_dict`` writes
  it (the config is rebuilt from that dict, never from code);
- ``meta_arrays.npz``: the array-valued meta entries (say the
  class-embedding table), and ``meta.json``: the other meta entries;
- ``optimizer.pt`` (training checkpoints only): the optimizer's
  ``state_dict`` (``engine/train.py::Optimizer``), tensors on the CPU.
  With ``state.pt`` it is the JAX package's whole ``TrainState``; the
  ``final`` checkpoint of a run holds the weights only.

``latest_checkpoint`` is the auto-resume hook: ``"last"`` when it exists.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from panst3r_torch.core import config as cfg


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(directory: str | Path, name: str, model,
                    model_config: Any = None,
                    meta: Optional[dict] = None,
                    optimizer: Optional[dict] = None) -> Path:
    """Save ``model``'s state_dict (or ``model`` itself when it is a state
    dict) with its config and meta under ``directory/name``, and
    ``optimizer`` (an optimizer's state_dict) when given; returns that
    path."""
    path = Path(directory).absolute() / name
    path.mkdir(parents=True, exist_ok=True)
    state = model if isinstance(model, dict) else model.state_dict()
    torch.save(_to_cpu(state), path / "state.pt")
    if optimizer is not None:
        torch.save(_to_cpu(optimizer), path / "optimizer.pt")
    else:                       # a weights-only save replaces the state
        (path / "optimizer.pt").unlink(missing_ok=True)
    if model_config is not None:
        (path / "config.json").write_text(
            json.dumps(cfg.to_dict(model_config), indent=2))
    if meta is not None:
        arrays = {k: np.asarray(v) for k, v in meta.items()
                  if isinstance(v, np.ndarray)}
        scalars = {k: v for k, v in meta.items() if k not in arrays}
        if arrays:
            np.savez(path / "meta_arrays.npz", **arrays)
        (path / "meta.json").write_text(json.dumps(scalars, indent=2))
    return path


def load_checkpoint(directory: str | Path, name: str,
                    map_location="cpu") -> tuple[dict, Any, dict]:
    """Returns (state_dict, model config or None, meta dict)."""
    path = Path(directory).absolute() / name
    state = torch.load(path / "state.pt", map_location=map_location,
                       weights_only=True)
    model_config = None
    cfg_file = path / "config.json"
    if cfg_file.exists():
        model_config = cfg.from_dict(json.loads(cfg_file.read_text()))
    meta_file = path / "meta.json"
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    arr_file = path / "meta_arrays.npz"
    if arr_file.exists():
        with np.load(arr_file) as z:
            meta.update({k: z[k] for k in z.files})
    return state, model_config, meta


def load_optimizer_state(directory: str | Path, name: str,
                         map_location="cpu") -> Optional[dict]:
    """The optimizer state_dict saved with checkpoint ``name``, or None
    when it holds none."""
    path = Path(directory).absolute() / name / "optimizer.pt"
    if not path.exists():
        return None
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_checkpoint(directory: str | Path) -> Optional[str]:
    """``"last"`` if ``directory/last`` exists, else None."""
    return "last" if (Path(directory) / "last").exists() else None
