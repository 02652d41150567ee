"""Shared app bootstrap: preset and checkpoint → ready InferenceEngine
(counterpart of panst3r_tpu/apps/common.py).

The apps need the same sequence: build the preset model, optionally load
weights, and pair them with the SAME class names and text-embedding table
they were trained with (the checkpoint's meta).  Keeping it in one place
keeps that pairing from drifting between apps.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PRESETS = ("v1", "v2", "tiny", "tiny_v2")


def preset_config(preset: str):
    from panst3r_torch.models import presets

    return {"v1": presets.panst3r_v1_config, "v2": presets.panst3r_v2_config,
            "tiny": presets.tiny_config,
            "tiny_v2": presets.tiny_v2_config}[preset]()


def load_weights(model, checkpoint: str | Path,
                 trust_pickle: bool = False) -> dict:
    """Fill ``model`` from ``checkpoint``: a directory written by
    ``core/checkpoint.py::save_checkpoint`` (returns its meta), or a
    reference-shaped torch checkpoint file such as the published PanSt3R
    weights (mapped by ``port_checkpoint.load_reference_state_dict``;
    returns an empty meta; any key left unmapped raises).

    A torch file is read by ``port_checkpoint.read_checkpoint``
    (``weights_only=True`` unless ``trust_pickle``)."""
    path = Path(checkpoint)
    if path.is_dir():
        from panst3r_torch.core.checkpoint import load_checkpoint

        state, _, meta = load_checkpoint(path.parent, path.name)
        model.load_state_dict(state)
        return meta
    from panst3r_torch.port_checkpoint import (load_reference_state_dict,
                                               read_checkpoint)

    ckpt = read_checkpoint(path, trust_pickle)
    report = load_reference_state_dict(model, ckpt)
    if report["unmapped"]:
        raise ValueError(f"{path}: {len(report['unmapped'])} keys of the "
                         f"checkpoint map to no parameter, e.g. "
                         f"{report['unmapped'][:5]}")
    return {}


def build_engine(preset: str, bucket, checkpoint: Optional[str] = None,
                 num_keyframes: int = 4, amp: bool = True,
                 classes: Optional[Sequence[str]] = None, seed: int = 0,
                 device=None, trust_pickle: bool = False):
    """Returns (engine, classes, cls_emb).

    Without a checkpoint the weights are random from ``seed`` and the class
    embeddings random unit vectors (architecture demos); with one,
    ``classes`` and ``cls_emb`` come from its meta when present
    (``trust_pickle``: see ``load_weights``).  The engine runs on the card
    unless ``device="cpu"``."""
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    cfg = preset_config(preset)
    model = build_model(cfg, device=device, seed=seed)
    lang_dim = cfg.panoptic.mask_transformer.lang_dim
    classes = list(classes) if classes is not None \
        else [f"class_{i}" for i in range(32)]
    rng = np.random.default_rng(seed)
    cls_emb = rng.standard_normal((len(classes), lang_dim)).astype(
        np.float32)
    cls_emb /= np.linalg.norm(cls_emb, axis=-1, keepdims=True)

    if checkpoint:
        meta = load_weights(model, checkpoint, trust_pickle)
        if "classes" in meta:
            classes = list(meta["classes"])
        if "cls_emb" in meta:
            # trained weights must pair with the SAME text embeddings
            cls_emb = np.asarray(meta["cls_emb"], np.float32)

    engine = InferenceEngine(model, bucket, num_keyframes=num_keyframes,
                             amp=amp, device=device)
    return engine, classes, cls_emb
