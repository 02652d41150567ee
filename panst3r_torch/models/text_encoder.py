"""Open-vocabulary text embeddings (counterpart of
panst3r_tpu/models/text_encoder.py).

Class names become L2-normalized embeddings through a text tower that runs
rarely (when the vocabulary changes), outside the model's step.  With
``fixed_vocab`` the table is computed once by ``set_vocab`` (or installed
by ``load_table``) and a missing class raises; without it, missing classes
are embedded on demand.  ``tower_fn`` is the tower: the port's
``models/siglip_text.py::NativeTextTower`` (SigLIP; with ``SIGLIP2_CONFIG``
and ``tokenize_siglip2`` for SigLIP2) or ``models/clip_text.py::
NativeClipTower`` (CLIP).  Without one, ``_hf_tower`` runs the HF tower
from a local HF checkpoint (it needs ``transformers`` and the weights).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from panst3r_torch.core import config as cfg

MODEL_CONFIGS = {
    # the reference's MODEL_CONFIGS
    "siglip2": dict(embed_dim=768, template="this is a photo of {}"),
    "siglip": dict(embed_dim=768, template="This is a photo of {}."),
    "clip": dict(embed_dim=512, template="a photo of {}"),
}


@cfg.register
@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    model_name: str = "siglip"
    fixed_vocab: bool = True

    @property
    def embed_dim(self) -> int:
        return MODEL_CONFIGS[self.model_name]["embed_dim"]


class TextEncoder:
    """Host-side class name → L2-normalized embedding provider."""

    def __init__(self, config: TextEncoderConfig = TextEncoderConfig(),
                 tower_fn: Optional[Callable[[Sequence[str]],
                                             np.ndarray]] = None):
        self.config = config
        self.embed_dim = config.embed_dim
        self.template = MODEL_CONFIGS[config.model_name]["template"]
        self._tower_fn = tower_fn
        self._table: dict[str, np.ndarray] = {}

    def _run_tower(self, classes: Sequence[str]) -> np.ndarray:
        prompts = [self.template.format(c) for c in classes]
        if self._tower_fn is not None:
            emb = np.asarray(self._tower_fn(prompts), np.float32)
        else:
            emb = _hf_tower(self.config.model_name, prompts)
        assert emb.shape == (len(classes), self.embed_dim)
        return emb

    def set_vocab(self, classes: Sequence[str]) -> None:
        """Compute and keep the embeddings of ``classes``."""
        emb = self._run_tower(classes)
        for c, e in zip(classes, emb):
            self._table[c] = e

    def load_table(self, classes: Sequence[str], embeddings: np.ndarray):
        """Install precomputed embeddings (e.g. from a checkpoint)."""
        for c, e in zip(classes, np.asarray(embeddings, np.float32)):
            self._table[c] = e

    def __call__(self, classes: Sequence[str]) -> np.ndarray:
        """(num_classes, embed_dim) L2-normalized."""
        missing = [c for c in classes if c not in self._table]
        if missing:
            if self.config.fixed_vocab:
                raise KeyError(
                    f"classes missing from fixed vocab: {missing[:5]}... "
                    "call set_vocab first")
            self.set_vocab(missing)
        emb = np.stack([self._table[c] for c in classes])
        return emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True),
                                1e-12)

    def state(self) -> dict:
        return {"classes": list(self._table),
                "embeddings": np.stack(list(self._table.values()))
                if self._table else np.zeros((0, self.embed_dim), np.float32)}


def _hf_tower(model_name: str, prompts: Sequence[str]) -> np.ndarray:
    """Run the HF text tower on the CPU from the checkpoint's files in the
    local HF cache (``local_files_only``: never a download; it raises when
    the files are not there)."""
    hf_names = {"siglip": "google/siglip-base-patch16-224",
                "siglip2": "google/siglip2-base-patch16-224",
                "clip": "openai/clip-vit-base-patch32"}
    import torch
    from transformers import AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(hf_names[model_name],
                                        local_files_only=True)
    model = AutoModel.from_pretrained(hf_names[model_name],
                                      local_files_only=True).eval()
    text_model = getattr(model, "text_model", model)
    outs = []
    with torch.no_grad():
        for i in range(0, len(prompts), 32):
            kw = dict(padding="max_length", max_length=64) \
                if model_name.startswith("siglip") else dict(padding=True)
            inputs = tok(list(prompts[i:i + 32]), return_tensors="pt", **kw)
            outs.append(text_model(**inputs).pooler_output)
    return torch.cat(outs).float().numpy()
