"""Panoptic head: feature concat → (input mixer) → upscaler → mask
transformer (counterpart of panst3r_tpu/models/panoptic_decoder.py), one
resolution bucket.  v1: PixelShuffle upscaler, no mixer; v2: InputMixer and
LoftUp.  The softmax label mode appends the learned ``nocls_token`` to the
class embeddings.  ``memory_queries`` selects the fast path that reuses
keyframe queries through the prediction heads only; the features (mixer
and upscaler) run on every call, as in the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.models.input_mixer import InputMixer, InputMixerConfig
from panst3r_torch.models.mask_transformer import (MaskTransformer,
                                                   MaskTransformerConfig)
from panst3r_torch.models.upscalers import (LoftUpUpscaler,
                                            LoftUpUpscalerConfig,
                                            PixelShuffleUpscaler,
                                            PixelShuffleUpscalerConfig)


@cfg.register
@dataclasses.dataclass(frozen=True)
class PanopticDecoderConfig:
    input_mixer: Optional[InputMixerConfig] = None        # v2 only
    upscaler: Union[PixelShuffleUpscalerConfig, LoftUpUpscalerConfig] = \
        PixelShuffleUpscalerConfig()
    mask_transformer: MaskTransformerConfig = MaskTransformerConfig()
    label_mode: str = "sigmoid"                           # or 'softmax'
    text_embed_dim: int = 768
    deep_supervision: bool = True

    def __post_init__(self):
        assert self.label_mode in ("sigmoid", "softmax")


class PanopticDecoder(nn.Module):
    def __init__(self, in_dim: int,
                 config: PanopticDecoderConfig = PanopticDecoderConfig()):
        super().__init__()
        c = self.config = config
        if c.input_mixer is not None:
            self.input_mixer = InputMixer(in_dim, c.input_mixer)
            in_dim = c.input_mixer.hidden_dim
        self.loftup = isinstance(c.upscaler, LoftUpUpscalerConfig)
        self.upscaler = (LoftUpUpscaler if self.loftup
                         else PixelShuffleUpscaler)(in_dim, c.upscaler)
        self.mask_transformer = MaskTransformer(c.mask_transformer)
        if c.label_mode == "softmax":
            self.nocls_token = nn.Parameter(torch.empty(c.text_embed_dim))

    def features(self, in_feats, images, pos, grid):
        """Concat → mixer → upscaler, per view.  in_feats: (B, V, N, C_i)
        each; images (B, V, H, W, 3); pos (B, V, N, 2)."""
        cat = torch.cat(list(in_feats), dim=-1)
        B, V, N, C = cat.shape
        flat = cat.reshape(B * V, N, C)
        if self.config.input_mixer is not None:
            flat = self.input_mixer(flat, pos.reshape(B * V, N, 2))
        if self.loftup:
            fpn, mask_f = self.upscaler(
                flat, images.reshape(B * V, *images.shape[2:]), grid)
        else:
            fpn, mask_f = self.upscaler(flat, grid)
        fpn = [f.reshape(B, V, *f.shape[1:]) for f in fpn]
        return fpn, mask_f.reshape(B, V, *mask_f.shape[1:])

    def cls_embeddings(self, cls_embeddings):
        if self.config.label_mode == "softmax":
            return torch.cat([cls_embeddings, self.nocls_token[None]], dim=0)
        return cls_embeddings

    def forward(self, in_feats, images, pos, portrait, cls_embeddings, grid,
                memory_queries=None, deep_supervision=None):
        """in_feats: (x_must3r, y_must3r, x_dino) each (B, V, N, C_i);
        images (B, V, H, W, 3) normalized; pos (B, V, N, 2); portrait
        (B, V) bool; cls_embeddings (num_classes, lang_dim)."""
        fpn, mask_f = self.features(in_feats, images, pos, grid)
        cls_emb = self.cls_embeddings(cls_embeddings)
        if deep_supervision is None:
            deep_supervision = self.config.deep_supervision
        if memory_queries is None:
            return self.mask_transformer(fpn, mask_f, cls_emb, portrait,
                                         deep_supervision=deep_supervision)
        return self.mask_transformer.decode_with_queries(
            memory_queries, mask_f, cls_emb)
