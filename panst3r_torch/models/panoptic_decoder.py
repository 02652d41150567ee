"""Panoptic head: feature concat → upscaler → mask transformer (counterpart
of panst3r_tpu/models/panoptic_decoder.py), v1 only: PixelShuffle upscaler,
no input mixer, sigmoid label mode, and the ``memory_queries`` fast path
that reuses keyframe queries through the prediction heads only.  The input
mixer, LoftUp and the softmax label mode wait for the v2 slice."""
from __future__ import annotations

import dataclasses
import torch
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.models.mask_transformer import (MaskTransformer,
                                                   MaskTransformerConfig)
from panst3r_torch.models.upscalers import (PixelShuffleUpscaler,
                                            PixelShuffleUpscalerConfig)


@cfg.register
@dataclasses.dataclass(frozen=True)
class PanopticDecoderConfig:
    upscaler: PixelShuffleUpscalerConfig = PixelShuffleUpscalerConfig()
    mask_transformer: MaskTransformerConfig = MaskTransformerConfig()
    deep_supervision: bool = True


class PanopticDecoder(nn.Module):
    def __init__(self, in_dim: int,
                 config: PanopticDecoderConfig = PanopticDecoderConfig()):
        super().__init__()
        self.config = config
        self.upscaler = PixelShuffleUpscaler(in_dim, config.upscaler)
        self.mask_transformer = MaskTransformer(config.mask_transformer)

    def features(self, in_feats, grid):
        """Concat → upscaler, per view.  in_feats: (B, V, N, C_i) each."""
        cat = torch.cat(list(in_feats), dim=-1)
        B, V, N, C = cat.shape
        fpn, mask_f = self.upscaler(cat.reshape(B * V, N, C), grid)
        fpn = [f.reshape(B, V, *f.shape[1:]) for f in fpn]
        return fpn, mask_f.reshape(B, V, *mask_f.shape[1:])

    def forward(self, in_feats, portrait, cls_embeddings, grid,
                memory_queries=None, deep_supervision=None):
        """in_feats: (x_must3r, y_must3r, x_dino) each (B, V, N, C_i);
        portrait (B, V) bool; cls_embeddings (num_classes, lang_dim)."""
        fpn, mask_f = self.features(in_feats, grid)
        if deep_supervision is None:
            deep_supervision = self.config.deep_supervision
        if memory_queries is None:
            return self.mask_transformer(fpn, mask_f, cls_embeddings,
                                         portrait,
                                         deep_supervision=deep_supervision)
        return self.mask_transformer.decode_with_queries(
            memory_queries, mask_f, cls_embeddings)
