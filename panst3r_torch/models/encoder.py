"""MUSt3R-style ViT-L/16 image encoder (counterpart of
panst3r_tpu/models/encoder.py): conv patch embed, ``depth`` pre-norm blocks
with 2D RoPE (base 100) whose tables are computed once per forward, final
LayerNorm.  The flax scan stack ``blocks/block`` becomes ``blocks.<i>``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.models.blocks import LN_EPS, Block
from panst3r_torch.ops.rope import patch_grid_positions, rope2d_tables


@cfg.register
@dataclasses.dataclass(frozen=True)
class ViTEncoderConfig:
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    rope_base: float = 100.0


class ViTEncoder(nn.Module):
    def __init__(self, config: ViTEncoderConfig = ViTEncoderConfig()):
        super().__init__()
        c = self.config = config
        self.patch_embed = nn.Conv2d(3, c.embed_dim, c.patch_size,
                                     stride=c.patch_size)
        self.blocks = nn.ModuleList(
            Block(c.embed_dim, c.num_heads, c.mlp_ratio,
                  rope_base=c.rope_base) for _ in range(c.depth))
        self.norm = nn.LayerNorm(c.embed_dim, eps=LN_EPS)

    def forward(self, images: torch.Tensor):
        """images (B, H, W, 3) in [-1, 1] → tokens (B, N, C), pos (B, N, 2)."""
        c = self.config
        B = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2))
        gh, gw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)
        pos = patch_grid_positions(gh, gw, images.device)[None].expand(
            B, gh * gw, 2)
        tabs = rope2d_tables(pos, c.embed_dim // c.num_heads, c.rope_base)
        for blk in self.blocks:
            x = blk(x, tabs=tabs)
        return self.norm(x), pos
