"""DINOv2-style frozen semantic encoder (counterpart of
panst3r_tpu/models/dino.py).

- ImageNet renormalization of the [-1, 1] input, in the image dtype;
- torch-exact bilinear resize (no antialias) so the 14-px grid has the
  16-px MUSt3R patch count;
- learned position embeddings resized bicubically as ``jax.image.resize``
  does (antialias, Keys a = -0.5; ops/image.py);
- layerscale blocks with the cls token carried as a separate (B, 1, C)
  stream (``split_cls``, the default): inside K1's gate the patch rows
  run K1 with the cls key/value joining every softmax, and the cls query
  row is one plain (1, N+1) softmax (dino.py:129-158 of the JAX package);
  outside it (more than 1024 patches, heads not of 64)
  ``flash_attention_split_cls`` runs K4 over the patches with its LSE and
  merges the cls column exactly;
- with ``split_cls=False``, blocks over the concatenated [cls; patches]
  (``SelfAttention`` without RoPE: K1 at <= 1024 tokens, K4 beyond); the
  parameters are the same, so either path loads one checkpoint;
- the cls token is dropped from the output.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.models.blocks import (LN_EPS, Mlp, SelfAttention,
                                         merge_heads, split_heads)
from panst3r_torch.ops.attention import (dot_product_attention,
                                         flash_attention_split_cls)
from panst3r_torch.ops.image import resize, resize_bilinear
from panst3r_torch.ops.tower_attention import (supports_tower_attention,
                                               tower_self_attention)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


@cfg.register
@dataclasses.dataclass(frozen=True)
class DinoEncoderConfig:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    pos_grid: int = 37
    layerscale_init: float = 1e-5
    output_stride: int = 16
    # carry the cls token as a separate stream (the same parameters either
    # way: checkpoints are interchangeable)
    split_cls: bool = True


class SplitClsSelfAttention(nn.Module):
    """Self-attention over [cls; patches] with the cls token carried
    separately; same parameters as SelfAttention (qkv, proj)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, c):
        qkv_x = self.qkv(x)
        qkv_c = self.qkv(c)
        C = qkv_x.shape[-1] // 3   # this rank's heads under TP
        H = self.num_heads
        D = C // H
        if not supports_tower_attention(x.shape[1], C, H):
            out_p, out_c = flash_attention_split_cls(
                *(split_heads(t, H) for t in qkv_x.split(C, dim=-1)),
                *(split_heads(t, H) for t in qkv_c.split(C, dim=-1)))
            return (self.proj(merge_heads(out_p)),
                    self.proj(merge_heads(out_c)))
        out_p = tower_self_attention(
            qkv_x, H, cls_kv=(qkv_c[..., C:2 * C].contiguous(),
                              qkv_c[..., 2 * C:].contiguous()))
        # cls query row: one (1, N+1) softmax in f32, plain ops
        qc, kc, vc = (split_heads(t, H) for t in qkv_c.split(C, dim=-1))
        k = split_heads(qkv_x[..., C:2 * C], H)
        v = split_heads(qkv_x[..., 2 * C:], H)
        out_c = dot_product_attention(qc, torch.cat([kc, k], 2),
                                      torch.cat([vc, v], 2), scale=D ** -0.5)
        return self.proj(out_p), self.proj(merge_heads(out_c))


class DinoBlock(nn.Module):
    """A layerscale block over the concatenated [cls; patches]."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.ls1 = nn.Parameter(torch.empty(dim))
        self.ls2 = nn.Parameter(torch.empty(dim))
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SelfAttention(dim, num_heads, rope_base=None)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.ls1 * self.attn(self.norm1(x))
        return x + self.ls2 * self.mlp(self.norm2(x))


class DinoBlockSplit(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.ls1 = nn.Parameter(torch.empty(dim))
        self.ls2 = nn.Parameter(torch.empty(dim))
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SplitClsSelfAttention(dim, num_heads)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, c):
        ax, ac = self.attn(self.norm1(x), self.norm1(c))
        x = x + self.ls1 * ax
        c = c + self.ls1 * ac
        x = x + self.ls2 * self.mlp(self.norm2(x))
        c = c + self.ls2 * self.mlp(self.norm2(c))
        return x, c


class DinoEncoder(nn.Module):
    """Frozen ViT semantic encoder; returns patch tokens (B, N, C)."""

    def __init__(self, config: DinoEncoderConfig = DinoEncoderConfig()):
        super().__init__()
        c = self.config = config
        self.patch_embed = nn.Conv2d(3, c.embed_dim, c.patch_size,
                                     stride=c.patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c.embed_dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, c.pos_grid * c.pos_grid + 1, c.embed_dim))
        block = DinoBlockSplit if c.split_cls else DinoBlock
        self.blocks = nn.ModuleList(
            block(c.embed_dim, c.num_heads, c.mlp_ratio)
            for _ in range(c.depth))
        self.norm = nn.LayerNorm(c.embed_dim, eps=LN_EPS)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) in [-1, 1]."""
        c = self.config
        mean = torch.tensor(_IMAGENET_MEAN, dtype=images.dtype,
                            device=images.device)
        std = torch.tensor(_IMAGENET_STD, dtype=images.dtype,
                           device=images.device)
        x = (images * 0.5 + 0.5 - mean) / std
        B, H, W, _ = x.shape
        x = resize_bilinear(x, H // c.output_stride * c.patch_size,
                            W // c.output_stride * c.patch_size)
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        gh, gw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)
        pos = self.pos_embed
        patch_pos = pos[:, 1:].reshape(1, c.pos_grid, c.pos_grid, -1)
        patch_pos = resize(patch_pos, (1, gh, gw, c.embed_dim), "bicubic")
        x = x + patch_pos.reshape(1, gh * gw, c.embed_dim)
        cls = (self.cls_token + pos[:, :1]).expand(B, 1, c.embed_dim)
        cls = cls.to(x.dtype)
        if c.split_cls:
            for blk in self.blocks:
                x, cls = blk(x, cls)
            # the final LayerNorm is per token; the dropped cls needs none
            return self.norm(x)
        x = torch.cat([cls, x], 1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1:]
