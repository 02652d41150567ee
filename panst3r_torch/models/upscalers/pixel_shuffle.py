"""PixelShuffle FPN upscaler for v1 models (counterpart of
panst3r_tpu/models/upscalers/pixel_shuffle.py): MLP → 2× pixel-shuffle three
times (stride 16 → 8 → 4 → 2), channels-last.  Returns ``fpn=[f16]`` and
the stride-2 mask features."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.models.blocks import Mlp


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C*r²) → (B, H*r, W*r, C), channels-last."""
    B, H, W, Cr2 = x.shape
    C = Cr2 // (r * r)
    x = x.reshape(B, H, W, r, r, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H * r, W * r, C)


@cfg.register
@dataclasses.dataclass(frozen=True)
class PixelShuffleUpscalerConfig:
    patch_size: int = 16
    hidden_dim_factor: float = 4.0
    fp_dim: tuple = (768, 512, 384, 256)

    @property
    def fpn_dim(self) -> tuple:
        return (self.fp_dim[0],)

    @property
    def mask_dim(self) -> int:
        return self.fp_dim[3]


class PixelShuffleUpscaler(nn.Module):
    def __init__(self, in_dim: int,
                 config: PixelShuffleUpscalerConfig = PixelShuffleUpscalerConfig()):
        super().__init__()
        c = self.config = config
        hf = c.hidden_dim_factor

        def proj(d_in, d_out):
            return Mlp(d_in, int(hf * d_in), d_out)

        self.proj_8 = proj(in_dim, c.fp_dim[1] * 4)
        self.proj_4 = proj(c.fp_dim[1], c.fp_dim[2] * 4)
        self.proj_2 = proj(c.fp_dim[2], c.fp_dim[3] * 4)
        self.proj_16 = proj(in_dim, c.fp_dim[0])

    def forward(self, feats: torch.Tensor, grid: tuple[int, int]):
        """feats (B, N, C) → ([f16 (B, gh, gw, fp0)], f2 (B, 8gh, 8gw, fp3))."""
        B = feats.shape[0]
        gh, gw = grid
        f8 = pixel_shuffle(self.proj_8(feats).reshape(B, gh, gw, -1), 2)
        f4 = pixel_shuffle(self.proj_4(f8), 2)
        f2 = pixel_shuffle(self.proj_2(f4), 2)
        f16 = self.proj_16(feats).reshape(B, gh, gw, -1)
        return [f16], f2
