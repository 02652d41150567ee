"""InputMixer of the v2 models (counterpart of
panst3r_tpu/models/input_mixer.py): project the concatenated per-patch
features (2816 channels) to ``hidden_dim``, mix them with RoPE-100 ViT
blocks (K1 at the v2 widths: 12 heads of 64), then a LayerNorm."""
from __future__ import annotations

import dataclasses

from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.models.blocks import LN_EPS, Block
from panst3r_torch.ops.rope import rope2d_tables


@cfg.register
@dataclasses.dataclass(frozen=True)
class InputMixerConfig:
    hidden_dim: int = 768
    num_heads: int = 12
    num_layers: int = 3
    ff_dim_mult: float = 4.0
    rope_base: float = 100.0


class InputMixer(nn.Module):
    def __init__(self, in_dim: int,
                 config: InputMixerConfig = InputMixerConfig()):
        super().__init__()
        c = self.config = config
        self.in_proj = nn.Linear(in_dim, c.hidden_dim)
        for i in range(c.num_layers):
            setattr(self, f"mixer_blk_{i}",
                    Block(c.hidden_dim, c.num_heads, c.ff_dim_mult,
                          rope_base=c.rope_base))
        self.mixer_norm = nn.LayerNorm(c.hidden_dim, eps=LN_EPS)

    def forward(self, x, pos):
        """x (B, N, in_dim) concat features; pos (B, N, 2) patch positions."""
        c = self.config
        x = self.in_proj(x)
        tabs = rope2d_tables(pos, c.hidden_dim // c.num_heads, c.rope_base)
        for i in range(c.num_layers):
            x = getattr(self, f"mixer_blk_{i}")(x, tabs=tabs)
        return self.mixer_norm(x)
