"""2D rotary position embedding ("RoPE100"), counterpart of panst3r_tpu/ops/rope.py.

The per-head dim D is split in two halves: the first is rotated by the
token's y (row) position, the second by its x (column) position, each with
1-D NeoX-layout RoPE (rotate-half within the half) at frequency base 100.
"""
from __future__ import annotations

import numpy as np
import torch


def _inv_freq(half_dim: int, base: float) -> np.ndarray:
    # 1 / base^(2i/D) for i in [0, D/2), D = half_dim (per-axis dim)
    return 1.0 / (base ** (np.arange(0, half_dim, 2) / half_dim))


def rope_cos_sin(positions: torch.Tensor, dim: int, base: float = 100.0):
    """positions (..., N) integer → cos, sin (..., N, dim), frequencies
    repeated twice (NeoX layout)."""
    inv = torch.as_tensor(_inv_freq(dim, base), dtype=torch.float32,
                          device=positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rope2d_tables(positions: torch.Tensor, dim: int, base: float = 100.0):
    """Full-width f32 (cos, sin) tables (B, N, dim) for 2D RoPE: the y-axis
    tables fill the first half, the x-axis tables the second."""
    cos_y, sin_y = rope_cos_sin(positions[..., 0], dim // 2, base)
    cos_x, sin_x = rope_cos_sin(positions[..., 1], dim // 2, base)
    return torch.cat([cos_y, cos_x], -1), torch.cat([sin_y, sin_x], -1)


def _rotate_half_2d(x: torch.Tensor) -> torch.Tensor:
    """rotate_half applied within each (y, x) half of the last dim."""
    q = x.shape[-1] // 4
    return torch.cat([-x[..., q:2 * q], x[..., :q],
                      -x[..., 3 * q:], x[..., 2 * q:3 * q]], dim=-1)


def apply_rope_tables(tokens: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """tokens (B, H, N, D), cos/sin (B, N, D); tables are cast to the token
    dtype first, as the JAX function does."""
    cos = cos[:, None].to(tokens.dtype)
    sin = sin[:, None].to(tokens.dtype)
    return tokens * cos + _rotate_half_2d(tokens) * sin


def apply_rope_tables_f32(tokens: torch.Tensor, cos: torch.Tensor,
                          sin: torch.Tensor) -> torch.Tensor:
    """The kernels' form: rotate in f32 (tables stay f32; f64 tokens rotate
    in f64) and round back to the token dtype once."""
    acc = torch.promote_types(tokens.dtype, torch.float32)
    t = tokens.to(acc)
    out = t * cos[:, None].to(acc) + _rotate_half_2d(t) * sin[:, None].to(acc)
    return out.to(tokens.dtype)


def patch_grid_positions(grid_h: int, grid_w: int,
                         device=None) -> torch.Tensor:
    """Integer (y, x) positions of an h×w patch grid, row-major: (h*w, 2)."""
    yy, xx = torch.meshgrid(
        torch.arange(grid_h, dtype=torch.int32, device=device),
        torch.arange(grid_w, dtype=torch.int32, device=device),
        indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)
