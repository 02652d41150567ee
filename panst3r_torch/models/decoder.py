"""MUSt3R-style multi-view decoder with cross-view token memory (counterpart
of panst3r_tpu/models/decoder.py).

- **update** (``render=False``): each view self-attends over its own tokens
  and cross-attends into [memory ‖ the batch's own norm_y tokens] (own
  tokens carry a zero bias); the per-layer norm_y tokens are appended to
  the memory.
- **render** (``render=True``): the same compute against a frozen memory.

Self-attention runs K1 (d=64 heads), the memory cross-attention K2 with the
validity bias.  With ``feedback_feats`` (a refinement pass, feedback type
``single_mlp``) the embedded tokens gain ``feedback_mlp`` of the features a
previous pass rendered; without them the MLP is not run (checkpoints carry
its parameters either way).  The flax scan stack ``layers/*`` becomes
``layers.<i>``.

A memory split over the mesh's ``mem`` axis (``TokenMemory.group``, the
counterpart of the JAX decoder's ``kv_shard`` constraint) holds only this
rank's slots: before each layer's cross-attention the ranks' slices of
that layer's bank are all-gathered (``TokenMemory.whole``) and K2 runs
over the whole bank, so the result has the bits of one device; an update
writes only this rank's slots of the new tokens.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.models import memory as memlib
from panst3r_torch.models.blocks import (LN_EPS, CrossAttention, Mlp,
                                         SelfAttention)
from panst3r_torch.models.memory import TokenMemory
from panst3r_torch.ops import flops
from panst3r_torch.ops.attention import memory_mask_bias
from panst3r_torch.ops.rope import rope2d_tables


@cfg.register
@dataclasses.dataclass(frozen=True)
class MemoryDecoderConfig:
    enc_dim: int = 1024
    dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    patch_size: int = 16
    feedback: str = "single_mlp"
    head_channels: int = 7


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 rope_base: float):
        super().__init__()
        self.norm_y = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.self_attn = SelfAttention(dim, num_heads, rope_base=rope_base)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = CrossAttention(dim, num_heads, rope_base=rope_base)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, mem_y_l, tabs_self, tabs_q, ktab, bias,
                render: bool):
        """x (B, V, N, C); mem_y_l (B, M, C).  Returns (x, norm_y tokens)."""
        B, V, N, C = x.shape
        y_cur = self.norm_y(x)
        if render:
            kv = mem_y_l.to(x.dtype)
        else:
            kv = torch.cat([mem_y_l.to(x.dtype), y_cur.reshape(B, V * N, C)],
                           dim=1)
        xv = x.reshape(B * V, N, C)
        xv = xv + self.self_attn(self.norm1(xv), tabs=tabs_self)
        x = xv.reshape(B, V * N, C)
        x = x + self.cross_attn(self.norm2(x), kv, kv, bias=bias,
                                qtab=tabs_q, ktab=ktab)
        x = x + self.mlp(self.norm3(x))
        return x.reshape(B, V, N, C), y_cur


class MemoryDecoder(nn.Module):
    def __init__(self, config: MemoryDecoderConfig = MemoryDecoderConfig()):
        super().__init__()
        c = self.config = config
        self.decoder_embed = nn.Linear(c.enc_dim, c.dim)
        if c.feedback == "single_mlp":
            self.feedback_mlp = Mlp(c.dim, c.dim * 2, c.dim)
        self.layers = nn.ModuleList(
            DecoderLayer(c.dim, c.num_heads, c.mlp_ratio, c.rope_base)
            for _ in range(c.depth))
        self.norm = nn.LayerNorm(c.dim, eps=LN_EPS)
        self.head = nn.Linear(c.dim, c.patch_size ** 2 * c.head_channels)

    def forward(self, x_enc, pos, mem: TokenMemory, render: bool,
                grid: tuple[int, int], feedback_feats=None):
        """x_enc (B, V, N, enc_dim); pos (B, V, N, 2); feedback_feats
        (B, V, N, dim) or None.  Returns (mem, pointmaps_raw (B, V, H, W,
        7), feats (B, V, N, dim)); in update mode ``mem`` is filled in
        place."""
        c = self.config
        B, V, N, _ = x_enc.shape
        gh, gw = grid
        assert gh * gw == N, (grid, N)
        x = self.decoder_embed(x_enc)
        if c.feedback == "single_mlp" and feedback_feats is not None:
            x = x + self.feedback_mlp(feedback_feats)
        elif c.feedback == "single_mlp":
            # the JAX decoder calls feedback_mlp on one zero token to create
            # its flax parameters (decoder.py:143); XLA drops the call and
            # the JAX FLOP counter counts it: two Dense layers of
            # 2·dim·2dim FLOPs each
            flops.add_traced_only(8.0 * c.dim * c.dim)

        flat_pos = pos.reshape(B, V * N, 2)
        hd = c.dim // c.num_heads
        mem_pos = mem.whole(mem.pos)
        mem_bias = memory_mask_bias(mem.whole(mem.valid))
        tabs_self = rope2d_tables(pos.reshape(B * V, N, 2), hd, c.rope_base)
        tabs_q = rope2d_tables(flat_pos, hd, c.rope_base)
        if render:
            bias = mem_bias
            ktab = rope2d_tables(mem_pos, hd, c.rope_base)
        else:
            zeros = torch.zeros((B, 1, 1, V * N), dtype=mem_bias.dtype,
                                device=mem_bias.device)
            bias = torch.cat([mem_bias, zeros], dim=-1)
            ktab = rope2d_tables(torch.cat([mem_pos, flat_pos], dim=1), hd,
                                 c.rope_base)

        new_y = []
        for li, layer in enumerate(self.layers):
            x, y_cur = layer(x, mem.whole(mem.y[li]), tabs_self, tabs_q,
                             ktab, bias, render)
            new_y.append(y_cur)
        feats = self.norm(x)
        if not render:
            mem = memlib.insert(
                mem, torch.stack(new_y).reshape(c.depth, B, V * N, c.dim),
                flat_pos)

        p = c.patch_size
        out = self.head(feats).reshape(B, V, gh, gw, p, p, c.head_channels)
        out = out.permute(0, 1, 2, 4, 3, 5, 6).reshape(
            B, V, gh * p, gw * p, c.head_channels)
        return mem, out, feats


def postprocess(pointmaps_raw: torch.Tensor) -> dict[str, torch.Tensor]:
    """Raw head output → pts3d / pts3d_local ('exp' activation) and
    conf = 1 + exp(clip(raw, -10, 10))."""

    def _exp_pts(raw):
        d = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
        return raw * (torch.expm1(d) / torch.clamp(d, min=1e-8))

    return {"pts3d": _exp_pts(pointmaps_raw[..., 0:3]),
            "pts3d_local": _exp_pts(pointmaps_raw[..., 3:6]),
            "conf": 1.0 + torch.exp(torch.clamp(pointmaps_raw[..., 6],
                                                -10.0, 10.0))}
