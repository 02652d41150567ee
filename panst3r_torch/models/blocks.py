"""Transformer blocks (counterpart of panst3r_tpu/models/blocks.py).

Parameter names follow the flax tree (``qkv``, ``proj``, ``projq`` ...,
``norm1``), so ``weights.load_jax_params`` maps them mechanically.  Every
LayerNorm states its eps: flax's default is 1e-6, torch's 1e-5.

Attention routing mirrors the JAX blocks: a tower shape (d=64 heads, the
``supports_tower_*`` gates) goes to K1/K2; other shapes take the JAX
package's generic path (``ops/attention.py``): plain attention for tiny
shapes, K4 otherwise.  Under tensor parallelism (``core/tp.py``) the
projections hold this rank's heads and ``num_heads`` counts them, so the
widths are read from the projections' outputs and the gates see the local
shape.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from panst3r_torch.ops.attention import (flash_attention,
                                         flash_attention_rope2d_tables)
from panst3r_torch.ops.gelu import gelu_exact
from panst3r_torch.ops.rope import rope2d_tables
from panst3r_torch.ops.tower_attention import (supports_tower_attention,
                                               supports_tower_cross,
                                               tower_cross_attention,
                                               tower_self_attention)

LN_EPS = 1e-6  # flax nn.LayerNorm default
TORCH_LN_EPS = 1e-5  # the reference's plain nn.LayerNorm (CrossonlyDecoderBlock)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, N, D = x.shape
    return x.transpose(1, 2).reshape(B, N, H * D)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


class SelfAttention(nn.Module):
    """Self-attention with optional 2D RoPE from precomputed tables."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 rope_base: Optional[float] = 100.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.rope_base = rope_base
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, tabs=None):
        """x (B, N, C); tabs: (cos, sin) (B, N, D) f32 RoPE tables."""
        qkv = self.qkv(x)
        C = qkv.shape[-1] // 3     # this rank's heads under TP
        t = tabs if self.rope_base is not None else None
        if supports_tower_attention(x.shape[1], C, self.num_heads):
            return self.proj(tower_self_attention(qkv, self.num_heads,
                                                  tabs=t))
        q, k, v = (split_heads(u, self.num_heads)
                   for u in qkv.split(C, dim=-1))
        if t is not None:
            out = flash_attention_rope2d_tables(q, k, v, qtab=t, ktab=t)
        else:
            out = flash_attention(q, k, v)
        return self.proj(merge_heads(out))


class CrossAttention(nn.Module):
    """Cross-attention with RoPE tables on q and k and an additive bias
    (B, 1, 1, Nk) per key (memory validity)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 rope_base: Optional[float] = 100.0):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.projq = nn.Linear(dim, dim, bias=qkv_bias)
        self.projk = nn.Linear(dim, dim, bias=qkv_bias)
        self.projv = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, key, value, bias=None, qtab=None, ktab=None):
        q, k, v = self.projq(x), self.projk(key), self.projv(value)
        C = q.shape[-1]            # this rank's heads under TP
        if self.rope_base is None:
            qtab = ktab = None
        per_key = (bias is not None and bias.ndim == 4
                   and bias.shape[1] == 1 and bias.shape[2] == 1)
        rope_ok = self.rope_base is None or (qtab is not None
                                             and ktab is not None)
        if (bias is None or per_key) and rope_ok and supports_tower_cross(
                x.shape[1], key.shape[1], C, self.num_heads):
            kv_bias = None
            if per_key:
                kv_bias = bias[:, 0, 0, :].float().expand(
                    k.shape[0], k.shape[1]).contiguous()
            out = tower_cross_attention(q, k, v, qtab=qtab, ktab=ktab,
                                        kv_bias=kv_bias)
            return self.proj(out)
        q, k, v = (split_heads(u, self.num_heads) for u in (q, k, v))
        if qtab is not None or ktab is not None:
            out = flash_attention_rope2d_tables(q, k, v, qtab=qtab,
                                                ktab=ktab, bias=bias)
        else:
            out = flash_attention(q, k, v, bias=bias)
        return self.proj(merge_heads(out))


class Block(nn.Module):
    """Pre-norm ViT block: x + attn(ln(x)); x + mlp(ln(x)) (croco Block)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, rope_base: Optional[float] = 100.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SelfAttention(dim, num_heads, qkv_bias, rope_base)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, tabs=None):
        x = x + self.attn(self.norm1(x), tabs=tabs)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Self-attn + memory cross-attn + MLP (pre-norm residual), RoPE from
    integer (y, x) positions (the JAX block's call surface)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, rope_base: Optional[float] = 100.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SelfAttention(dim, num_heads, qkv_bias, rope_base)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = CrossAttention(dim, num_heads, qkv_bias, rope_base)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, xpos, mem_y, mem_pos, mem_bias=None):
        """x (B, N, C); xpos (B, N, 2); mem_y (B, M, C) pre-normalized
        memory tokens; mem_pos (B, M, 2); mem_bias (B, 1, 1, M)."""
        tabs_x = tabs_mem = None
        if self.attn.rope_base is not None:
            hd = self.attn.head_dim
            tabs_x = rope2d_tables(xpos, hd, self.attn.rope_base)
            tabs_mem = rope2d_tables(mem_pos, hd, self.attn.rope_base)
        x = x + self.attn(self.norm1(x), tabs=tabs_x)
        x = x + self.cross_attn(self.norm2(x), mem_y, mem_y, bias=mem_bias,
                                qtab=tabs_x, ktab=tabs_mem)
        return x + self.mlp(self.norm3(x))


class CrossonlyDecoderBlock(nn.Module):
    """Cross-attention + MLP residual block with no self-attention and a
    norm on the memory (the LoftUp upscaler's block).  Its LayerNorms use
    eps 1e-5, the attention has no q/k/v bias and no RoPE, so at LoftUp's
    4 heads of 96 the attention takes K4."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, rope_base: Optional[float] = None):
        super().__init__()
        self.norm_y = nn.LayerNorm(dim, eps=TORCH_LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=TORCH_LN_EPS)
        self.cross_attn = CrossAttention(dim, num_heads, qkv_bias, rope_base)
        self.norm3 = nn.LayerNorm(dim, eps=TORCH_LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, y):
        """x (B, Nq, C) queries; y (B, Nk, C) memory.  Returns (x, y)."""
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_)
        x = x + self.mlp(self.norm3(x))
        return x, y
