"""Attention entry points (counterpart of panst3r_tpu/ops/attention.py).

Conventions: q (B, H, Nq, D), k/v (B, H, Nk, D); ``bias`` is additive in
logits; ``mask`` is boolean with True = may attend.  Masked logits take
``finfo(f32).min``, not ``-inf``, as in the JAX package.

Routing mirrors the JAX package.  Shapes it sends to the tower kernels go
to K1/K2 (``ops/tower_attention.py``) from the model blocks; the masked
cross-attention goes to K3 (``ops/masked_attention.py``).  Everything else
the JAX package sends to its generic flash kernel (K4), which is not
ported yet: on a CUDA tensor those shapes raise, on the CPU they run the
plain formula.  The one exception is the tiny-shape branch (Nq < 256,
Nk <= 1024, no bias or mask), where the JAX package itself runs plain jnp —
e.g. the mask transformer's 200-query self-attention.
"""
from __future__ import annotations

import os

import torch

from panst3r_torch.ops.rope import apply_rope_tables

NEG_INF = float(torch.finfo(torch.float32).min)


def needs_k4(t: torch.Tensor, what: str) -> None:
    """Refuse to run a plain formula on the card where the JAX package runs
    its generic flash kernel (K4)."""
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"{what} at shape {tuple(t.shape)} needs K4 (not yet ported)")


def dot_product_attention(q, k, v, bias=None, mask=None, scale=None):
    """Scaled dot-product attention with f32 logits and softmax; the
    probabilities are cast to v's dtype before the value product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def _tiny(q, k, bias) -> bool:
    return q.shape[2] < 256 and k.shape[2] <= 1024 and bias is None


def flash_attention(q, k, v, bias=None, scale=None):
    """JAX ``flash_attention`` routing: tiny shapes run plain attention on
    any device; other shapes need K4 on the card."""
    if not _tiny(q, k, bias):
        needs_k4(q, "flash_attention")
    return dot_product_attention(q, k, v, bias=bias, scale=scale)


def flash_attention_rope2d_tables(q, k, v, qtab=None, ktab=None, bias=None,
                                  scale=None):
    """Attention with 2D RoPE from precomputed (cos, sin) tables."""
    if not _tiny(q, k, bias):
        needs_k4(q, "flash_attention_rope2d_tables")
    if qtab is not None:
        q = apply_rope_tables(q, *qtab)
    if ktab is not None:
        k = apply_rope_tables(k, *ktab)
    return dot_product_attention(q, k, v, bias=bias, scale=scale)


def masked_attention(q, k, v, blocked, scale=None):
    """Masked cross-attention; blocked (B, Nq, Nk) bool, True = may NOT
    attend, shared across heads.  Runs K3 (plain version on the CPU).
    ``PANST3R_DISABLE_SPARSE_MASK=1`` selects the JAX package's dense-bias
    path, which runs K4 there: it raises on the card."""
    if os.environ.get("PANST3R_DISABLE_SPARSE_MASK", "0") == "1":
        needs_k4(q, "dense-bias masked attention")
        return dot_product_attention(q, k, v, mask=~blocked[:, None],
                                     scale=scale)
    from panst3r_torch.ops.masked_attention import masked_mha

    return masked_mha(q.contiguous(), k.contiguous(), v.contiguous(),
                      blocked.contiguous(), scale=scale)


def memory_mask_bias(valid: torch.Tensor, dtype=torch.float32):
    """valid (B, Nk) bool → (B, 1, 1, Nk) additive bias, finfo.min at
    invalid slots."""
    zero = torch.zeros((), dtype=dtype, device=valid.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=valid.device)
    return torch.where(valid, zero, neg)[:, None, None, :]
