"""Attention entry points (counterpart of panst3r_tpu/ops/attention.py).

Conventions: q (B, H, Nq, D), k/v (B, H, Nk, D); ``bias`` is additive in
logits; ``mask`` is boolean with True = may attend.  Masked logits take
``finfo(f32).min``, not ``-inf``, as in the JAX package.

Routing mirrors the JAX package.  Shapes it sends to the tower kernels go
to K1/K2 (``ops/tower_attention.py``) from the model blocks; the masked
cross-attention goes to K3 (``ops/masked_attention.py``); everything else
goes to the generic flash kernel K4 (``ops/flash_attention.py``), which
runs its plain version on a CPU tensor.  The one exception is the
tiny-shape branch (Nq < 256, Nk <= 1024, no bias or mask), where the JAX
package itself runs plain jnp — e.g. the mask transformer's 200-query
self-attention.  Unlike the JAX wrappers, nothing here falls back to plain
attention when a kernel refuses a shape: the refusal propagates.
"""
from __future__ import annotations

import os

import torch

from panst3r_torch.ops import flops
from panst3r_torch.ops.rope import apply_rope_tables

NEG_INF = float(torch.finfo(torch.float32).min)


def needs_k4(t: torch.Tensor, what: str) -> None:
    """Refuse to run a plain formula on the card where the JAX package runs
    K4 on a path the port has not wired to it yet (DINO's non-split-cls
    attention)."""
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"{what} at shape {tuple(t.shape)} needs K4 (not yet wired)")


class _Recompute(torch.autograd.Function):
    """``fwd(*xs)`` with the vector-Jacobian product of ``plain(*xs)``,
    recomputed with autograd in the backward (``recompute_vjp``).  A FLOP
    count takes the products of that backward but not the recomputed
    forward: model work, as the JAX package's CPU count (plain jnp, no
    ``custom_vjp``) has it."""

    @staticmethod
    def forward(ctx, fwd, plain, need_grad, *xs):
        if need_grad:
            ctx.save_for_backward(*xs)
            ctx.plain = plain
        return fwd(*xs)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            xs = [None if x is None else x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, needs)]
            with flops.declare(0):
                out = ctx.plain(*xs)
            grads = iter(torch.autograd.grad(
                out, [x for x, n in zip(xs, needs) if n], g))
        return (None, None, None) + tuple(next(grads) if n else None
                                          for n in needs)


def recompute_vjp(fwd, plain, *xs):
    """``fwd(*xs)`` (a kernel, or its plain version on the CPU), with the
    gradient in the tensors ``xs`` (None allowed) of ``plain(*xs)``
    recomputed in the backward: the JAX package's ``custom_vjp`` around
    the forward-only kernels K1-K3, whose backward differentiates a plain
    formula (tower_attention.py:229-238, :612-621; masked_attention.py:
    197-212).  Anything else ``fwd`` and ``plain`` use gets no gradient."""
    need_grad = torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)
    return _Recompute.apply(fwd, plain, need_grad, *xs)


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
    any device; other shapes run K4."""
    if _tiny(q, k, bias):
        return dot_product_attention(q, k, v, scale=scale)
    from panst3r_torch.ops.flash_attention import flash_mha

    return flash_mha(q, k, v, bias=bias, scale=scale)


def flash_attention_rope2d_tables(q, k, v, qtab=None, ktab=None, bias=None,
                                  scale=None):
    """Attention with 2D RoPE from precomputed f32 (cos, sin) tables (B, N,
    D).  With both tables and a non-tiny shape, K4 rotates q and k in f32;
    otherwise the tables rotate in the token dtype first, as in the JAX
    package."""
    if not _tiny(q, k, bias) and qtab is not None and ktab is not None:
        from panst3r_torch.ops.flash_attention import flash_mha

        return flash_mha(q, k, v, bias=bias, rope=(*qtab, *ktab),
                         scale=scale)
    if qtab is not None:
        q = apply_rope_tables(q, *qtab)
    if ktab is not None:
        k = apply_rope_tables(k, *ktab)
    return flash_attention(q, k, v, bias=bias, scale=scale)


def masked_attention(q, k, v, blocked, scale=None):
    """Masked cross-attention; blocked (B, Nq, Nk) bool, True = may NOT
    attend, shared across heads.  Runs K3 (plain version on the CPU).
    ``PANST3R_DISABLE_SPARSE_MASK=1`` selects the dense path: K4 with a
    head-broadcast finfo.min bias (the JAX package runs plain attention
    there; the values agree because the mask transformer never passes a
    fully blocked row)."""
    if os.environ.get("PANST3R_DISABLE_SPARSE_MASK", "0") == "1":
        from panst3r_torch.ops.flash_attention import flash_mha

        bias = torch.where(blocked, NEG_INF, 0.0)[:, None]
        return flash_mha(q, k, v, bias=bias, scale=scale)
    from panst3r_torch.ops.masked_attention import masked_mha

    return masked_mha(q.contiguous(), k.contiguous(), v.contiguous(),
                      blocked.contiguous(), scale=scale)


def memory_mask_bias(valid: torch.Tensor, dtype=torch.float32):
    """valid (B, Nk) bool → (B, 1, 1, Nk) additive bias, finfo.min at
    invalid slots."""
    zero = torch.zeros((), dtype=dtype, device=valid.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=valid.device)
    return torch.where(valid, zero, neg)[:, None, None, :]
