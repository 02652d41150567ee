"""Image resampling and input casting (counterpart of panst3r_tpu/ops/image.py
and the uint8 branch of panst3r_tpu/engine/inference.py:46-66).

Two resize semantics are needed, and they differ:

- ``resize_bilinear``: torch ``F.interpolate(mode='bilinear',
  align_corners=False)`` with no antialias, written as the same gather and
  lerp as the JAX function (the DINO image resize, reference dino.py:66).
- ``resize``: ``jax.image.resize`` with its default ``antialias=True``,
  which widens the kernel by the scale factor when downsampling, and with
  Keys a = -0.5 for bicubic.  torch's ``F.interpolate`` antialiases only on
  request and uses a = -0.75, so the port builds the same separable weight
  matrices as ``jax.image.scale_and_translate`` and contracts with them
  (the DINO pos-embed, the mask transformer's token-grid mask features and
  the fusion mask upsample).  The YUV420 wire waits for the serving slice.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _axis_lerp(out_size: int, in_size: int, device):
    c = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * (in_size / out_size) - 0.5
    c = torch.clamp(c, 0.0, in_size - 1)
    lo = torch.floor(c).to(torch.int64)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    return lo, hi, c - lo


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize WITHOUT antialias on (..., H, W, C) tensors."""
    *lead, H, W, C = x.shape
    if (H, W) == (out_h, out_w):
        return x
    flat = x.reshape(-1, H, W, C)
    ly, hy, wy = _axis_lerp(out_h, H, x.device)
    lx, hx, wx = _axis_lerp(out_w, W, x.device)
    wy = wy[None, :, None, None].to(flat.dtype)
    wx = wx[None, None, :, None].to(flat.dtype)
    rows_lo = flat[:, ly]
    rows_hi = flat[:, hy]
    top = rows_lo[:, :, lx] * (1 - wx) + rows_lo[:, :, hx] * wx
    bot = rows_hi[:, :, lx] * (1 - wx) + rows_hi[:, :, hx] * wx
    out = top * (1 - wy) + bot * wy
    return out.reshape(*lead, out_h, out_w, C)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x):
    return np.maximum(np.float32(0), 1 - np.abs(x)).astype(np.float32)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) f32 weights of jax.image.scale_and_translate
    (translation 0, antialias on), computed in f32 as JAX does."""
    f32 = np.float32
    scale = f32(out_size / in_size)
    inv_scale = f32(1.0) / scale
    # the kernel widens by the scale factor when downsampling (antialias)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x.astype(f32))
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize(x: torch.Tensor, shape, method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` (antialias on) for the
    bilinear and bicubic kernels: one separable contraction per resized
    dim, with the weights cast to x's dtype.  XLA contracts the last
    resized dim first and rounds between the contractions; the same order
    makes the bf16 fusion masks bit-identical."""
    assert len(shape) == x.ndim
    for d in reversed(range(x.ndim)):
        n_in, n_out = x.shape[d], shape[d]
        if n_in == n_out:
            continue
        w = torch.as_tensor(resize_weights(n_in, n_out, method),
                            device=x.device).to(x.dtype)
        x = torch.movedim(torch.matmul(torch.movedim(x, d, -1), w), -1, d)
    return x


def image_cast(x: torch.Tensor, amp: bool) -> torch.Tensor:
    """uint8 RGB → dust3r normalization ([-1, 1]) in bf16 (amp) or f32;
    float input is only cast (to bf16 under amp)."""
    dtype = torch.bfloat16 if amp else torch.float32
    if x.dtype == torch.uint8:
        return x.to(dtype) / 127.5 - 1.0
    return x.to(dtype) if amp else x
