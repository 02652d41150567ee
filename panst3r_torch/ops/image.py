"""Image resampling and input casting (counterpart of panst3r_tpu/ops/image.py
and the uint8 branch of panst3r_tpu/engine/inference.py:46-66).

Two resize semantics are needed, and they differ:

- ``resize_bilinear``: torch ``F.interpolate(mode='bilinear',
  align_corners=False)`` with no antialias, written as the same gather and
  lerp as the JAX function (the DINO image resize, reference dino.py:66).
- ``resize``: ``jax.image.resize``, by default with ``antialias=True``,
  which widens the kernel by the scale factor when downsampling, and with
  Keys a = -0.5 for bicubic.  torch's ``F.interpolate`` antialiases only on
  request and uses a = -0.75, so the port builds the same separable weight
  matrices as ``jax.image.scale_and_translate`` and contracts with them
  (the DINO pos-embed, the mask transformer's token-grid mask features, the
  fusion mask upsample and, without antialias, the matcher's grid).
- ``scale_and_translate_linear``: ``jax.image.scale_and_translate`` with the
  linear kernel and no antialias, its scale and translation given as
  device tensors (the mask loss's jittered grid).

The packed YUV420 serving input (``rgb_to_yuv420`` on the host,
``yuv420_to_rgb`` on the device) and ``image_cast``, the engine's input
normalization, close the module.
"""
from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from panst3r_torch.ops import flops


def _axis_lerp(out_size: int, in_size: int, device, dtype=torch.float32):
    c = (torch.arange(out_size, dtype=dtype, device=device) + 0.5) \
        * (in_size / out_size) - 0.5
    c = torch.clamp(c, 0.0, in_size - 1)
    lo = torch.floor(c).to(torch.int64)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    return lo, hi, c - lo


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize WITHOUT antialias on (..., H, W, C) tensors.  The
    lerp weights are f32, or f64 for an f64 input, as JAX makes them (its
    default float width)."""
    *lead, H, W, C = x.shape
    if (H, W) == (out_h, out_w):
        return x
    flat = x.reshape(-1, H, W, C)
    wdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    ly, hy, wy = _axis_lerp(out_h, H, x.device, wdt)
    lx, hx, wx = _axis_lerp(out_w, W, x.device, wdt)
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
def resize_weights(in_size: int, out_size: int, method: str,
                   antialias: bool = True) -> np.ndarray:
    """(in_size, out_size) f32 weights of jax.image.scale_and_translate
    (translation 0), computed in f32 as JAX does: the inverse scale is the
    Python (f64) quotient rounded to f32, and with ``antialias`` the kernel
    widens by it when downsampling."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
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


def einsum_flops(in_shape, out_shape, dims) -> float:
    """FLOPs of contracting x of ``in_shape`` with one weight matrix per
    dim of ``dims``, in ``jnp.einsum``'s order (opt_einsum's optimal path:
    the fewest multiply-adds): what the JAX counter counts for
    ``jax.image.resize`` / ``scale_and_translate``, and for their
    backward (one product per contraction again).  The port contracts the
    last dim first (``_Separable``), which is that order for fusion's
    landscape upsampling; elsewhere its work differs from this count by a
    few multiply-adds per output, and it declares this count."""
    best = None
    for perm in itertools.permutations(dims):
        cur, cost = list(in_shape), 0
        for d in perm:
            cost += math.prod(cur) * out_shape[d]
            cur[d] = out_shape[d]
        best = cost if best is None else min(best, cost)
    return 2.0 * (best or 0)


class _Separable(torch.autograd.Function):
    """x contracted with the matrix ``w`` of each dim ``d`` of ``pairs``,
    in that order, each product rounded to x's dtype; differentiable in x
    (the weights are constants).  Forward and backward declare
    ``count`` FLOPs (``einsum_flops``) to an open counter."""

    @staticmethod
    def _contract(x, d, w):
        return torch.movedim(torch.matmul(torch.movedim(x, d, -1), w), -1,
                             d)

    @staticmethod
    def forward(ctx, x, pairs, count):
        ctx.pairs, ctx.count = pairs, count
        with flops.declare(count):
            for d, w in pairs:
                x = _Separable._contract(x, d, w)
        return x

    @staticmethod
    def backward(ctx, g):
        with flops.declare(ctx.count):
            for d, w in reversed(ctx.pairs):
                g = _Separable._contract(g, d, w.t())
        return g, None, None


def resize(x: torch.Tensor, shape, method: str,
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, shape, method, antialias)`` for the bilinear
    and bicubic kernels: one separable contraction per resized dim, with
    the weights cast to x's dtype.  XLA contracts the last resized dim
    first for fusion's masks and rounds between the contractions; the
    same order makes the bf16 fusion masks bit-identical.  Declares
    ``einsum_flops``."""
    assert len(shape) == x.ndim
    dims = [d for d in range(x.ndim) if x.shape[d] != shape[d]]
    pairs = [(d, torch.as_tensor(resize_weights(x.shape[d], shape[d], method,
                                                antialias),
                                 device=x.device).to(x.dtype))
             for d in reversed(dims)]
    return _Separable.apply(x, pairs, einsum_flops(x.shape, shape, dims))


def _linear_weights(in_size: int, out_size: int, scale, translation):
    """``compute_weight_mat`` of jax.image for the linear kernel without
    antialias, from f32 0-d tensors ``scale`` and ``translation`` on the
    device (a step's random jitter stays there): (in_size, out_size)."""
    f32 = torch.float32
    dev = scale.device
    inv_scale = 1.0 / scale
    sample_f = (torch.arange(out_size, dtype=f32, device=dev) + 0.5) \
        * inv_scale - translation * inv_scale - 0.5
    x = (sample_f[None, :]
         - torch.arange(in_size, dtype=f32, device=dev)[:, None]).abs()
    w = torch.clamp(1.0 - x, min=0.0)
    tot = w.sum(dim=0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def scale_and_translate_linear(x: torch.Tensor, shape, spatial_dims,
                               scale: torch.Tensor,
                               translation: torch.Tensor) -> torch.Tensor:
    """``jax.image.scale_and_translate(x, shape, spatial_dims, scale,
    translation, method="linear", antialias=False)`` on an f32 ``x``;
    ``scale`` and ``translation`` are f32 tensors with one entry per spatial
    dim.  The last spatial dim is contracted first, as for ``resize``;
    declares ``einsum_flops``."""
    pairs = [(d, _linear_weights(x.shape[d], shape[d], scale[i],
                                 translation[i]))
             for i, d in reversed(list(enumerate(spatial_dims)))]
    return _Separable.apply(x, pairs,
                            einsum_flops(x.shape, shape, list(spatial_dims)))


# ------------------------------------------------------- YUV420 wire ----
# Serving input compression (panst3r_tpu/ops/image.py:57-109): full-range
# BT.601 YUV with 2x2-mean-subsampled chroma, 12 bits a pixel instead of 24.
# Layout (..., H*3/2, W) uint8: the Y plane (H, W) on top, below it the
# half-resolution U and V planes side by side, [U | V] (H/2, W).


def rgb_to_yuv420(img) -> np.ndarray:
    """Host-side pack: (..., H, W, 3) uint8 RGB → (..., H*3/2, W) uint8."""
    x = np.asarray(img, np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    H, W = y.shape[-2:]
    lead = y.shape[:-2]

    def sub(c):        # 2x2 mean subsample
        return c.reshape(*lead, H // 2, 2, W // 2, 2).mean(axis=(-3, -1))

    bottom = np.concatenate([sub(cb), sub(cr)], axis=-1)      # (H/2, W)
    packed = np.concatenate([y, bottom], axis=-2)             # (H*3/2, W)
    return np.clip(np.rint(packed), 0, 255).astype(np.uint8)


def yuv420_to_rgb(packed: torch.Tensor) -> torch.Tensor:
    """Device-side unpack: (..., H*3/2, W) uint8 → f32 RGB in [0, 255]
    (chroma nearest-upsampled), the same f32 operations in the same order
    as the JAX function."""
    H = packed.shape[-2] * 2 // 3
    W = packed.shape[-1]
    p = packed.to(torch.float32)
    y = p[..., :H, :]
    bottom = p[..., H:, :]
    cb = bottom[..., :, :W // 2] - 128.0
    cr = bottom[..., :, W // 2:] - 128.0

    def up(c):         # nearest 2x upsample
        return c.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)

    cb, cr = up(cb), up(cr)
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def is_packed_yuv(x) -> bool:
    """A rank-3 uint8 array whose last dim is not 3 is the packed wire
    (V, H*3/2, W); (V, H, W, 3) and a single (H, W, 3) are RGB."""
    return (str(x.dtype).endswith("uint8") and x.ndim == 3
            and x.shape[-1] != 3)


def yuv420_decode(packed: torch.Tensor) -> torch.Tensor:
    """Packed YUV420 → uint8 RGB (V, H, W, 3): rint before anything else,
    so the packed input is exactly its decoded RGB on every serve path."""
    return torch.round(yuv420_to_rgb(packed)).to(torch.uint8)


def image_cast(x: torch.Tensor, amp: bool) -> torch.Tensor:
    """uint8 RGB → dust3r normalization ([-1, 1]) in bf16 (amp) or f32;
    float input is only cast (to bf16 under amp).  Packed YUV420 input is
    decoded to uint8 RGB first and then takes the uint8 path, so
    serve(pack(x)) equals serve(decode(pack(x))) bit for bit under amp
    too (the JAX package normalizes packed input in f32 and casts after,
    which equals this in f32 only: ROADMAP.md queue 3)."""
    dtype = torch.bfloat16 if amp else torch.float32
    if is_packed_yuv(x):
        x = yuv420_decode(x)
    if x.dtype == torch.uint8:
        # Divide by a device tensor, not a Python number: CUDA divides by a
        # host scalar through its reciprocal, one ulp off the quotient the
        # CPU and the JAX package compute for some values, and the v2
        # head's Fourier features multiply that ulp by up to e^10.
        return x.to(dtype) / torch.full((), 127.5, dtype=dtype,
                                        device=x.device) - 1.0
    return x.to(dtype) if amp else x
