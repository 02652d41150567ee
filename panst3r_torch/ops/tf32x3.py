"""Plain emulation of the f32 kernels' 3xTF32 products
(``csrc/attn_f32_sm90.cuh``), for the tests and ``chip_smoke.py``; no
kernel path calls it.

- ``tf32_round``: f32 to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
  does: round to nearest with ties away from zero on the 13 dropped bits,
  by int32 bit operations; inf and NaN pass through.
- ``split_tf32``: x = hi + lo, hi = tf32(x), lo = tf32(x - hi).
- ``matmul_tf32x3``: a @ b as lo·hi + hi·lo + hi·hi of the splits, each
  product exact in f64 (TF32 mantissas multiply exactly) and summed into
  f32, as the tensor cores accumulate; the dropped lo·lo term is about
  2^-22 of each product.
"""
from __future__ import annotations

import torch

_DROP = 13                       # f32 mantissa bits TF32 drops
_HALF = 1 << (_DROP - 1)
_KEEP = ~((1 << _DROP) - 1)      # as an int32 mask: 0xFFFFE000


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32, ties away from zero; the result is f32
    with the low 13 mantissa bits clear.  Adding half a TF32 unit to the
    magnitude's bits carries into the exponent where the rounding does
    (subnormals into normals, the largest values into inf)."""
    bits = x.float().view(torch.int32)
    rounded = ((bits + _HALF) & _KEEP).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x.float())


def split_tf32(x: torch.Tensor):
    """(hi, lo), both TF32 values in f32, with hi + lo ~ x."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (f32) through the 3xTF32 split: lo·hi + hi·lo + hi·hi, the
    products taken in f64 and the sum rounded to f32."""
    ah, al = (t.double() for t in split_tf32(a))
    bh, bl = (t.double() for t in split_tf32(b))
    return (al @ bh + ah @ bl + ah @ bh).float()


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with one TF32 product (hi·hi): what a plain TF32 kernel
    computes, about three decimal digits."""
    return (tf32_round(a).double() @ tf32_round(b).double()).float()
