"""K6: head-packed flash attention (counterpart of
tools/ab_attention_packed.py::packed_mha).

``packed_mha(q, k, v, scale=None)`` replaces ``_packed_kernel``: bf16
runs ``csrc/packed_flash_sm90.cu`` (the Hopper engine: TMA ring, wgmma,
softmax in registers, one CTA per (batch, pair, head, 128-query tile)),
f32 ``csrc/packed_flash.cu``.  q, k, v of shape (B, P, N, 128) carry two d=64 heads
per 128-lane row (P = H/2 head pairs); each head gets its own softmax
stream, with no mask and no bias.  Semantics, as in the Pallas kernel:
``scale or 64**-0.5`` (so 0 means the default); f32 scores from the
inputs' dtype with the scale on the f32 score; the value product takes p
rounded to v's dtype while the row sum takes the unrounded f32 p; the
output is acc / l cast to q's dtype.

The only caller is the A/B tool (``panst3r_torch/tools/
ab_attention_packed.py``).  The kernel is forward-only, as the Pallas one
is: on a CUDA tensor that requires a gradient it raises.  q, k, v may be
any (batch, pair, token)-strided views with a unit lane stride, such as
the pair view of a (B, N, H*64) projection (bf16: strides that are
multiples of 8 elements and 16-byte aligned bases, the tensor maps' rule);
the output is the (B, P, N, 128) view of (B, N, P, 128) storage, so
merging the heads is a free reshape.

On a CPU tensor ``packed_mha`` runs ``packed_mha_ref``; on a CUDA tensor it
launches the kernel or raises (N must be a multiple of the kernels' 64-row
tiles; the Pallas kernel takes multiples of its 768-row blocks).
``launches`` counts the calls, ``launches_f32`` those of them on the f32
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from panst3r_torch.ops import cuda_build, flops

HEAD_DIM = 64
LANES = 2 * HEAD_DIM
TILE = 64          # N must be a multiple of this (the f32 kernel's tile)


def _scale(scale):
    return scale or HEAD_DIM ** -0.5


def packed_mha_ref(q, k, v, scale=None):
    """Plain version of K6 (same signature as ``packed_mha``)."""
    scale = _scale(scale)
    B, P, N, _ = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)

    def heads(t):                 # (B, P, N, 128) -> (B, P, 2, N, 64)
        return t.reshape(B, P, t.shape[2], 2, HEAD_DIM).transpose(2, 3)

    qh, kh, vh = heads(q), heads(k), heads(v)
    s = torch.matmul(qh.to(acc), kh.to(acc).transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    num = torch.matmul(p.to(v.dtype).to(acc), vh.to(acc))
    out = num / p.sum(-1, keepdim=True)
    return out.transpose(2, 3).reshape(B, P, N, LANES).to(q.dtype)


def _strides(t, name):
    if t.stride(-1) != 1:
        raise ValueError(f"packed_mha: {name} needs a unit lane stride")
    return list(t.stride()[:3])


def _packed_kernel(q, k, v, scale):
    """Launch K6."""
    B, P, N, D = q.shape
    if D != LANES:
        raise ValueError(f"packed_mha takes 128-lane head pairs, not {D}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"packed_mha takes f32/bf16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype \
                or tuple(t.shape) != (B, P, N, D):
            raise ValueError(f"packed_mha: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{q.dtype} {(B, P, N, D)}")
    if N % TILE:
        raise NotImplementedError(
            f"packed_mha: K6 takes N a multiple of {TILE}, not N={N}")
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "packed_mha is forward-only (the Pallas kernel has no backward)")
    out = torch.empty((B, N, P, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(_strides(q, "q") + _strides(k, "k") + _strides(v, "v")
          + _strides(out, "out")))
    p = ctypes.c_void_p
    args = [p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, p]
    if q.dtype == torch.bfloat16:       # the Hopper engine
        for name, t in (("q", q), ("k", k), ("v", v)):
            if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
                raise ValueError(
                    f"packed_mha: {name}'s strides {t.stride()} and base "
                    "must be multiples of 16 bytes (the tensor maps' rule)")
        lib, fn = cuda_build.function("packed_flash_sm90",
                                      "p3_packed_flash_sm90", args)
    else:
        lib, fn = cuda_build.function("packed_flash", "p3_packed_flash",
                                      args)
    P_ = cuda_build.ptr
    err = fn(P_(q), P_(k), P_(v), P_(out), strides, B, P, N, float(scale),
             cuda_build.stream_of(q))
    cuda_build.check(lib, err, "packed_mha")
    packed_mha.launches += 1
    packed_mha.launches_f32 += int(q.dtype == torch.float32)
    return out


def packed_mha(q, k, v, scale=None):
    """K6.  q, k, v (B, P, N, 128), two d=64 heads per row; returns
    (B, P, N, 128) in q's dtype.  ``scale``: falsy means 64**-0.5."""
    scale = _scale(scale)
    B, P, N, _ = q.shape
    with flops.declare(flops.attention_flops(B, 2 * P, N, k.shape[2],
                                             HEAD_DIM)):
        if q.device.type == "cpu":
            return packed_mha_ref(q, k, v, scale)
        return _packed_kernel(q, k, v, scale)


# launches: every call; launches_f32: those of them on the f32 kernel
packed_mha.launches = packed_mha.launches_f32 = 0
