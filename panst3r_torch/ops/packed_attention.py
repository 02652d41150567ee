"""K6: head-packed flash attention (counterpart of
tools/ab_attention_packed.py::packed_mha).

``packed_mha(q, k, v, scale=None)`` replaces ``_packed_kernel``: bf16
runs ``csrc/packed_flash_sm90.cu`` (the Hopper engine: TMA ring, wgmma,
softmax in registers, one CTA per (batch, pair, head, 128-query tile)),
f32 the f32 K4's engine (``csrc/flash_fwd_sm90.cu``'s
``p3_flash_fwd_sm90``: 3xTF32, K/V hi/lo pre-pass, no bias, no LSE) over
the d=64 heads as strided views (``head_views``).  q, k, v of shape (B,
P, N, 128) carry two d=64 heads per 128-lane row (P = H/2 head pairs);
each head gets its own softmax stream, with no mask and no bias.
Semantics, as in the Pallas kernel: ``scale or 64**-0.5`` (so 0 means
the default); f32 scores from the inputs' dtype with the scale on the f32
score; the value product takes p rounded to v's dtype while the row sum
takes the unrounded f32 p; the output is acc / l cast to q's dtype.
``packed_mha_split_ref`` emulates the f32 route's arithmetic (the tests
only).

The only caller is the A/B tool (``panst3r_torch/tools/
ab_attention_packed.py``).  The kernel is forward-only, as the Pallas one
is: on a CUDA tensor that requires a gradient it raises.  q, k, v may be
any (batch, pair, token)-strided views with a unit lane stride, such as
the pair view of a (B, N, H*64) projection (bf16: strides that are
multiples of 8 elements and 16-byte aligned bases, the tensor maps' rule;
f32: multiples of 4, and a layout ``head_views`` takes); the output is
the (B, P, N, 128) view of (B, N, P, 128) storage, so merging the heads
is a free reshape (f32 inputs whose pair stride is not 128: (B, P, N,
128) storage, as theirs).

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
from panst3r_torch.ops import flash_attention as fa

HEAD_DIM = 64
LANES = 2 * HEAD_DIM
TILE = 64          # N must be a multiple of this (the bf16 kernel's tile; both
                   # dtypes keep the rule)


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


def head_views(*ts):
    """The d=64 heads of (B, P, N, 128) head-pair tensors as strided (B',
    H', N, 64) views that the f32 engine walks, one layout for all: (B, 2P)
    with head stride 64 where every pair stride is 128 (a (B, N, H·64)
    projection's pair view; any P = 1 tensor), else (B·P, 2) with the
    pair stride as the batch stride where every batch stride is P × the
    pair stride (contiguous tensors).  Any other layout raises
    ``NotImplementedError``."""
    B, P, N, _ = ts[0].shape
    if all(P == 1 or t.stride(1) == LANES for t in ts):
        return [t.as_strided((B, 2 * P, N, HEAD_DIM),
                             (t.stride(0), HEAD_DIM, t.stride(2), 1),
                             t.storage_offset()) for t in ts]
    if all(B == 1 or t.stride(0) == P * t.stride(1) for t in ts):
        return [t.as_strided((B * P, 2, N, HEAD_DIM),
                             (t.stride(1), HEAD_DIM, t.stride(2), 1),
                             t.storage_offset()) for t in ts]
    raise NotImplementedError(
        "packed_mha (f32): a layout the port has not wired, strides "
        f"{[t.stride() for t in ts]}")


def _f32_out(q, k, v):
    """The f32 route's output: (B, N, P, 128) storage where the inputs are
    pair views (pair stride 128), else (B, P, N, 128) storage."""
    B, P, N, D = q.shape
    if all(P == 1 or t.stride(1) == LANES for t in (q, k, v)):
        return torch.empty((B, N, P, D), dtype=q.dtype,
                           device=q.device).transpose(1, 2)
    return torch.empty((B, P, N, D), dtype=q.dtype, device=q.device)


def packed_mha_split_ref(q, k, v, scale=None, matmul=torch.matmul):
    """Plain version of the f32 K6's arithmetic (f32 only): the f32 K4's
    (``flash_attention.flash_mha_split_ref``) over ``head_views``'s views,
    written to the output the route allocates.  ``matmul`` takes the
    products (``ops/tf32x3.py::matmul_tf32x3`` emulates the kernel's)."""
    out = _f32_out(q, k, v)
    qv, kv, vv, ov = head_views(q, k, v, out)
    ov.copy_(fa.flash_mha_split_ref(qv, kv, vv, scale=_scale(scale),
                                    matmul=matmul))
    return out


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _strides(t, name)
    p, i32, P_ = ctypes.c_void_p, ctypes.c_int, cuda_build.ptr
    if q.dtype == torch.bfloat16:       # the Hopper engine
        out = torch.empty((B, N, P, D), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        for name, t in (("q", q), ("k", k), ("v", v)):
            if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
                raise ValueError(
                    f"packed_mha: {name}'s strides {t.stride()} and base "
                    "must be multiples of 16 bytes (the tensor maps' rule)")
        strides = (ctypes.c_longlong * 12)(
            *(_strides(q, "q") + _strides(k, "k") + _strides(v, "v")
              + _strides(out, "out")))
        lib, fn = cuda_build.function(
            "packed_flash_sm90", "p3_packed_flash_sm90",
            [p] * 5 + [i32] * 3 + [ctypes.c_float, p])
        err = fn(P_(q), P_(k), P_(v), P_(out), strides, B, P, N,
                 float(scale), cuda_build.stream_of(q))
    else:       # the f32 flash engine over the heads as strided views
        out = _f32_out(q, k, v)
        views = head_views(q, k, v, out)
        Bv, Hv = views[0].shape[:2]
        if any(s % 4 for s in views[0].stride()[:3]) or q.data_ptr() % 16:
            raise ValueError(
                f"packed_mha: q's strides {q.stride()} and base must be "
                "multiples of 16 bytes (the tensor map's rule)")
        strides = (ctypes.c_longlong * 16)(
            *[s for t in views for s in t.stride()[:3]], 0, 0, 0, 0)
        scratch = fa.fwd_scratch(Bv, Hv, N, HEAD_DIM, q.device)
        lib, fn = cuda_build.function(
            "flash_fwd_sm90", "p3_flash_fwd_sm90",
            [p] * 12 + [i32] * 5 + [ctypes.c_float] + [p] * 9)
        qv, kv, vv, ov = map(P_, views)
        err = fn(qv, kv, vv, None, None, None, None, None, None, ov, None,
                 strides, Bv, Hv, N, N, HEAD_DIM, float(scale), None,
                 *map(P_, scratch), cuda_build.stream_of(q))
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
