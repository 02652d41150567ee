"""K1 and K2: transpose-free tower attention (counterpart of
panst3r_tpu/ops/pallas/tower_attention.py).

- ``tower_self_attention`` (K1, ``csrc/tower_self.cu``) replaces
  ``_tower_fwd``: self-attention straight from the fused qkv projection
  (B, N, 3C) with optional 2D-RoPE tables and an optional cls key/value.
- ``tower_cross_attention`` (K2, ``csrc/tower_cross.cu``) replaces
  ``_cross_fwd`` (bf16/f32 path): cross-attention over projected
  (B, Nq, C) x (B, Nk, C) streams with per-side RoPE tables, a per-key
  additive bias and dead-tile skipping.

On a CPU tensor each wrapper runs its plain PyTorch version
(``*_ref``), which follows the kernel's semantics: RoPE in f32 rounded to
the input dtype once, p rounded to the v dtype before both the numerator
and the row sum, rows without a live key → 0.  On a CUDA tensor it
launches the kernel or raises; ``launches`` counts the launches.

What bounds the kernels on the H100 and what their design does about it
is noted at the top of each ``.cu`` source.
"""
from __future__ import annotations

import os

import torch

from panst3r_torch.ops import cuda_build
from panst3r_torch.ops.attention import NEG_INF
from panst3r_torch.ops.rope import apply_rope_tables_f32

_DTYPES = (torch.float32, torch.bfloat16)


def supports_tower_attention(N: int, C: int, heads: int) -> bool:
    """JAX gate (tower_attention.py:649-652): N <= 1024, d=64 heads, an
    even head count.  Shapes outside it go to K4 in the JAX package."""
    return (N <= 1024 and C % 128 == 0 and heads * 64 == C
            and heads % 2 == 0)


def supports_tower_cross(Nq: int, Nk: int, C: int, heads: int) -> bool:
    """JAX gate (tower_attention.py:655-659)."""
    return (C % 128 == 0 and heads * 64 == C and heads % 2 == 0
            and Nq * Nk >= 256 * 256)


def _split_heads(t, D):
    B, N, C = t.shape
    return t.reshape(B, N, C // D, D).transpose(1, 2)


def _merge_heads(t):
    B, H, N, D = t.shape
    return t.transpose(1, 2).reshape(B, N, H * D)


def _softmax_rounded(s, v, extra=None):
    """out = sum_j p_j v_j / sum_j p_j with p rounded to v's dtype and
    logits <= finfo.min/2 contributing 0.  ``extra`` = (s_c, v_c): one
    column that enters in f32 without rounding (K1's cls)."""
    m = s.amax(-1, keepdim=True)
    if extra is not None:
        m = torch.maximum(m, extra[0])
    safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - safe)).to(v.dtype).float()
    num = torch.matmul(p, v.float())
    den = p.sum(-1, keepdim=True)
    if extra is not None:
        pc = torch.exp(extra[0] - safe)
        num = num + pc * extra[1].float()
        den = den + pc
    den = torch.where(den == 0, torch.ones_like(den), den)
    return num / den


def tower_self_attention_ref(qkv, heads: int, tabs=None, cls_kv=None,
                             scale=None):
    """Plain version of K1 (same signature as ``tower_self_attention``)."""
    C = qkv.shape[-1] // 3
    D = C // heads
    if scale is None:
        scale = D ** -0.5
    q, k, v = (_split_heads(t, D) for t in qkv.split(C, dim=-1))
    if tabs is not None:
        q = apply_rope_tables_f32(q, *tabs)
        k = apply_rope_tables_f32(k, *tabs)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    extra = None
    if cls_kv is not None:
        kc, vc = (_split_heads(t, D) for t in cls_kv)     # (B, H, 1, D)
        sc = (q.float() * kc.float()).sum(-1, keepdim=True) * scale
        extra = (sc, vc)
    return _merge_heads(_softmax_rounded(s, v, extra).to(qkv.dtype))


def tower_cross_attention_ref(q, k, v, qtab=None, ktab=None, kv_bias=None,
                              scale=None):
    """Plain version of K2: RoPE in f32, q scaled after rotation and
    rounded once, per-key bias in f32."""
    if scale is None:
        scale = 64 ** -0.5
    qh, kh, vh = (_split_heads(t, 64) for t in (q, k, v))
    if qtab is not None:
        qf = apply_rope_tables_f32(qh.float(), *qtab)
        kh = apply_rope_tables_f32(kh, *ktab)
    else:
        qf = qh.float()
    qh = (qf * scale).to(q.dtype)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if kv_bias is not None:
        s = s + kv_bias.float()[:, None, None, :]
    return _merge_heads(_softmax_rounded(s, vh).to(q.dtype))


_check = cuda_build.check_tensor


def _tables(tabs, B, N, device, name):
    if tabs is None:
        return None, None
    cos, sin = tabs
    _check(cos, name + " cos", (B, N, 64), torch.float32, device)
    _check(sin, name + " sin", (B, N, 64), torch.float32, device)
    return cos, sin


def tower_self_attention(qkv, heads: int, tabs=None, cls_kv=None,
                         scale=None):
    """K1.  qkv (B, N, 3C); tabs: optional f32 (cos, sin) (B, N, 64);
    cls_kv: optional (kc, vc) (B, 1, C).  Returns (B, N, C)."""
    if qkv.device.type == "cpu":
        return tower_self_attention_ref(qkv, heads, tabs, cls_kv, scale)
    import ctypes

    B, N, C3 = qkv.shape
    C = C3 // 3
    if heads * 64 != C:
        raise NotImplementedError(
            f"tower_self_attention takes d=64 heads (C={C}, heads={heads})")
    if scale is None:
        scale = 64 ** -0.5
    dev = qkv.device
    _check(qkv, "qkv", (B, N, 3 * C), qkv.dtype, dev)
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"tower_self_attention takes f32/bf16, not {qkv.dtype}")
    cos, sin = _tables(tabs, B, N, dev, "tabs")
    kc = vc = None
    if cls_kv is not None:
        kc, vc = cls_kv
        _check(kc, "kc", (B, 1, C), qkv.dtype, dev)
        _check(vc, "vc", (B, 1, C), qkv.dtype, dev)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=dev)
    p = ctypes.c_void_p
    lib, fn = cuda_build.function("tower_self", "p3_tower_self",
                                  [p] * 6 + [ctypes.c_int] * 3
                                  + [ctypes.c_float, ctypes.c_int, p])
    P = cuda_build.ptr
    err = fn(P(qkv), P(cos), P(sin), P(kc), P(vc), P(out), B, N, C,
             float(scale), int(qkv.dtype == torch.bfloat16),
             cuda_build.stream_of(qkv))
    cuda_build.check(lib, err, "tower_self_attention")
    tower_self_attention.launches += 1
    return out


tower_self_attention.launches = 0


def tower_cross_attention(q, k, v, qtab=None, ktab=None, kv_bias=None,
                          scale=None, kv_int8=None):
    """K2.  q (B, Nq, C), k/v (B, Nk, C); qtab/ktab: optional f32
    (cos, sin) tables (B, N, 64), both or neither; kv_bias: optional f32
    (B, Nk) additive bias.  Returns (B, Nq, C)."""
    if kv_int8 is None:
        kv_int8 = os.environ.get("PANST3R_KV_INT8", "0") == "1"
    if kv_int8 and q.device.type != "cpu":
        raise NotImplementedError(
            "tower_cross_attention: the int8 score path is not ported")
    if q.device.type == "cpu":
        return tower_cross_attention_ref(q, k, v, qtab, ktab, kv_bias, scale)
    import ctypes

    B, Nq, C = q.shape
    Nk = k.shape[1]
    if C % 64:
        raise NotImplementedError(
            f"tower_cross_attention takes d=64 heads (C={C})")
    if (qtab is None) != (ktab is None):
        raise ValueError("tower_cross_attention: give both tables or neither")
    if scale is None:
        scale = 64 ** -0.5
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"tower_cross_attention takes f32/bf16, not {q.dtype}")
    _check(q, "q", (B, Nq, C), q.dtype, dev)
    _check(k, "k", (B, Nk, C), q.dtype, dev)
    _check(v, "v", (B, Nk, C), q.dtype, dev)
    qcos, qsin = _tables(qtab, B, Nq, dev, "qtab")
    kcos, ksin = _tables(ktab, B, Nk, dev, "ktab")
    if kv_bias is not None:
        _check(kv_bias, "kv_bias", (B, Nk), torch.float32, dev)
    out = torch.empty((B, Nq, C), dtype=q.dtype, device=dev)
    p = ctypes.c_void_p
    lib, fn = cuda_build.function("tower_cross", "p3_tower_cross",
                                  [p] * 9 + [ctypes.c_int] * 4
                                  + [ctypes.c_float, ctypes.c_int, p])
    P = cuda_build.ptr
    err = fn(P(q), P(k), P(v), P(qcos), P(qsin), P(kcos), P(ksin),
             P(kv_bias), P(out), B, Nq, Nk, C, float(scale),
             int(q.dtype == torch.bfloat16), cuda_build.stream_of(q))
    cuda_build.check(lib, err, "tower_cross_attention")
    tower_cross_attention.launches += 1
    return out


tower_cross_attention.launches = 0
