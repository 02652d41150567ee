"""K4: generic flash attention forward (counterpart of
panst3r_tpu/ops/pallas/flash_attention.py).

``flash_mha`` (``csrc/flash_fwd.cu``) replaces ``_flash_fwd``: attention
over (B, H, N, D) streams with an optional dense additive bias, key
validity, a per-key bias row, 2D-RoPE tables and the natural-log LSE per
row.  It serves every shape the tower and masked kernels (K1-K3) do not
take: the v2 LoftUp cross-attention (4 heads of 96), the generic
self-attention of non-tower widths, and the dense-bias mask transformer.

Semantics, as in the Pallas kernel: a bias of shape (B|1, 1, 1, Nk) travels
as a (B, Nk) row, and key validity folds into that row (0 / finfo.min);
masked logits are finfo(f32).min, never -inf; q and k are rotated by the
tables in f32 and rounded to their dtype; the scale multiplies the f32
score; the row sum takes the unrounded f32 p and the value product p
rounded to v's dtype; a row with no live key writes 0 and has the LSE
finfo.min.

On a CPU tensor ``flash_mha`` runs ``flash_mha_ref``; on a CUDA tensor it
launches the kernel or raises.  ``launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from panst3r_torch.ops import cuda_build
from panst3r_torch.ops.attention import NEG_INF
from panst3r_torch.ops.rope import apply_rope_tables_f32

HEAD_DIMS = (64, 96)   # the kernel's instantiations


def _split_bias(bias, kv_valid, B, Nk):
    """(dense bias or None, (B, Nk) f32 per-key row or None)."""
    row = None
    if bias is not None and bias.ndim == 4 and bias.shape[1] == 1 \
            and bias.shape[2] == 1:
        row = bias[:, 0, 0, :].float().expand(B, Nk)
        bias = None
    if kv_valid is not None:
        vb = torch.where(kv_valid, 0.0, NEG_INF).to(torch.float32)
        row = vb if row is None else row + vb
    return bias, row


def flash_mha_ref(q, k, v, bias=None, kv_valid=None, rope=None, scale=None,
                  with_lse=False):
    """Plain version of K4 (same signature as ``flash_mha``)."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    if rope is not None:
        qcos, qsin, kcos, ksin = rope
        q = apply_rope_tables_f32(q, qcos, qsin)
        k = apply_rope_tables_f32(k, kcos, ksin)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    bias, row = _split_bias(bias, kv_valid, B, Nk)
    if bias is not None:
        s = s + bias.to(acc)
    if row is not None:
        s = s + row.to(acc)[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - safe))
    den = p.sum(-1, keepdim=True)
    num = torch.matmul(p.to(v.dtype).to(acc), v.to(acc))
    out = (num / torch.where(den == 0, torch.ones_like(den), den)).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF),
                      m + torch.log(den))[..., 0].to(torch.float32)
    return out, lse


def _strides(t):
    if t.stride(-1) != 1:
        raise ValueError("flash_mha needs a unit stride over the head dim")
    return list(t.stride()[:3])


def flash_mha(q, k, v, bias=None, kv_valid=None, rope=None, scale=None,
              with_lse=False):
    """K4.  q (B, H, Nq, D), k/v (B, H, Nk, D), any strides with a unit
    stride over D; bias: additive, broadcastable to (B, H, Nq, Nk) (a
    (B|1, 1, 1, Nk) bias is taken as a per-key row); kv_valid: (B, Nk)
    bool, True = may attend; rope: f32 (qcos, qsin, kcos, ksin) tables
    (B, Nq, D) / (B, Nk, D).  Returns out (B, H, Nq, D) and, with
    ``with_lse``, the natural-log LSE (B, H, Nq) f32."""
    if q.device.type == "cpu":
        return flash_mha_ref(q, k, v, bias, kv_valid, rope, scale, with_lse)
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_mha: K4 is built for head dims {HEAD_DIMS}, not {D}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_mha takes f32/bf16, not {q.dtype}")
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    for name, t, shape in (("q", q, (B, H, Nq, D)), ("k", k, (B, H, Nk, D)),
                           ("v", v, (B, H, Nk, D))):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(f"flash_mha: {name} is {t.dtype} {tuple(t.shape)}"
                             f" on {t.device}, expected {q.dtype} {shape}")
    bias, row = _split_bias(bias, kv_valid, B, Nk)
    if row is not None:
        row = row.contiguous()
        cuda_build.check_tensor(row, "key bias", (B, Nk), torch.float32, dev)
    bstr = [0, 0, 0, 0]
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32)
        if bias.ndim < 4:
            bias = bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape))
        bias = bias.expand(B, H, Nq, Nk)
        bstr = list(bias.stride())
    tabs = [None] * 4
    if rope is not None:
        tabs = list(rope)
        for name, t, n in zip(("qcos", "qsin", "kcos", "ksin"), tabs,
                              (Nq, Nq, Nk, Nk)):
            cuda_build.check_tensor(t, name, (B, n, D), torch.float32, dev)
    # (B, Nq, H, D) storage: merging the heads afterwards is a free reshape
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = (torch.empty((B, H, Nq), dtype=torch.float32, device=dev)
           if with_lse else None)
    strides = (ctypes.c_longlong * 16)(
        *(_strides(q) + _strides(k) + _strides(v) + _strides(out) + bstr))
    p = ctypes.c_void_p
    lib, fn = cuda_build.function("flash_fwd", "p3_flash_fwd",
                                  [p] * 12 + [ctypes.c_int] * 5
                                  + [ctypes.c_float, ctypes.c_int, p])
    P = cuda_build.ptr
    err = fn(P(q), P(k), P(v), P(bias), P(row), *map(P, tabs), P(out),
             P(lse), strides, B, H, Nq, Nk, D, float(scale),
             int(q.dtype == torch.bfloat16), cuda_build.stream_of(q))
    cuda_build.check(lib, err, "flash_mha")
    flash_mha.launches += 1
    return (out, lse) if with_lse else out


flash_mha.launches = 0
