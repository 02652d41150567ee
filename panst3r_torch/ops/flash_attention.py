"""K4 and K5: generic flash attention, forward and backward (counterpart of
panst3r_tpu/ops/pallas/flash_attention.py and flash_attention_bwd.py).

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

``flash_mha`` is differentiable in q, k and v (the bias, the validity and
the tables are not, as in the JAX ``custom_vjp``s, flash_attention.py:
429-570).  When a gradient is wanted its forward also keeps the LSE, and
its backward is ``flash_mha_bwd``: K5 (``csrc/flash_bwd.cu``), which
replaces ``flash_bwd`` — FlashAttention-2's two kernels, dq over query
tiles and dk, dv over key tiles, recomputing p = exp(s - lse) tile by
tile.  The JAX package makes its kernel backward opt-in
(``PANST3R_FLASH_BWD=1``, flash_attention.py:404-413) because XLA's fused
recompute measured faster on a TPU; on the card the alternative is plain
torch over the materialized logits, 6 GB per LoftUp call at 10 views in
f32.  So on the card the K4 backward is always K5: no switch selects it.

On a CPU tensor ``flash_mha`` and ``flash_mha_bwd`` run their plain
versions (``flash_mha_ref``, ``flash_mha_bwd_ref``); on a CUDA tensor they
launch the kernels or raise.  ``launches`` counts the launches (K5: one
per kernel, two per backward).
"""
from __future__ import annotations

import ctypes

import torch

from panst3r_torch.ops import cuda_build, flops
from panst3r_torch.ops.attention import NEG_INF
from panst3r_torch.ops.rope import _rotate_half_2d, apply_rope_tables_f32

HEAD_DIMS = (64, 96)   # the kernels' instantiations


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


def _logits(q, k, bias, kv_valid, rope, scale):
    """(rotated q, rotated k, f32 logits) as the kernels form them."""
    B, Nk = q.shape[0], k.shape[2]
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
    return q, k, s


def flash_mha_ref(q, k, v, bias=None, kv_valid=None, rope=None, scale=None,
                  with_lse=False):
    """Plain version of K4 (same signature as ``flash_mha``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    _, _, s = _logits(q, k, bias, kv_valid, rope, scale)
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


def _check_qkv(what, q, k, v):
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"{what}: K4/K5 are built for head dims {HEAD_DIMS}, not {D}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes f32/bf16, not {q.dtype}")
    for name, t, shape in (("q", q, (B, H, Nq, D)), ("k", k, (B, H, Nk, D)),
                           ("v", v, (B, H, Nk, D))):
        if t.device != q.device or t.dtype != q.dtype \
                or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} is {t.dtype} {tuple(t.shape)}"
                             f" on {t.device}, expected {q.dtype} {shape}")


def _kernel_extras(what, q, k, bias, kv_valid, rope):
    """(dense bias, key row, [qcos, qsin, kcos, ksin], bias strides) in the
    form both kernels take."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    dev = q.device
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
            cuda_build.check_tensor(t, f"{what} {name}", (B, n, D),
                                    torch.float32, dev)
    return bias, row, tabs, bstr


def _flash_fwd_kernel(q, k, v, bias, kv_valid, rope, scale, with_lse):
    """Launch K4; returns (out, lse or None)."""
    _check_qkv("flash_mha", q, k, v)
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    dev = q.device
    bias, row, tabs, bstr = _kernel_extras("flash_mha", q, k, bias, kv_valid,
                                           rope)
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
    return out, lse


class _FlashMHA(torch.autograd.Function):
    """K4 forward (kernel or plain version); K5 backward (kernel or plain
    version) from the saved output and LSE."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_valid, qcos, qsin, kcos, ksin, scale,
                with_lse, need_grad):
        rope = None if qcos is None else (qcos, qsin, kcos, ksin)
        keep_lse = with_lse or need_grad
        if q.device.type == "cpu":
            res = flash_mha_ref(q, k, v, bias, kv_valid, rope, scale,
                                with_lse=keep_lse)
            out, lse = res if keep_lse else (res, None)
        else:
            out, lse = _flash_fwd_kernel(q, k, v, bias, kv_valid, rope,
                                         scale, keep_lse)
        if need_grad:
            ctx.save_for_backward(q, k, v, out)
            ctx.extras = (bias, kv_valid, rope, lse, scale)
        if with_lse:
            ctx.mark_non_differentiable(lse)
            return out, lse
        return out

    @staticmethod
    def backward(ctx, g, *_):
        q, k, v, out = ctx.saved_tensors
        bias, kv_valid, rope, lse, scale = ctx.extras
        dq, dk, dv = flash_mha_bwd(q, k, v, out, lse, g, bias=bias,
                                   kv_valid=kv_valid, rope=rope, scale=scale)
        return (dq, dk, dv) + (None,) * 9


def flash_mha(q, k, v, bias=None, kv_valid=None, rope=None, scale=None,
              with_lse=False):
    """K4.  q (B, H, Nq, D), k/v (B, H, Nk, D), any strides with a unit
    stride over D; bias: additive, broadcastable to (B, H, Nq, Nk) (a
    (B|1, 1, 1, Nk) bias is taken as a per-key row); kv_valid: (B, Nk)
    bool, True = may attend; rope: f32 (qcos, qsin, kcos, ksin) tables
    (B, Nq, D) / (B, Nk, D).  Returns out (B, H, Nq, D) and, with
    ``with_lse``, the natural-log LSE (B, H, Nq) f32.  Differentiable in
    q, k, v (backward: K5)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    need_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    tabs = (None,) * 4 if rope is None else tuple(rope)
    B, H, Nq, D = q.shape
    with flops.declare(flops.attention_flops(B, H, Nq, k.shape[2], D)):
        return _FlashMHA.apply(q, k, v, bias, kv_valid, *tabs, float(scale),
                               with_lse, need_grad)


flash_mha.launches = 0


def _rope_adjoint(g, cos, sin):
    """Adjoint of x -> x*cos + R(x)*sin on g (B, H, N, D): g*cos - R(g*sin)
    (R^T = -R), in g's dtype."""
    return g * cos[:, None] - _rotate_half_2d(g * sin[:, None])


def flash_mha_bwd_ref(q, k, v, o, lse, do, bias=None, kv_valid=None,
                      rope=None, scale=None):
    """Plain version of K5 (same signature as ``flash_mha_bwd``): the
    kernels' formulas over the whole (Nq, Nk) logits."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qr, kr, s = _logits(q, k, bias, kv_valid, rope, scale)
    lse = lse.to(acc)[..., None]
    p = torch.where((s <= NEG_INF / 2) | (lse <= NEG_INF / 2)
                    | (lse >= -NEG_INF / 2), torch.zeros_like(s),
                    torch.exp(s - lse))
    g = do.to(q.dtype)
    dp = torch.matmul(g.to(acc), v.to(acc).transpose(-1, -2))
    dvec = (do.to(acc) * o.to(acc)).sum(-1, keepdim=True)
    ds = p * (dp - dvec) * scale
    dq = torch.matmul(ds.to(k.dtype).to(acc), kr.to(acc))
    dk = torch.matmul(ds.to(q.dtype).to(acc).transpose(-1, -2), qr.to(acc))
    dv = torch.matmul(p.to(g.dtype).to(acc).transpose(-1, -2), g.to(acc))
    if rope is not None:
        qcos, qsin, kcos, ksin = rope
        dq = _rope_adjoint(dq, qcos.to(acc), qsin.to(acc))
        dk = _rope_adjoint(dk, kcos.to(acc), ksin.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_mha_bwd(q, k, v, o, lse, do, bias=None, kv_valid=None, rope=None,
                  scale=None):
    """K5.  Gradients (dq, dk, dv) of ``flash_mha(q, k, v, bias, kv_valid,
    rope, scale)`` with respect to the unrotated q, k, v, in their dtypes,
    from its output ``o``, its LSE ``lse`` (B, H, Nq) f32 and the output
    gradient ``do``.  The bias, validity and tables as ``flash_mha`` takes
    them; none of them gets a gradient.  Declares the four products of the
    dense backward (8·B·H·Nq·Nk·D), not the kernels' recompute of p."""
    B, H, Nq, D = q.shape
    with flops.declare(2 * flops.attention_flops(B, H, Nq, k.shape[2], D)):
        if q.device.type == "cpu":
            return flash_mha_bwd_ref(q, k, v, o, lse, do, bias, kv_valid,
                                     rope, scale)
        return _flash_bwd_kernel(q, k, v, o, lse, do, bias, kv_valid, rope,
                                 scale)


def _flash_bwd_kernel(q, k, v, o, lse, do, bias, kv_valid, rope, scale):
    """Launch K5's two kernels."""
    _check_qkv("flash_mha_bwd", q, k, v)
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    dev = q.device
    if scale is None:
        scale = D ** -0.5
    for name, t in (("o", o), ("do", do)):
        if t.device != dev or tuple(t.shape) != (B, H, Nq, D):
            raise ValueError(f"flash_mha_bwd: {name} is {tuple(t.shape)} on "
                             f"{t.device}, expected {(B, H, Nq, D)}")
    cuda_build.check_tensor(lse, "lse", (B, H, Nq), torch.float32, dev)
    bias, row, tabs, bstr = _kernel_extras("flash_mha_bwd", q, k, bias,
                                           kv_valid, rope)
    dvec = (do.float() * o.float()).sum(-1).contiguous()
    g = do.to(q.dtype)
    if g.stride(-1) != 1:
        g = g.contiguous()
    dq = torch.empty((B, H, Nq, D), dtype=torch.float32, device=dev)
    dk = torch.empty((B, H, Nk, D), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    strides = (ctypes.c_longlong * 16)(
        *(_strides(q) + _strides(k) + _strides(v) + _strides(g) + bstr))
    P = cuda_build.ptr
    ins = (P(q), P(k), P(v), P(g), P(lse), P(dvec), P(bias), P(row),
           *map(P, tabs))
    tail = (strides, B, H, Nq, Nk, D, float(scale),
            int(q.dtype == torch.bfloat16), cuda_build.stream_of(q))
    p = ctypes.c_void_p
    sig = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, p]
    lib, fn = cuda_build.function("flash_bwd", "p3_flash_bwd_dq",
                                  [p] * 14 + sig)
    cuda_build.check(lib, fn(*ins, P(dq), *tail), "flash_mha_bwd (dq)")
    flash_mha_bwd.launches += 1
    lib, fn = cuda_build.function("flash_bwd", "p3_flash_bwd_dkdv",
                                  [p] * 15 + sig)
    cuda_build.check(lib, fn(*ins, P(dk), P(dv), *tail),
                     "flash_mha_bwd (dkdv)")
    flash_mha_bwd.launches += 1
    if rope is not None:
        qcos, qsin, kcos, ksin = rope
        dq = _rope_adjoint(dq, qcos, qsin)
        dk = _rope_adjoint(dk, kcos, ksin)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_mha_bwd.launches = 0
