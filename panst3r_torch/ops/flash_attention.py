"""K4 and K5: generic flash attention, forward and backward (counterpart of
panst3r_tpu/ops/pallas/flash_attention.py and flash_attention_bwd.py).

``flash_mha`` (K4) replaces ``_flash_fwd``: attention
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
its backward is ``flash_mha_bwd``: K5, which replaces ``flash_bwd`` —
FlashAttention-2's two kernels, dq over query tiles and dk, dv over key
tiles, recomputing p = exp(s - lse) tile by tile.  The JAX package makes
its kernel backward opt-in (``PANST3R_FLASH_BWD=1``,
flash_attention.py:404-413) because XLA's fused
recompute measured faster on a TPU; on the card the alternative is plain
torch over the materialized logits, 6 GB per LoftUp call at 10 views in
f32.  So on the card the K4 backward is always K5: no switch selects it.

On a CUDA tensor both route by dtype: f32, the dtype of every launch on
the main paths (LoftUp runs in f32 under amp), to the Hopper f32 engine
(``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_sm90.cu``: a pre-pass that
writes the streamed operands as TF32 hi/lo planes, 3xTF32 tensor-core
products, K5's dkdv over ``SPLIT_TILES`` query tiles per CTA merged in
order).  bf16 K4 and K5 run the bf16 Hopper engine
(``csrc/flash_fwd_bf16_sm90.cu``: q and k rotated once per call, a list of
live key tiles of ``BF16_KEY_TILE[D]`` keys, wgmma products, the softmax
in registers; ``bf16_prepass_ref`` is its pre-pass's plain version;
``csrc/flash_bwd_bf16_sm90.cu``: the same rotation, live key tiles of
``BF16_BWD_KEY_TILE`` keys, the LSE and Dvec pre-pass of the f32 K5,
wgmma products, dkdv over the same fixed query splits).
``flash_mha_split_ref`` and ``flash_mha_bwd_split_ref`` emulate the
kernels' arithmetic (the f32 K4 and K5; K5 in bf16 too; the tests
only).

On a CPU tensor ``flash_mha`` and ``flash_mha_bwd`` run their plain
versions (``flash_mha_ref``, ``flash_mha_bwd_ref``); on a CUDA tensor they
launch the kernels or raise.  ``launches`` counts the launches (K5: one
per kernel, two per backward).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from panst3r_torch.ops import cuda_build, flops
from panst3r_torch.ops.attention import NEG_INF
from panst3r_torch.ops.rope import _rotate_half_2d, apply_rope_tables_f32

HEAD_DIMS = (64, 96)   # the kernels' instantiations
# The f32 kernels' tiles: keys per ring entry (the unit of the live-tile
# list), queries per tile of K5's dkdv split, and the fixed number of
# query tiles a dkdv CTA walks (the split is part of the result: dk and dv
# add the splits' partial sums in order).
KEY_TILE = 32
QUERY_TILE = 64
SPLIT_TILES = 64
# The bf16 K4's key tile by head dim: d=64 in the K1/K2 layout, d=96 in
# K3's (csrc/flash_fwd_bf16_sm90.cu); the bf16 K5's, K3's layout at both
# (csrc/flash_bwd_bf16_sm90.cu).  The bf16 K5's dkdv walks the f32 K5's
# fixed splits of SPLIT_TILES query tiles of QUERY_TILE.
BF16_KEY_TILE = {64: 128, 96: 64}
BF16_BWD_KEY_TILE = 64
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


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


def _aligned(t):
    """``t``, or a contiguous copy where its (batch, head, token) strides
    are not in 16-byte units or its base is not 16-byte aligned."""
    step = 16 // t.element_size()
    if any(st % step for st in t.stride()[:3]) or t.data_ptr() % 16:
        return t.contiguous()
    return t


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
    f32 = q.dtype == torch.float32
    # the Hopper engines read q (bf16: q, k and v) through tensor maps or
    # 16-byte loads
    if f32:
        q = _aligned(q)
    else:
        q, k, v = map(_aligned, (q, k, v))
    strides = (ctypes.c_longlong * 16)(
        *(_strides(q) + _strides(k) + _strides(v) + _strides(out) + bstr))
    p, P = ctypes.c_void_p, cuda_build.ptr
    head = (P(q), P(k), P(v), P(bias), P(row), *map(P, tabs), P(out),
            P(lse), strides, B, H, Nq, Nk, D, float(scale))
    sig = [p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float]
    stream = cuda_build.stream_of(q)
    if f32:
        qr = (torch.empty((B, H, Nq, D), dtype=torch.float32, device=dev)
              if rope is not None else None)
        lib, fn = cuda_build.function("flash_fwd_sm90", "p3_flash_fwd_sm90",
                                      sig + [p] * 9)
        err = fn(*head, P(qr), *map(P, fwd_scratch(B, H, Nk, D, dev)),
                 stream)
    else:
        rot = [None, None] if rope is None else [
            torch.empty((B, H, n, D), dtype=q.dtype, device=dev)
            for n in (Nq, Nk)]
        nwg = bf16_warpgroups(B, H, Nq, D)
        lib, fn = cuda_build.function(
            "flash_fwd_bf16_sm90", "p3_flash_fwd_bf16_sm90",
            sig + [ctypes.c_int] + [p] * 6)
        err = fn(*head, nwg, *map(P, rot),
                 *map(P, tile_scratch(B, Nk, BF16_KEY_TILE[D], dev)),
                 stream)
    cuda_build.check(lib, err, "flash_mha")
    flash_mha.launches += 1
    flash_mha.launches_f32 += int(f32)
    return out, lse


def bf16_warpgroups(B: int, H: int, Nq: int, D: int) -> int:
    """The bf16 K4's consumer warpgroups per CTA: K2's choice
    (``tower_attention.cta_warpgroups``) at d=64, one (64-row CTAs, two per
    SM) at d=96; it changes no row's arithmetic."""
    from panst3r_torch.ops.tower_attention import cta_warpgroups

    return 1 if D == 96 else cta_warpgroups(B, H, Nq)


def tile_scratch(B: int, Nk: int, tile: int, device) -> list:
    """A key pre-pass's outputs: the key biases padded to whole tiles of
    ``tile`` keys (B, nt·tile) f32, each batch's live tiles (B, nt) and
    their count (B) int32."""
    nt = -(-Nk // tile)
    tiles = torch.empty(B * nt + B, dtype=torch.int32, device=device)
    return [torch.empty(B, nt * tile, dtype=torch.float32, device=device),
            tiles, tiles[B * nt:]]


def fwd_scratch(B: int, H: int, Nk: int, D: int, device) -> list:
    """The f32 K4 pre-pass's outputs, which its main kernel reads (and the
    f32 K1's and K6's): the K and V hi/lo planes (B, H, Nk, D) f32, then
    ``tile_scratch`` at ``KEY_TILE`` keys."""
    planes = [torch.empty(B, H, Nk, D, dtype=torch.float32, device=device)
              for _ in range(4)]
    return planes + tile_scratch(B, Nk, KEY_TILE, device)


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


# launches: every call; launches_f32: those of them on the f32 kernel
flash_mha.launches = flash_mha.launches_f32 = 0


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
    in_f32 = int(q.dtype == torch.float32)
    # the products take do rounded to q's dtype (g); Dvec = rowsum(do * o)
    # takes do and o unrounded, as the plain version does: the f32 kernels
    # read both in f32 (exact from any narrower float), the bf16 kernels
    # each in bf16 or f32 (``raw``: the unrounded do, and o)
    g = do.to(q.dtype)
    raw, o = ((g, o.to(q.dtype)) if in_f32 else
              (x if x.dtype in (torch.bfloat16, torch.float32) else x.float()
               for x in (do, o)))
    g, raw, o = (x if x.stride(-1) == 1 else x.contiguous()
                 for x in (g, raw, o))
    f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    dq, dk, dv = f32(B, H, Nq, D), f32(B, H, Nk, D), f32(B, H, Nk, D)
    p, i32, P = ctypes.c_void_p, ctypes.c_int, cuda_build.ptr
    ints = functools.partial(torch.empty, dtype=torch.int32, device=dev)
    Nqp = -(-Nq // QUERY_TILE) * QUERY_TILE
    # Dvec = rowsum(do * o) is summed by the kernels' pre-pass in an order
    # fixed per row (torch's reduction order follows the row count, so a
    # query range's Dvec could differ in its last bit); the LSE and Dvec
    # rows are padded to whole query tiles
    stats = [f32(B, H, Nqp), f32(B, H, Nqp)]
    if in_f32:                          # the Hopper f32 engine
        lib_name, sfx = "flash_bwd_sm90", "sm90"
        nt = -(-Nk // KEY_TILE)
        # q hi/lo, do hi/lo, k hi/lo, v hi/lo, key biases, LSE, Dvec
        work = [f32(B, H, Nq, D) for _ in range(4)] \
            + [f32(B, H, Nk, D) for _ in range(4)] \
            + [f32(B, nt * KEY_TILE)] + stats + [ints(B, nt), ints(B)]
    else:                               # the bf16 Hopper engine
        lib_name, sfx = "flash_bwd_bf16_sm90", "bf16_sm90"
        # the tensor maps read q, k, v and do through their strides
        q, k, v, g = map(_aligned, (q, k, v, g))
        # q~ and k~ (with tables), key biases, LSE, Dvec, live tiles
        bl, tiles, count = tile_scratch(B, Nk, BF16_BWD_KEY_TILE, dev)
        rot = [None, None] if rope is None else [
            torch.empty((B, H, n, D), dtype=q.dtype, device=dev)
            for n in (Nq, Nk)]
        work = rot + [bl] + stats + [tiles, count]
    strides = (ctypes.c_longlong * 22)(
        *(_strides(q) + _strides(k) + _strides(v) + _strides(g) + bstr
          + _strides(o) + _strides(raw)))
    ins = (P(q), P(k), P(v), P(g), P(lse), P(o), P(bias), P(row),
           *map(P, tabs), strides)   # strides: o's at [16:19], raw's [19:]
    ptrs = (p * len(work))(*(None if t is None else t.data_ptr()
                             for t in work))
    ns = dkv_splits(Nq)
    part = f32(2 * ns * B * H * Nk * D) if ns > 1 else None
    shape = (ptrs, B, H, Nq, Nk, D, float(scale))
    sig = [p] * 14 + [i32] * 5 + [ctypes.c_float]
    stream = cuda_build.stream_of(q)
    if in_f32:
        lib, fn = cuda_build.function(lib_name, f"p3_flash_bwd_dq_{sfx}",
                                      sig + [p, p])
        rc = fn(*ins, *shape, P(dq), stream)
    else:
        lib, fn = cuda_build.function(lib_name, f"p3_flash_bwd_dq_{sfx}",
                                      sig + [p, i32, p, p])
        raw_f32 = (int(raw.dtype == torch.float32)
                   + 2 * int(o.dtype == torch.float32))
        rc = fn(*ins, *shape, P(raw), raw_f32, P(dq), stream)
    cuda_build.check(lib, rc, "flash_mha_bwd (dq)")
    flash_mha_bwd.launches += 1
    flash_mha_bwd.launches_f32 += in_f32
    lib, fn = cuda_build.function(lib_name, f"p3_flash_bwd_dkdv_{sfx}",
                                  sig + [p, p, p, i32, p])
    cuda_build.check(lib, fn(*ins, *shape, P(dk), P(dv), P(part),
                             SPLIT_TILES, stream), "flash_mha_bwd (dkdv)")
    flash_mha_bwd.launches += 1
    flash_mha_bwd.launches_f32 += in_f32
    if rope is not None:
        qcos, qsin, kcos, ksin = rope
        dq = _rope_adjoint(dq, qcos, qsin)
        dk = _rope_adjoint(dk, kcos, ksin)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# launches: one per main kernel, two per backward; launches_f32: those of
# them on the f32 kernels
flash_mha_bwd.launches = flash_mha_bwd.launches_f32 = 0


def dkv_splits(Nq: int, split_tiles: int = None) -> int:
    """How many fixed query splits K5's dkdv kernel walks (f32 and bf16):
    ceil(query tiles / ``split_tiles``) (default ``SPLIT_TILES``)."""
    split_tiles = SPLIT_TILES if split_tiles is None else split_tiles
    return -(-(-(-Nq // QUERY_TILE)) // split_tiles)


def key_tiles_ref(row, B: int, Nk: int, device=None, tile: int = KEY_TILE):
    """Plain version of the kernels' key pre-pass: the per-key bias row
    (B, Nk) (None: every key live) in log2 units padded to whole tiles of
    ``tile`` keys (default the f32 kernels' ``KEY_TILE``), finfo.min where
    dead or past Nk, and each batch's live tiles in order."""
    nt = -(-Nk // tile)
    x = torch.full((B, nt * tile), NEG_INF, device=device)
    x[:, :Nk] = 0.0 if row is None else row.float()
    live = x > NEG_INF / 2
    bl = torch.where(live, x * _LOG2E, torch.full_like(x, NEG_INF))
    tiles = [torch.nonzero(r).flatten().tolist()
             for r in live.view(B, nt, tile).any(-1)]
    return bl, tiles


def bf16_prepass_ref(q, k, bias=None, kv_valid=None, rope=None):
    """Plain version of the bf16 K4's pre-pass (``rope_bf16``,
    ``cross_tiles`` in ``csrc/flash_fwd_bf16_sm90.cu``): q~ and k~ rotated
    by the tables in f32 and rounded to the input dtype once, unscaled (q
    and k themselves without tables), and ``key_tiles_ref`` of the key row
    (the (B|1, 1, 1, Nk) bias and the validity) at ``BF16_KEY_TILE[D]``.
    Returns (q~, k~, bias_log2 (B, nt·tile) f32, [live tiles] per
    batch)."""
    B, _, _, D = q.shape
    Nk = k.shape[2]
    if rope is not None:
        q = apply_rope_tables_f32(q, rope[0], rope[1])
        k = apply_rope_tables_f32(k, rope[2], rope[3])
    _, row = _split_bias(bias, kv_valid, B, Nk)
    return (q, k) + key_tiles_ref(row, B, Nk, q.device, BF16_KEY_TILE[D])


def _steps(n: int, step: int = 8):
    """[a, b) ranges of ``step`` rows over n (the products' 8-row steps)."""
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def _split_logits(q, k, bias, kv_valid, rope, scale, matmul,
                  tile: int = KEY_TILE):
    """(rotated q, rotated k, logits in log2 units (NEG where masked), the
    live keys of each batch) as the kernels form them: q and k rotated in
    f32 and rounded to their dtype once (then held in f32), s·scale·log2(e)
    plus the key row and the dense bias in log2 units; the live keys are
    those of the live tiles of ``tile`` keys."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if rope is not None:
        qcos, qsin, kcos, ksin = rope
        q = apply_rope_tables_f32(q, qcos, qsin)
        k = apply_rope_tables_f32(k, kcos, ksin)
    q, k = q.float(), k.float()
    dense, row = _split_bias(bias, kv_valid, B, Nk)
    bl, tiles = key_tiles_ref(row, B, Nk, q.device, tile)
    x = matmul(q, k.transpose(-1, -2)) * (scale * _LOG2E) \
        + bl[:, None, None, :Nk]
    if dense is not None:
        d = dense.float().expand(B, H, Nq, Nk)
        x = torch.where(d <= NEG_INF / 2, NEG_INF, x + d * _LOG2E)
    x = torch.where(x <= NEG_INF / 2, NEG_INF, x)
    keys = [[j for t in tl for j in range(t * tile, min((t + 1) * tile, Nk))]
            for tl in tiles]
    return q, k, x, keys


def _walk(p, b, idx, matmul):
    """sum over the 8-row steps of ``idx`` of p[..., step] @ b[step, :],
    each step's product added to the running sum in f32 (the kernels'
    round-to-nearest add of a fresh accumulator)."""
    acc = torch.zeros(p.shape[:-1] + (b.shape[-1],), device=p.device)
    for a, z in _steps(len(idx)):
        sel = idx[a:z]
        acc = acc + matmul(p[..., sel], b[..., sel, :])
    return acc


def flash_mha_split_ref(q, k, v, bias=None, kv_valid=None, rope=None,
                        scale=None, with_lse=False, matmul=torch.matmul):
    """Plain version of the f32 K4's arithmetic (``csrc/flash_fwd_sm90.cu``,
    f32 only): logits in log2 units from the pre-pass's key biases, p =
    exp2(x − m) with m the row max over the batch's live tiles (0 where
    <= NEG/2), O summed per 8-key step in f32, out = O / l, LSE = (m +
    log2 l)·ln 2 (finfo.min for a row with no live key).  ``matmul`` takes
    the products (``ops/tf32x3.py::matmul_tf32x3`` emulates the kernel's).
    The kernel's online softmax rescales O per 32-key entry; this takes
    the row's max at once, which moves only the rounding."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, H, Nq, D = q.shape
    _, _, x, keys = _split_logits(q, k, bias, kv_valid, rope, scale, matmul)
    out = torch.zeros(B, H, Nq, D, device=q.device)
    lse = torch.full((B, H, Nq), NEG_INF, device=q.device)
    for b in range(B):
        if not keys[b]:
            continue
        idx = torch.tensor(keys[b], dtype=torch.long, device=q.device)
        xb = x[b][..., idx]
        m = xb.amax(-1, keepdim=True)
        safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
        p = torch.where(xb <= NEG_INF / 2, torch.zeros_like(xb),
                        torch.exp2(xb - safe))
        den = p.sum(-1, keepdim=True)
        o = _walk(p, v[b].float()[:, idx],
                  torch.arange(len(keys[b]), device=q.device), matmul)
        out[b] = o / torch.where(den == 0, torch.ones_like(den), den)
        lse[b] = torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF),
                             (m + torch.log2(den)) * _LN2)[..., 0]
    out = out.to(q.dtype)
    return (out, lse) if with_lse else out


def flash_mha_bwd_split_ref(q, k, v, o, lse, do, bias=None, kv_valid=None,
                            rope=None, scale=None,
                            split_tiles: int = SPLIT_TILES,
                            matmul=torch.matmul):
    """Plain version of K5's arithmetic on the Hopper engines
    (``csrc/flash_bwd_sm90.cu`` in f32, ``csrc/flash_bwd_bf16_sm90.cu`` in
    bf16): q and k rotated in f32 and rounded to their dtype, p = exp2(x −
    LSE·log2 e) from K4's LSE (0 where x or the LSE is dead), ds = p·(dp −
    Dvec)·scale, ds and p rounded to the inputs' dtype before the products
    (a no-op in f32); dq summed over the batch's live keys (tiles of
    ``KEY_TILE`` keys in f32, ``BF16_BWD_KEY_TILE`` in bf16) per 8-key step
    in f32; dk and dv summed per 8-query step in f32 within each fixed
    split of ``split_tiles`` query tiles, the splits' sums added in split
    order; the rotation's adjoint on dq and dk; the gradients in the
    inputs' dtypes.  ``matmul`` takes the products."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, H, Nq, D = q.shape
    dt = q.dtype
    tile = KEY_TILE if dt == torch.float32 else BF16_BWD_KEY_TILE
    qr, kr, x, keys = _split_logits(q, k, bias, kv_valid, rope, scale,
                                    matmul, tile)
    g = do.to(dt).float()
    lse = lse.float()
    dead = (lse <= NEG_INF / 2) | (lse >= -NEG_INF / 2)
    l2 = torch.where(dead, -NEG_INF, lse * _LOG2E)[..., None]
    p = torch.where((x <= NEG_INF / 2) | (l2 >= -NEG_INF / 2),
                    torch.zeros_like(x), torch.exp2(x - l2))
    dp = matmul(g, v.float().transpose(-1, -2))
    dvec = (g * o.float()).sum(-1, keepdim=True)
    ds = (p * (dp - dvec) * scale).to(dt).float()
    p = p.to(dt).float()
    dq = torch.zeros(B, H, Nq, D, device=q.device)
    for b in range(B):
        idx = torch.tensor(keys[b], dtype=torch.long, device=q.device)
        dq[b] = _walk(ds[b], kr[b], idx, matmul)
    bounds = [(a * split_tiles * QUERY_TILE,
               min((a + 1) * split_tiles * QUERY_TILE, Nq))
              for a in range(dkv_splits(Nq, split_tiles))]
    dk = dv = None
    for a, z in bounds:
        rows = torch.arange(a, z, device=q.device)
        pk = _walk(ds.transpose(-1, -2), qr, rows, matmul)
        pv = _walk(p.transpose(-1, -2), g, rows, matmul)
        dk, dv = (pk, pv) if dk is None else (dk + pk, dv + pv)
    if rope is not None:
        qcos, qsin, kcos, ksin = rope
        dq = _rope_adjoint(dq, qcos, qsin)
        dk = _rope_adjoint(dk, kcos, ksin)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)
