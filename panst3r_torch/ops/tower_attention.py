"""K1 and K2: transpose-free tower attention (counterpart of
panst3r_tpu/ops/pallas/tower_attention.py).

- ``tower_self_attention`` (K1) replaces ``_tower_fwd``: self-attention
  straight from the fused qkv projection (B, N, 3C) with optional 2D-RoPE
  tables and an optional cls key/value.  bf16 runs ``csrc/tower_self_sm90.cu``
  (the Hopper engine ``csrc/attn_sm90.cuh``: TMA ring, wgmma, softmax in
  registers), f32 the f32 K4's engine (``csrc/flash_fwd_sm90.cu``'s
  ``p3_tower_self_f32_sm90``: 3xTF32, K/V hi/lo pre-pass) over strided
  views of qkv (``self_views``), the cls key/value one more key row;
  ``tower_self_split_ref`` emulates its arithmetic (the tests only).
- ``tower_cross_attention`` (K2) replaces ``_cross_fwd`` (bf16/f32 path):
  cross-attention over projected (B, Nq, C) x (B, Nk, C) streams with
  per-side RoPE tables, a per-key additive bias and dead-tile skipping.
  Both dtypes run ``csrc/tower_cross_sm90.cu`` (q and k rotated once per
  call, a list of live key tiles, split-KV with a fixed merge order:
  ``split_plan``): bf16 on the wgmma engine, f32 on the 3xTF32 engine
  ``csrc/attn_f32_sm90.cuh``.
- ``tower_cross_int8`` (K2-int8) replaces the ``kv_int8`` branch of
  ``_cross_fwd``: int8 x int8 -> int32 scores, k quantized per tensor
  after its rotation (``int8_prepare``), q per row over each head pair by
  the kernel's pre-pass (``int8_qprep_ref`` is its plain version).  bf16
  and f32 run ``csrc/tower_cross_int8_sm90.cu`` (q pre-pass, the key
  pre-pass and live-tile list of K2): bf16 on the wgmma engine (wgmma s8
  scores over 128-key tiles), f32 on the 3xTF32 engine (mma.sync s8
  scores over 64-key tiles, ``INT8_F32_TILE``; P.V in 3xTF32).
  ``tower_cross_attention`` routes to
  it on a CUDA tensor exactly where the JAX gate opens (``int8_gate``:
  ``PANST3R_KV_INT8=1`` or ``kv_int8=True``, RoPE tables, Nq >= 16384).
  On a CPU tensor ``tower_cross_attention`` ignores int8, as the JAX
  package's CPU path (the jnp formula) does.

On a CPU tensor each wrapper runs its plain PyTorch version
(``*_ref``), which follows the kernel's semantics: RoPE in f32 rounded to
the input dtype once, p rounded to the v dtype before both the numerator
and the row sum, rows without a live key → 0.  On a CUDA tensor it
launches the kernel or raises; ``launches`` counts the launches.  Both are
differentiable as the JAX ``custom_vjp``s are (tower_attention.py:229-238,
:612-621): the backward recomputes the plain version and differentiates
it; the tables and the key bias get no gradient.

What bounds the kernels on the H100 and what their design does about it
is noted at the top of each ``.cu`` source.
"""
from __future__ import annotations

import math
import os

import torch

from panst3r_torch.ops import cuda_build, flops
from panst3r_torch.ops import flash_attention as fa
from panst3r_torch.ops.attention import NEG_INF, recompute_vjp
from panst3r_torch.ops.rope import _rotate_half_2d, apply_rope_tables_f32

_DTYPES = (torch.float32, torch.bfloat16)
_LOG2E = math.log2(math.e)
# The Hopper engine's key tile (BKT in csrc/attn_sm90.cuh) and K2's fixed
# split: a batch's live key tiles are cut into runs of SPLIT_TILES, which
# the wrapper passes to csrc/tower_cross_sm90.cu.  N_SMS: the H100's SMs,
# for the choice of 64- or 128-row CTAs only (it changes no row's
# arithmetic).
BLOCK_K = 128
SPLIT_TILES = 16
# K2-int8's key tiles: the bf16 kernel's (BLOCK_K, the plain version's
# default) and the f32 kernel's (its ring entries); the bf16 kernel's consumer
# warpgroups per CTA (csrc/tower_cross_int8_sm90.cu's NWG: its launcher
# refuses any other value)
INT8_F32_TILE = 64
INT8_WARPGROUPS = 2
N_SMS = 132
# int8 scores engage only at render-scale query counts
# (panst3r_tpu/ops/pallas/tower_attention.py:45, :472); tests monkeypatch
# this to run the path at small shapes.
_INT8_MIN_NQ = 16384


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
    m = m.detach()          # a shift: no gradient flows through it
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


def self_views(qkv, heads: int):
    """q, k and v of the fused projection ``qkv`` (B, N, 3C) as strided
    (B, H, N, 64) views (batch stride N·3C, head stride 64, token stride
    3C, at element offsets 0, C and 2C): what the f32 K1 reads, without a
    relayout."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    return [qkv.as_strided((B, heads, N, C // heads),
                           (N * C3, C // heads, C3, 1),
                           qkv.storage_offset() + i * C) for i in range(3)]


def tower_self_split_ref(qkv, heads: int, tabs=None, cls_kv=None,
                         scale=None, matmul=torch.matmul):
    """Plain version of the f32 K1's arithmetic (``p3_tower_self_f32_sm90``
    in ``csrc/flash_fwd_sm90.cu``, f32 only): the f32 K4's
    (``flash_attention.flash_mha_split_ref``) over ``self_views``'s views,
    q and k rotated by the same tables, the cls key/value (B, 1, C) one
    more key after the N tokens, unrotated (its table row the identity).
    ``matmul`` takes the products (``ops/tf32x3.py::matmul_tf32x3``
    emulates the kernel's).  Returns (B, N, C)."""
    if scale is None:
        scale = 64 ** -0.5
    q, k, v = self_views(qkv, heads)
    rope = None
    if tabs is not None:
        rope = (tabs[0], tabs[1], tabs[0], tabs[1])
    if cls_kv is not None:
        kc, vc = (_split_heads(t, 64) for t in cls_kv)
        k, v = torch.cat([k, kc], 2), torch.cat([v, vc], 2)
        if rope is not None:
            B = qkv.shape[0]
            one = torch.ones(B, 1, 64, device=qkv.device)
            rope = rope[:2] + (torch.cat([tabs[0], one], 1),
                               torch.cat([tabs[1], torch.zeros_like(one)],
                                         1))
    return _merge_heads(fa.flash_mha_split_ref(q, k, v, rope=rope,
                                               scale=scale, matmul=matmul))


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


def key_tiles(Nk: int) -> int:
    """Key tiles of BLOCK_K that cover Nk keys."""
    return -(-Nk // BLOCK_K)


def max_splits(Nk: int) -> int:
    """Splits of the fullest batch (every tile live): the grid's depth."""
    return max(1, -(-key_tiles(Nk) // SPLIT_TILES))


def split_plan(live_tiles: int, split_tiles: int = SPLIT_TILES):
    """K2's split of a batch's live key tiles: [start, stop) ranges into its
    list of live tiles, runs of ``split_tiles`` in order, at least one (an
    empty one when no tile is live).  It depends on the live-tile count
    alone, so no row's result depends on B, Nq or the grid."""
    if live_tiles == 0:
        return [(0, 0)]
    return [(a, min(a + split_tiles, live_tiles))
            for a in range(0, live_tiles, split_tiles)]


def cta_warpgroups(B: int, heads: int, Nq: int, splits: int = 1) -> int:
    """Consumer warpgroups per CTA (rows = 64 x this): 1 where 128-row CTAs
    would not fill the SMs, else 2."""
    return 1 if B * heads * -(-Nq // 128) * splits < N_SMS else 2


def cross_prepass_ref(q, k, qtab=None, ktab=None, kv_bias=None, scale=None):
    """Plain version of K2's pre-pass (``cross_rotate``, ``cross_tiles``):
    q~ = scale·rope(q) and k~ = rope(k) (k itself without tables), rotated
    in f32 and rounded to the input dtype once; the key bias in log2 units
    padded to whole tiles, NEG where dead (bias <= finfo.min/2, -inf
    included) or past Nk; per batch the live tiles in order.  Returns
    (q~, k~, bias_log2 (B, tiles·BLOCK_K) f32, [live tile indices] per
    batch)."""
    if scale is None:
        scale = 64 ** -0.5
    B, Nk, C = k.shape
    qh, kh = _split_heads(q, 64), _split_heads(k, 64)
    if qtab is not None:
        qf = apply_rope_tables_f32(qh.float(), *qtab)
        kh = apply_rope_tables_f32(kh, *ktab)
    else:
        qf = qh.float()
    qs = _merge_heads((qf * scale).to(q.dtype))
    ks = _merge_heads(kh)
    nt = key_tiles(Nk)
    x = torch.full((B, nt * BLOCK_K), NEG_INF, device=k.device)
    x[:, :Nk] = 0.0 if kv_bias is None else kv_bias.float()
    live = x > NEG_INF / 2
    bl = torch.where(live, x * _LOG2E, torch.full_like(x, NEG_INF))
    tiles = [torch.nonzero(row).flatten().tolist()
             for row in live.view(B, nt, BLOCK_K).any(-1)]
    return qs, ks, bl, tiles


def tower_cross_split_ref(q, k, v, qtab=None, ktab=None, kv_bias=None,
                          scale=None, split_tiles: int = SPLIT_TILES,
                          matmul=torch.matmul):
    """Plain version of K2's split-then-merge arithmetic from
    ``cross_prepass_ref``: per batch and split, logits x = s·log2(e) + bias
    over the split's live tiles, m = max(NEG, max x) (0 where <= NEG/2), p =
    exp2(x − m) rounded to v's dtype in both O and l; one split is O / l,
    more merge in split order with weights exp2(m_s − max m) (0 for a split
    without a live key).  Rows without a live key are 0.  ``matmul`` takes
    the two products (``ops/tf32x3.py::matmul_tf32x3`` emulates the f32
    kernel's)."""
    qs, ks, bl, tiles = cross_prepass_ref(q, k, qtab, ktab, kv_bias, scale)
    B, Nq, C = q.shape
    Nk = k.shape[1]
    qh, kh = _split_heads(qs, 64).float(), _split_heads(ks, 64).float()
    vh = _split_heads(v, 64)
    out = torch.zeros(B, C // 64, Nq, 64, device=q.device)
    for b in range(B):
        parts = []
        for a, z in split_plan(len(tiles[b]), split_tiles):
            keys = [j for t in tiles[b][a:z]
                    for j in range(t * BLOCK_K, min((t + 1) * BLOCK_K, Nk))]
            idx = torch.tensor(keys, dtype=torch.long, device=q.device)
            x = matmul(qh[b], kh[b][:, idx].transpose(-1, -2)) \
                * _LOG2E + bl[b, idx]
            m = torch.full(x.shape[:-1] + (1,), NEG_INF, device=q.device)
            if keys:
                m = torch.maximum(m, x.amax(-1, keepdim=True))
            safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
            p = torch.where(x <= NEG_INF / 2, torch.zeros_like(x),
                            torch.exp2(x - safe)).to(v.dtype).float()
            parts.append((matmul(p, vh[b][:, idx].float()), m,
                          p.sum(-1, keepdim=True)))
        if len(parts) == 1:
            num, _, den = parts[0]
        else:
            mx = torch.stack([m for _, m, _ in parts]).amax(0)
            safe = torch.where(mx <= NEG_INF / 2, torch.zeros_like(mx), mx)
            num = den = 0.0
            for o, m, l in parts:
                w = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                                torch.exp2(m - safe))
                num, den = num + w * o, den + w * l
        out[b] = num / torch.where(den == 0, torch.ones_like(den), den)
    return _merge_heads(out.to(q.dtype))


_check = cuda_build.check_tensor


def _tables(tabs, B, N, device, name):
    if tabs is None:
        return None, None
    cos, sin = tabs
    _check(cos, name + " cos", (B, N, 64), torch.float32, device)
    _check(sin, name + " sin", (B, N, 64), torch.float32, device)
    return cos, sin


def _tower_self_kernel(qkv, heads: int, tabs, cls_kv, scale):
    """Launch K1: one launch as counted, whatever CUDA launches the call
    makes (the pre-passes and the main kernel)."""
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
    p, i32, P = ctypes.c_void_p, ctypes.c_int, cuda_build.ptr
    if qkv.dtype == torch.bfloat16:     # the Hopper engine
        qk = None if cos is None else torch.empty(
            (B, N, 2 * C), dtype=qkv.dtype, device=dev)
        lib, fn = cuda_build.function(
            "tower_self_sm90", "p3_tower_self_sm90",
            [p] * 7 + [i32] * 3 + [ctypes.c_float, i32, p])
        err = fn(P(qkv), P(cos), P(sin), P(kc), P(vc), P(out), P(qk), B, N,
                 C, float(scale), cta_warpgroups(B, heads, N),
                 cuda_build.stream_of(qkv))
    else:       # the f32 flash engine over strided views of qkv and out
        if qkv.data_ptr() % 16:         # q is read through a tensor map
            qkv = qkv.clone()
        views = self_views(qkv, heads) + [
            out.view(B, N, heads, 64).transpose(1, 2)]
        cls = [] if kc is None else [t.view(B, heads, 1, 64)
                                     for t in (kc, vc)]
        strides = (ctypes.c_longlong * 14)(
            *[s for t in views for s in t.stride()[:3]],
            *(cls[0].stride()[:2] if cls else (0, 0)))
        qr = (torch.empty((B, heads, N, 64), dtype=qkv.dtype, device=dev)
              if cos is not None else None)
        scratch = fa.fwd_scratch(B, heads, N + (kc is not None), 64, dev)
        lib, fn = cuda_build.function(
            "flash_fwd_sm90", "p3_tower_self_f32_sm90",
            [p] * 9 + [i32] * 3 + [ctypes.c_float] + [p] * 9)
        err = fn(*map(P, views[:3]), P(kc), P(vc), P(cos), P(sin), P(out),
                 strides, B, heads, N, float(scale), P(qr),
                 *map(P, scratch), cuda_build.stream_of(qkv))
    cuda_build.check(lib, err, "tower_self_attention")
    tower_self_attention.launches += 1
    tower_self_attention.launches_f32 += int(qkv.dtype == torch.float32)
    return out


def tower_self_attention(qkv, heads: int, tabs=None, cls_kv=None,
                         scale=None):
    """K1.  qkv (B, N, 3C); tabs: optional f32 (cos, sin) (B, N, 64);
    cls_kv: optional (kc, vc) (B, 1, C).  Returns (B, N, C).
    Differentiable in qkv and cls_kv through the plain version."""
    kc, vc = (None, None) if cls_kv is None else cls_kv

    def run(fn):
        return lambda qkv, kc, vc: fn(qkv, heads, tabs,
                                      None if kc is None else (kc, vc), scale)

    B, N, C3 = qkv.shape
    # the jnp formula's work: the cls column is one more key
    with flops.declare(flops.attention_flops(
            B, heads, N, N + (cls_kv is not None), C3 // 3 // heads)):
        fwd = tower_self_attention_ref if qkv.device.type == "cpu" \
            else _tower_self_kernel
        return recompute_vjp(run(fwd), run(tower_self_attention_ref), qkv,
                             kc, vc)


# launches: every call; launches_f32: those of them on the f32 kernel
tower_self_attention.launches = tower_self_attention.launches_f32 = 0


def _tower_cross_kernel(q, k, v, qtab, ktab, kv_bias, scale):
    """Launch K2: one launch as counted, whatever CUDA launches the call
    makes (the pre-passes, the main kernel and the split merge)."""
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
    p, i32, P = ctypes.c_void_p, ctypes.c_int, cuda_build.ptr
    nt, ms = key_tiles(Nk), max_splits(Nk)

    def scratch(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    # the Hopper engines, split-KV: q~ and k~ in the inputs' dtype, the
    # padded log2 bias, the live tiles, the splits' O, m and l
    qs = scratch(B, Nq, C, dtype=q.dtype)
    ks = None if qcos is None else scratch(B, Nk, C, dtype=q.dtype)
    bl = scratch(B, nt * BLOCK_K)
    tiles = scratch(B, nt, dtype=torch.int32)
    count = scratch(B, dtype=torch.int32)
    opart = ml = None
    if ms > 1:
        opart = scratch(ms, B, Nq, C)
        ml = scratch(ms, B, C // 64, Nq, 2)
    lib, fn = cuda_build.function(
        "tower_cross_sm90", "p3_tower_cross_sm90",
        [p] * 16 + [i32] * 4 + [ctypes.c_float] + [i32] * 3 + [p])
    err = fn(P(q), P(k), P(v), P(qcos), P(qsin), P(kcos), P(ksin),
             P(kv_bias), P(out), P(qs), P(ks), P(bl), P(tiles), P(count),
             P(opart), P(ml), B, Nq, Nk, C, float(scale),
             cta_warpgroups(B, C // 64, Nq, ms), SPLIT_TILES,
             int(q.dtype == torch.float32), cuda_build.stream_of(q))
    cuda_build.check(lib, err, "tower_cross_attention")
    tower_cross_attention.launches += 1
    tower_cross_attention.launches_f32 += int(q.dtype == torch.float32)
    return out


def _cross_flops(q, k) -> float:
    """Dense work over every key, live or not (64-wide heads)."""
    B, Nq, C = q.shape
    return flops.attention_flops(B, C // 64, Nq, k.shape[1], 64)


def int8_gate(Nq: int, qtab, kv_int8=None) -> bool:
    """True where the JAX package runs K2's int8 branch: ``kv_int8`` (read
    from ``PANST3R_KV_INT8`` at call time when None) with RoPE tables
    (tower_attention.py:642-646) and ``Nq >= _INT8_MIN_NQ`` (:472)."""
    if kv_int8 is None:
        kv_int8 = os.environ.get("PANST3R_KV_INT8", "0") == "1"
    return bool(kv_int8 and qtab is not None) and Nq >= _INT8_MIN_NQ


def _const(x: float, like) -> torch.Tensor:
    """An f32 0-d tensor on ``like``'s device: CUDA divides by a host scalar
    through its reciprocal, one ulp off the quotient JAX computes."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def int8_prepare(k, qtab, ktab, scale):
    """The int8 branch's work outside the kernel (tower_attention.py:483-497),
    in plain torch on the tensors' device: k rotated in f32 with its tables
    and quantized per tensor (one scale sk over batch, heads and keys; it
    stays on the device) and the q tables pre-multiplied by
    scale·log2(e)·sk.  Returns (k8 (B, Nk, C) int8, (qcos, qsin)
    (B, Nq, 64) f32)."""
    B, Nk, C = k.shape
    kf = k.float().reshape(B, Nk, C // 64, 64)
    kr = kf * ktab[0].float()[:, :, None] \
        + _rotate_half_2d(kf) * ktab[1].float()[:, :, None]
    sig_k = torch.clamp(kr.abs().amax(), min=1e-20) / _const(127.0, k)
    k8 = torch.round(kr / sig_k).to(torch.int8).reshape(B, Nk, C)
    mul = (scale * _LOG2E) * sig_k
    qtabs = tuple((t.float() * mul).contiguous() for t in qtab)
    return k8, qtabs


def int8_log2_bias(kv_bias):
    """The key bias (B, Nk) in log2 units, kv_bias·log2(e) in f32, or None:
    what the plain version takes (the kernels' key pre-pass computes it
    from the raw bias)."""
    return None if kv_bias is None \
        else (kv_bias.float() * _LOG2E).contiguous()


def int8_qprep_ref(q, qcos, qsin):
    """Plain version of K2-int8's q pre-pass (``int8_qprep``): q rotated in
    f32 with the pre-scaled tables, amax over each head pair's 128 lanes,
    q8 = rint(q_rot·127/amax), c = amax/127.  Returns (q8 (B, Nq, C)
    int8, c (B, Nq, C/128) f32)."""
    B, Nq, C = q.shape
    qf = q.float().reshape(B, Nq, C // 64, 64)
    qrot = qf * qcos[:, :, None] + _rotate_half_2d(qf) * qsin[:, :, None]
    pairs = qrot.reshape(B, Nq, C // 128, 128)
    amax = torch.clamp(pairs.abs().amax(-1, keepdim=True), min=1e-20)
    q8 = torch.round(pairs * (_const(127.0, q) / amax))
    c = amax * (1.0 / 127.0)
    return q8.to(torch.int8).reshape(B, Nq, C), c[..., 0]


def _int8_attend(q, k8, v, qcos, qsin, kb, tile: int = BLOCK_K):
    """The int8 branch's attention from ``int8_prepare``'s outputs and the
    log2 key bias ``kb`` (``int8_log2_bias``), in plain torch: q8 and c
    from ``int8_qprep_ref``; integer scores (exact in f32); the stabilizer
    m = rowmax(s)·c over the keys of live key tiles of ``tile`` keys (the
    kernel's tiles: BLOCK_K for bf16, INT8_F32_TILE for f32; the zero
    scores of the last tile's padding keys count, as in the kernel); p = exp2(s·c + kb − m) rounded to v's dtype before both sums;
    rows without a live key → 0."""
    B, Nq, C = q.shape
    Nk = k8.shape[1]
    H = C // 64
    q8, c = int8_qprep_ref(q, qcos, qsin)
    q8 = q8.float().reshape(B, Nq, H, 64).transpose(1, 2)
    c = c.repeat_interleave(2, dim=2).transpose(1, 2)[..., None]  # (B,H,Nq,1)
    kh = k8.float().reshape(B, Nk, H, 64).transpose(1, 2)
    s = torch.matmul(q8, kh.transpose(-1, -2))
    kbf = torch.zeros(B, Nk, device=q.device) if kb is None else kb
    n_tiles = -(-Nk // tile)
    padded = torch.full((B, n_tiles * tile), NEG_INF, device=q.device)
    padded[:, :Nk] = kbf
    live = (padded.view(B, n_tiles, tile) > NEG_INF / 2).any(-1)
    live_key = live.repeat_interleave(tile, dim=1)[:, :Nk]    # (B, Nk)
    smax = torch.where(live_key[:, None, None], s,
                       torch.full_like(s, -math.inf)).amax(-1, keepdim=True)
    if Nk % tile:
        tail = live[:, -1][:, None, None, None]
        smax = torch.where(tail, torch.clamp(smax, min=0.0), smax)
    m = smax * c
    safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    sf = s * c + kbf[:, None, None, :]
    p = torch.where(live_key[:, None, None], torch.exp2(sf - safe),
                    torch.zeros_like(sf)).to(v.dtype).float()
    vh = _split_heads(v, 64).float()
    num = torch.matmul(p, vh)
    den = p.sum(-1, keepdim=True)
    den = torch.where(den == 0, torch.ones_like(den), den)
    return _merge_heads((num / den).to(q.dtype))


def tower_cross_int8_ref(q, k, v, qtab, ktab, kv_bias=None, scale=None,
                         tile: int = BLOCK_K):
    """Plain version of K2-int8 (same arguments as ``tower_cross_int8``;
    ``tile``: the kernel's key tile, as ``_int8_attend`` takes it)."""
    if scale is None:
        scale = 64 ** -0.5
    k8, (qcos, qsin) = int8_prepare(k, qtab, ktab, scale)
    return _int8_attend(q, k8, v, qcos, qsin, int8_log2_bias(kv_bias), tile)


def _tower_cross_int8_kernel(q, k, v, qtab, ktab, kv_bias, scale):
    """Launch K2-int8 after ``int8_prepare``: one launch as counted,
    whatever CUDA launches the call makes (the q and key pre-passes and
    the main kernel)."""
    import ctypes

    B, Nq, C = q.shape
    Nk = k.shape[1]
    if C % 128:
        raise NotImplementedError(
            f"tower_cross_int8 takes head pairs of d=64 (C={C})")
    if qtab is None or ktab is None:
        raise ValueError("tower_cross_int8 needs both RoPE tables")
    if q.dtype not in _DTYPES:
        raise TypeError(f"tower_cross_int8 takes f32/bf16, not {q.dtype}")
    if scale is None:
        scale = 64 ** -0.5
    dev = q.device
    _check(q, "q", (B, Nq, C), q.dtype, dev)
    _check(k, "k", (B, Nk, C), q.dtype, dev)
    _check(v, "v", (B, Nk, C), q.dtype, dev)
    _tables(qtab, B, Nq, dev, "qtab")
    _tables(ktab, B, Nk, dev, "ktab")
    if kv_bias is not None:
        _check(kv_bias, "kv_bias", (B, Nk), torch.float32, dev)
    k8, (qcos, qsin) = int8_prepare(k, qtab, ktab, scale)
    out = torch.empty((B, Nq, C), dtype=q.dtype, device=dev)
    p, i32, P = ctypes.c_void_p, ctypes.c_int, cuda_build.ptr
    f32 = q.dtype == torch.float32
    q8 = torch.empty((B, Nq, C), dtype=torch.int8, device=dev)
    c = torch.empty((B, Nq, C // 128), dtype=torch.float32, device=dev)
    # the key pre-pass takes the raw key bias (log2 units are its work)
    head = (P(q), P(k8), P(v), P(qcos), P(qsin), P(kv_bias), P(out), P(q8),
            P(c), *map(P, fa.tile_scratch(
                B, Nk, INT8_F32_TILE if f32 else BLOCK_K, dev)), B, Nq, Nk, C)
    stream = cuda_build.stream_of(q)
    if f32:
        lib, fn = cuda_build.function(
            "tower_cross_int8_sm90", "p3_tower_cross_int8_f32_sm90",
            [p] * 12 + [i32] * 4 + [p])
        err = fn(*head, stream)
    else:
        lib, fn = cuda_build.function(
            "tower_cross_int8_sm90", "p3_tower_cross_int8_sm90",
            [p] * 12 + [i32] * 5 + [p])
        err = fn(*head, INT8_WARPGROUPS, stream)
    cuda_build.check(lib, err, "tower_cross_int8")
    tower_cross_int8.launches += 1
    tower_cross_int8.launches_f32 += int(f32)
    return out


def tower_cross_int8(q, k, v, qtab, ktab, kv_bias=None, scale=None):
    """K2-int8.  q (B, Nq, C), k/v (B, Nk, C) f32 or bf16, C % 128 == 0;
    qtab/ktab: f32 (cos, sin) tables (B, N, 64), both required; kv_bias:
    optional f32 (B, Nk), ≤ 0.  Returns (B, Nq, C).  Differentiable in q,
    k, v through the plain f32/bf16 formula, as the JAX custom_vjp is
    (tower_attention.py:612-618): the int8 path is for inference."""
    def run(fn):
        return lambda q, k, v: fn(q, k, v, qtab, ktab, kv_bias, scale)

    # declared as K2's dense work, as the JAX package counts the jnp formula
    with flops.declare(_cross_flops(q, k)):
        fwd = tower_cross_int8_ref if q.device.type == "cpu" \
            else _tower_cross_int8_kernel
        return recompute_vjp(run(fwd), run(tower_cross_attention_ref), q, k,
                             v)


# launches: every call; launches_f32: those of them on the f32 kernel
tower_cross_int8.launches = tower_cross_int8.launches_f32 = 0


def tower_cross_attention(q, k, v, qtab=None, ktab=None, kv_bias=None,
                          scale=None, kv_int8=None):
    """K2.  q (B, Nq, C), k/v (B, Nk, C); qtab/ktab: optional f32
    (cos, sin) tables (B, N, 64), both or neither; kv_bias: optional f32
    (B, Nk) additive bias.  Returns (B, Nq, C).  Differentiable in q, k, v
    through the plain version.  On a CUDA tensor where ``int8_gate`` opens
    it is K2-int8 (``tower_cross_int8``), which launches or raises."""
    if q.device.type != "cpu" and int8_gate(q.shape[1], qtab, kv_int8):
        return tower_cross_int8(q, k, v, qtab, ktab, kv_bias, scale)

    def run(fn):
        return lambda q, k, v: fn(q, k, v, qtab, ktab, kv_bias, scale)

    with flops.declare(_cross_flops(q, k)):
        fwd = tower_cross_attention_ref if q.device.type == "cpu" \
            else _tower_cross_kernel
        return recompute_vjp(run(fwd), run(tower_cross_attention_ref), q, k,
                             v)


tower_cross_attention.launches = tower_cross_attention.launches_f32 = 0
