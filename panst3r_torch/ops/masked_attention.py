"""K3: block-sparse masked attention (counterpart of
panst3r_tpu/ops/pallas/masked_attention.py).

``masked_mha`` replaces ``_sparse_fwd``: the mask transformer's masked
cross-attention, where a (B, Nq, Nk) bool mask (True = blocked) is shared
across heads and most (query block, key block) tiles are fully blocked in
late layers.  Both dtypes run ``csrc/masked_attn_sm90.cu`` (a pre-pass
that lists each 64-query block's live 64-key blocks on the card, a main
kernel over fixed runs of ``SPLIT_TILES`` live blocks, a merge of the runs
in order: ``split_plan``): bf16 on the wgmma engine, f32 on the 3xTF32
engine ``csrc/attn_f32_sm90.cuh``.  ``plan_blocks`` builds the JAX
package's visit plan with torch ops (live key blocks first, ascending,
then the last live index repeated, plus the count), as the JAX package
builds it in jnp outside its kernel; ``live_blocks`` is the plain version
of the pre-pass (the first ``count`` entries of ``plan_blocks``' lists),
and ``masked_mha_split_ref`` that of the split-then-merge arithmetic.

The kernels are built for head dims 96 (the v1 mask transformer's) and
128 (``HEAD_DIMS``); any other D up to 128 is padded with zeros to the
next of them inside the kernel wrapper, as the Pallas kernel pads D to
its lane width (q, k and v gain zero lanes, out is sliced back; the
scale and the FLOP declaration stay at the true D).  A D above 128 is
padded to a multiple of 64 and runs the wide-head forward
(``csrc/flash_wide_sm90.cu``, ``flash_attention.wide_fwd``; f32 and bf16:
the same semantics, a pre-pass listing each row tile's live key tiles of
64, so that a key tile whose whole block is blocked is skipped).

On a CPU tensor ``masked_mha`` runs ``masked_mha_ref`` (same semantics: p
rounded to the v dtype before both sums, fully blocked rows → 0); on a
CUDA tensor it launches the kernel or raises.  ``launches`` counts the
calls at D <= 128, ``launches_f32`` those of them in f32;
``launches_wide`` and ``launches_wide_f32`` the calls on the wide-head
engine.
"""
from __future__ import annotations

import ctypes

import torch

from panst3r_torch.ops import cuda_build, flops
from panst3r_torch.ops.attention import (NEG_INF, dot_product_attention,
                                         recompute_vjp)
from panst3r_torch.ops.flash_attention import (is_wide, kernel_head_dim,
                                               pad_head_dim, wide_fwd)
from panst3r_torch.ops.tower_attention import _LOG2E, _softmax_rounded

BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (96, 128)   # the kernels' instantiations (96: the v1 mask
                        # transformer's)
# The kernel's fixed split (both dtypes): a (batch, query block)'s live key
# blocks are cut into runs of SPLIT_TILES, which the wrapper passes to
# csrc/masked_attn_sm90.cu.
SPLIT_TILES = 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_blocks(blocked: torch.Tensor, block_q: int, block_k: int,
                nqp: int, nkp: int):
    """From the (B, Nq, Nk) True=blocked mask build the sparse visit plan
    over the mask padded (blocked) to (nqp, nkp).

    Returns (kv_idx (B, nq, nk) int32 — live key-block indices first
             (ascending), then the last live index repeated,
             count (B, nq) int32 — number of live key blocks).  The JAX
    function also returns the padded int8 mask; the kernel here reads the
    unpadded bool mask and masks the ragged edge itself."""
    B, Nq, Nk = blocked.shape
    blk = torch.ones((B, nqp, nkp), dtype=torch.bool, device=blocked.device)
    blk[:, :Nq, :Nk] = blocked
    nq, nk = nqp // block_q, nkp // block_k
    dead = blk.view(B, nq, block_q, nk, block_k).all(dim=4).all(dim=2)
    count = (~dead).sum(-1, dtype=torch.int32)
    kv_idx = torch.argsort(dead.to(torch.uint8), dim=-1, stable=True)
    last = torch.gather(kv_idx, -1, (count.long() - 1).clamp(min=0)[..., None])
    steps = torch.arange(nk, device=blocked.device)
    kv_idx = torch.where(steps < count[..., None], kv_idx, last)
    return kv_idx.to(torch.int32), count


def live_blocks(blocked, block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """Plain version of the pre-pass (``masked_plan``): per batch and
    query block, the key blocks that hold a key some row may attend, in
    ascending order (rows past Nq and keys past Nk count as blocked)."""
    B, Nq, Nk = blocked.shape
    nq, nk = -(-Nq // block_q), -(-Nk // block_k)
    return [[[t for t in range(nk)
              if not bool(blocked[b, a * block_q:(a + 1) * block_q,
                                  t * block_k:(t + 1) * block_k].all())]
             for a in range(nq)] for b in range(B)]


def split_plan(live_tiles: int, split_tiles: int = SPLIT_TILES):
    """The kernel's split of a (batch, query block)'s live key blocks:
    [start, stop) ranges into its list, runs of ``split_tiles`` in order,
    at least one (an empty one when no block is live).  It depends on the
    live count alone, so no row's result depends on B, Nq or the grid."""
    if live_tiles == 0:
        return [(0, 0)]
    return [(a, min(a + split_tiles, live_tiles))
            for a in range(0, live_tiles, split_tiles)]


def max_splits(Nk: int) -> int:
    """Splits of the fullest query block (every key block live) at the
    current SPLIT_TILES: the grid's depth."""
    return max(1, -(-Nk // (BLOCK_K * SPLIT_TILES)))


def masked_mha_split_ref(q, k, v, blocked, scale=None,
                         split_tiles: int = SPLIT_TILES, matmul=torch.matmul):
    """Plain version of the kernel's split-then-merge arithmetic: per
    batch, query block and split (``split_plan`` over ``live_blocks``),
    logits x = s·scale·log2(e) (NEG where blocked), m = max(NEG, max x) (0
    where <= NEG/2), p = exp2(x − m) rounded to v's dtype in both O and l;
    one split is O / l, more merge in split order with weights exp2(m_s −
    max m) (0 for a split without a live key).  Rows without a live key
    are 0.  ``matmul`` takes the two products
    (``ops/tf32x3.py::matmul_tf32x3`` emulates the f32 kernel's)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    out = torch.zeros(B, H, Nq, D, device=q.device)
    for b, lists in enumerate(live_blocks(blocked)):
        for a, tiles in enumerate(lists):
            rows = slice(a * BLOCK_Q, min((a + 1) * BLOCK_Q, Nq))
            parts = []
            for s0, s1 in split_plan(len(tiles), split_tiles):
                keys = [j for t in tiles[s0:s1]
                        for j in range(t * BLOCK_K, min((t + 1) * BLOCK_K,
                                                        Nk))]
                idx = torch.tensor(keys, dtype=torch.long, device=q.device)
                x = matmul(q[b, :, rows].float(),
                           k[b][:, idx].float().transpose(-1, -2)) \
                    * (scale * _LOG2E)
                x = torch.where(blocked[b, rows][:, idx], NEG_INF, x)
                m = torch.full(x.shape[:-1] + (1,), NEG_INF, device=q.device)
                if keys:
                    m = torch.maximum(m, x.amax(-1, keepdim=True))
                safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
                p = torch.where(x <= NEG_INF / 2, torch.zeros_like(x),
                                torch.exp2(x - safe)).to(v.dtype).float()
                parts.append((matmul(p, v[b][:, idx].float()), m,
                              p.sum(-1, keepdim=True)))
            if len(parts) == 1:
                num, _, den = parts[0]
            else:
                mx = torch.stack([m for _, m, _ in parts]).amax(0)
                safe = torch.where(mx <= NEG_INF / 2, torch.zeros_like(mx),
                                   mx)
                num = den = 0.0
                for o, m, l in parts:
                    w = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                                    torch.exp2(m - safe))
                    num, den = num + w * o, den + w * l
            out[b, :, rows] = num / torch.where(den == 0,
                                                torch.ones_like(den), den)
    return out.to(q.dtype)


def masked_mha_ref(q, k, v, blocked, scale=None):
    """Plain version of K3 (same signature as ``masked_mha``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(blocked[:, None], NEG_INF, s)
    return _softmax_rounded(s, v).to(q.dtype)


def masked_mha(q, k, v, blocked, scale=None):
    """K3.  q (B, H, Nq, D), k/v (B, H, Nk, D), blocked (B, Nq, Nk) bool,
    True = may NOT attend.  Returns (B, H, Nq, D).  Differentiable in q,
    k, v: the backward recomputes dense masked attention, as the JAX
    ``custom_vjp`` does (masked_attention.py:197-212); ``blocked`` gets no
    gradient."""
    B, H, Nq, D = q.shape
    # dense work, not the tiles the plan visits: the JAX count of the jnp
    # formula, independent of the mask
    with flops.declare(flops.attention_flops(B, H, Nq, k.shape[2], D)):
        fwd = masked_mha_ref if q.device.type == "cpu" \
            else _masked_mha_kernel
        return recompute_vjp(
            lambda q, k, v: fwd(q, k, v, blocked, scale),
            lambda q, k, v: dot_product_attention(
                q, k, v, mask=~blocked[:, None], scale=scale),
            q, k, v)


# launches: every call at D <= 128; launches_f32: those of them in f32;
# launches_wide(_f32): the calls on the wide-head engine
masked_mha.launches = masked_mha.launches_f32 = 0
masked_mha.launches_wide = masked_mha.launches_wide_f32 = 0


def _masked_mha_kernel(q, k, v, blocked, scale):
    """K3 at any head dim: q, k and v padded with zero lanes to the
    kernel's head dim (``kernel_head_dim``), out sliced back; above 128 on
    the wide-head engine."""
    D = q.shape[-1]
    P = kernel_head_dim(D, HEAD_DIMS)
    launch = (_masked_wide_launch if is_wide(P, HEAD_DIMS)
              else _masked_mha_launch)
    if P == D:
        return launch(q, k, v, blocked, scale)
    return launch(*(pad_head_dim(t, P) for t in (q, k, v)), blocked,
                  D ** -0.5 if scale is None else scale)[..., :D]


def _masked_wide_launch(q, k, v, blocked, scale):
    """Launch K3 on the wide-head engine (``flash_attention.wide_fwd``
    with the mask) at a head dim that is a multiple of 64 above 128."""
    out, _ = wide_fwd("masked_mha", q, k, v, scale, blocked=blocked)
    masked_mha.launches_wide += 1
    masked_mha.launches_wide_f32 += int(q.dtype == torch.float32)
    return out


def _masked_mha_launch(q, k, v, blocked, scale):
    """Launch K3 at an instantiated head dim: one launch as counted,
    whatever CUDA launches the call makes (the plan pre-pass, the main
    kernel and the split merge)."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"masked_mha: K3 is built for head dims {HEAD_DIMS}, not {D} "
            "(pad it: kernel_head_dim)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"masked_mha takes f32/bf16, not {q.dtype}")
    if scale is None:
        scale = D ** -0.5
    for name, t, shape in (("q", q, (B, H, Nq, D)), ("k", k, (B, H, Nk, D)),
                           ("v", v, (B, H, Nk, D))):
        cuda_build.check_tensor(t, name, shape, q.dtype, q.device)
    cuda_build.check_tensor(blocked, "blocked", (B, Nq, Nk), torch.bool,
                            q.device)
    out = torch.empty_like(q)
    p, i32, P = ctypes.c_void_p, ctypes.c_int, cuda_build.ptr
    # the mask's tensor map wants rows of a multiple of 16 bytes
    mask = blocked.view(torch.uint8)
    ld = _round_up(Nk, 16)
    if ld != Nk:
        mask = torch.nn.functional.pad(mask, (0, ld - Nk), value=1)
    nqb, nkb, ms = -(-Nq // BLOCK_Q), -(-Nk // BLOCK_K), max_splits(Nk)
    # the live lists and counts; the splits' O, m and l
    plan = torch.empty(B * nqb * (nkb + 1), dtype=torch.int32,
                       device=q.device)
    part = None if ms == 1 else torch.empty(
        ms * B * H * Nq * (D + 2), dtype=torch.float32, device=q.device)
    lib, fn = cuda_build.function(
        "masked_attn_sm90", "p3_masked_attn_sm90",
        [p] * 7 + [i32] * 5 + [ctypes.c_float, i32, i32, i32, p])
    err = fn(P(q), P(k), P(v), P(mask), P(out), P(plan), P(part), B, H, Nq,
             Nk, ld, float(scale), SPLIT_TILES, int(q.dtype == torch.float32),
             D, cuda_build.stream_of(q))
    cuda_build.check(lib, err, "masked_mha")
    masked_mha.launches += 1
    masked_mha.launches_f32 += int(q.dtype == torch.float32)
    return out
