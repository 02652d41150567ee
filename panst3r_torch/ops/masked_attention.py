"""K3: block-sparse masked attention (counterpart of
panst3r_tpu/ops/pallas/masked_attention.py).

``masked_mha`` (``csrc/masked_attn.cu``) replaces ``_sparse_fwd``: the
mask transformer's masked cross-attention, where a (B, Nq, Nk) bool mask
(True = blocked) is shared across heads and most (query block, key block)
tiles are fully blocked in late layers.  ``plan_blocks`` builds the visit
plan on the device with torch ops (live key blocks first, ascending, then
the last live index repeated, plus the count), as the JAX package builds it
in jnp outside its kernel; the kernel reads its own list and visits only
live tiles.

On a CPU tensor ``masked_mha`` runs ``masked_mha_ref`` (same semantics: p
rounded to the v dtype before both sums, fully blocked rows → 0); on a CUDA
tensor it launches the kernel or raises.  ``launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from panst3r_torch.ops import cuda_build
from panst3r_torch.ops.attention import NEG_INF
from panst3r_torch.ops.tower_attention import _softmax_rounded

BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIM = 96  # the v1 mask transformer's; the kernel is built for it


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


def masked_mha_ref(q, k, v, blocked, scale=None):
    """Plain version of K3 (same signature as ``masked_mha``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(blocked[:, None], NEG_INF, s)
    return _softmax_rounded(s, v).to(q.dtype)


def masked_mha(q, k, v, blocked, scale=None):
    """K3.  q (B, H, Nq, D), k/v (B, H, Nk, D), blocked (B, Nq, Nk) bool,
    True = may NOT attend.  Returns (B, H, Nq, D)."""
    if q.device.type == "cpu":
        return masked_mha_ref(q, k, v, blocked, scale)
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if D != HEAD_DIM:
        raise NotImplementedError(
            f"masked_mha: K3 is built for head dim {HEAD_DIM}, not {D} "
            "(not yet ported)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"masked_mha takes f32/bf16, not {q.dtype}")
    if scale is None:
        scale = D ** -0.5
    for name, t, shape in (("q", q, (B, H, Nq, D)), ("k", k, (B, H, Nk, D)),
                           ("v", v, (B, H, Nk, D))):
        cuda_build.check_tensor(t, name, shape, q.dtype, q.device)
    cuda_build.check_tensor(blocked, "blocked", (B, Nq, Nk), torch.bool,
                            q.device)
    kv_idx, count = plan_blocks(blocked, BLOCK_Q, BLOCK_K,
                                _round_up(Nq, BLOCK_Q), _round_up(Nk, BLOCK_K))
    out = torch.empty_like(q)
    p = ctypes.c_void_p
    lib, fn = cuda_build.function("masked_attn", "p3_masked_attn",
                                  [p] * 7 + [ctypes.c_int] * 5
                                  + [ctypes.c_float, ctypes.c_int, p])
    P = cuda_build.ptr
    err = fn(P(q), P(k), P(v), P(blocked.view(torch.uint8)), P(kv_idx),
             P(count), P(out), B, H, Nq, Nk, D, float(scale),
             int(q.dtype == torch.bfloat16), cuda_build.stream_of(q))
    cuda_build.check(lib, err, "masked_mha")
    masked_mha.launches += 1
    return out


masked_mha.launches = 0
