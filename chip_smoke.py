#!/usr/bin/env python3
"""Smoke run of panst3r_torch on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py            # every phase; needs one card
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --phases train_v2

Run from the root of a checkout.  It builds the CUDA kernels of
``panst3r_torch/csrc`` with nvcc (into the git-ignored
``panst3r_torch/_build``), then runs, each phase printing JSON lines:

1. ``kernels``: K1 (tower_self), K2 (tower_cross), K2-int8
   (tower_cross_int8), K3 (masked_attn), K4 (flash_fwd) and K6
   (packed_flash) against their
   plain PyTorch versions at the main paths' shapes, in f32 and bf16, with
   the max abs error and its limit, the kernel's time, the plain version's
   time (and its TFLOP/s), one PyTorch library call on the same work
   (``scaled_dot_product_attention``, a yardstick only — the port never
   calls it; none computes int8-score attention, so K2-int8 records SDPA
   for scale and its distance from K2) and the least time the card could
   take (``panst3r_torch/ops/flops.py::bound_ms``; the f32 K1-K6 and
   K2-int8 also at the 3xTF32 rate of their tensor-core products); every
   kernel in both dtypes (the Hopper engines) also with the device ms of
   each CUDA kernel of one traced call, K2, K3 and K5 with each split
   size of ``SPLIT_TILES_TRIED``; K5 (flash_bwd) likewise
   against its plain version from K4's own output and LSE, and K4 + K5
   through autograd; K4 and K5 also at train_v2's LoftUp batch
   (``loftup_train_full``, f32, plain versions per slice of views), the
   f32 K1 at its B*V = 10 views (``encoder_train``, ``decoder_train``);
   gradients through K1-K3 on the card bit-equal to their plain formulas';
2. ``small``: v1 and v2 widths at depth 2 (v2 with its full mixer and
   LoftUp), f32, V=4 / K=3 at 384x512, the same seeded weights on the card
   (kernels) and on the CPU (plain versions), outputs and FLOP counts
   (``ops/flops.py``) compared; one v2 train step (B=1, V=3 at 160x512),
   card against CPU, its FLOP count included; one v1 serve wire with
   cameras, card against CPU;
3. ``v1`` and ``v2``: the full v1 and v2 main paths
   (``InferenceEngine.run_device`` + ``fuse``, bf16, V=8 / K=4 at 384x512,
   random seeded weights), stage times, peak memory, finiteness and shapes,
   a profile by kernel, each kernel's launch count against the count the
   config and schedule imply, the scene's FLOPs (``pipeline_flops``, held
   to the JAX package's count) and its MFU, and (v1) each stage's MFU;
4. ``train_v2``: four micro-steps (two updates) of the v2 train step at
   full width and depth (frozen towers stored in bf16, the train_v2 recipe,
   B=2 x V=5 at 384x512), step and stage times, peak memory, gradients on
   every trainable leaf, frozen parameters unchanged, launch counts, the
   shapes of K4's and K5's launches (K5's held to ``LOFTUP_TRAIN_FULL``),
   a profile by kernel, and one micro-step's FLOPs and MFU;
5. ``serve``: the v1 serving wire at full width and depth (V=8 / K=4):
   every ``fusion_res``, cameras, packed YUV420 input, both latency paths
   and ``serve_stream``, held to the checks of tests/test_serve.py, with
   times, wire bytes, peak memory, launch counts, FLOPs and MFU;
6. ``serve_long``: V=50 / K=16 from packed YUV420 on the hybrid wire with
   ``PANST3R_KV_INT8=1``: K2-int8 exactly once per decoder layer per
   scene, the stream at queue depth 6, the same scene with int8 off, a
   profile by kernel, FLOPs and MFU;
7. ``ab_packed``: K6's path, the A/B tool
   (``panst3r_torch/tools/ab_attention_packed.py``) at full shape:
   exactly 24 K6 launches per run of the ``packed`` variant, K6 against
   K4, every variant's ms per layer and the bound; one f32 run of the
   ``packed`` variant (24 launches of the f32 K6);

then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failed phase raises, and the script exits non-zero without
the last line.  Without a CUDA device, or outside a checkout, it exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time

import numpy as np

# f32: a kernel within 1e-4 abs of its plain version.  bf16: against the
# plain version run in f32 on the same (bf16) inputs, the kernel's max abs
# error at most 1.5 times the plain bf16 version's own (plus 1e-5) and its
# RMS error at most 1.25 times the plain one's (plus 1e-6): the kernel may
# round little worse than the plain version does.  The RMS bound catches a small
# fault spread over many values, which the max (set by the rounding of the
# largest values) would hide.
F32_TOL = 1e-4
BF16_MAX_RATIO, BF16_MAX_ATOL = 1.5, 1e-5
BF16_RMS_RATIO, BF16_RMS_ATOL = 1.25, 1e-6
# q and k spread so that the logits have a std of about 2 (peaked, as in
# trained attention): a near-uniform softmax would hide faults in the
# scores and in which value rows are summed.
QK_STD = 1.4
REPLACES = {
    "tower_self": "panst3r_tpu/ops/pallas/tower_attention.py:129",
    "tower_cross": "panst3r_tpu/ops/pallas/tower_attention.py:411",
    "tower_self_f32": "panst3r_tpu/ops/pallas/tower_attention.py:129 (f32)",
    "tower_cross_f32": "panst3r_tpu/ops/pallas/tower_attention.py:411 "
                       "(f32 branch)",
    "tower_cross_int8": "panst3r_tpu/ops/pallas/tower_attention.py:411 "
                        "(kv_int8)",
    "tower_cross_int8_f32": "panst3r_tpu/ops/pallas/tower_attention.py:411 "
                            "(kv_int8, f32)",
    "masked_attn": "panst3r_tpu/ops/pallas/masked_attention.py:119",
    "masked_attn_f32": "panst3r_tpu/ops/pallas/masked_attention.py:119 "
                       "(f32)",
    "flash_fwd": "panst3r_tpu/ops/pallas/flash_attention.py:171",
    "flash_bwd": "panst3r_tpu/ops/pallas/flash_attention_bwd.py:115",
    "flash_bwd_bf16": "panst3r_tpu/ops/pallas/flash_attention_bwd.py:115 "
                      "(bf16)",
    "packed_flash": "tools/ab_attention_packed.py:84",
    "packed_flash_f32": "tools/ab_attention_packed.py:84 (f32)",
}
PHASES = ("kernels", "small", "v1", "v2", "train_v2", "serve", "serve_long",
          "ab_packed")
# every kernel runs a Hopper engine in both dtypes: bf16 the wgmma engine
# (K2-int8 its s8 scores); of the f32 paths (entries ``*_f32`` of the
# kernels line) K2, K2-int8 and K3 run the 3xTF32 engine in the same
# sources (F32_SOURCE; K2-int8 its scores by mma.sync s8), K1 and K6 the
# f32 K4's source (its main kernel over strided views); K4 and K5 run
# sources of their own per dtype (their main paths run f32 only)
SOURCE = {"tower_self": "tower_self_sm90", "tower_cross": "tower_cross_sm90",
          "tower_cross_int8": "tower_cross_int8_sm90",
          "masked_attn": "masked_attn_sm90",
          "flash_fwd": "flash_fwd_bf16_sm90",
          "flash_bwd": "flash_bwd_bf16_sm90",
          "packed_flash": "packed_flash_sm90"}
F32_SOURCE = {"tower_self": "flash_fwd_sm90",
              "tower_cross": "tower_cross_sm90",
              "tower_cross_int8": "tower_cross_int8_sm90",
              "masked_attn": "masked_attn_sm90",
              "flash_fwd": "flash_fwd_sm90", "flash_bwd": "flash_bwd_sm90",
              "packed_flash": "flash_fwd_sm90"}
# the case and dtype of each kernel on its main path: K1-K3 under v1's bf16,
# K4 in LoftUp's f32 (flax promotes that branch to f32 under amp; the v2
# scene's 4 views), K5 at train_v2's LoftUp call (B*V = 10 views), the f32
# K1-K3 in train_v2 (at its shapes), K6 in the A/B tool (bf16, and its f32
# run); two kernels no path runs (NO_PATH): the f32 K2-int8 (serving is
# bf16) at the long render, the bf16 K5 (LoftUp runs f32) at LoftUp's
# training shape
MAIN_CASE = {"tower_self": ("encoder_rope", "bfloat16"),
             "tower_cross": ("render", "bfloat16"),
             "tower_self_f32": ("encoder_train", "float32"),
             "tower_cross_f32": ("render_train", "float32"),
             "tower_cross_int8": ("render_long", "bfloat16"),
             "tower_cross_int8_f32": ("render_long", "float32"),
             "masked_attn": ("mask_transformer", "bfloat16"),
             "masked_attn_f32": ("mask_transformer_train", "float32"),
             "flash_fwd": ("loftup", "float32"),
             "flash_bwd": ("loftup_train_full", "float32"),
             "flash_bwd_bf16": ("loftup_train", "bfloat16"),
             "packed_flash": ("tool", "bfloat16"),
             "packed_flash_f32": ("tool", "float32")}
# entries of the kernels line that no main path launches: listed with
# their launches summed over every path this run drove, which the launch
# check holds to 0
NO_PATH = ("tower_cross_int8_f32", "flash_bwd_bf16")
# K2's and K3's fixed splits (key tiles per split) and a larger one, each
# timed on the kernel's cases on the Hopper engines (bf16, and f32) in the
# same run; K5's dkdv splits (query tiles of 64 per split) likewise
SPLIT_TILES_TRIED = {"tower_cross": (16, 48), "masked_attn": (8, 16),
                     "flash_bwd": (64, 192)}
# LoftUp's call in the train_v2 micro-step: all B*V = 2*5 views at once,
# 4 heads of 96, 192x256 pixel queries against 24x32 patch tokens (the
# train_v2 phase checks that its K4/K5 launches have this shape)
LOFTUP_TRAIN_FULL = (10, 4, 49152, 768, 96)
# the plain versions of K4 and K5 at that batch run per slice of views
# (attention is independent per batch): the whole call's f32 logits (6 GB)
# and their temporaries would not fit beside the inputs
PLAIN_SLICE = 2
# K4's LSE against its plain version's: f32 logits on both sides
LSE_RTOL = 1e-4
# The JAX package's matmul/conv FLOPs of one run_device + fusion scene at
# 384x512 (preset, V, K): panst3r_tpu's InferenceEngine.pipeline_flops over
# jax.eval_shape parameters, run on the CPU (the per-stage split is
# tools/mfu_report.py::stage_flops).  The port's pipeline_flops must equal
# them within FLOPS_RTOL.
JAX_SCENE_FLOPS = {("v1", 8, 4): 14_320_910_696_448,
                   ("v2", 8, 4): 16_343_079_026_688,
                   ("v1", 50, 16): 110_496_179_601_408}
FLOPS_RTOL = 1e-6
# K6 against K4 in the A/B tool: a few bf16 units of outputs of size ~1
AB_PARITY_ATOL = 2.0 ** -6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bf16_check(out, plain, plain_f32) -> dict:
    """The bf16 rule above; every tensor in f32."""
    def stats(d):
        return float(d.abs().max()), float(d.square().mean().sqrt())

    kmax, krms = stats(out - plain_f32)
    pmax, prms = stats(plain - plain_f32)
    lmax = BF16_MAX_RATIO * pmax + BF16_MAX_ATOL
    lrms = BF16_RMS_RATIO * prms + BF16_RMS_ATOL
    return {"kernel_max": kmax, "plain_max": pmax, "limit_max": lmax,
            "kernel_rms": krms, "plain_rms": prms, "limit_rms": lrms,
            "ok": kmax <= lmax and krms <= lrms}


# ------------------------------------------------------------ phase 1 ----

def _grid_pos(B, gh, gw, dev):
    from panst3r_torch.ops.rope import patch_grid_positions

    return patch_grid_positions(gh, gw, dev)[None].expand(B, gh * gw, 2)


def _masked_mha_pallas_sums(q, k, v, blocked):
    """K3 as the Pallas kernel sums it: p rounded to the value dtype in the
    numerator only, the denominator over the unrounded p (one pass)."""
    import torch

    from panst3r_torch.ops.attention import NEG_INF

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * q.shape[-1] ** -0.5
    s = torch.where(blocked[:, None], NEG_INF, s)
    m = s.amax(-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - m))
    den = p.sum(-1, keepdim=True)
    num = torch.matmul(p.to(v.dtype).float(), v.float())
    return (num / torch.where(den == 0, torch.ones_like(den), den)).to(q.dtype)


def kernel_cases(dtype, dev):
    """Dicts: kernel, case, fn (kernel), ref (plain), f32 (plain on f32
    copies of the inputs), lib (library call), flops, bytes and, for K3,
    pallas_sums (its Pallas summation)."""
    import torch
    import torch.nn.functional as F

    from panst3r_torch.ops import masked_attention as ma
    from panst3r_torch.ops import tower_attention as ta
    from panst3r_torch.ops.rope import rope2d_tables

    g = torch.Generator(device=dev).manual_seed(0)
    es = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

    def f32(t):
        return None if t is None else t.float()

    def heads(t, D):
        B, N, C = t.shape
        return t.reshape(B, N, C // D, D).transpose(1, 2).contiguous()

    cases = []
    # K1: encoder (RoPE), DINO (cls), decoder self-attention (RoPE, C=768),
    # no options: B = chunk = 4 views, N = 24*32 = 768 tokens; and the
    # memory build's decoder self-attention, one view (B=1: 64-row CTAs).
    for label, B, C, H, rope, cls in (
            ("encoder_rope", 4, 1024, 16, True, False),
            ("dino_cls", 4, 1024, 16, False, True),
            ("decoder_rope", 4, 768, 12, True, False),
            ("plain", 4, 1024, 16, False, False),
            ("decoder_update", 1, 768, 12, True, False)):
        _k1_case(cases, label, B, C, H, rope, cls, rnd, g, es, dev)

    # K2: decoder update (second +1 step: 1536 of 3072 memory slots valid,
    # own 768 tokens appended), render (4 views x 768 against a full
    # 4-keyframe memory), and a ragged shape with dead tiles.
    def k2(label, B, Nq, Nk, valid):
        C = 768
        q, k = rnd(B, Nq, C, s=QK_STD), rnd(B, Nk, C, s=QK_STD)
        v = rnd(B, Nk, C)
        qpos = torch.randint(0, 32, (B, Nq, 2), generator=g, device=dev)
        kpos = torch.randint(0, 32, (B, Nk, 2), generator=g, device=dev)
        qtab, ktab = rope2d_tables(qpos, 64), rope2d_tables(kpos, 64)
        bias = torch.where(valid, 0.0, float(torch.finfo(torch.float32).min))
        live = int(valid.sum())                        # over the batch
        qh, kh, vh = (heads(t, 64) for t in (q, k, v))
        nbytes = (2 * q.numel() + 2 * live * C) * es \
            + 2 * (B * Nq + live) * 64 * 4 + bias.numel() * 4
        cases.append(dict(
            kernel="tower_cross", case=label,
            fn=lambda: ta.tower_cross_attention(q, k, v, qtab, ktab, bias),
            ref=lambda: ta.tower_cross_attention_ref(q, k, v, qtab, ktab,
                                                     bias),
            f32=lambda: ta.tower_cross_attention_ref(f32(q), f32(k), f32(v),
                                                     qtab, ktab, bias),
            lib=lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bias[:, None, None, :].to(dtype)),
            flops=4.0 * Nq * live * C, bytes=nbytes,
            splits=ta.max_splits(Nk),
            warpgroups=ta.cta_warpgroups(B, C // 64, Nq, ta.max_splits(Nk))))

    valid = torch.ones(1, 3840, dtype=torch.bool, device=dev)
    valid[:, 1536:3072] = False
    k2("update_bias", 1, 768, 3840, valid)
    # a memory update short enough for one split (12 key tiles): 64-row CTAs
    k2("update_one_split", 1, 768, 1536,
       torch.ones(1, 1536, dtype=torch.bool, device=dev))
    # serve_long's last memory update: 11520 of 12288 slots valid, then
    # the update's own 768 tokens (Nk = 13056)
    valid = torch.ones(1, 13056, dtype=torch.bool, device=dev)
    valid[:, 11520:12288] = False
    k2("update_long", 1, 768, 13056, valid)
    k2("render", 1, 3072, 3072,
       torch.ones(1, 3072, dtype=torch.bool, device=dev))
    valid = torch.rand(2, 2950, generator=g, device=dev) > 0.1
    valid[0, 640:1600] = False
    valid[1, 2000:] = False
    k2("ragged_dead_tiles", 2, 1000, 2950, valid)
    cases += _int8_cases(rnd, g, es, dtype, dev)

    # K3: mask-transformer cross-attention, 200 queries x 4 views x 768
    # tokens (and x 16 keyframes x 768 at serve_long), 8 heads of 96,
    # object-like blocked mask with dead tiles and some fully blocked rows.
    # The long case is drawn after the others, so they keep their inputs.
    blocked = _k3_case(cases, "mask_transformer", 3072, rnd, g, es, dev)
    cases += _k4_cases(rnd, g, es, dtype, dev, blocked)
    cases += _k6_cases(rnd, es)
    _k3_case(cases, "mask_transformer_long", 12288, rnd, g, es, dev)
    # train_v2's shapes (B=2 x V=5 views of 768 tokens), where the f32 K2
    # and K3 run, drawn last: the render against the full memory, the
    # first memory update (none of the 3840 slots valid yet, its own 2 x
    # 768 tokens appended: expected_train_launches' first call), the mask
    # transformer over 5 x 768 keys
    k2("render_train", 2, 3840, 3840,
       torch.ones(2, 3840, dtype=torch.bool, device=dev))
    valid = torch.ones(2, 5376, dtype=torch.bool, device=dev)
    valid[:, :3840] = False
    k2("update_train", 2, 1536, 5376, valid)
    _k3_case(cases, "mask_transformer_train", 3840, rnd, g, es, dev, B=2)
    if dtype == torch.float32:
        # K4 at train_v2's LoftUp batch, where the path runs it in f32
        cases += _k4_cases(rnd, g, es, dtype, dev, None, full=True)
        # the f32 K1 at the micro-step's B*V = 10 views: the encoder, and
        # the decoder's self-attention over the render's views
        _k1_case(cases, "encoder_train", 10, 1024, 16, True, False, rnd, g,
                 es, dev)
        _k1_case(cases, "decoder_train", 10, 768, 12, True, False, rnd, g,
                 es, dev)
    return cases


def _k1_case(cases, label, B, C, H, rope, cls, rnd, g, es, dev):
    """Appends K1's case at (B, 768 tokens, C) with H heads of 64, RoPE
    tables and a cls key/value as asked; the library call is SDPA on the
    heads split out (without the cls column)."""
    import torch
    import torch.nn.functional as F

    from panst3r_torch.ops import tower_attention as ta
    from panst3r_torch.ops.rope import rope2d_tables

    def f32(t):
        return None if t is None else t.float()

    def heads(t, D):
        B, N, C = t.shape
        return t.reshape(B, N, C // D, D).transpose(1, 2).contiguous()

    N = 768
    qkv = torch.cat([rnd(B, N, 2 * C, s=QK_STD), rnd(B, N, C)], -1)
    tabs = rope2d_tables(_grid_pos(B, 24, 32, dev), 64) if rope else None
    ckv = (rnd(B, 1, C, s=QK_STD), rnd(B, 1, C)) if cls else None
    q, k, v = (heads(t, 64) for t in qkv.split(C, -1))
    nbytes = qkv.numel() * es + B * N * C * es \
        + (2 * B * N * 64 * 4 if rope else 0) + (2 * B * C * es if cls else 0)
    cases.append(dict(
        kernel="tower_self", case=label,
        fn=lambda: ta.tower_self_attention(qkv, H, tabs=tabs, cls_kv=ckv),
        ref=lambda: ta.tower_self_attention_ref(qkv, H, tabs=tabs,
                                                cls_kv=ckv),
        f32=lambda: ta.tower_self_attention_ref(
            qkv.float(), H, tabs=tabs,
            cls_kv=None if ckv is None else tuple(map(f32, ckv))),
        lib=lambda: F.scaled_dot_product_attention(q, k, v),
        flops=4.0 * B * H * N * (N + (1 if cls else 0)) * 64,
        bytes=nbytes, warpgroups=ta.cta_warpgroups(B, H, N)))


def _k3_case(cases, label, Nk, rnd, g, es, dev, B=1):
    """Appends K3's case at (B, 8, 200, Nk), D=96 (each batch with spans of
    its own); returns its mask."""
    import torch
    import torch.nn.functional as F

    from panst3r_torch.ops import masked_attention as ma

    def f32(t):
        return t.float()

    H, Nq, D = 8, 200, 96
    q, k = rnd(B, H, Nq, D, s=QK_STD), rnd(B, H, Nk, D, s=QK_STD)
    v = rnd(B, H, Nk, D)
    blocked = torch.ones(B, Nq, Nk, dtype=torch.bool, device=dev)
    starts = torch.randint(0, Nk - 400, (B, 8), generator=g, device=dev)
    for b in range(B):
        for qi in range(Nq):
            s = int(starts[b, qi % 8])
            blocked[b, qi, s:s + 100 + 30 * (qi % 8)] = False
    blocked &= torch.rand(B, Nq, Nk, generator=g, device=dev) > 0.02
    blocked[:, 150:160] = True                         # fully blocked rows
    _, count = ma.plan_blocks(blocked, ma.BLOCK_Q, ma.BLOCK_K, 256, Nk)
    live_tiles = int(count.sum())
    live_kb = int((~blocked.view(B, Nq, Nk // 64, 64).all(-1).all(1)).sum())
    nbytes = (2 * q.numel() + 2 * H * live_kb * 64 * D) * es + blocked.numel()
    cases.append(dict(
        kernel="masked_attn", case=label,
        fn=lambda: ma.masked_mha(q, k, v, blocked),
        ref=lambda: ma.masked_mha_ref(q, k, v, blocked),
        f32=lambda: ma.masked_mha_ref(f32(q), f32(k), f32(v), blocked),
        lib=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=~blocked[:, None]),
        pallas_sums=lambda: _masked_mha_pallas_sums(q, k, v, blocked),
        flops=4.0 * H * live_tiles * 64 * 64 * D, bytes=nbytes,
        splits=ma.max_splits(Nk), warpgroups=1))
    return blocked


def _k6_cases(rnd, es):
    """K6 at the A/B tool's shape (B=8 views x 8 head pairs x 768 tokens)
    and with two 768-key Pallas blocks (one view, N=1536); the library
    call is SDPA on the same heads split out."""
    import torch.nn.functional as F

    from panst3r_torch.ops import packed_attention as pa

    cases = []
    for label, (B, P, N) in (("tool", (8, 8, 768)),
                             ("two_key_blocks", (1, 8, 1536))):
        q, k = rnd(B, P, N, 128, s=QK_STD), rnd(B, P, N, 128, s=QK_STD)
        v = rnd(B, P, N, 128)
        qh, kh, vh = (t.view(B, P, N, 2, 64).transpose(2, 3)
                      .reshape(B, 2 * P, N, 64) for t in (q, k, v))
        cases.append(dict(
            kernel="packed_flash", case=label,
            fn=lambda q=q, k=k, v=v: pa.packed_mha(q, k, v),
            ref=lambda q=q, k=k, v=v: pa.packed_mha_ref(q, k, v),
            f32=lambda q=q, k=k, v=v: pa.packed_mha_ref(q.float(), k.float(),
                                                        v.float()),
            lib=lambda qh=qh, kh=kh, vh=vh:
                F.scaled_dot_product_attention(qh, kh, vh),
            flops=4.0 * B * 2 * P * N * N * 64,
            bytes=4 * q.numel() * es, warpgroups=2))
    return cases


def _by_rows(fn, q, qtab, *rest, rows: int = 4096):
    """A plain version ``fn(q, k, v, qtab, ...)`` over query chunks of
    ``rows`` (its rows are independent): the long render's logits would
    not fit the card in one piece."""
    import torch

    return torch.cat([fn(q[:, a:a + rows], rest[0], rest[1],
                         (qtab[0][:, a:a + rows], qtab[1][:, a:a + rows]),
                         *rest[2:])
                      for a in range(0, q.shape[1], rows)], 1)


# K2-int8 cases: (label, B, Nq, Nk) at C = 768 with RoPE tables
INT8_CASES = (("render_long", 1, 38400, 12288),     # 50 views x 768 q,
              ("gate_edge", 1, 16384, 3000),        # 16 keyframes x 768 k
              ("batch2", 2, 16384, 3072))


def _int8_cases(rnd, g, es, dtype, dev):
    """K2 at the long render shape, and K2-int8 (through the gated
    ``tower_cross_attention(kv_int8=True)``) at the long render (zero
    bias), at the gate's edge (Nq = 16384, a ragged Nk, dead key tiles and
    a soft-biased span) and at B=2 with batch 1's keys three times larger
    (the per-tensor scale spans the batch).  Each int8 case also carries
    the bf16/f32 K2 on the same inputs (``vs_k2``) and SDPA at its dtype
    for scale (``sdpa``); no PyTorch call computes int8-score attention."""
    import torch
    import torch.nn.functional as F

    from panst3r_torch.ops import tower_attention as ta
    from panst3r_torch.ops.rope import apply_rope_tables_f32, rope2d_tables

    cases = []
    C, NEG = 768, float(torch.finfo(torch.float32).min)
    for label, B, Nq, Nk in INT8_CASES:
        q, k = rnd(B, Nq, C, s=QK_STD), rnd(B, Nk, C, s=QK_STD)
        v = rnd(B, Nk, C)
        if label == "batch2":
            k[1] *= 3
        qtab = rope2d_tables(torch.randint(0, 32, (B, Nq, 2), generator=g,
                                           device=dev), 64)
        ktab = rope2d_tables(torch.randint(0, 32, (B, Nk, 2), generator=g,
                                           device=dev), 64)
        bias = torch.zeros(B, Nk, device=dev)
        if label == "gate_edge":
            bias[:, 640:1600] = NEG
            bias[:, 100:300] = -0.7
        live = int((bias > NEG / 2).sum())
        qh, kh = (apply_rope_tables_f32(t.reshape(B, -1, 12, 64)
                                        .transpose(1, 2), *tab)
                  for t, tab in ((q, qtab), (k, ktab)))
        vh = v.reshape(B, Nk, 12, 64).transpose(1, 2)
        mask = (bias[:, None, None, :] > NEG / 2)
        nbytes = (2 * q.numel() + 2 * live * C) * es \
            + 2 * (B * Nq + live) * 64 * 4 + bias.numel() * 4

        def run(fn, *a, q=q, k=k, v=v, qtab=qtab, ktab=ktab, bias=bias,
                **kw):
            return fn(q, k, v, qtab, ktab, bias, *a, **kw)

        def sdpa(qh=qh, kh=kh, vh=vh, mask=mask):
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        # the plain version at the kernel's key tile (bf16: 128, f32: 64)
        plain = functools.partial(_by_rows, functools.partial(
            ta.tower_cross_int8_ref,
            tile=ta.BLOCK_K if dtype == torch.bfloat16 else ta.INT8_F32_TILE))
        plain_k2 = functools.partial(_by_rows, ta.tower_cross_attention_ref)
        f32 = (lambda t: t.float())
        if label == "render_long":
            cases.append(dict(
                kernel="tower_cross", case=label,
                fn=lambda run=run: run(ta.tower_cross_attention,
                                       kv_int8=False),
                ref=lambda q=q, k=k, v=v, qtab=qtab, ktab=ktab, bias=bias:
                    plain_k2(q, qtab, k, v, ktab, bias),
                f32=lambda q=q, k=k, v=v, qtab=qtab, ktab=ktab, bias=bias:
                    plain_k2(f32(q), qtab, f32(k), f32(v), ktab, bias),
                lib=sdpa, flops=4.0 * Nq * live * C, bytes=nbytes,
                reps=5, plain_reps=2, splits=ta.max_splits(Nk),
                warpgroups=ta.cta_warpgroups(B, C // 64, Nq,
                                             ta.max_splits(Nk))))
        cases.append(dict(
            kernel="tower_cross_int8", case=label,
            fn=lambda run=run: run(ta.tower_cross_attention, kv_int8=True),
            ref=lambda q=q, k=k, v=v, qtab=qtab, ktab=ktab, bias=bias:
                plain(q, qtab, k, v, ktab, bias),
            f32=lambda q=q, k=k, v=v, qtab=qtab, ktab=ktab, bias=bias:
                plain(f32(q), qtab, f32(k), f32(v), ktab, bias),
            lib=None, sdpa=sdpa,
            vs_k2=lambda run=run: run(ta.tower_cross_attention,
                                      kv_int8=False),
            flops=2.0 * Nq * live * C, int8_ops=2.0 * Nq * live * C,
            bytes=nbytes, reps=5 if label == "render_long" else 20,
            plain_reps=2, warpgroups=ta.INT8_WARPGROUPS))
    return cases


def _sliced(fn, n: int, *ts):
    """``fn`` over the batch in slices of ``n`` (the tensors ``ts`` cut
    along dim 0), the results joined: the plain version of attention at a
    batch whose logits would not fit at once."""
    import torch

    parts = [fn(*(t[a:a + n] for t in ts)) for a in range(0, ts[0].shape[0],
                                                           n)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(x) for x in zip(*parts))
    return torch.cat(parts)


def _k4_cases(rnd, g, es, dtype, dev, blocked, full=False):
    """K4 at the v2 LoftUp shape (split-heads views of the projections, as
    the block passes them), with ragged dead keys, with the dense
    mask-transformer bias, with RoPE tables and with the LSE; with
    ``full``, only at train_v2's LoftUp batch (its plain version per slice
    of PLAIN_SLICE views)."""
    import torch
    import torch.nn.functional as F

    from panst3r_torch.ops import flash_attention as fa
    from panst3r_torch.ops.attention import NEG_INF
    from panst3r_torch.ops.rope import apply_rope_tables_f32, rope2d_tables

    def f32(t):
        return None if t is None else t.float()

    def case(label, q, k, v, bias=None, kv_valid=None, rope=None,
             with_lse=False, live_keys=None, lib_mask=None, slices=None):
        B, H, Nq, D = q.shape
        Nk = k.shape[2]
        live_keys = B * Nk if live_keys is None else live_keys
        nbytes = (2 * q.numel() + 2 * H * live_keys * D) * es
        nbytes += 0 if bias is None else bias.numel() * 4
        nbytes += 0 if kv_valid is None else kv_valid.numel()
        nbytes += 0 if rope is None else 2 * B * (Nq + Nk) * D * 4
        nbytes += B * H * Nq * 4 if with_lse else 0
        kw = dict(bias=bias, kv_valid=kv_valid, rope=rope, with_lse=with_lse)
        ql, kl = q, k
        if rope is not None:        # the library call gets rotated q, k
            ql = apply_rope_tables_f32(q, rope[0], rope[1])
            kl = apply_rope_tables_f32(k, rope[2], rope[3])
        if slices is not None:
            def ref():
                return _sliced(lambda *t: fa.flash_mha_ref(*t, **kw), slices,
                               q, k, v)
        else:
            def ref():
                return fa.flash_mha_ref(q, k, v, **kw)
        return dict(
            kernel="flash_fwd", case=label,
            fn=lambda: fa.flash_mha(q, k, v, **kw), ref=ref,
            f32=lambda: fa.flash_mha_ref(f32(q), f32(k), f32(v), **kw),
            lib=lambda: F.scaled_dot_product_attention(
                ql, kl, v, attn_mask=lib_mask),
            flops=4.0 * H * Nq * live_keys * D, bytes=nbytes,
            warpgroups=fa.bf16_warpgroups(B, H, Nq, D))

    def heads(B, N, H, D, s=1.0):
        """(B, H, N, D) view of a (B, N, H*D) projection."""
        return rnd(B, N, H * D, s=s).view(B, N, H, D).transpose(1, 2)

    if full:        # f32 only: the f32 plain version is the reference
        B, H, Nq, Nk, D = LOFTUP_TRAIN_FULL
        return [case("loftup_train_full", heads(B, Nq, H, D, QK_STD),
                     heads(B, Nk, H, D, QK_STD), heads(B, Nk, H, D),
                     slices=PLAIN_SLICE)]
    cases = []
    # v2 LoftUp: 4 views x 192x256 pixels against 4 x 768 patch tokens
    B, H, Nq, Nk, D = 4, 4, 49152, 768, 96
    cases.append(case("loftup", heads(B, Nq, H, D, QK_STD),
                      heads(B, Nk, H, D, QK_STD), heads(B, Nk, H, D)))
    # key validity with dead tiles (K2's ragged_dead_tiles pattern), D=64
    B, H, Nq, Nk, D = 2, 12, 1000, 2950, 64
    valid = torch.rand(B, Nk, generator=g, device=dev) > 0.1
    valid[0, 640:1600] = False
    valid[1, 2000:] = False
    cases.append(case(
        "kv_valid", rnd(B, H, Nq, D, s=QK_STD), rnd(B, H, Nk, D, s=QK_STD),
        rnd(B, H, Nk, D), kv_valid=valid, live_keys=int(valid.sum()),
        lib_mask=valid[:, None, None, :]))
    # dense mask transformer (PANST3R_DISABLE_SPARSE_MASK=1): a head-shared
    # finfo.min bias from K3's blocked mask
    B, H, Nq, Nk, D = 1, 8, 200, 3072, 96
    bias = torch.where(blocked, NEG_INF, 0.0)[:, None]
    cases.append(case(
        "dense_bias", rnd(B, H, Nq, D, s=QK_STD), rnd(B, H, Nk, D, s=QK_STD),
        rnd(B, H, Nk, D), bias=bias, lib_mask=~blocked[:, None]))
    # RoPE tables at a decoder-tower shape; the LSE at an encoder shape
    B, H, N, D = 4, 12, 768, 64
    tabs = rope2d_tables(_grid_pos(B, 24, 32, dev), D)
    cases.append(case(
        "rope_tables", rnd(B, H, N, D, s=QK_STD), rnd(B, H, N, D, s=QK_STD),
        rnd(B, H, N, D), rope=(*tabs, *tabs)))
    B, H = 4, 16
    cases.append(case(
        "lse", rnd(B, H, N, D, s=QK_STD), rnd(B, H, N, D, s=QK_STD),
        rnd(B, H, N, D), with_lse=True))
    return cases


def k5_cases(dtype, dev):
    """K5 cases: q, k, v, do and K4's keyword arguments, with the FLOPs of
    the seven products and the bytes moved (each input read once, each
    gradient written once), and the library yardstick's mask; in f32 last
    the train_v2 LoftUp batch (``slices``: its plain version per slice of
    views)."""
    import torch

    from panst3r_torch.ops.attention import NEG_INF
    from panst3r_torch.ops.rope import rope2d_tables

    g = torch.Generator(device=dev).manual_seed(1)
    es = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

    def heads(B, N, H, D, s=1.0):
        """(B, H, N, D) view of a (B, N, H*D) projection."""
        return rnd(B, N, H * D, s=s).view(B, N, H, D).transpose(1, 2)

    cases = []

    def case(label, q, k, v, live_keys=None, lib_mask=None, slices=None,
             **kw):
        B, H, Nq, D = q.shape
        Nk = k.shape[2]
        live = B * Nk if live_keys is None else live_keys
        nbytes = (4 * q.numel() + 4 * H * live * D) * es + B * H * Nq * 4
        for t in (kw.get("bias"), kw.get("kv_valid")):
            nbytes += 0 if t is None else t.numel() * t.element_size()
        nbytes += 0 if "rope" not in kw else 2 * B * (Nq + Nk) * D * 4
        cases.append(dict(case=label, q=q, k=k, v=v,
                          do=heads(B, Nq, H, D), kw=kw, lib_mask=lib_mask,
                          slices=slices,
                          flops=7 * 2.0 * H * Nq * live * D, bytes=nbytes))

    # LoftUp's training shape: 2 views x 192x256 pixels against 768 tokens
    B, H, Nq, Nk, D = 2, 4, 49152, 768, 96
    case("loftup_train", heads(B, Nq, H, D, QK_STD), heads(B, Nk, H, D, QK_STD),
         heads(B, Nk, H, D))
    B, H, Nq, Nk, D = 2, 12, 1000, 2950, 64
    valid = torch.rand(B, Nk, generator=g, device=dev) > 0.1
    valid[0, 640:1600] = False
    valid[1, 2000:] = False
    case("kv_valid", rnd(B, H, Nq, D, s=QK_STD), rnd(B, H, Nk, D, s=QK_STD),
         rnd(B, H, Nk, D), live_keys=int(valid.sum()),
         lib_mask=valid[:, None, None, :], kv_valid=valid)
    # the mask transformer's dense path at training size: 200 queries x 5
    # views x 768 tokens, a head-shared finfo.min bias from a blocked mask
    B, H, Nq, Nk, D = 2, 8, 200, 3840, 96
    blocked = torch.ones(B, Nq, Nk, dtype=torch.bool, device=dev)
    starts = torch.randint(0, Nk - 400, (B, 8), generator=g, device=dev)
    for b in range(B):
        for qi in range(Nq):
            s = int(starts[b, qi % 8])
            blocked[b, qi, s:s + 100 + 30 * (qi % 8)] = False
    blocked &= torch.rand(B, Nq, Nk, generator=g, device=dev) > 0.02
    case("dense_bias", rnd(B, H, Nq, D, s=QK_STD), rnd(B, H, Nk, D, s=QK_STD),
         rnd(B, H, Nk, D), lib_mask=~blocked[:, None],
         bias=torch.where(blocked, NEG_INF, 0.0)[:, None])
    B, H, N, D = 4, 12, 768, 64
    tabs = rope2d_tables(_grid_pos(B, 24, 32, dev), D)
    case("rope_tables", rnd(B, H, N, D, s=QK_STD), rnd(B, H, N, D, s=QK_STD),
         rnd(B, H, N, D), rope=(*tabs, *tabs))
    if dtype == torch.float32:
        # the micro-step's LoftUp backward: all B*V views in one call
        B, H, Nq, Nk, D = LOFTUP_TRAIN_FULL
        case("loftup_train_full", heads(B, Nq, H, D, QK_STD),
             heads(B, Nk, H, D, QK_STD), heads(B, Nk, H, D),
             slices=PLAIN_SLICE)
    return cases


def _grad_check(got, plain, plain_f32, dtype) -> dict:
    """f32: max abs error within 1e-4 of the plain gradient's max |value|;
    bf16: the bf16 rule, per gradient."""
    import torch

    out = {}
    for name, a, b, c in zip(("dq", "dk", "dv"), got, plain, plain_f32):
        a, b, c = a.float(), b.float(), c.float()
        if dtype == torch.float32:
            err, lim = float((a - b).abs().max()), 1e-4 * float(b.abs().max())
            out[name] = {"max_abs_err": err, "limit": lim, "ok": err <= lim}
        else:
            out[name] = bf16_check(a, b, c)
        out[name]["finite"] = bool(torch.isfinite(a).all())
    return out


def _sdpa_bwd(c):
    """One backward of ``F.scaled_dot_product_attention`` on the case's
    work (q, k rotated first for RoPE), as a timed closure."""
    import torch
    import torch.nn.functional as F

    from panst3r_torch.ops.rope import apply_rope_tables_f32

    q, k = c["q"], c["k"]
    rope = c["kw"].get("rope")
    if rope is not None:
        q = apply_rope_tables_f32(q, rope[0], rope[1])
        k = apply_rope_tables_f32(k, rope[2], rope[3])
    ins = [t.detach().clone().requires_grad_() for t in (q, k, c["v"])]
    out = F.scaled_dot_product_attention(*ins, attn_mask=c["lib_mask"])
    return lambda: torch.autograd.grad(out, ins, c["do"], retain_graph=True)


def phase_k5(dtype, dname: str, dev, rows: dict) -> None:
    """K5 against its plain version from K4's own output and LSE, then
    K4 + K5 through autograd against autograd through ``flash_mha_ref``
    (f32; in bf16 against the plain pair's gradients, with the exact f32
    gradient as the reference).  A case with ``slices`` holds both against
    the plain versions run per slice of views.  Every row (the Hopper
    engines) also carries the device ms of each CUDA kernel of one traced
    call, the library's CUDA kernels and each dkdv split of
    SPLIT_TILES_TRIED; the f32 rows the 3xTF32 bound."""
    import torch

    from panst3r_torch.core.profiling import profile_by_kernel
    from panst3r_torch.ops import flash_attention as fa
    from panst3r_torch.ops.flops import bound_ms

    def leaves(*ts):
        return [t.detach().clone().requires_grad_() for t in ts]

    def ref_grads(q, k, v, do, kw):
        """Autograd through the plain forward, in f32."""
        ins = leaves(q, k, v)
        fa.flash_mha_ref(*ins, **kw).backward(do)
        return tuple(t.grad for t in ins)

    for c in k5_cases(dtype, dev):
        q, k, v, do, kw = c["q"], c["k"], c["v"], c["do"], c["kw"]
        n = c["slices"]
        o, lse = fa.flash_mha(q, k, v, with_lse=True, **kw)
        n0 = fa.flash_mha_bwd.launches

        def fn():
            return fa.flash_mha_bwd(q, k, v, o, lse, do, **kw)

        def plain():
            if n is None:
                return fa.flash_mha_bwd_ref(q, k, v, o, lse, do, **kw)
            return _sliced(lambda *t: fa.flash_mha_bwd_ref(*t, **kw), n,
                           q, k, v, o, lse, do)

        got = fn()
        torch.cuda.synchronize()
        want = plain()
        if dtype == torch.float32:
            want_f32 = want
        else:
            f32 = [t.float() for t in (q, k, v, o, do)]
            want_f32 = fa.flash_mha_bwd_ref(*f32[:3], f32[3], lse, f32[4],
                                            **kw)
        check = {"kernel": _grad_check(got, want, want_f32, dtype)}
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))

        # K4 + K5 through autograd
        ins = leaves(q, k, v)
        fa.flash_mha(*ins, **kw).backward(do)
        auto = [t.grad for t in ins]
        f32 = [t.float() for t in (q, k, v, do)]
        if n is None:
            exact = ref_grads(*f32, kw)
        else:
            exact = _sliced(lambda *t: ref_grads(*t, kw), n, *f32)
        if dtype == torch.float32:
            pair = exact
        else:
            po, plse = fa.flash_mha_ref(q, k, v, with_lse=True, **kw)
            pair = fa.flash_mha_bwd_ref(q, k, v, po, plse, do, **kw)
        check["autograd"] = _grad_check(auto, pair, exact, dtype)
        del ins, auto, exact, pair, f32
        ok = all(g["ok"] and g["finite"] for part in check.values()
                 for g in part.values())
        reps = 5 if n is not None else 10
        row = {
            "phase": "kernels", "kernel": "flash_bwd", "case": c["case"],
            "dtype": dname, "shape": list(q.shape) + [k.shape[2]],
            "max_abs_err": err, "check": check,
            "kernel_ms": time_ms(fn, reps=reps),
            "plain_ms": time_ms(plain, reps=1 if n is not None else 3,
                                warmup=1),
            "library_ms": time_ms(_sdpa_bwd(c), reps=reps),
        }
        if n is not None:
            row["plain_by_slices_of"] = n
        prof = profile_by_kernel(fn, top=8)
        if not prof["top"]:                 # a trace that caught nothing
            prof = profile_by_kernel(fn, top=8)
        row["device_ms_by_kernel"] = {
            _short(t["name"]): t["ms"] for t in prof["top"]}
        row["device_ms"] = prof["device_busy_ms"]
        lib = profile_by_kernel(_sdpa_bwd(c), top=6)
        row["library_device_ms_by_kernel"] = {
            t["name"][:160]: t["ms"] for t in lib["top"]}
        row["max_splits"] = fa.dkv_splits(q.shape[2])
        row["by_split_tiles"] = _k5_splits(fn, reps, want, want_f32, dtype)
        row["launches"] = fa.flash_mha_bwd.launches - n0
        row["bound_ms"], row["bound_by"] = bound_ms(c["flops"], c["bytes"],
                                                    dname)
        if dtype == torch.float32:
            row["bound_ms_tf32x3"], row["bound_by_tf32x3"] = bound_ms(
                c["flops"], c["bytes"], "tf32x3")
        emit(row)
        if not ok:
            raise AssertionError(f"flash_bwd {c['case']} {dname}: {check}")
        rows[("flash_bwd", c["case"], dname)] = row
        del got, want, want_f32, o, lse
        torch.cuda.empty_cache()


def _k5_splits(fn, reps, want, want_f32, dtype) -> dict:
    """K5 timed (CUDA events, and the device time of one traced call) and
    held to its dtype's rule against the plain gradients ``want`` (bf16:
    with their f32 run ``want_f32``), with each fixed dkdv split of
    SPLIT_TILES_TRIED in turn (the module's ``SPLIT_TILES`` restored
    after)."""
    from panst3r_torch.core.profiling import profile_by_kernel
    from panst3r_torch.ops import flash_attention as fa

    keep, res = fa.SPLIT_TILES, {}
    try:
        for st in SPLIT_TILES_TRIED["flash_bwd"]:
            fa.SPLIT_TILES = st
            got = fn()
            check = _grad_check(got, want, want_f32, dtype)
            busy = profile_by_kernel(fn, top=8)["device_busy_ms"] \
                or profile_by_kernel(fn, top=8)["device_busy_ms"]
            res[str(st)] = {"ms": time_ms(fn, reps=reps), "device_ms": busy,
                            "ok": all(g["ok"] for g in check.values())}
            del got
    finally:
        fa.SPLIT_TILES = keep
    return res


def phase_autograd(dtype, dname: str, dev) -> None:
    """K1-K3 differentiate their plain versions (the JAX custom_vjps): the
    gradients through each wrapper on the card are bit-identical to those
    through the recomputed plain formula on the same inputs."""
    import torch

    from panst3r_torch.ops import masked_attention as ma
    from panst3r_torch.ops import tower_attention as ta
    from panst3r_torch.ops.attention import dot_product_attention
    from panst3r_torch.ops.rope import rope2d_tables

    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype) \
            .requires_grad_()

    B, N, C, H = 10, 768, 768, 12          # the v2 InputMixer at 10 views
    tabs = rope2d_tables(_grid_pos(B, 24, 32, dev), 64)
    qkv = rnd(B, N, 3 * C, s=QK_STD)
    kc, vc = rnd(B, 1, C, s=QK_STD), rnd(B, 1, C)
    valid = torch.ones(1, 3840, dtype=torch.bool, device=dev)
    valid[:, 1536:3072] = False
    bias = torch.where(valid, 0.0, float(torch.finfo(torch.float32).min))
    qpos = torch.randint(0, 32, (1, 768, 2), generator=g, device=dev)
    kpos = torch.randint(0, 32, (1, 3840, 2), generator=g, device=dev)
    qtab, ktab = rope2d_tables(qpos, 64), rope2d_tables(kpos, 64)
    cq, ck, cv = rnd(1, 768, C, s=QK_STD), rnd(1, 3840, C, s=QK_STD), \
        rnd(1, 3840, C)
    mq, mk, mv = rnd(2, 8, 200, 96, s=QK_STD), rnd(2, 8, 3840, 96, s=QK_STD), \
        rnd(2, 8, 3840, 96)
    blocked = torch.rand(2, 200, 3840, generator=g, device=dev) > 0.3
    cases = (
        ("tower_self", (qkv,), lambda x: ta.tower_self_attention(x, H, tabs),
         lambda x: ta.tower_self_attention_ref(x, H, tabs)),
        ("tower_self_cls", (qkv, kc, vc),
         lambda x, a, b: ta.tower_self_attention(x, H, cls_kv=(a, b)),
         lambda x, a, b: ta.tower_self_attention_ref(x, H, cls_kv=(a, b))),
        ("tower_cross", (cq, ck, cv),
         lambda a, b, c: ta.tower_cross_attention(a, b, c, qtab, ktab, bias),
         lambda a, b, c: ta.tower_cross_attention_ref(a, b, c, qtab, ktab,
                                                      bias)),
        ("masked_attn", (mq, mk, mv),
         lambda a, b, c: ma.masked_mha(a, b, c, blocked),
         lambda a, b, c: dot_product_attention(a, b, c,
                                               mask=~blocked[:, None])),
    )
    for name, ins, fn, plain in cases:
        out = fn(*ins)
        cot = torch.randn(out.shape, generator=g, device=dev).to(dtype)
        got = torch.autograd.grad(out, ins, cot)
        want = torch.autograd.grad(plain(*ins), ins, cot)
        equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        emit({"phase": "kernels", "autograd": name, "dtype": dname,
              "grads_bit_equal": equal,
              "grad_max_abs": [float(a.float().abs().max()) for a in got]})
        if not all(equal):
            raise AssertionError(f"{name} {dname}: card gradients differ "
                                 f"from the plain version's: {equal}")


def phase_kernels():
    import torch

    from panst3r_torch.core.profiling import profile_by_kernel
    from panst3r_torch.ops.flops import bound_ms

    dev = torch.device("cuda")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        phase_autograd(dtype, dname, dev)
        phase_k5(dtype, dname, dev, rows)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for c in kernel_cases(dtype, dev):
            name, label = c["kernel"], c["case"]
            counter = _counters()[name]
            n0 = counter.launches
            out, lse = _with_lse(c["fn"]())
            torch.cuda.synchronize()
            want, want_lse = _with_lse(c["ref"]())
            want = want.float()
            err = float((out.float() - want).abs().max())
            if dtype == torch.float32:
                def check_of(o, want=want):
                    e = float((o - want).abs().max())
                    return {"limit": F32_TOL, "ok": e <= F32_TOL}
            else:
                want_f32 = _with_lse(c["f32"]())[0].float()

                def check_of(o, want=want, want_f32=want_f32):
                    return bf16_check(o, want, want_f32)
            check = check_of(out.float())
            if lse is not None:
                lerr = float((lse - want_lse).abs().max())
                llim = LSE_RTOL * (1 + float(want_lse.abs().max()))
                check.update(lse_max_abs_err=lerr, lse_limit=llim,
                             ok=check["ok"] and lerr <= llim)
            finite = bool(torch.isfinite(out).all())
            reps = c.get("reps", 20)
            row = {
                "phase": "kernels", "kernel": name, "case": label,
                "dtype": dname, "shape": list(out.shape),
                "max_abs_err": err, "finite": finite, "check": check,
                "ref_max_abs": float(want.abs().max()),
                "ref_rms": float(want.square().mean().sqrt()),
                "kernel_ms": time_ms(c["fn"], reps=reps),
                "plain_ms": time_ms(c["ref"], reps=c.get("plain_reps", 5),
                                    warmup=1),
                "library_ms": (time_ms(c["lib"], reps=reps)
                               if c["lib"] is not None else None),
            }
            row["tflop_s"] = c["flops"] / row["kernel_ms"] / 1e9
            if "sdpa" in c:
                # no library call computes int8-score attention: SDPA on
                # the same shape in this dtype, for scale only
                row["sdpa_ms_for_scale"] = time_ms(c["sdpa"], reps=reps)
            if "vs_k2" in c:
                # how far int8 scores move the output from K2's (reported,
                # not a gate)
                a, b = out.float().flatten(), c["vs_k2"]().float().flatten()
                row["vs_tower_cross"] = {
                    "max_abs_diff": float((a - b).abs().max()),
                    "cosine": float(a @ b / (a.norm() * b.norm()))}
            if "pallas_sums" in c:
                # how far the kernel's (and its plain version's) bf16 sums
                # sit from the Pallas kernel's summation
                ps = c["pallas_sums"]().float()
                row["pallas_sums_max_abs_diff"] = {
                    "kernel": float((out.float() - ps).abs().max()),
                    "plain": float((want - ps).abs().max())}
            hopper = name in (SOURCE if dtype == torch.bfloat16
                              else F32_SOURCE)
            if hopper:
                # one traced call of the Hopper engine: device ms of its
                # pre-passes, main kernel and (K2, K3) split merge, beside
                # kernel_ms, which holds the wrapper's host time where
                # that is the longer
                prof = profile_by_kernel(c["fn"], top=8)
                if not prof["top"]:         # a trace that caught nothing
                    prof = profile_by_kernel(c["fn"], top=8)
                row["device_ms_by_kernel"] = {
                    _short(t["name"]): t["ms"] for t in prof["top"]}
                row["device_ms"] = prof["device_busy_ms"]
                if prof["device_busy_ms"]:
                    row["tflop_s_device"] = \
                        c["flops"] / prof["device_busy_ms"] / 1e9
                if dtype == torch.bfloat16:
                    row["cta_warpgroups"] = c["warpgroups"]
                elif c["lib"] is not None:
                    # which CUDA kernels the f32 yardstick runs (and their
                    # device ms): the kernel it is compared with
                    lib = profile_by_kernel(c["lib"], top=4)
                    row["library_device_ms_by_kernel"] = {
                        t["name"][:160]: t["ms"] for t in lib["top"]}
                if "splits" in c:
                    row["max_splits"] = c["splits"]
                    row["by_split_tiles"] = _split_tiles_tried(
                        c, reps, want, check_of)
            # the check plus warm-up and timed launches, from the counter
            row["launches"] = counter.launches - n0
            row["bound_ms"], row["bound_by"] = bound_ms(
                c["flops"], c["bytes"], dname, c.get("int8_ops", 0))
            if hopper and dtype == torch.float32:
                # the same work at the rate of the kernel's 3xTF32 products
                row["bound_ms_tf32x3"], row["bound_by_tf32x3"] = bound_ms(
                    c["flops"], c["bytes"], "tf32x3", c.get("int8_ops", 0))
            emit(row)
            if not (finite and check["ok"]):
                raise AssertionError(f"{name} {label} {dname}: max abs err "
                                     f"{err}, check {check}, finite={finite}")
            rows[(name, label, dname)] = row
            del out, want
            torch.cuda.empty_cache()
    return rows


def _short(name: str) -> str:
    """A CUDA kernel's name without its arguments and namespaces."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("::")[-1]


def _split_tiles_tried(c, reps, want, check_of) -> dict:
    """A K2 or K3 case timed (CUDA events over back-to-back calls, and the
    device time of one traced call), and held to its dtype's rule
    (``check_of``), with each fixed split of SPLIT_TILES_TRIED in turn (the
    module's ``SPLIT_TILES`` restored after)."""
    from panst3r_torch.core.profiling import profile_by_kernel
    from panst3r_torch.ops import masked_attention as ma
    from panst3r_torch.ops import tower_attention as ta

    mod = {"tower_cross": ta, "masked_attn": ma}[c["kernel"]]
    keep, res = mod.SPLIT_TILES, {}
    try:
        for st in SPLIT_TILES_TRIED[c["kernel"]]:
            mod.SPLIT_TILES = st
            out = c["fn"]().float()
            busy = profile_by_kernel(c["fn"], top=8)["device_busy_ms"] \
                or profile_by_kernel(c["fn"], top=8)["device_busy_ms"]
            res[str(st)] = {"ms": time_ms(c["fn"], reps=reps),
                            "device_ms": busy,
                            "ok": check_of(out)["ok"]}
    finally:
        mod.SPLIT_TILES = keep
    return res


def _with_lse(res):
    """(out, lse or None) from a K4 call with or without the LSE."""
    return res if isinstance(res, tuple) else (res, None)


# ------------------------------------------------------------ phases 2-4 --

def _config(preset: str, depth=None):
    """``panst3r_<preset>_config()``; with ``depth``, the encoder, DINO,
    decoder and mask transformer cut to that depth (the v2 mixer and LoftUp
    stay whole)."""
    from panst3r_torch.models import presets

    cfg = getattr(presets, f"panst3r_{preset}_config")()
    if depth is None:
        return cfg
    rep = dataclasses.replace
    return rep(cfg, encoder=rep(cfg.encoder, depth=depth),
               dino=rep(cfg.dino, depth=depth),
               decoder=rep(cfg.decoder, depth=depth),
               panoptic=rep(cfg.panoptic, mask_transformer=rep(
                   cfg.panoptic.mask_transformer, dec_layers=depth)))


def _inputs(V, H=384, W=512, ncls=32):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8),
            np.zeros(V, bool),
            rng.standard_normal((ncls, 768)).astype(np.float32))


def _counters():
    from panst3r_torch.ops.flash_attention import flash_mha, flash_mha_bwd
    from panst3r_torch.ops.masked_attention import masked_mha
    from panst3r_torch.ops.packed_attention import packed_mha
    from panst3r_torch.ops.tower_attention import (tower_cross_attention,
                                                   tower_cross_int8,
                                                   tower_self_attention)

    return {"tower_self": tower_self_attention,
            "tower_cross": tower_cross_attention,
            "tower_cross_int8": tower_cross_int8,
            "masked_attn": masked_mha,
            "flash_fwd": flash_mha,
            "flash_bwd": flash_mha_bwd,
            "packed_flash": packed_mha}


# the f32 engine's share of K1's and K2's launches on each main path, as
# read by ``_read_counts(path)``
F32_LAUNCHES = {}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_f32"):
            fn.launches_f32 = 0


def _read_counts(path=None):
    """Every kernel's launches; with ``path``, K1's and K2's f32 share is
    kept in F32_LAUNCHES[path] too."""
    fns = _counters()
    if path is not None:
        F32_LAUNCHES[path] = {k: fn.launches_f32 for k, fn in fns.items()
                              if hasattr(fn, "launches_f32")}
    return {k: fn.launches for k, fn in fns.items()}


def expected_launches(cfg, V, K, chunk):
    """Launches per kernel for one run_device: the towers per chunk, the
    decoder per memory update and render chunk, the mask transformer's
    masked layers once, and the v2 head's mixer blocks (K1) and LoftUp
    blocks (K4) once per panoptic call (keyframes, then the others)."""
    from panst3r_torch.models.upscalers import LoftUpUpscalerConfig

    n_chunks = math.ceil(V / chunk)
    n_updates = len(cfg.mem_batches(K))
    n_heads = 2 if V > K else 1
    dec = cfg.decoder.depth
    pan = cfg.panoptic
    mixer = pan.input_mixer.num_layers if pan.input_mixer else 0
    loftup = isinstance(pan.upscaler, LoftUpUpscalerConfig)
    return {
        "tower_self": n_chunks * (cfg.encoder.depth + cfg.dino.depth)
        + (n_updates + n_chunks) * dec + n_heads * mixer,
        "tower_cross": (n_updates + n_chunks) * dec,
        "masked_attn": pan.mask_transformer.dec_layers,
        "flash_fwd": n_heads * pan.upscaler.num_layers if loftup else 0,
        "flash_bwd": 0,
        "tower_cross_int8": 0,
        "packed_flash": 0,
    }


def expected_train_launches(cfg, V, grid):
    """Launches per kernel for one train micro-step (``PanSt3R.forward`` on
    all B·V views at once, then the backward): the towers once; the
    decoder per memory update and for the render, its cross-attention on
    K2 where the tower gate takes the shape, else on K4; the mask
    transformer's masked layers; the mixer (K1) and LoftUp (K4 with the
    LSE) once in the forward, and in the backward K5's two kernels per
    LoftUp block.  K1-K3 differentiate their plain versions: no launch in
    the backward."""
    from panst3r_torch.models.upscalers import LoftUpUpscalerConfig
    from panst3r_torch.ops.tower_attention import supports_tower_cross

    N = grid[0] * grid[1]
    dec = cfg.decoder
    calls = [(nb * N, V * N + nb * N) for nb in cfg.mem_batches(V)]
    calls.append((V * N, V * N))                          # the render
    k2 = sum(supports_tower_cross(nq, nk, dec.dim, dec.num_heads)
             for nq, nk in calls)
    pan = cfg.panoptic
    mixer = pan.input_mixer.num_layers if pan.input_mixer else 0
    loftup = pan.upscaler.num_layers \
        if isinstance(pan.upscaler, LoftUpUpscalerConfig) else 0
    return {
        "tower_self": cfg.encoder.depth + cfg.dino.depth
        + len(calls) * dec.depth + mixer,
        "tower_cross": k2 * dec.depth,
        "masked_attn": pan.mask_transformer.dec_layers,
        "flash_fwd": (len(calls) - k2) * dec.depth + loftup,
        "flash_bwd": 2 * loftup,
        "tower_cross_int8": 0,
        "packed_flash": 0,
    }


def phase_small(preset: str):
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.ops.flops import FlopCounter

    cfg = _config(preset, depth=2)
    V, K = 4, 3
    images, portrait, cls_emb = _inputs(V)
    cpu_model = build_model(cfg, device="cpu", seed=0)
    gpu_model = build_model(cfg, device="cuda", seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict())
    outs, flops = {}, {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = InferenceEngine(model, Bucket(384, 512), num_keyframes=K,
                              chunk=4, amp=False, device=name)
        _reset_counts()
        t0 = time.perf_counter()
        with FlopCounter() as fc:          # its time is in "seconds"
            outs[name] = eng.run(images, portrait, cls_emb)
        counts = _read_counts()
        flops[name] = fc.total
        emit({"phase": "small", "model": preset, "device": name,
              "seconds": time.perf_counter() - t0, "launches": counts,
              "flops": fc.total})
        if name == "cuda":
            want = expected_launches(cfg, V, K, 4)
            if counts != want:
                raise AssertionError(f"small {preset}: launches {counts} "
                                     f"!= {want}")
    a, b = outs["cuda"], outs["cpu"]
    row = {"phase": "small", "model": preset, "compare": "cuda_vs_cpu",
           "flops_equal": flops["cuda"] == flops["cpu"]}
    for key, atol, rtol in (("pointmaps_raw", 2e-4, 0.0),
                            ("pred_logits", 2e-3, 0.0),
                            ("pred_masks", 1e-2, 1e-2)):
        diff = np.abs(a[key] - b[key])
        row[key] = {"max_abs_err": float(diff.max()), "atol": atol,
                    "rtol": rtol,
                    "ok": bool(np.all(diff <= atol + rtol * np.abs(b[key])))}
    emit(row)
    bad = [k for k in ("pointmaps_raw", "pred_logits", "pred_masks")
           if not row[k]["ok"]]
    if not row["flops_equal"]:
        bad.append(f"flops {flops}")
    if bad or a["keyframes"] != b["keyframes"]:
        raise AssertionError(f"small {preset}: card and CPU disagree on "
                             f"{bad}")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()


def check_scene_flops(fl: float, preset: str, V: int, K: int) -> None:
    """Hold the port's count of a scene (``pipeline_flops``, computed
    outside the timed windows: it drives the stages once more, on zeros)
    to the JAX package's (``JAX_SCENE_FLOPS``)."""
    want = JAX_SCENE_FLOPS[(preset, V, K)]
    if abs(fl - want) > FLOPS_RTOL * want:
        raise AssertionError(f"{preset} V={V} K={K}: pipeline_flops {fl} != "
                             f"the JAX count {want}")


def phase_full(preset: str):
    """The full ``preset`` main path; returns its launch counts."""
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.core.profiling import profile_by_kernel
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.ops.flops import mfu
    from panst3r_torch.tools.mfu_report import stage_mfu

    cfg = _config(preset)
    V, K, chunk, H, W = 8, 4, 4, 384, 512
    images, portrait, cls_emb = _inputs(V, H, W)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    eng = InferenceEngine(model, Bucket(H, W), num_keyframes=K, chunk=chunk,
                          amp=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng.fuse(eng.run_device(images, portrait, cls_emb), (H, W))   # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    stage = {}
    t0 = time.perf_counter()
    out = eng.run_device(images, portrait, cls_emb, stage_times=stage)
    t1 = time.perf_counter()
    fused = eng.fuse(out, (H, W))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _read_counts(preset)
    stage["fuse"] = t2 - t1

    # the same run once more without stage synchronization
    t3 = time.perf_counter()
    eng.fuse(eng.run_device(images, portrait, cls_emb), (H, W))
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t3

    profile = profile_by_kernel(lambda: eng.fuse(
        eng.run_device(images, portrait, cls_emb), (H, W)))

    Q, ncls = cfg.panoptic.mask_transformer.num_queries, cls_emb.shape[0]
    shapes = {"pointmaps_raw": (V, H, W, 7), "pred_logits": (Q, ncls),
              "pred_masks": (V, Q, H // 2, W // 2)}
    checks = {k: (list(out[k].shape) == list(s),
                  bool(torch.isfinite(out[k].float()).all()))
              for k, s in shapes.items()}
    pan = fused[0]["pan"]
    want = expected_launches(cfg, V, K, chunk)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = eng.stage_flops(V, K)
    flops = sum(st.values())
    emit({"phase": preset, "views": V, "keyframes": out["keyframes"],
          "setup_s": setup_s, "stage_s": stage,
          "run_plus_fuse_s": t2 - t0, "run_plus_fuse_nosync_s": e2e,
          "peak_mem_gib": peak,
          "n_segments": len(fused[0]["segments_info"]),
          "pan_shape": list(pan.shape), "checks": checks,
          "launches": counts, "expected_launches": want,
          "flops": flops, "stage_flops": st,
          "jax_flops": JAX_SCENE_FLOPS[(preset, V, K)],
          "mfu": mfu(flops, e2e),
          "mfu_device": mfu(flops, profile["device_busy_ms"] / 1e3),
          "stage_mfu": stage_mfu(st, stage)})
    # the tracer slows the host; the untraced run's wall is the fairer
    # denominator for the device's idle share
    profile["device_idle_share_untraced"] = 1 - profile["device_busy_ms"] \
        / (e2e * 1e3)
    emit({"phase": f"{preset}_profile", **profile})
    bad = [k for k, (shape_ok, finite) in checks.items()
           if not (shape_ok and finite)]
    if bad or tuple(pan.shape) != (V, H, W):
        raise AssertionError(f"{preset}: wrong or non-finite outputs: {bad}")
    if counts != want:
        raise AssertionError(f"{preset}: launches {counts} != expected "
                             f"{want}")
    check_scene_flops(flops, preset, V, K)
    del eng, model, out, fused
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------ training --

def train_config(**overrides):
    """The train section of ``configs/train_v2.yaml`` (lr 1e-4, wd 0.05,
    betas (0.9, 0.95), accum_iter 2, max_instances 48, 12288 points,
    sigmoid labels, grid sampling, deep supervision) with warmup_epochs=0,
    so the first update is not at lr 0."""
    from panst3r_torch.engine.criterion import PanopticLossConfig
    from panst3r_torch.engine.train import TrainConfig

    kw = dict(epochs=200, warmup_epochs=0, lr=1e-4, blr=1.5e-4, min_lr=1e-6,
              weight_decay=0.05, betas=(0.9, 0.95), batch_size=2,
              accum_iter=2, clip_grad=None, seed=777, max_instances=48,
              loss=PanopticLossConfig(
                  class_weight=1.0, mask_weight=20.0, dice_weight=1.0,
                  no_obj_weight=0.1, num_points=12288, label_mode="sigmoid",
                  deep_supervision=True, matcher_sampling="grid",
                  loss_sampling="grid"))
    kw.update(overrides)
    return TrainConfig(**kw)


def train_batch(B, V, H, W, ncls, max_instances, seed):
    """A batch built the trainer's way (``data/loader.py::collate_batch``)
    from seeded per-view instance maps: per sample a dataset vocabulary of
    20 of the ``ncls`` classes and 12 instances, each a rectangle in the
    views that see it.  Returns (numpy batch, (ncls, 768) class
    embeddings)."""
    from panst3r_torch.data.loader import collate_batch

    rng = np.random.default_rng(seed)
    classes = [f"class{i}" for i in range(ncls)]
    samples = []
    for _ in range(B):
        local = rng.choice(ncls, size=min(ncls, 20), replace=False)
        inst_cls = rng.integers(0, len(local), 12)
        views = []
        for _ in range(V):
            inst = np.zeros((H, W), np.int64)
            cls = np.zeros((H, W), np.int64)
            for i in range(1, 13):
                if rng.random() < 0.2:
                    continue                      # not seen in this view
                h, w = rng.integers(H // 8, H // 2), rng.integers(W // 8,
                                                                   W // 2)
                y, x = rng.integers(0, H - h), rng.integers(0, W - w)
                inst[y:y + h, x:x + w] = i
                cls[y:y + h, x:x + w] = inst_cls[i - 1]
            views.append({"img": rng.random((H, W, 3)) * 2 - 1,
                          "pan_inst_id": inst, "pan_cls_id": cls,
                          "class_set": ";".join(classes[c] for c in local)})
        samples.append(views)
    return (collate_batch(samples, classes, max_instances),
            rng.standard_normal((ncls, 768)).astype(np.float32))


def _recording(optimizer_cls):
    class Recording(optimizer_cls):
        """Keeps the gradients each micro-step hands it (``grads``)."""

        def step(self):
            self.grads = {n: p.grad.detach().clone()
                          for n, p in self.params.items()}
            return super().step()
    return Recording


@contextlib.contextmanager
def _pinned_auction(calls: list, pin=None):
    """Stand in for ``engine.criterion.auction_lap``: each call runs the
    real auction and records its cost, span, column validity and own
    assignment (on the host) in ``calls``; with ``pin`` (one assignment
    per call, from another run) the call returns ``pin[i]`` on the cost's
    device instead of its own."""
    from panst3r_torch.engine import criterion

    real = criterion.auction_lap

    def lap(cost, span=None, col_valid=None, **kw):
        own = real(cost, span=span, col_valid=col_valid, **kw)
        calls.append({"cost": cost.detach().float().cpu(),
                      "span": None if span is None else span.detach().cpu(),
                      "valid": None if col_valid is None
                      else col_valid.detach().cpu(),
                      "assign": own.cpu()})
        if pin is None:
            return own
        return pin[len(calls) - 1].to(own.device)

    criterion.auction_lap = lap
    try:
        yield
    finally:
        criterion.auction_lap = real


def eps_optimal(call: dict) -> dict:
    """Whether one recorded auction's assignment is ε-optimal against its
    own cost: for each problem (..., R, C) with T valid columns, a
    matching of distinct rows whose total cost over the valid columns is
    within T·ε of the optimum (``scipy.optimize.linear_sum_assignment``
    in f64 on the host copy), ε = span·2e-3 / (C + 1) as
    ``ops/lap.py::auction_lap`` sets it."""
    from scipy.optimize import linear_sum_assignment

    cost = call["cost"].double()
    R, C = cost.shape[-2:]
    cost = cost.reshape(-1, R, C)
    n = cost.shape[0]
    assign = call["assign"].reshape(n, C)
    valid = (call["valid"].reshape(n, C) if call["valid"] is not None
             else np.ones((n, C), bool))
    span = (call["span"].double().reshape(-1).expand(n)
            if call["span"] is not None
            else cost.abs().amax(dim=(1, 2)))
    worst, ok = 0.0, True
    for i in range(n):
        cols = np.flatnonzero(np.asarray(valid[i]))
        if cols.size == 0:
            continue
        c = cost[i][:, cols].numpy()
        rows = assign[i].numpy()[cols]
        r, k = linear_sum_assignment(c)
        opt = float(c[r, k].sum())
        got = float(c[rows, np.arange(cols.size)].sum())
        eps = max(float(span[i]), 1e-6) * 2e-3 / (C + 1)
        limit = cols.size * eps
        distinct = len(set(rows.tolist())) == cols.size
        worst = max(worst, (got - opt) / limit)
        ok = ok and distinct and got - opt <= limit
    return {"ok": ok, "gap_over_limit": worst}


# (B, V, H, W, classes) of the two training phases
SMALL_TRAIN_SHAPE = (1, 3, 160, 512, 32)
TRAIN_SHAPE = (2, 5, 384, 512, 32)


def phase_small_train(shape=SMALL_TRAIN_SHAPE, depth: int = 2):
    """One v2 train step (full width at ``depth``, by default B=1, V=3 at
    160x512 with 32 classes, f32)
    on the CPU and then on the card from the same weights, batch and draws,
    under ONE assignment: the card's matcher runs its own auction, which
    is recorded and checked for ε-optimality against its own cost
    (``eps_optimal``), and then hands the CPU's indices to the card's
    losses (``_pinned_auction``).  The ε-optimal auction may return either
    of two near-tied assignments on the two devices, so equal assignments
    are reported, not required.  Loss within 1e-4 relative, each trainable
    gradient within 1e-4 of its leaf's max |grad| (plus 1e-6 of the largest
    gradient of all: a leaf whose true gradient is 0, such as a key
    projection's bias, holds only rounding), frozen parameters
    bit-identical after the update, and the card's launches as counted."""
    import torch

    from panst3r_torch.engine import train as tr
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.ops.flops import FlopCounter

    cfg = _config("v2", depth=depth)
    B, V, H, W, ncls = shape
    tcfg = train_config(accum_iter=1)
    batch, cls = train_batch(B, V, H, W, ncls, tcfg.max_instances, seed=3)
    g = torch.Generator().manual_seed(5)
    draws = [{"mask": torch.rand(2, generator=g) - 0.5}
             for _ in range(cfg.panoptic.mask_transformer.dec_layers + 1)]
    cpu_model = build_model(cfg, device="cpu", seed=0)
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    res, calls = {}, {"cpu": [], "cuda": []}
    for name in ("cpu", "cuda"):
        if name == "cuda":
            model = build_model(cfg, device="cuda", seed=1)
            model.load_state_dict(state)
        else:
            model = cpu_model
        mask = tr.trainable_mask(model)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = _recording(tr.Optimizer)(
            {n: p for n, p in model.named_parameters() if mask[n]}, tcfg, 1,
            1)
        step = tr.make_train_step(model, opt, tcfg.loss, (H // 16, W // 16))
        _reset_counts()
        t0 = time.perf_counter()
        # the count covers the backward, which the card runs on autograd's
        # device thread (K5's declaration and the matmuls' gradients)
        pin = ([c["assign"] for c in calls["cpu"]] if name == "cuda"
               else None)
        with FlopCounter() as fc, _pinned_auction(calls[name], pin):
            loss, det = step(tr.batch_to(batch, name),
                             torch.as_tensor(cls, device=name), draws=draws)
        counts = _read_counts()
        res[name] = dict(
            flops=fc.total, loss=float(loss), assign=det["assign"].cpu(),
            grads={n: x.cpu() for n, x in opt.grads.items()},
            frozen_same=all(torch.equal(p, before[n]) for n, p in
                            model.named_parameters() if not mask[n]),
            trained=sum(not torch.equal(p, before[n]) for n, p in
                        model.named_parameters() if mask[n]))
        emit({"phase": "small", "model": "v2_train", "device": name,
              "seconds": time.perf_counter() - t0, "loss": res[name]["loss"],
              "flops": fc.total, "launches": counts, "frozen_bit_identical":
              res[name]["frozen_same"],
              "trainable_leaves_changed": res[name]["trained"]})
        if name == "cuda":
            want = expected_train_launches(cfg, V, (H // 16, W // 16))
            if counts != want:
                raise AssertionError(f"small v2_train: launches {counts} "
                                     f"!= {want}")
    a, b = res["cuda"], res["cpu"]
    floor = 1e-6 * max(float(x.abs().max()) for x in b["grads"].values())
    worst, bad = 0.0, []
    for n, gp in b["grads"].items():
        err = float((a["grads"][n] - gp).abs().max())
        lim = 1e-4 * float(gp.abs().max()) + floor
        worst = max(worst, err / lim)
        if err > lim:
            bad.append(n)
    own = [eps_optimal(c) for c in calls["cuda"]]
    row = {"phase": "small", "model": "v2_train", "compare": "cuda_vs_cpu",
           "flops_equal": a["flops"] == b["flops"],
           "auction_calls": len(own),
           "card_assign_eps_optimal": bool(own) and all(o["ok"] for o in own),
           "card_gap_over_limit_max": max((o["gap_over_limit"] for o in own),
                                          default=None),
           "card_own_assign_equal_cpu": all(
               torch.equal(c["assign"], d["assign"])
               for c, d in zip(calls["cuda"], calls["cpu"])),
           "loss_rel_err": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
           "grad_err_over_limit_max": worst, "grads_bad": bad[:40],
           "n_trainable_leaves": len(b["grads"])}
    emit(row)
    if not (row["card_assign_eps_optimal"]
            and len(calls["cuda"]) == len(calls["cpu"])
            and torch.equal(a["assign"], b["assign"])
            and row["loss_rel_err"] <= 1e-4 and not bad
            and a["frozen_same"] and b["frozen_same"]
            and row["flops_equal"]):
        raise AssertionError(f"small v2_train: card and CPU disagree: {row}")
    del cpu_model, model
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _flash_shapes():
    """[B, H, Nq, Nk, D] of every K4 and K5 kernel launch made inside."""
    from panst3r_torch.ops import flash_attention as fa

    seen = {"flash_fwd": [], "flash_bwd": []}
    real_fwd, real_bwd = fa._flash_fwd_kernel, fa._flash_bwd_kernel

    def shape(q, k):
        return list(q.shape[:3]) + [k.shape[2], q.shape[3]]

    def fwd(q, k, *a, **kw):
        seen["flash_fwd"].append(shape(q, k))
        return real_fwd(q, k, *a, **kw)

    def bwd(q, k, *a, **kw):
        seen["flash_bwd"].append(shape(q, k))
        return real_bwd(q, k, *a, **kw)

    fa._flash_fwd_kernel, fa._flash_bwd_kernel = fwd, bwd
    try:
        yield seen
    finally:
        fa._flash_fwd_kernel, fa._flash_bwd_kernel = real_fwd, real_bwd


def phase_train_v2():
    """The slice's path at full width and depth: ``panst3r_v2_config()``
    with seeded random weights and the frozen towers stored in bf16, the
    train_v2 recipe, B=2 x V=5 views at 384x512 with 32 classes, four
    micro-steps (two updates).  Returns the launches of one micro-step."""
    import torch

    from panst3r_torch.core import rng as prng
    from panst3r_torch.core.profiling import profile_by_kernel
    from panst3r_torch.engine import train as tr
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.ops.flops import count_flops, mfu

    cfg = _config("v2")
    B, V, H, W, ncls = TRAIN_SHAPE
    tcfg = train_config()
    t0 = time.perf_counter()
    model = tr.cast_frozen_params(build_model(cfg, seed=0))
    mask = tr.trainable_mask(model)
    train = {n: p for n, p in model.named_parameters() if mask[n]}
    opt = tr.Optimizer(train, tcfg, 1, steps_per_epoch=8)
    step = tr.make_train_step(model, opt, tcfg.loss, (H // 16, W // 16))
    host = [train_batch(B, V, H, W, ncls, tcfg.max_instances, seed=10 + i)
            for i in range(2)]
    cls_emb = torch.as_tensor(host[0][1], device="cuda")
    batches = [tr.batch_to(b, "cuda") for b, _ in host]
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not mask[n]}
    train0 = {n: p.detach().clone() for n, p in train.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    want = expected_train_launches(cfg, V, (H // 16, W // 16))
    torch.cuda.reset_peak_memory_stats()
    steps, counts_all, zero_grad = [], [], None
    for i in range(4):
        gen = prng.generator(tcfg.seed, 0, i, device="cuda")
        _reset_counts()
        with _flash_shapes() as shapes:
            t0 = time.perf_counter()
            loss, det = step(batches[i % 2], cls_emb, gen)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        if i == 0:
            flash_shapes = shapes
        steps.append({"seconds": seconds,
                      "loss": float(loss), "updated": opt.mini_step == 0,
                      "valid_targets": int(batches[i % 2]["targets"].valid
                                           .sum())})
        counts_all.append(_read_counts("train_v2" if i == 0 else None))
        if i == 0:      # the accumulator holds this micro-step's gradients
            zero_grad = [n for n, a in opt.acc.items()
                         if not float(a.abs().max()) > 0]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    changed = sum(not torch.equal(p, train0[n]) for n, p in train.items())
    frozen_same = all(torch.equal(p, frozen0[n]) for n, p in
                      model.named_parameters() if not mask[n])
    split = {}
    step(batches[0], cls_emb, prng.generator(tcfg.seed, 0, 4, device="cuda"),
         stage_times=split)
    # 40 names: the f32 K1-K5's pre-passes beside their main kernels
    profile = profile_by_kernel(lambda: step(batches[1], cls_emb, prng.generator(
        tcfg.seed, 0, 5, device="cuda")), top=40)
    # one more micro-step under the counter (the counterpart of
    # tools/train_step_bench.py:196-205): forward, criterion and backward
    flops = count_flops(step, batches[0], cls_emb,
                        prng.generator(tcfg.seed, 0, 6, device="cuda"))
    secs = sorted(s["seconds"] for s in steps[1:])
    median = secs[len(secs) // 2]
    emit({"phase": "train_v2", "batch": B, "views": V, "hw": [H, W],
          "setup_s": setup_s, "steps": steps,
          "median_step_s_2_to_4": median,
          # the step computes in f32 (frozen towers stored in bf16): MFU
          # against the dense bf16 peak (the convention) and the f32 one
          "flops": flops, "mfu": mfu(flops, median),
          "mfu_f32_peak": mfu(flops, median, "float32"),
          "stage_s": split, "peak_mem_gib": peak,
          "n_trainable_leaves": len(train),
          "trainable_params": sum(p.numel() for p in train.values()),
          "frozen_params": sum(p.numel() for n, p in model.named_parameters()
                               if not mask[n]),
          "zero_grad_leaves": zero_grad, "trainable_leaves_changed": changed,
          "frozen_bit_identical": frozen_same,
          "launches": counts_all, "expected_launches": want,
          # the kernels phase's loftup_train_full cases take this shape
          "flash_shapes_step_1": flash_shapes})
    emit({"phase": "train_v2_profile", **profile})
    if not all(math.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"train_v2: non-finite loss {steps}")
    if zero_grad or changed != len(train) or not frozen_same:
        raise AssertionError(
            f"train_v2: leaves without gradient {zero_grad[:10]}, "
            f"{changed}/{len(train)} trainable leaves changed, frozen "
            f"unchanged: {frozen_same}")
    if any(c != want for c in counts_all):
        raise AssertionError(f"train_v2: launches {counts_all} != {want}")
    if any(sh != list(LOFTUP_TRAIN_FULL) for sh in flash_shapes["flash_bwd"]):
        raise AssertionError(f"train_v2: K5 ran at {flash_shapes}, the "
                             f"kernels phase at {LOFTUP_TRAIN_FULL}")
    del model, opt, step, batches, frozen0, train0
    torch.cuda.empty_cache()
    return counts_all[0]


# ------------------------------------------------------------- serving --

@contextlib.contextmanager
def _env(name: str, value: str):
    """Set an environment variable for the block (the engine reads
    ``PANST3R_KV_INT8`` at call time, as the JAX package does)."""
    import os

    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def expected_serve_launches(cfg, V, K, N, path="serve", upload_chunk=None,
                            render_chunk=4, int8=False):
    """Launches per kernel for one scene through a serve path: the towers
    once over all V views (``serve``) or once per upload chunk (``latency``,
    ``overlap``); the decoder once per memory update and per render call,
    the render one call over all V views except in ``overlap``, which
    renders the keyframes ``render_chunk`` views a call and the other views
    in one call; a render call runs K2-int8 where its gate opens (``int8``
    and Nq >= 16384); the mask transformer once (the keyframe call); the
    v2 head's mixer and LoftUp once per head call."""
    from panst3r_torch.models.upscalers import LoftUpUpscalerConfig
    from panst3r_torch.ops.tower_attention import _INT8_MIN_NQ

    n_updates = len(cfg.mem_batches(K))
    towers = 1 if path == "serve" else math.ceil(V / upload_chunk)
    if path == "overlap" and V > K:
        renders = [min(render_chunk, K - s) * N
                   for s in range(0, K, render_chunk)] + [(V - K) * N]
    else:
        renders = [V * N]
    r8 = sum(int8 and nq >= _INT8_MIN_NQ for nq in renders)
    dec = cfg.decoder.depth
    pan = cfg.panoptic
    n_heads = 2 if V > K else 1
    mixer = pan.input_mixer.num_layers if pan.input_mixer else 0
    loftup = isinstance(pan.upscaler, LoftUpUpscalerConfig)
    return {
        "tower_self": towers * (cfg.encoder.depth + cfg.dino.depth)
        + (n_updates + len(renders)) * dec + n_heads * mixer,
        "tower_cross": (n_updates + len(renders) - r8) * dec,
        "masked_attn": pan.mask_transformer.dec_layers,
        "flash_fwd": n_heads * pan.upscaler.num_layers if loftup else 0,
        "flash_bwd": 0,
        "tower_cross_int8": r8 * dec,
        "packed_flash": 0,
    }


def _timed(fn, *args, **kwargs):
    """(host numpy wire, seconds) of one synchronized serve call, the
    wire's download included."""
    import torch

    from panst3r_torch.engine.inference import fetch_wire

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wire = fetch_wire(fn(*args, **kwargs))
    return wire, time.perf_counter() - t0


def wire_agreement(a: dict, b: dict, conf_atol: float) -> dict:
    """pan, seg_ids, labels and selected equal; conf within ``conf_atol``
    (both unpacked wires)."""
    eq = {k: bool(np.array_equal(a[k], b[k]))
          for k in ("pan", "seg_ids", "labels", "selected")}
    cdiff = float(np.abs(a["conf"] - b["conf"]).max())
    eq["conf_max_abs_diff"] = cdiff
    eq["ok"] = all(eq[k] for k in ("pan", "seg_ids", "labels", "selected")) \
        and cdiff <= conf_atol + 1e-6
    return eq


def _pooled(conf, s):
    V, H, W = conf.shape
    c = conf.reshape(V, H // s, s, W // s, s).mean((2, 4))
    return c.repeat(s, axis=1).repeat(s, axis=2)


def segment_classes(eng, images, portrait, ncls: int = 32,
                    alive: int = 4) -> np.ndarray:
    """(ncls, lang_dim) class embeddings under which only queries
    0..alive-1 pass the class threshold of fusion on this scene.  With
    random weights every query passes it with random class embeddings,
    the queries split the pixels, none passes the overlap test and every
    map is void; a few live queries give real segments, so the wire
    comparisons compare something.  The embeddings enter only the class
    logits, which are linear in them: one probe with the identity gives
    the logits' matrix, least squares the embeddings for logits of +4
    (query i, class i) and -8 elsewhere."""
    lang = eng.model.config.panoptic.mask_transformer.lang_dim
    probe = eng.run_fused(images, portrait, np.eye(lang, dtype=np.float32))
    probe = probe["pred_logits"].double().cpu().numpy()       # (Q, lang)
    target = np.tile(-8.0 - 0.5 * np.arange(ncls), (probe.shape[0], 1))
    for i in range(alive):
        target[i, i] = 4.0
    return np.linalg.lstsq(probe, target, rcond=None)[0].T.astype(np.float32)


def phase_serve():
    """The v1 serving wire at full width and depth (bf16, random weights
    from seed 0, V=8 / K=4 at 384x512, 32 classes): ``serve_device`` with
    every ``fusion_res`` and with cameras, the same from packed YUV420,
    both latency paths (upload chunk 2) and ``serve_stream`` over 8 scenes
    at queue depth 2, each held to the checks of tests/test_serve.py, with
    launch counts, times, wire bytes and peak memory.  Returns the launches
    of one ``serve_device`` scene."""
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine, fetch_wire
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.ops.flops import mfu
    from panst3r_torch.ops.image import rgb_to_yuv420, yuv420_decode

    cfg = _config("v1")
    V, K, H, W, chunk = 8, 4, 384, 512, 4
    images, portrait, cls_emb = _inputs(V, H, W)
    eng = InferenceEngine(build_model(cfg, seed=0), Bucket(H, W),
                          num_keyframes=K, chunk=chunk, amp=True)
    N = eng.n_tokens
    cls_emb = segment_classes(eng, images, portrait)
    port, cls = (torch.as_tensor(a, device="cuda") for a in (portrait,
                                                             cls_emb))
    unpack = eng.unpack_wire
    checks, secs, nbytes, counts = {}, {}, {}, {}
    eng.serve_device(images, port, cls)                        # warm-up

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    wire, secs["serve_device_full"] = _timed(eng.serve_device, images, port,
                                             cls)
    counts["serve"] = _read_counts("serve")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    nbytes["full"] = wire.nbytes
    full = unpack(wire, V)
    pan, conf, seg, lab, sel = (fetch_wire(t) for t in eng.fuse_device(
        eng.run_fused(images, port, cls), (H, W)))
    fused = {"pan": pan[0], "conf": conf[0], "seg_ids": seg[0],
             "labels": lab[0], "selected": sel[0].astype(bool)}
    checks["full_vs_fuse_device"] = wire_agreement(full, fused, 1.0 / 255)
    checks["segments"] = {"n": int(full["selected"].sum()),
                          "pan_assigned_share": float((full["pan"] > 0)
                                                      .mean())}
    checks["segments"]["ok"] = checks["segments"]["n"] > 0

    for fr, s in (("hybrid", 2), ("hybrid4", 4), ("mask", 0)):
        w, secs[f"serve_device_{fr}"] = _timed(eng.serve_device, images,
                                               port, cls, fusion_res=fr)
        nbytes[fr] = w.nbytes
        dec = unpack(w, V)
        if s:
            ref = dict(full, conf=_pooled(full["conf"], s))
            checks[fr] = wire_agreement(dec, ref, 2.0 / 255)
        else:
            out = eng.run_fused(images, port, cls)
            hm, wm = out["pred_masks"].shape[-2:]
            p_half = fetch_wire(eng.fuse_device(out, (hm, wm))[0])[0]
            up = p_half.repeat(H // hm, axis=1).repeat(W // wm, axis=2)
            checks[fr] = {"pan_vs_fuse_at_mask_res":
                          bool(np.array_equal(dec["pan"], up)),
                          "shape": list(dec["pan"].shape)}
            checks[fr]["ok"] = checks[fr]["pan_vs_fuse_at_mask_res"]

    w, secs["serve_device_cameras"] = _timed(
        eng.serve_device, images, port, cls, with_cameras=True)
    dec = unpack(w, V, with_cameras=True)
    checks["cameras"] = {
        "pan_equal": bool(np.array_equal(dec["pan"], full["pan"])),
        "finite": bool(np.isfinite(dec["focals"]).all()
                       and np.isfinite(dec["cam2world"]).all()),
        "last_row": bool(np.array_equal(dec["cam2world"][:, 3],
                                        np.tile([0, 0, 0, 1.0], (V, 1))))}
    checks["cameras"]["ok"] = all(checks["cameras"].values())

    packed = rgb_to_yuv420(images)
    decoded = fetch_wire(yuv420_decode(torch.as_tensor(packed,
                                                       device="cuda")))
    yuv = {}
    for fr in ("full", "hybrid", "hybrid4", "mask"):
        wp, secs[f"serve_device_yuv_{fr}"] = _timed(
            eng.serve_device, packed, port, cls, fusion_res=fr)
        wd = fetch_wire(eng.serve_device(decoded, port, cls, fusion_res=fr))
        yuv[fr] = bool(np.array_equal(wp, wd))
        if fr == "full":
            w_yuv = wp
    checks["yuv_equals_decoded_rgb"] = dict(yuv, ok=all(yuv.values()))
    nbytes["upload_rgb"], nbytes["upload_yuv"] = images.nbytes, packed.nbytes

    lat = {}
    for name, fn, path in (
            ("latency", eng.serve_latency_device, "latency"),
            ("overlap", eng.serve_latency_overlap, "overlap")):
        fn(images, port, cls, chunk=2)                         # warm-up
        _reset_counts()
        w, secs[f"serve_{name}"] = _timed(fn, images, port, cls, chunk=2)
        counts[name] = _read_counts()
        want = expected_serve_launches(cfg, V, K, N, path, upload_chunk=2,
                                       render_chunk=chunk)
        lat[name] = wire_agreement(unpack(w, V), full, 1.0 / 255)
        lat[name]["launches_ok"] = counts[name] == want
        wy = fetch_wire(fn(packed, port, cls, chunk=2))
        lat[name]["yuv_wire_equal"] = bool(np.array_equal(wy, w_yuv))
        lat[name]["ok"] = lat[name]["ok"] and lat[name]["launches_ok"]
    checks.update(lat)

    scenes = [np.ascontiguousarray(np.roll(images, s + 1, axis=0))
              for s in range(8)]
    seq_t0 = time.perf_counter()
    seq = [unpack(fetch_wire(eng.serve_device(sc, port, cls,
                                              fusion_res="hybrid")), V)
           for sc in scenes]
    secs["sequential_8_scenes"] = time.perf_counter() - seq_t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = list(eng.serve_stream(scenes, port, cls, queue_depth=2,
                                   fusion_res="hybrid"))
    secs["stream_8_scenes"] = time.perf_counter() - t0
    same = [wire_agreement(a, b, 0.0)["ok"] for a, b in zip(stream, seq)]
    checks["stream"] = {"n": len(stream),
                        "ok": len(stream) == len(seq) and all(same)}

    want = expected_serve_launches(cfg, V, K, N)
    checks["launches"] = {"serve": counts["serve"], "expected": want,
                          "ok": counts["serve"] == want}
    flops = eng.pipeline_flops(V, K)
    emit({"phase": "serve", "views": V, "keyframes": K, "hw": [H, W],
          "flops": flops, "mfu": mfu(flops, secs["serve_device_full"]),
          "scene_s": secs, "stream_views_per_s": 8 * V /
          secs["stream_8_scenes"], "sequential_views_per_s":
          8 * V / secs["sequential_8_scenes"], "wire_bytes": nbytes,
          "peak_mem_gib": peak, "launches": counts, "checks": checks})
    bad = [k for k, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"serve: failed checks {bad}: "
                             f"{ {k: checks[k] for k in bad} }")
    check_scene_flops(flops, "v1", V, K)
    del eng
    torch.cuda.empty_cache()
    return counts["serve"]


def phase_serve_long():
    """The long-memory serving regime: v1 at full width and depth, V=50
    views and K=16 keyframes at 384x512 from packed YUV420, the hybrid wire,
    ``PANST3R_KV_INT8=1``: one ``serve_device`` scene (K2-int8 exactly once
    per decoder layer, in the one render call of Nq = 50·768), the stream
    over 4 scenes at queue depth 6, and the same scene with int8 off (the
    share of pan pixels the two wires agree on, and the largest change int8
    makes to the raw outputs of ``run_fused``, are reported, not gated).
    Returns the launches of the int8 scene."""
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.core.profiling import profile_by_kernel
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.ops.flops import mfu
    from panst3r_torch.ops.image import rgb_to_yuv420

    cfg = _config("v1")
    V, K, H, W = 50, 16, 384, 512
    images, portrait, cls_emb = _inputs(V, H, W)
    scenes = [rgb_to_yuv420(np.roll(images, 7 * s, axis=0))
              for s in range(4)]
    eng = InferenceEngine(build_model(cfg, seed=0), Bucket(H, W),
                          num_keyframes=K, chunk=4, amp=True)
    with _env("PANST3R_KV_INT8", "1"):
        cls_emb = segment_classes(eng, scenes[0], portrait)
    port, cls = (torch.as_tensor(a, device="cuda") for a in (portrait,
                                                             cls_emb))
    kw = dict(fusion_res="hybrid")
    want = expected_serve_launches(cfg, V, K, eng.n_tokens, int8=True)
    res = {"phase": "serve_long", "views": V, "keyframes": K, "hw": [H, W],
           "input": "yuv420", "wire": "hybrid"}
    with _env("PANST3R_KV_INT8", "1"):
        eng.serve_device(scenes[0], port, cls, **kw)           # warm-up
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        wire8, res["scene_s"] = _timed(eng.serve_device, scenes[0], port,
                                       cls, **kw)
        counts = _read_counts("serve_long")
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        _reset_counts()
        t0 = time.perf_counter()
        stream = list(eng.serve_stream(scenes, port, cls, queue_depth=6,
                                       **kw))
        res["stream_4_scenes_s"] = time.perf_counter() - t0
        stream_counts = _read_counts()
        profile = profile_by_kernel(lambda: eng.serve_device(scenes[0], port, cls,
                                                    **kw).cpu())
        out8 = eng.run_fused(scenes[0], port, cls)
    with _env("PANST3R_KV_INT8", "0"):
        _reset_counts()
        wire16, res["scene_int8_off_s"] = _timed(eng.serve_device, scenes[0],
                                                 port, cls, **kw)
        counts_off = _read_counts()
        out16 = eng.run_fused(scenes[0], port, cls)
    # how far int8 scores move the pipeline's raw outputs (reported)
    res["int8_vs_bf16_max_abs_diff"] = {
        k: float((out8[k].float() - out16[k].float()).abs().max())
        for k in ("pointmaps_raw", "pred_logits", "pred_masks")}
    res["int8_vs_bf16_max_abs"] = {
        k: float(out16[k].float().abs().max())
        for k in ("pointmaps_raw", "pred_logits", "pred_masks")}
    del out8, out16
    dec8, dec16 = eng.unpack_wire(wire8, V), eng.unpack_wire(wire16, V)
    flops = eng.pipeline_flops(V, K)
    res.update(
        flops=flops, mfu=mfu(flops, res["scene_s"]),
        mfu_device=mfu(flops, profile["device_busy_ms"] / 1e3),
        stream_views_per_s=4 * V / res["stream_4_scenes_s"],
        scene_views_per_s=V / res["scene_s"], wire_bytes=wire8.nbytes,
        upload_bytes=scenes[0].nbytes, launches=counts,
        expected_launches=want, stream_launches=stream_counts,
        launches_int8_off=counts_off,
        pan_agree_int8_vs_bf16=float((dec8["pan"] == dec16["pan"]).mean()),
        stream_first_equals_scene=wire_agreement(stream[0], dec8, 0.0)["ok"],
        n_segments=int(dec8["selected"].sum()),
        n_segments_int8_off=int(dec16["selected"].sum()),
        pan_assigned_share=float((dec8["pan"] > 0).mean()))
    emit(res)
    emit({"phase": "serve_long_profile", **profile})
    want_off = dict(want, tower_cross=want["tower_cross"]
                    + want["tower_cross_int8"], tower_cross_int8=0)
    want_stream = {k: 4 * n for k, n in want.items()}
    if counts != want or counts_off != want_off \
            or stream_counts != want_stream:
        raise AssertionError(
            f"serve_long: launches {counts} / off {counts_off} / stream "
            f"{stream_counts} != {want} / {want_off} / {want_stream}")
    if not (res["stream_first_equals_scene"] and len(stream) == 4
            and dec8["pan"].shape == (V, H, W)):
        raise AssertionError(f"serve_long: wrong outputs {res}")
    check_scene_flops(flops, "v1", V, K)
    del eng
    torch.cuda.empty_cache()
    return counts


def phase_small_serve():
    """``serve_device(with_cameras=True)`` at full width and depth 2 (f32,
    V=4 / K=3 at 384x512) on the card and on the CPU from the same weights:
    seg_ids, labels and selected equal, pan equal on >= 99.9% of pixels,
    focals and cam2world within 1e-3 of the CPU's, relative to the largest
    |value| of each."""
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    cfg = _config("v1", depth=2)
    V, K = 4, 3
    images, portrait, cls_emb = _inputs(V)
    cpu_model = build_model(cfg, device="cpu", seed=0)
    gpu_model = build_model(cfg, device="cuda", seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict())
    dec = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        eng = InferenceEngine(model, Bucket(384, 512), num_keyframes=K,
                              chunk=4, amp=False, device=name)
        if name == "cpu":
            cls_emb = segment_classes(eng, images, portrait)
        dec[name] = eng.unpack_wire(
            eng.serve_device(images, portrait, cls_emb, with_cameras=True),
            V, with_cameras=True)
    a, b = dec["cuda"], dec["cpu"]
    row = {"phase": "small", "model": "v1_serve", "compare": "cuda_vs_cpu",
           "pan_agree": float((a["pan"] == b["pan"]).mean()),
           "n_segments": int(b["selected"].sum())}
    for k in ("seg_ids", "labels", "selected"):
        row[k + "_equal"] = bool(np.array_equal(a[k], b[k]))
    for k in ("focals", "cam2world"):
        row[k + "_rel_err"] = float(np.abs(a[k] - b[k]).max()
                                    / np.abs(b[k]).max())
    emit(row)
    if not (row["pan_agree"] >= 0.999 and row["n_segments"] > 0
            and row["seg_ids_equal"]
            and row["labels_equal"] and row["selected_equal"]
            and row["focals_rel_err"] <= 1e-3
            and row["cam2world_rel_err"] <= 1e-3):
        raise AssertionError(f"small v1_serve: card and CPU disagree {row}")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()


# ------------------------------------------------------------- A/B tool --

def phase_ab_packed():
    """K6's path: the A/B tool (``panst3r_torch/tools/
    ab_attention_packed.py``) at full shape (B=8, H=16, N=768, D=64, bf16,
    24 layers): one run of the ``packed`` variant launches K6 exactly once
    per layer (the bf16 kernel) and nothing else, its output is finite, K6
    agrees with K4 (the tool's parity check), and every variant's ms per
    layer and the card's bound per layer are emitted; then one run of the
    ``packed`` variant in f32 launches the f32 K6 once per layer.  Returns
    the launches of the bf16 and of the f32 ``packed`` run."""
    import torch

    from panst3r_torch.ops.packed_attention import packed_mha
    from panst3r_torch.tools import ab_attention_packed as ab

    layers, reps = 24, 5
    x, kx, vx, tabs = ab.inputs(torch.device("cuda"))
    packed = ab.variants(kx, vx, tabs)["packed"]
    with torch.inference_mode():
        _reset_counts()
        out = ab.run_layers(packed, x, layers)
        torch.cuda.synchronize()
        counts = _read_counts("ab_packed")
    finite = bool(torch.isfinite(out).all())
    n0 = packed_mha.launches
    res = ab.run("cuda", layers=layers, reps=reps)
    # the parity call, the warm-up run and the timed runs
    timed_launches = packed_mha.launches - n0
    want = dict.fromkeys(counts, 0)
    want["packed_flash"] = layers
    emit({"phase": "ab_packed", **res, "launches": counts,
          "expected_launches": want, "finite": finite,
          "timed_launches": timed_launches,
          "parity_limit": AB_PARITY_ATOL})
    if counts != want or timed_launches != 1 + layers * (1 + reps):
        raise AssertionError(f"ab_packed: launches {counts} (timed "
                             f"{timed_launches}) != {want}")
    if not finite or res["packed_vs_unpacked_max_abs_err"] > AB_PARITY_ATOL:
        raise AssertionError(f"ab_packed: finite={finite}, K6 vs K4 "
                             f"{res['packed_vs_unpacked_max_abs_err']}")
    if F32_LAUNCHES["ab_packed"]["packed_flash"]:
        raise AssertionError("ab_packed: bf16 run reached the f32 K6")

    x, kx, vx, tabs = ab.inputs(torch.device("cuda"), torch.float32)
    packed = ab.variants(kx, vx, tabs)["packed"]
    with torch.inference_mode():
        _reset_counts()
        out = ab.run_layers(packed, x, layers)
        torch.cuda.synchronize()
        counts32 = _read_counts("ab_packed_f32")
    finite = bool(torch.isfinite(out).all())
    f32 = F32_LAUNCHES["ab_packed_f32"]["packed_flash"]
    emit({"phase": "ab_packed", "dtype": "float32", "launches": counts32,
          "launches_f32": f32, "finite": finite})
    if counts32 != want or f32 != layers or not finite:
        raise AssertionError(f"ab_packed f32: launches {counts32} (f32 "
                             f"{f32}) != {want}, finite={finite}")
    torch.cuda.empty_cache()
    return counts, counts32


# ------------------------------------------------------------------ main --

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from panst3r_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a panst3r checkout ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    logs = cuda_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs),
          "ptxas": [ln.strip() for text in logs.values()
                    for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]})
    for name in sorted({*SOURCE.values(), *F32_SOURCE.values()}):
        # the Hopper libraries: each kernel's registers, shared memory and
        # spills, and any warning (setmaxnreg ignored, wgmma serialized)
        emit({"phase": "build", "library": name, "ptxas": [
            ln.strip() for ln in logs.get(name, "").splitlines()
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "arning"))]})

    rows = phase_kernels() if "kernels" in phases else {}
    if "small" in phases:
        phase_small("v1")
        phase_small("v2")
        phase_small_train()
        phase_small_serve()
    launches = {p: phase_full(p) for p in ("v1", "v2") if p in phases}
    if "train_v2" in phases:
        launches["train_v2"] = phase_train_v2()
    if "serve" in phases:
        launches["serve"] = phase_serve()
    if "serve_long" in phases:
        launches["serve_long"] = phase_serve_long()
    if "ab_packed" in phases:
        launches["ab_packed"], launches["ab_packed_f32"] = phase_ab_packed()

    def count(entry, path):
        """An entry's launches on a path: its wrapper's launches in the
        entry's dtype (each wrapper's ``launches_f32`` is the f32
        share)."""
        name = entry.removesuffix("_f32").removesuffix("_bf16")
        n = launches.get(path, {}).get(name)
        if n is None:
            return n
        f32 = F32_LAUNCHES.get(path, {}).get(name, 0)
        return f32 if MAIN_CASE[entry][1] == "float32" else n - f32

    kernels = []
    for entry, (case, dname) in MAIN_CASE.items():
        name = entry.removesuffix("_f32").removesuffix("_bf16")
        r = rows.get((name, case, dname), {})
        # each kernel's count on its path: K6 on the A/B tool (bf16, and
        # its f32 run), K4, K5 and the f32 K1-K3 on train_v2, NO_PATH on
        # none, the others on serve_long
        path = {"packed_flash": "ab_packed",
                "packed_flash_f32": "ab_packed_f32",
                "flash_fwd": "train_v2", "flash_bwd": "train_v2",
                "tower_self_f32": "train_v2", "tower_cross_f32": "train_v2",
                "masked_attn_f32": "train_v2"}.get(entry, "serve_long")
        if entry in NO_PATH:
            path = None
        source = (F32_SOURCE if dname == "float32" else SOURCE).get(name,
                                                                      name)
        by_path = {p: count(entry, p) for p in launches}
        kernels.append({
            "name": entry, "route": "cuda",
            "source": f"panst3r_torch/csrc/{source}.cu",
            "replaces": REPLACES[entry], "main_path": path,
            "launches": (sum(n or 0 for n in by_path.values())
                         if path is None else count(entry, path)),
            "launches_by_path": by_path,
            "case": case, "dtype": dname,
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("kernel_ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"),
        })
        if "bound_ms_tf32x3" in r:
            kernels[-1]["bound_ms_tf32x3"] = r["bound_ms_tf32x3"]
    emit({"kernels": kernels})
    idle = [k["name"] for k in kernels
            if k["main_path"] is not None and not k["launches"]]
    stray = [k["name"] for k in kernels
             if k["main_path"] is None and k["launches"]]
    if phases == set(PHASES) and idle:
        raise AssertionError(f"not launched on their main paths: {idle}")
    if stray:
        raise AssertionError(f"launched on a path that should not run them: "
                             f"{stray}")
    if phases != set(PHASES):
        print("chip_smoke: partial run, no result line", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
