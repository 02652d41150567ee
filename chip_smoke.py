#!/usr/bin/env python3
"""Smoke run of panst3r_torch on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py            # every phase; needs one card
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --phases train_v2
    python3 chip_smoke.py --phases text,train_app
    python3 chip_smoke.py --phases slam,slam_app,eval
    python3 chip_smoke.py --phases multi_gpu
    python3 chip_smoke.py --phases tiny,dino_large
    python3 chip_smoke.py --phases checkpoint

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
   K2 and K3 at ``serve_many``'s batch of two scenes (``update_many``,
   ``render_many``, ``mask_transformer_many``);
   gradients through K1-K3 on the card bit-equal to their plain formulas';
2. ``small``: v1 and v2 widths at depth 2 (v2 with its full mixer and
   LoftUp), f32, V=4 / K=3 at 384x512, the same seeded weights on the card
   (kernels) and on the CPU (plain versions), outputs and FLOP counts
   (``ops/flops.py``) compared; one v2 train step (B=1, V=3 at 160x512),
   card against CPU, its FLOP count included; one v1 serve wire with
   cameras, card against CPU; ``serve_many_device`` of two scenes, v1 and
   v2 (K4 in LoftUp), each scene at the serve wire's limits; memory
   refinement (one pass) and a two-stage v1 mask transformer (under one
   query selection), card against CPU;
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
   a profile by kernel, one micro-step's FLOPs and MFU, and the
   micro-step repeated on the same weights and batch with every gradient
   bit-equal (``train_repeat``);
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
8. ``multibucket``: the mixed-aspect v1 main path
   (``MultiBucketEngine.run`` + ``fuse``, bf16, V=8 uint8 views over the
   384x512, 336x512 and 160x512 buckets, one portrait view, K=4 linspace
   keyframes in three buckets sharing one memory of 2080 slots): times,
   peak memory, shapes and finiteness, launches held to
   ``expected_multibucket_launches``; then the same scene at depth 2 in
   f32 for v1 and v2, card against CPU at ``small``'s limits; the
   ``kernels`` phase holds K1, K2 and K3 at this scene's shapes
   (``encoder_672``, ``encoder_320``, ``render_mixed``,
   ``mask_transformer_mixed``);
9. ``demo``: full v2 weights saved by ``core/checkpoint.py`` into a
   temporary directory, ``apps/common.py::build_engine`` from it (weights,
   classes and class embeddings restored), ``apps/demo.py``'s
   ``reconstruct_scene`` with QUBO and standard v2 fusion on V=8 uint8
   views, and ``export_scene``'s PLY and cameras.json, with finite poses;
   neither PIL nor PyYAML is imported;
10. ``serve_many``: ``serve_many_device`` of S=2 v1 scenes of V=8 (K=4,
   bf16, hybrid wire with cameras; RGB and packed YUV420), each scene's
   wire against its own ``serve_device`` wire, launches those of one
   scene (the memory build, the render and the heads run at batch 2),
   seconds against two sequential ``serve_device`` calls, peak memory;
   a wire that differs is traced to the first module whose output depends
   on the batch (``_batch_trace``);
11. ``refine``: ``build_memory(refine_iterations=1)`` at full v1 width,
   launches as the call structure implies, seconds against no refinement;
12. ``retrieval_head``: ``run_device(use_retrieval=True)`` with a seeded
   ``RetrievalHead`` (``RETRIEVAL_WIDTHS``, through
   ``port_retrieval_checkpoint``): the keyframes of the host selection on
   the same tokens, ``asmk_similarity``'s seconds;
13. ``serve_app``: the serving daemon (``apps/serve.py``) in a thread on
   127.0.0.1 with the engine on the card: ``/healthz``, one
   ``/reconstruct?cameras=1`` equal to the unpacked ``serve_device`` wire,
   a ``/slam/frame`` before ``/slam/start`` refused;
14. ``text``: the SigLIP text tower at full width over the demo's class
   prompts (K4 f32, 12 launches a call, with a finfo.min key row whose
   pad tiles are dead; the ``kernels`` phase holds K4 at that call,
   ``text_siglip``) and the CLIP tower (no launch), each card against
   CPU, and ``TextEncoder``'s tables from the card towers;
15. ``train_app``: the training entry point (``apps/train.py::train``)
   at full v2 width and depth with configs/train_v2.yaml's recipe (five
   buckets, four spawned loader workers) on a ScanNet++-layout dataset
   the phase writes: two epochs straight, and one epoch plus a resumed
   run, compared (the final weights bit-equal); launches as ``expected_train_launches`` sums over the
   buckets drawn; micro-step seconds per bucket, loader seconds per
   batch, the idle share of one traced epoch; the ``final`` checkpoint
   through ``build_engine`` into one ``run_device`` scene;
16. ``slam``: ``apps/slam.py::run_slam`` at full v1 width (bf16, chunk 1)
   on 40 drifting uint8 frames with the pose graph and BA, launches held
   to ``expected_slam_launches``, frames/s and ms per frame; a 60-frame
   session with at most 6 keyframes, ``stream`` against ``process``
   through the evictions; both backends twice, bit for bit; depth 2, f32,
   card against CPU (the ``kernels`` phase holds K2 at the frontend's
   memory with an evicted window, ``slam_memory``);
17. ``slam_app``: the daemon's ``/slam/start``, six ``/slam/frame`` and
   ``/slam/finish`` over HTTP, the poses against ``run_slam``'s;
18. ``eval``: ``apps/eval.py::main`` at v1 on a ScanNet++ scene (standard
   v2 fusion, QUBO) and at v2 on a rendered-test scene (K4 f32), the
   train app with ``eval_every=1``, depth 2 f32 card against CPU;
19. ``multi_gpu``: the multi-device layer rehearsed with two gloo ranks
   on the one card (``core/dryrun.py``'s workers, each sharded path
   against the same work on one rank): ``serve_device`` under
   ``model`` = 2 at full v1 width and depth (V=4), in f32 (raw outputs
   within 1e-4 relative) and in bf16 (decoded pan on > 99% of pixels and
   conf within 0.05 where the segment agrees, both dtypes; launches
   those of one rank's scene), ``serve_many_device`` of two V=8 scenes
   over ``data`` = 2 and the memory split over ``mem`` = 2 (each rank
   holding half of the bank; wires byte-equal), a v2 micro-step at depth
   2 (f32) over ``data`` = 2 (loss within 1e-6 relative),
   ``fusion_sharded`` at V=8 and full mask size (bit-exact) and
   ``bundle_adjust_sharded`` at SLAM's sizes; then one NCCL rank runs the
   collectives and the data-parallel step.  Any error of a rank fails the
   phase, a collective gloo refuses on a CUDA tensor too (the error is
   printed: that check was not rehearsed on the card);
20. ``tiny``: the registered ``tiny_config`` and ``tiny_v2_config`` as
   they are (head dims 16, 12 and 8: every attention on K4 or K3 at a
   padded head dim, DINO's split cls on K4 with its LSE) at 384x512, V=4,
   K=3, card against CPU at ``small``'s limits with the launches their
   call structure implies, and one tiny_v2 train micro-step card against
   CPU (K5 at 8 and 16); the ``kernels`` phase holds K3, K4 (with tables,
   with the LSE) and K5 at each head dim of ``PAD_DIMS`` (8, 16, 48, 80,
   128; cases ``d<D>*``) against their plain versions;
21. ``dino_large``: v1 at full width and depth at Bucket(480, 640) (1200
   patches, past K1's 1024: the encoder and the decoder's self-attention
   on K4 with tables, DINO's split cls on K4 with its LSE, 24 launches a
   pass), V=8 / K=4, launches as implied; DINO-L alone at depth 2 at that
   bucket, card against CPU (``DINO_RTOL``); the ``kernels`` phase holds
   K4 at those calls (``dino_1200_lse``, ``encoder_1200_rope``);
22. ``checkpoint``: the checkpoint interop tools at full v1 and v2 width
   and depth on a reference-named state_dict synthesized from a seed
   (``tests/torch_reference_sd.py``) and saved as a ``.pth``: the port's
   command line (``python -m panst3r_torch.port_checkpoint``),
   ``tools/verify_port.py`` on the card (verdict ok; its ``card_parity``
   stage, each stack card against CPU in f32 at ``small``'s and
   ``DINO_RTOL``'s limits, and its ``forward`` stage run, their K1/K2/K3
   (and LoftUp's K4) launches as the call structure implies), the
   command line's ``ported_params.npz`` loaded into a model, the
   reverse export of that model reproducing the file bit for bit, and
   ``build_engine`` on the file with one V=8 ``serve_device`` scene at
   384x512, launches as implied; the seconds of each step and the
   host's peak memory;

then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failed phase raises, and the script exits non-zero
without the last line.  Without a CUDA device, or outside a checkout, it
exits 2.
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
    "flash_fwd_bf16": "panst3r_tpu/ops/pallas/flash_attention.py:171 "
                      "(bf16)",
    "flash_bwd": "panst3r_tpu/ops/pallas/flash_attention_bwd.py:115",
    "flash_bwd_bf16": "panst3r_tpu/ops/pallas/flash_attention_bwd.py:115 "
                      "(bf16)",
    "packed_flash": "tools/ab_attention_packed.py:84",
    "packed_flash_f32": "tools/ab_attention_packed.py:84 (f32)",
}
PHASES = ("kernels", "small", "v1", "v2", "train_v2", "serve", "serve_long",
          "ab_packed", "multibucket", "demo", "serve_many", "refine",
          "retrieval_head", "serve_app", "text", "train_app", "slam",
          "slam_app", "eval", "multi_gpu", "tiny", "dino_large", "checkpoint")
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
# run); the bf16 K4 at DINO's split-cls call past 1024 patches (phase
# dino_large, where the towers run bf16 under amp); two kernels no path
# runs (NO_PATH): the f32 K2-int8 (serving is bf16) at the long render,
# the bf16 K5 (LoftUp runs f32) at LoftUp's training shape
MAIN_CASE = {"tower_self": ("encoder_rope", "bfloat16"),
             "tower_cross": ("render", "bfloat16"),
             "tower_self_f32": ("encoder_train", "float32"),
             "tower_cross_f32": ("render_train", "float32"),
             "tower_cross_int8": ("render_long", "bfloat16"),
             "tower_cross_int8_f32": ("render_long", "float32"),
             "masked_attn": ("mask_transformer", "bfloat16"),
             "masked_attn_f32": ("mask_transformer_train", "float32"),
             "flash_fwd": ("loftup", "float32"),
             "flash_fwd_bf16": ("dino_1200_lse", "bfloat16"),
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
# head dims the kernels pad to their instantiations (the tiny presets' 8
# and 16; 48, 80) and D = 128, each a case of K3, K4 and K5 (``d<D>*``)
PAD_DIMS = (8, 16, 48, 80, 128)
# phase dino_large's bucket: 30 x 40 = 1200 patches, past K1's 1024
DINO_LARGE_HW = (480, 640)
# DINO-L alone at depth 2 at that bucket, card against CPU (f32, TF32
# off): max abs error within this share of the output's max |value|
DINO_RTOL = 1e-4
# card against CPU in f32 (``small`` and every phase that reuses its
# limits): (output, atol, rtol)
SMALL_LIMITS = (("pointmaps_raw", 2e-4, 0.0), ("pred_logits", 2e-3, 0.0),
                ("pred_masks", 1e-2, 1e-2))
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
# The mixed-aspect scene of phase multibucket: V=8 views over three
# DEFAULT_BUCKETS entries, view 5 a portrait view stored landscape; its
# linspace keyframes 0, 2, 4, 7 lie in three buckets, their token grids
# 24x32, 21x32, 10x32 and 10x32 (a shared memory of 2080 slots)
MB_SHAPES = ((384, 512), (384, 512), (336, 512), (336, 512), (160, 512),
             (336, 512), (384, 512), (160, 512))
MB_PORTRAIT = (5,)
MB_KEYFRAME_GRIDS = (24, 21, 10, 10)
# The text towers' limit, card against CPU on the pooled output (f32; the
# tower's GEMMs in f32 with TF32 off, K4 on the card)
TEXT_TOL = 1e-4
# The train app's resumed run against its straight run (phase train_app).
# The final weights must be bit-equal: the micro-step repeats run to run
# (train_v2's ``train_repeat``).  Losses within RESUME_LOSS_RTOL
# (relative); final weights within 2 * lr * updates: an Adam step moves a
# parameter by at most about lr (|m_hat / sqrt(v_hat)| <= 1 for
# betas (0.9, 0.95) over the first updates), so two runs part by at most
# twice that per update
RESUME_LOSS_RTOL = 1e-4


class WordPieces:
    """A stand-in for a SigLIP sentencepiece model (none is in the
    repository): one id per word, from its letters, within the
    vocabulary and clear of the special ids."""

    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        return [2 + sum((i + 1) * ord(c) for i, c in enumerate(w))
                % (self.vocab_size - 2) for w in text.split()]


def text_prompts(model: str = "siglip") -> list[str]:
    """The demo's class names in ``model``'s prompt template (the prompts
    ``TextEncoder`` sends its tower)."""
    from panst3r_torch.apps.demo import SCANNET_CLASSES
    from panst3r_torch.models.text_encoder import MODEL_CONFIGS

    return [MODEL_CONFIGS[model]["template"].format(c)
            for c in SCANNET_CLASSES]


def text_prompt_mask() -> np.ndarray:
    """(C, 64) attention mask of ``text_prompts`` as the SigLIP tower takes
    them (``tokenize_siglip`` with ``WordPieces``)."""
    from panst3r_torch.models.siglip_text import tokenize_siglip

    return tokenize_siglip(text_prompts(), WordPieces())[1]


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
    def k2(label, B, Nq, Nk, valid, qpos=None, kpos=None):
        C = 768
        q, k = rnd(B, Nq, C, s=QK_STD), rnd(B, Nk, C, s=QK_STD)
        v = rnd(B, Nk, C)
        if qpos is None:
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
    # the mixed-bucket scene's shapes (phase multibucket, chunk 4), drawn
    # last: the encoder over the 3 views of the 336x512 bucket and the 2 of
    # the 160x512 bucket; the render of its largest 21x32 group (the 2
    # non-keyframe views 3 and 5) against the keyframe memory of the grids
    # 24x32, 21x32, 10x32 and 10x32 (2080 slots: a ragged last key tile);
    # the mask transformer over those 2080 keyframe tokens
    for label, B, grid in (("encoder_672", 3, (21, 32)),
                           ("encoder_320", 2, (10, 32))):
        _k1_case(cases, label, B, 1024, 16, True, False, rnd, g, es, dev,
                 grid=grid)
    kpos = torch.cat([_grid_pos(1, gh, 32, dev) for gh in MB_KEYFRAME_GRIDS],
                     1)
    k2("render_mixed", 1, 2 * 672, kpos.shape[1],
       torch.ones(1, kpos.shape[1], dtype=torch.bool, device=dev),
       qpos=_grid_pos(1, 21, 32, dev).repeat(1, 2, 1), kpos=kpos)
    _k3_case(cases, "mask_transformer_mixed", kpos.shape[1], rnd, g, es, dev)
    # serve_many's batch of S = 2 scenes (phase serve_many), drawn last:
    # each scene's second +1 memory update (768 queries against its
    # 3072-slot memory, 1536 slots valid, and the view's own 768 keys), the
    # render of both scenes' 8 views against their full memories, the mask
    # transformer over both scenes' 4 x 768 keyframe tokens
    valid = torch.ones(2, 3840, dtype=torch.bool, device=dev)
    valid[:, 1536:3072] = False
    k2("update_many", 2, 768, 3840, valid)
    k2("render_many", 2, 6144, 3072,
       torch.ones(2, 3072, dtype=torch.bool, device=dev))
    _k3_case(cases, "mask_transformer_many", 3072, rnd, g, es, dev, B=2)
    # the SigLIP text tower's attention (phase text), drawn last
    cases += _k4_cases(rnd, g, es, dtype, dev, None, text=True)
    # the SLAM frontend's render (phase slam), drawn last: one frame's 768
    # queries against a memory sized for 64 keyframes of 768 tokens in
    # which six windows were filled and the second then evicted (a dead
    # window inside the live range; windows 7-64 never filled), grid
    # positions as the frontend banks them
    valid = torch.zeros(1, 64 * 768, dtype=torch.bool, device=dev)
    valid[:, :768] = True
    valid[:, 2 * 768:6 * 768] = True
    k2("slam_memory", 1, 768, 64 * 768, valid,
       qpos=_grid_pos(1, 24, 32, dev),
       kpos=_grid_pos(1, 24, 32, dev).repeat(1, 64, 1))
    # the head dims the kernels pad (PAD_DIMS), drawn last: K4 with tables
    # and with its LSE at a tiny tower's shape, K3 at the mask
    # transformer's 200 x 3072 with 4 heads; then DINO-L at phase
    # dino_large's bucket (K4 with its LSE over 1200 patches, and the
    # encoder's K4 with tables)
    for D in PAD_DIMS:
        cases += _k4_cases(rnd, g, es, dtype, dev, None, head_dim=D)
        _k3_case(cases, f"d{D}", 3072, rnd, g, es, dev, H=4, D=D,
                 splits=False)
    cases += _k4_cases(rnd, g, es, dtype, dev, None, dino=True)
    return cases


def _k1_case(cases, label, B, C, H, rope, cls, rnd, g, es, dev,
             grid=(24, 32)):
    """Appends K1's case at (B, gh*gw tokens, C) with H heads of 64, RoPE
    tables of the grid and a cls key/value as asked; the library call is
    SDPA on the heads split out (without the cls column)."""
    import torch
    import torch.nn.functional as F

    from panst3r_torch.ops import tower_attention as ta
    from panst3r_torch.ops.rope import rope2d_tables

    def f32(t):
        return None if t is None else t.float()

    def heads(t, D):
        B, N, C = t.shape
        return t.reshape(B, N, C // D, D).transpose(1, 2).contiguous()

    N = grid[0] * grid[1]
    qkv = torch.cat([rnd(B, N, 2 * C, s=QK_STD), rnd(B, N, C)], -1)
    tabs = rope2d_tables(_grid_pos(B, *grid, dev), 64) if rope else None
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


def _k3_case(cases, label, Nk, rnd, g, es, dev, B=1, H=8, D=96,
             splits=True):
    """Appends K3's case at (B, H, 200, Nk), by default 8 heads of D=96
    (each batch with spans of its own); returns its mask.  ``splits``:
    time each split of SPLIT_TILES_TRIED too."""
    import torch
    import torch.nn.functional as F

    from panst3r_torch.ops import masked_attention as ma

    def f32(t):
        return t.float()

    Nq = 200
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
    _, count = ma.plan_blocks(blocked, ma.BLOCK_Q, ma.BLOCK_K, 256,
                              ma.BLOCK_K * -(-Nk // ma.BLOCK_K))
    live_tiles = int(count.sum())
    nkb = -(-Nk // 64)                  # a ragged last key block counts
    padded = F.pad(blocked, (0, nkb * 64 - Nk), value=True)
    live_kb = int((~padded.view(B, Nq, nkb, 64).all(-1).all(1)).sum())
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
        warpgroups=1))
    if splits:
        cases[-1]["splits"] = ma.max_splits(Nk)
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


def _k4_cases(rnd, g, es, dtype, dev, blocked, full=False, text=False,
              head_dim=None, dino=False):
    """K4 at the v2 LoftUp shape (split-heads views of the projections, as
    the block passes them), with ragged dead keys, with the dense
    mask-transformer bias, with RoPE tables and with the LSE; with
    ``full``, only at train_v2's LoftUp batch (its plain version per slice
    of PLAIN_SLICE views); with ``text``, only at the SigLIP text tower's
    call over the demo's class prompts (phase text); with ``head_dim``,
    only at that head dim, with tables and with the LSE (4 views x 4 heads
    x 768 tokens: a tiny preset's tower); with ``dino``, only at phase
    dino_large's shapes (4 views x 16 heads x 1200 patches of 64: DINO's
    split-cls call with its LSE, and the encoder's with tables)."""
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

    if text:
        # 12 heads of 64 over the 64 padded positions of each prompt; the
        # (C, 1, 1, 64) finfo.min bias on the pad keys travels as a key
        # row, and every prompt is shorter than 32 tokens: whole dead key
        # tiles
        mask = torch.as_tensor(text_prompt_mask(), device=dev)
        B, N = mask.shape
        H, D = 12, 64
        bias = torch.where(mask > 0, 0.0, NEG_INF)[:, None, None, :]
        return [case("text_siglip", heads(B, N, H, D, QK_STD),
                     heads(B, N, H, D, QK_STD), heads(B, N, H, D),
                     bias=bias, live_keys=int(mask.sum()),
                     lib_mask=(mask > 0)[:, None, None, :])]
    if head_dim is not None:
        B, H, N, D = 4, 4, 768, head_dim
        tabs = rope2d_tables(_grid_pos(B, 24, 32, dev), D)
        return [case(f"d{D}_rope", heads(B, N, H, D, QK_STD),
                     heads(B, N, H, D, QK_STD), heads(B, N, H, D),
                     rope=(*tabs, *tabs)),
                case(f"d{D}_lse", heads(B, N, H, D, QK_STD),
                     heads(B, N, H, D, QK_STD), heads(B, N, H, D),
                     with_lse=True)]
    if dino:
        B, H, D = 4, 16, 64
        gh, gw = DINO_LARGE_HW[0] // 16, DINO_LARGE_HW[1] // 16
        N = gh * gw
        tabs = rope2d_tables(_grid_pos(B, gh, gw, dev), D)
        return [case("dino_1200_lse", heads(B, N, H, D, QK_STD),
                     heads(B, N, H, D, QK_STD), heads(B, N, H, D),
                     with_lse=True),
                case("encoder_1200_rope", heads(B, N, H, D, QK_STD),
                     heads(B, N, H, D, QK_STD), heads(B, N, H, D),
                     rope=(*tabs, *tabs))]
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
    # the head dims K5 pads (PAD_DIMS), drawn last: 2 views x 4 heads x
    # 768 tokens with RoPE tables (a tiny preset's mixer, LoftUp at 8)
    for D in PAD_DIMS:
        B, H, N = 2, 4, 768
        tabs = rope2d_tables(_grid_pos(B, 24, 32, dev), D)
        case(f"d{D}_rope", heads(B, N, H, D, QK_STD),
             heads(B, N, H, D, QK_STD), heads(B, N, H, D),
             rope=(*tabs, *tabs))
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


def _inputs(V, H=384, W=512, ncls=32, lang_dim=768):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8),
            np.zeros(V, bool),
            rng.standard_normal((ncls, lang_dim)).astype(np.float32))


def _counters():
    from panst3r_torch.core.dryrun import kernel_wrappers

    return kernel_wrappers()


# the f32 engine's share of K1's and K2's launches on each main path, as
# read by ``_read_counts(path)``
F32_LAUNCHES = {}


def _read_f32():
    """Each kernel's f32 launches (the wrappers with an f32 share)."""
    return {k: fn.launches_f32 for k, fn in _counters().items()
            if hasattr(fn, "launches_f32")}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_f32"):
            fn.launches_f32 = 0


def _read_counts(path=None):
    """Every kernel's launches; with ``path``, K1's and K2's f32 share is
    kept in F32_LAUNCHES[path] too."""
    if path is not None:
        F32_LAUNCHES[path] = _read_f32()
    return {k: fn.launches for k, fn in _counters().items()}


def _self_kernel(N: int, C: int, heads: int):
    """The kernel a self-attention over N tokens of width C takes: K1 in
    its gate, else K4, or none on the JAX tiny-shape branch (N < 256)."""
    from panst3r_torch.ops.tower_attention import supports_tower_attention

    if supports_tower_attention(N, C, heads):
        return "tower_self"
    return None if N < 256 else "flash_fwd"


def _dino_kernel(N: int, dino):
    """DINO's attention over N patches and the cls token: K1 with the cls
    key in its gate, else K4 (split cls: K4 with its LSE, always; the
    concatenated path as any self-attention over N + 1 tokens)."""
    from panst3r_torch.ops.tower_attention import supports_tower_attention

    if not dino.split_cls:
        return _self_kernel(N + 1, dino.embed_dim, dino.num_heads)
    return ("tower_self" if supports_tower_attention(N, dino.embed_dim,
                                                     dino.num_heads)
            else "flash_fwd")


def _launch_table(*sites) -> dict:
    """Launches per kernel from (kernel or None, count) pairs."""
    out = dict.fromkeys(("tower_self", "tower_cross", "masked_attn",
                         "flash_fwd", "flash_bwd", "tower_cross_int8",
                         "packed_flash"), 0)
    for kernel, n in sites:
        if kernel is not None:
            out[kernel] += n
    return out


def expected_launches(cfg, V, K, chunk, grid=(24, 32)):
    """Launches per kernel for one run_device at a bucket of ``grid``
    patches: the towers per chunk, the decoder per memory update and
    render chunk, the mask transformer's masked layers once, and the v2
    head's mixer blocks and LoftUp blocks (K4) once per panoptic call
    (keyframes, then the others).  Each attention takes the kernel its
    gate gives it: K1/K2 at the published widths at 384x512, K4 past 1024
    tokens or for heads not of 64 (the tiny presets); the decoder's
    cross-attention K2 where its gate takes the widths (every call has
    Nq·Nk >= 256², a key bias: never the tiny branch), else K4."""
    from panst3r_torch.models.upscalers import LoftUpUpscalerConfig
    from panst3r_torch.ops.tower_attention import supports_tower_cross

    N = grid[0] * grid[1]
    n_chunks = math.ceil(V / chunk)
    n_updates = len(cfg.mem_batches(K))
    n_heads = 2 if V > K else 1
    enc, dec, pan = cfg.encoder, cfg.decoder, cfg.panoptic
    dec_calls = (n_updates + n_chunks) * dec.depth
    mix = pan.input_mixer
    loftup = isinstance(pan.upscaler, LoftUpUpscalerConfig)
    return _launch_table(
        (_self_kernel(N, enc.embed_dim, enc.num_heads),
         n_chunks * enc.depth),
        (_dino_kernel(N, cfg.dino), n_chunks * cfg.dino.depth),
        (_self_kernel(N, dec.dim, dec.num_heads), dec_calls),
        ("tower_cross" if supports_tower_cross(N, N, dec.dim, dec.num_heads)
         else "flash_fwd", dec_calls),
        ("masked_attn", pan.mask_transformer.dec_layers),
        (None if mix is None else _self_kernel(N, mix.hidden_dim,
                                               mix.num_heads),
         n_heads * (mix.num_layers if mix else 0)),
        ("flash_fwd", n_heads * pan.upscaler.num_layers if loftup else 0))


def expected_train_launches(cfg, V, grid):
    """Launches per kernel for one train micro-step (``PanSt3R.forward`` on
    all B·V views at once, then the backward): the towers once; the
    decoder per memory update and for the render, its cross-attention on
    K2 where the tower gate takes the shape, else on K4; the mask
    transformer's masked layers; the mixer and LoftUp (K4 with the LSE)
    once in the forward, each attention on the kernel its gate gives it
    (``expected_launches``), and in the backward K5's two kernels per
    trainable K4 call (LoftUp's blocks; the mixer's where it is off K1's
    gate, as in the tiny presets).  K1-K3 differentiate their plain
    versions: no launch in the backward."""
    from panst3r_torch.models.upscalers import LoftUpUpscalerConfig
    from panst3r_torch.ops.tower_attention import supports_tower_cross

    N = grid[0] * grid[1]
    enc, dec, pan = cfg.encoder, cfg.decoder, cfg.panoptic
    calls = [(nb * N, V * N + nb * N) for nb in cfg.mem_batches(V)]
    calls.append((V * N, V * N))                          # the render
    k2 = sum(supports_tower_cross(nq, nk, dec.dim, dec.num_heads)
             for nq, nk in calls)
    mix = pan.input_mixer
    mixer = _self_kernel(N, mix.hidden_dim, mix.num_heads) if mix else None
    mixer_layers = mix.num_layers if mix else 0
    loftup = pan.upscaler.num_layers \
        if isinstance(pan.upscaler, LoftUpUpscalerConfig) else 0
    k4_trained = loftup + (mixer_layers if mixer == "flash_fwd" else 0)
    return _launch_table(
        (_self_kernel(N, enc.embed_dim, enc.num_heads), enc.depth),
        (_dino_kernel(N, cfg.dino), cfg.dino.depth),
        (_self_kernel(N, dec.dim, dec.num_heads), len(calls) * dec.depth),
        ("tower_cross", k2 * dec.depth),
        ("flash_fwd", (len(calls) - k2) * dec.depth + loftup),
        (mixer, mixer_layers),
        ("masked_attn", pan.mask_transformer.dec_layers),
        ("flash_bwd", 2 * k4_trained))


def phase_small(preset: str, cfg=None):
    """``preset`` at depth 2 (or the config ``cfg`` as it is), f32, V=4 /
    K=3 at 384x512, on the card and on the CPU from the same weights:
    outputs and FLOP counts compared, the card's launches as
    ``expected_launches`` implies.  Returns the card's launches and their
    f32 share."""
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.ops.flops import FlopCounter

    cfg = _config(preset, depth=2) if cfg is None else cfg
    V, K = 4, 3
    images, portrait, cls_emb = _inputs(
        V, lang_dim=cfg.panoptic.mask_transformer.lang_dim)
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
            card = counts, _read_f32()
            want = expected_launches(cfg, V, K, 4)
            if counts != want:
                raise AssertionError(f"small {preset}: launches {counts} "
                                     f"!= {want}")
    a, b = outs["cuda"], outs["cpu"]
    row = {"phase": "small", "model": preset, "compare": "cuda_vs_cpu",
           "flops_equal": flops["cuda"] == flops["cpu"]}
    for key, atol, rtol in SMALL_LIMITS:
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
    return card


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


def train_batch(B, V, H, W, ncls, max_instances, seed, lang_dim=768):
    """A batch built the trainer's way (``data/loader.py::collate_batch``)
    from seeded per-view instance maps: per sample a dataset vocabulary of
    20 of the ``ncls`` classes and 12 instances, each a rectangle in the
    views that see it.  Returns (numpy batch, (ncls, lang_dim) class
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
            rng.standard_normal((ncls, lang_dim)).astype(np.float32))


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


def phase_small_train(shape=SMALL_TRAIN_SHAPE, depth: int = 2, cfg=None,
                      label: str = "v2_train"):
    """One v2 train step (full width at ``depth``, or the config ``cfg`` as
    it is; by default B=1, V=3 at 160x512 with 32 classes, f32)
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

    cfg = _config("v2", depth=depth) if cfg is None else cfg
    B, V, H, W, ncls = shape
    # the matcher's auction takes no more targets than queries (the tiny
    # presets have 16)
    tcfg = train_config(accum_iter=1, max_instances=min(
        48, cfg.panoptic.mask_transformer.num_queries))
    batch, cls = train_batch(B, V, H, W, ncls, tcfg.max_instances, seed=3,
                             lang_dim=cfg.panoptic.mask_transformer.lang_dim)
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
        if name == "cuda":
            card = counts, _read_f32()
        res[name] = dict(
            flops=fc.total, loss=float(loss), assign=det["assign"].cpu(),
            grads={n: x.cpu() for n, x in opt.grads.items()},
            frozen_same=all(torch.equal(p, before[n]) for n, p in
                            model.named_parameters() if not mask[n]),
            trained=sum(not torch.equal(p, before[n]) for n, p in
                        model.named_parameters() if mask[n]))
        emit({"phase": "small", "model": label, "device": name,
              "seconds": time.perf_counter() - t0, "loss": res[name]["loss"],
              "flops": fc.total, "launches": counts, "frozen_bit_identical":
              res[name]["frozen_same"],
              "trainable_leaves_changed": res[name]["trained"]})
        if name == "cuda":
            want = expected_train_launches(cfg, V, (H // 16, W // 16))
            if counts != want:
                raise AssertionError(f"small {label}: launches {counts} "
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
    row = {"phase": "small", "model": label, "compare": "cuda_vs_cpu",
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
        raise AssertionError(f"small {label}: card and CPU disagree: {row}")
    del cpu_model, model
    torch.cuda.empty_cache()
    return card


def _sum_counts(*counts) -> dict:
    out = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


def phase_tiny():
    """The registered tiny presets on the card: ``tiny_config`` and
    ``tiny_v2_config`` as they are (every attention off K1's and K2's
    gates: K4 at head dims 16 and 12 in the towers, 16 in DINO's split
    cls with its LSE and the v2 mixer, 8 in LoftUp; K3 at 8 in the mask
    transformer, each padded to its kernel's head dim) at 384x512, V=4,
    K=3, card against CPU under ``phase_small``'s limits and launches as
    ``expected_launches`` implies; then one tiny_v2 train micro-step (B=1,
    V=3 at 160x512) card against CPU under ``phase_small_train``'s rules
    (K5 at 8 and 16).  Returns the launches of the three card runs and
    keeps their f32 share in F32_LAUNCHES["tiny"]."""
    from panst3r_torch.models.presets import tiny_config, tiny_v2_config

    runs = [phase_small("tiny", tiny_config()),
            phase_small("tiny_v2", tiny_v2_config()),
            phase_small_train(cfg=tiny_v2_config(), label="tiny_v2_train")]
    F32_LAUNCHES["tiny"] = _sum_counts(*(f32 for _, f32 in runs))
    return _sum_counts(*(counts for counts, _ in runs))


def phase_dino_large():
    """v1 at full width and depth at Bucket(480, 640): 30 x 40 = 1200
    patches, past K1's 1024, so the encoder's and the decoder's
    self-attention run K4 with tables and DINO's split cls K4 with its LSE
    (24 launches a pass of 4 views), the decoder's cross-attention K2 and
    the mask transformer K3; ``run_device`` + ``fuse`` at V=8, K=4, bf16,
    outputs finite and of their shapes, launches as ``expected_launches``
    implies.  Then DINO-L alone at depth 2 (layerscale 1, so that the
    blocks move the tokens) on two views at that bucket, f32, card
    against CPU within DINO_RTOL of the output's max |value|, one K4
    launch a layer."""
    import copy

    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.dino import DinoEncoder
    from panst3r_torch.models.panst3r import build_model, init_params

    cfg = _config("v1")
    V, K, chunk = 8, 4, 4
    H, W = DINO_LARGE_HW
    grid = (H // 16, W // 16)
    images, portrait, cls_emb = _inputs(V, H, W)
    model = build_model(cfg, seed=0)
    eng = InferenceEngine(model, Bucket(H, W), num_keyframes=K, chunk=chunk,
                          amp=True)
    eng.fuse(eng.run_device(images, portrait, cls_emb), (H, W))   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = eng.run_device(images, portrait, cls_emb)
    fused = eng.fuse(out, (H, W))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _read_counts("dino_large")
    want = expected_launches(cfg, V, K, chunk, grid)
    Q, ncls = cfg.panoptic.mask_transformer.num_queries, cls_emb.shape[0]
    shapes = {"pointmaps_raw": (V, H, W, 7), "pred_logits": (Q, ncls),
              "pred_masks": (V, Q, H // 2, W // 2)}
    checks = {k: (list(out[k].shape) == list(s),
                  bool(torch.isfinite(out[k].float()).all()))
              for k, s in shapes.items()}
    pan = fused[0]["pan"]
    emit({"phase": "dino_large", "views": V, "keyframes": out["keyframes"],
          "bucket": [H, W], "patches": grid[0] * grid[1],
          "run_plus_fuse_s": seconds,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "checks": checks, "pan_shape": list(pan.shape),
          "launches": counts, "expected_launches": want,
          "dino_k4_lse_launches_per_pass": cfg.dino.depth})
    bad = [k for k, (shape_ok, finite) in checks.items()
           if not (shape_ok and finite)]
    if bad or tuple(pan.shape) != (V, H, W):
        raise AssertionError(f"dino_large: wrong or non-finite outputs: "
                             f"{bad}")
    if counts != want:
        raise AssertionError(f"dino_large: launches {counts} != expected "
                             f"{want}")
    del eng, model, out, fused
    torch.cuda.empty_cache()

    dcfg = dataclasses.replace(cfg.dino, depth=2, layerscale_init=1.0)
    with torch.device("meta"):
        enc = DinoEncoder(dcfg)
    cpu = init_params(enc.to_empty(device="cpu"),
                      torch.Generator().manual_seed(0)).eval()
    card = copy.deepcopy(cpu).cuda()
    x = torch.as_tensor(np.random.default_rng(1).uniform(
        -1, 1, (2, H, W, 3)).astype(np.float32))
    outs = {}
    with torch.no_grad():
        outs["cpu"] = cpu(x)
        _reset_counts()
        outs["cuda"] = card(x.cuda()).cpu()
        dcounts = _read_counts()
    ref = outs["cpu"]
    err = float((outs["cuda"] - ref).abs().max())
    lim = DINO_RTOL * float(ref.abs().max())
    row = {"phase": "dino_large", "compare": "dino_depth2_cuda_vs_cpu",
           "shape": list(ref.shape), "max_abs_err": err, "limit": lim,
           "ref_max_abs": float(ref.abs().max()),
           "k4_launches": dcounts["flash_fwd"],
           "ok": err <= lim and dcounts["flash_fwd"] == dcfg.depth
           and bool(torch.isfinite(outs["cuda"]).all())}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"dino_large: DINO-L card and CPU disagree: "
                             f"{row}")
    return counts


class _GradProbe:
    """An optimizer stand-in for ``make_train_step``: it keeps each
    micro-step's gradients and clears them without an update, so every
    call starts from the same weights."""

    def __init__(self, params: dict):
        self.params = params
        self.grads = None

    def step(self):
        self.grads = {n: p.grad.detach().clone()
                      for n, p in self.params.items() if p.grad is not None}
        for p in self.params.values():
            p.grad = None


def train_repeat(model, mask: dict, tcfg, grid, batch, cls_emb,
                 reps: int = 3) -> dict:
    """The micro-step (forward, loss, backward) ``reps`` times on the same
    weights, batch and draws: every trainable parameter's gradient against
    the first call's, the losses, and the warm calls' seconds.  As shipped
    no gradient differs: the mask loss's border pad
    (``criterion.replicate_pad1``) and LoftUp's 1x1 ``patch_embed``
    (``loftup.Conv1x1``) add in a fixed order, where ``F.pad(mode=
    "replicate")``'s backward and cuDNN's filter gradient did not."""
    import torch

    from panst3r_torch.core import rng as prng
    from panst3r_torch.engine import train as tr

    probe = _GradProbe({n: p for n, p in model.named_parameters()
                        if mask[n]})
    step = tr.make_train_step(model, probe, tcfg.loss, grid)
    grads, secs, losses = [], [], []
    for _ in range(reps):
        gen = prng.generator(tcfg.seed, 0, 0, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = step(batch, cls_emb, gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        grads.append(probe.grads)
    differ = [n for n in probe.params
              if any(not torch.equal(g[n], grads[0][n]) for g in grads[1:])]
    return {"reps": reps, "step_s": secs,
            "losses_equal": len(set(losses)) == 1,
            "params_whose_grad_differs": len(differ),
            "differing": differ[:12],
            "max_abs_grad_diff": max(
                (float((g[n] - grads[0][n]).abs().max())
                 for g in grads[1:] for n in differ), default=0.0)}


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
    repeat = train_repeat(model, mask, tcfg, (H // 16, W // 16), batches[0],
                          cls_emb)
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
          "flash_shapes_step_1": flash_shapes, "repeat": repeat})
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
    if repeat["params_whose_grad_differs"] or not repeat["losses_equal"]:
        raise AssertionError(f"train_v2: the micro-step does not repeat "
                             f"run to run: {repeat}")
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


# ------------------------------------- many scenes, refinement, retrieval --

def _v1_engine(V=8, K=4, H=384, W=512):
    """The v1 main path's engine at full width and depth (bf16, random
    weights from seed 0, chunk 4), the ``serve`` phase's V uint8 views and
    portrait flags, and class embeddings under which four queries pass
    fusion's threshold (``segment_classes``)."""
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    images, portrait, _ = _inputs(V, H, W)
    eng = InferenceEngine(build_model(_config("v1"), seed=0), Bucket(H, W),
                          num_keyframes=K, chunk=4, amp=True)
    return eng, images, portrait, segment_classes(eng, images, portrait)


def _first_tensor(o):
    import torch

    if torch.is_tensor(o):
        return o
    if isinstance(o, dict):
        o = list(o.values())
    if isinstance(o, (list, tuple)):
        for e in o:
            t = _first_tensor(e)
            if t is not None:
                return t
    return None


def _scene0(t, like):
    """Scene 0's rows of a tensor of the batch of scenes: the leading rows
    of ``like``'s count where only the leading axis differs."""
    if t.shape[0] != like.shape[0] and t.shape[1:] == like.shape[1:]:
        return t[:like.shape[0]]
    return t


# module types whose forward is one torch library call (cuBLAS, cuDNN,
# the LayerNorm kernel): no port kernel runs inside them
LIBRARY_MODULES = ("Linear", "Conv2d", "LayerNorm")


def _batch_trace(eng, scenes, ports, cls) -> dict:
    """Where the batch of S scenes first changes scene 0's bits in
    ``serve_many_device``: each stage (towers, memory build, render, heads)
    is fed the batch path's own inputs, for scene 0 alone and beside the
    others, and its scene-0 outputs compared bit for bit; in the first
    stage that differs, every module's first input and output are recorded
    (scene 0 alone), and the first module, in the order modules finish,
    whose input is equal beside the others but whose output is not is the
    culprit.  ``library``: the culprit is a torch library layer
    (``LIBRARY_MODULES``), not code that launches a port kernel."""
    import torch

    from panst3r_torch.engine.inference import _pick
    from panst3r_torch.engine.retrieval import select_keyframes_linspace
    from panst3r_torch.models.memory import TokenMemory

    model = eng.model
    cls = torch.as_tensor(cls, device=eng.device).to(eng.dtype)
    ports = torch.as_tensor(ports, device=eng.device)
    with torch.inference_mode():
        imgs = torch.as_tensor(scenes, device=eng.device)
        S, V = imgs.shape[:2]
        K = min(eng.num_keyframes, V)
        keyframes = select_keyframes_linspace(V, K)
        kf = torch.as_tensor(keyframes, device=eng.device).expand(S, K)
        nk = torch.as_tensor(sorted(set(range(V)) - set(keyframes)),
                             device=eng.device).expand(S, V - K)

        def towers(n):
            out = eng._towers(imgs[:n].reshape(-1, *imgs.shape[2:]))
            return tuple(t.reshape(n, V, *t.shape[1:]) for t in out)

        img, x, pos, dino = towers(S)
        mem = eng.build_memory(_pick(x, kf), _pick(pos, kf))

        def memory(n):
            return (eng.build_memory(_pick(x, kf)[:n], _pick(pos, kf)[:n])
                    .y.transpose(0, 1),)

        def render(n):
            part = TokenMemory(mem.y[:, :n], mem.pos[:n], mem.valid[:n],
                               mem.count)
            return model.decoder_render(x[:n], pos[:n], part, eng.grid)

        pm, y = render(S)

        def heads(n):
            out = eng._heads(img[:n], x[:n], y[:n], dino[:n], pos[:n],
                             ports[:n], cls, kf[:n], nk[:n])
            return out["pred_logits"], out["pred_masks"]

        stages, first = {}, None
        for name, fn in (("towers", towers), ("memory", memory),
                         ("render", render), ("heads", heads)):
            one, many = fn(1), fn(S)
            stages[name] = [bool(torch.equal(a, b[:1]))
                            for a, b in zip(one, many)]
            if first is None and not all(stages[name]):
                first = (name, fn)
        res = {"stages_bit_equal": stages, "first_stage": None,
               "culprit": None, "library": False}
        if first is None:
            return res
        res["first_stage"] = first[0]
        rec, calls, state = [], [], {"i": 0, "hit": None}
        names = {m: n for n, m in model.named_modules()}

        def hook(mod, inp, out):
            i0, o = _first_tensor(inp), _first_tensor(out)
            if o is None:
                return
            if state["mode"] == "one":
                rec.append((names[mod], i0, o))
                return
            j = state["i"]
            state["i"] += 1
            if state["hit"] is not None or j >= len(rec):
                return
            name, a_in, a_out = rec[j]
            same_in = a_in is None or i0 is None or bool(torch.equal(
                _scene0(i0, a_in), a_in))
            if same_in and not torch.equal(_scene0(o, a_out), a_out):
                state["hit"] = (name, type(mod).__name__, float(
                    (_scene0(o, a_out).float() - a_out.float()).abs().max()))

        handles = [m.register_forward_hook(hook) for m in model.modules()]
        try:
            state["mode"] = "one"
            first[1](1)
            state["mode"] = "many"
            first[1](S)
        finally:
            for h in handles:
                h.remove()
        if state["hit"] is not None:
            name, kind, diff = state["hit"]
            res.update(culprit=name, culprit_type=kind, max_abs_diff=diff,
                       library=kind in LIBRARY_MODULES)
        del rec
        torch.cuda.empty_cache()
        return res


def phase_serve_many():
    """``serve_many_device`` at full v1 width (bf16, K = 4): S = 2 scenes of
    V = 8, the ``serve`` phase's views and a ``np.roll`` of them, hybrid
    wire with cameras, then the same from packed YUV420.  Each scene's
    wire against its own ``serve_device`` wire under ``wire_agreement`` at
    1/255; where the two differ, ``_batch_trace`` finds the first module
    whose output depends on the batch, and only when that is a library
    layer the small ``v1_serve`` rule holds instead (pan on >= 99.9% of
    pixels, seg_ids, labels and selected equal).  Launches equal to one
    scene's (``expected_serve_launches``); the batched call's seconds
    against two sequential ``serve_device`` calls, in turns, two readings
    each; the peak memory.  Returns the launches of the RGB call."""
    import torch

    from panst3r_torch.engine.inference import fetch_wire
    from panst3r_torch.ops.image import rgb_to_yuv420

    cfg = _config("v1")
    V, K, S = 8, 4, 2
    eng, images, portrait, cls_emb = _v1_engine(V, K)
    scenes = np.stack([images, np.roll(images, 1, axis=0)])
    packed = np.stack([rgb_to_yuv420(sc) for sc in scenes])
    port, cls = (torch.as_tensor(a, device="cuda") for a in (portrait,
                                                             cls_emb))
    ports = torch.stack([port] * S)
    kw = dict(fusion_res="hybrid", with_cameras=True)

    def many(sc):
        return eng.serve_many_device(sc, ports, cls, **kw)

    def pair(sc):
        return [fetch_wire(eng.serve_device(sc[s], port, cls, **kw))
                for s in range(S)]

    many(scenes)                                               # warm-up
    pair(scenes)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    wires, t = _timed(many, scenes)
    counts = _read_counts("serve_many")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    secs = {"serve_many": [t], "two_serve_device": []}
    for turn in range(3):            # in turns: many, pair, many, pair
        if turn % 2 == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            singles = pair(scenes)
            secs["two_serve_device"].append(time.perf_counter() - t0)
        else:
            secs["serve_many"].append(_timed(many, scenes)[1])

    checks = {}
    for name, got, want in (("rgb", wires, singles),
                            ("yuv420", fetch_wire(many(packed)),
                             pair(packed))):
        for s in range(S):
            a = eng.unpack_wire(got[s], V, with_cameras=True)
            b = eng.unpack_wire(want[s], V, with_cameras=True)
            c = wire_agreement(a, b, 1.0 / 255)
            c.update(wire_equal=bool(np.array_equal(got[s], want[s])),
                     pan_agree=float((a["pan"] == b["pan"]).mean()),
                     n_segments=int(b["selected"].sum()),
                     cameras_max_abs_diff=max(
                         float(np.abs(a[k] - b[k]).max())
                         for k in ("focals", "cam2world")))
            checks[f"{name}_{s}"] = c
    trace = None
    if not all(c["ok"] for c in checks.values()):
        trace = _batch_trace(eng, scenes, ports, cls)
        if trace["library"]:
            for c in checks.values():
                c["rule"] = "small v1_serve (library layer)"
                c["ok"] = c["pan_agree"] >= 0.999 and all(
                    c[k] for k in ("seg_ids", "labels", "selected"))
    want = expected_serve_launches(cfg, V, K, eng.n_tokens)
    emit({"phase": "serve_many", "scenes": S, "views": V, "keyframes": K,
          "wire": "hybrid+cameras", "seconds": secs,
          "views_per_s": {"serve_many": S * V / min(secs["serve_many"]),
                          "two_serve_device":
                          S * V / min(secs["two_serve_device"])},
          "peak_mem_gib": peak, "launches": counts,
          "expected_launches": want, "checks": checks, "trace": trace})
    bad = [k for k, c in checks.items() if not c["ok"]]
    if not sum(c["n_segments"] for c in checks.values()):
        bad.append("no segments")
    if bad or counts != want:
        raise AssertionError(f"serve_many: checks {bad}, launches {counts} "
                             f"!= {want}, trace {trace}")
    del eng
    torch.cuda.empty_cache()
    return counts


def expected_refine_launches(cfg, K, chunk, r):
    """K1's and K2's launches for one ``build_memory(refine_iterations=r)``:
    per decoder layer, (1 + r) builds of the update schedule and r renders
    of the keyframes, ``chunk`` views a call."""
    n = ((1 + r) * len(cfg.mem_batches(K)) + r * math.ceil(K / chunk)) \
        * cfg.decoder.depth
    return {"tower_self": n, "tower_cross": n, "masked_attn": 0,
            "flash_fwd": 0, "flash_bwd": 0, "tower_cross_int8": 0,
            "packed_flash": 0}


def phase_refine():
    """``build_memory(refine_iterations=1)`` at full v1 width (bf16) over
    K = 4 keyframes: launches as the call structure implies
    (``expected_refine_launches``), a finite memory and a finite render of
    the keyframes against it, and its seconds against
    ``refine_iterations=0`` (in turns, two readings each).  Returns the
    launches."""
    import torch

    cfg = _config("v1")
    K = 4
    eng, images, _, _ = _v1_engine(8, K)
    with torch.inference_mode():
        x, pos = eng.encode_batch(torch.as_tensor(images[:K], device="cuda"))
        eng.build_memory(x, pos, refine_iterations=1)           # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        mem = eng.build_memory(x, pos, refine_iterations=1)
        counts = _read_counts("refine")
        pm, y = eng.render_batch(x, pos, mem)
        finite = bool(torch.isfinite(mem.y).all() and torch.isfinite(pm).all()
                      and torch.isfinite(y).all())
        secs = {0: [], 1: []}
        for r in (1, 0, 0, 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.build_memory(x, pos, refine_iterations=r)
            torch.cuda.synchronize()
            secs[r].append(time.perf_counter() - t0)
    want = expected_refine_launches(cfg, K, eng.chunk, 1)
    emit({"phase": "refine", "keyframes": K, "refine_iterations": 1,
          "seconds": {"refine_1": secs[1], "refine_0": secs[0]},
          "launches": counts, "expected_launches": want, "finite": finite,
          "count": mem.count})
    if counts != want or not finite or mem.count != K * eng.n_tokens:
        raise AssertionError(f"refine: launches {counts} != {want}, "
                             f"finite {finite}, count {mem.count}")
    del eng
    torch.cuda.empty_cache()
    return counts


# the seeded retrieval head of phase retrieval_head: the v1 encoder's 1024
# channels in; prewhiten 1024 x 1024, a projector 1024 -> 1024 -> 128 with
# GELU between, postwhiten 128 x 128, 1024 codebook words (the released
# retrieval model's widths and codebook are not in the repository)
RETRIEVAL_WIDTHS = (1024, 1024, 128, 1024)


def retrieval_checkpoint(seed: int = 0) -> dict:
    """A retrieval checkpoint in the released files' layout (``model``,
    ``args``, ``asmk_codebook``, ``asmk_params``) at ``RETRIEVAL_WIDTHS``,
    drawn from ``seed`` on the CPU: weights scaled by 1/sqrt(fan-in),
    small biases, unit codebook rows."""
    import argparse

    import torch

    C, hid, out, words = RETRIEVAL_WIDTHS
    g = torch.Generator().manual_seed(seed)

    def lin(o, i):
        return (torch.randn(o, i, generator=g) / i ** 0.5,
                0.01 * torch.randn(o, generator=g))

    model = {}
    for name, (o, i) in (("prewhiten", (C, C)), ("projector.0", (hid, C)),
                         ("projector.2", (out, hid)),
                         ("postwhiten", (out, out))):
        model[f"{name}.weight"], model[f"{name}.bias"] = lin(o, i)
    cb = torch.randn(words, out, generator=g)
    return {"model": model, "args": argparse.Namespace(residual=False),
            "asmk_codebook": {"centroids": cb / cb.norm(dim=-1,
                                                        keepdim=True)},
            "asmk_params": {"similarity": {"alpha": 3.0,
                                           "similarity_threshold": 0.0}}}


def phase_retrieval_head():
    """``run_device(use_retrieval=True)`` at full v1 width (bf16, V = 8,
    K = 4) with a seeded ``RetrievalHead`` built through
    ``port_retrieval_checkpoint``: launches those of one ``run_device``,
    the keyframes equal to ``select_keyframes_retrieval`` with the same
    head on the same encoder tokens moved to the CPU; the seconds of
    ``asmk_similarity`` on the card's tokens (projection on the card, the
    ASMK loops on the host) and on the CPU.  Returns the launches."""
    import torch

    from panst3r_torch.engine.retrieval import (RetrievalHead,
                                                asmk_similarity,
                                                select_keyframes_retrieval)
    from panst3r_torch.port_checkpoint import port_retrieval_checkpoint

    cfg = _config("v1")
    V, K = 8, 4
    eng, images, portrait, cls_emb = _v1_engine(V, K)
    head = RetrievalHead(**port_retrieval_checkpoint(retrieval_checkpoint()))
    eng.retrieval_head = head
    eng.run_device(images, portrait, cls_emb, use_retrieval=True)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = eng.run_device(images, portrait, cls_emb, use_retrieval=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _read_counts("retrieval_head")
    with torch.inference_mode():
        x, _ = eng.encode_batch(torch.as_tensor(images, device="cuda"))
        tokens = x.float()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = asmk_similarity(head, tokens)
        card_s = time.perf_counter() - t0
        host = tokens.cpu()
        t0 = time.perf_counter()
        sim_cpu = asmk_similarity(head, host)
        cpu_s = time.perf_counter() - t0
        want = select_keyframes_retrieval(host, K, head=head)
        pooled = select_keyframes_retrieval(host, K)
        words, _, _ = head.assign_and_binarize(tokens[:1])
    want_launches = expected_launches(cfg, V, K, eng.chunk)
    res = {"phase": "retrieval_head", "views": V, "keyframes": out[
        "keyframes"], "keyframes_cpu": want, "keyframes_pooled_cosine":
        pooled, "widths": list(RETRIEVAL_WIDTHS),
        "run_device_s": run_s, "asmk_similarity_s": {"card_tokens": card_s,
                                                     "cpu": cpu_s},
        "sim_card_vs_cpu_max_abs_diff": float(np.abs(sim - sim_cpu).max()),
        "sim_offdiag_range": [float(sim[~np.eye(V, dtype=bool)].min()),
                              float(sim[~np.eye(V, dtype=bool)].max())],
        "words_used_view0": int(words.unique().numel()),
        "launches": counts, "expected_launches": want_launches}
    emit(res)
    if out["keyframes"] != want or counts != want_launches \
            or len(set(want)) != K:
        raise AssertionError(f"retrieval_head: {res}")
    del eng
    torch.cuda.empty_cache()
    return counts


def phase_serve_app():
    """The port's serving daemon (``apps/serve.py``) on 127.0.0.1, port 0,
    in a thread, with the v1 engine on the card (bf16, V = 8, K = 4):
    ``GET /healthz`` answers ok; one ``POST /reconstruct?cameras=1`` of the
    scene equals ``unpack_wire(serve_device(...))`` (pan equal, cameras
    within 1e-5); a ``POST /slam/frame`` before ``/slam/start`` answers
    400.  Returns the launches of the request."""
    import io
    import threading
    import urllib.error
    import urllib.request

    import torch

    from panst3r_torch.apps.serve import SceneServer, make_server

    cfg = _config("v1")
    V, K = 8, 4
    eng, images, portrait, cls_emb = _v1_engine(V, K)
    want = eng.unpack_wire(eng.serve_device(images, portrait, cls_emb,
                                            with_cameras=True), V,
                           with_cameras=True)
    srv = make_server(SceneServer(eng, cls_emb), "127.0.0.1", 0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = r.read()
        buf = io.BytesIO()
        np.savez(buf, images=images, portrait=portrait)
        body = buf.getvalue()
        times = []
        for i in range(2):
            if i == 1:
                _reset_counts()
            t0 = time.perf_counter()
            req = urllib.request.Request(f"{url}/reconstruct?cameras=1",
                                         data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                got = dict(np.load(io.BytesIO(r.read())))
            times.append(time.perf_counter() - t0)
        counts = _read_counts("serve_app")
        buf = io.BytesIO()
        np.savez(buf, image=images[0])
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"{url}/slam/frame", data=buf.getvalue(), method="POST"),
                timeout=60)
            slam = None
        except urllib.error.HTTPError as e:
            slam = e.code
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    checks = {
        "healthz": health == b"ok",
        "pan_equal": bool(np.array_equal(got["pan"], want["pan"])),
        "cameras_max_abs_diff": max(float(np.abs(got[k] - want[k]).max())
                                    for k in ("focals", "cam2world")),
        "slam_status": slam,
        "n_segments": int(want["selected"].sum())}
    checks["ok"] = (checks["healthz"] and checks["pan_equal"]
                    and checks["cameras_max_abs_diff"] <= 1e-5
                    and slam == 400 and checks["n_segments"] > 0)
    expected = expected_serve_launches(cfg, V, K, eng.n_tokens)
    emit({"phase": "serve_app", "views": V, "request_s": times,
          "request_bytes": len(body), "launches": counts,
          "expected_launches": expected, "checks": checks})
    if not checks["ok"] or counts != expected:
        raise AssertionError(f"serve_app: {checks}, launches {counts}")
    del eng
    torch.cuda.empty_cache()
    return counts


def phase_small_serve_many(preset: str):
    """``serve_many_device(with_cameras=True)`` of S = 2 scenes (the
    ``small`` views and a ``np.roll`` of them) at full width and depth 2,
    f32, V=4 / K=3 at 384x512, on the card and on the CPU from the same
    weights, each scene at ``phase_small_serve``'s limits (pan on >= 99.9%
    of pixels, seg_ids, labels and selected equal, cameras within 1e-3
    relative; segments in at least one scene, the class embeddings being
    solved on the first); launches one scene's; v2 brings K4 (LoftUp)
    in."""
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    cfg = _config(preset, depth=2)
    V, K, S = 4, 3, 2
    images, portrait, _ = _inputs(V)
    scenes = np.stack([images, np.roll(images, 1, axis=0)])
    ports = np.stack([portrait] * S)
    cpu_model = build_model(cfg, device="cpu", seed=0)
    gpu_model = build_model(cfg, device="cuda", seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict())
    dec = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        eng = InferenceEngine(model, Bucket(384, 512), num_keyframes=K,
                              chunk=4, amp=False, device=name)
        if name == "cpu":
            cls_emb = segment_classes(eng, images, portrait)
        _reset_counts()
        wires = eng.serve_many_device(scenes, ports, cls_emb,
                                      with_cameras=True)
        counts = _read_counts()
        dec[name] = [eng.unpack_wire(w, V, with_cameras=True)
                     for w in wires.cpu().numpy()]
    want = expected_serve_launches(cfg, V, K, 768)
    segments = sum(int(d["selected"].sum()) for d in dec["cpu"])
    for s in range(S):
        a, b = dec["cuda"][s], dec["cpu"][s]
        row = {"phase": "small", "model": f"{preset}_serve_many",
               "scene": s, "compare": "cuda_vs_cpu",
               "pan_agree": float((a["pan"] == b["pan"]).mean()),
               "n_segments": int(b["selected"].sum()), "launches": counts}
        for k in ("seg_ids", "labels", "selected"):
            row[k + "_equal"] = bool(np.array_equal(a[k], b[k]))
        for k in ("focals", "cam2world"):
            row[k + "_rel_err"] = float(np.abs(a[k] - b[k]).max()
                                        / np.abs(b[k]).max())
        emit(row)
        if not (row["pan_agree"] >= 0.999 and segments > 0
                and row["seg_ids_equal"] and row["labels_equal"]
                and row["selected_equal"] and row["focals_rel_err"] <= 1e-3
                and row["cam2world_rel_err"] <= 1e-3 and counts == want):
            raise AssertionError(f"small {preset}_serve_many: card and CPU "
                                 f"disagree {row} (launches want {want})")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()


def phase_small_refine():
    """``build_memory(refine_iterations=1)`` at full v1 width and depth 2,
    f32, over the K=3 keyframes of the ``small`` views, then the render of
    all V=4 views against it, on the card and on the CPU from the same
    weights: pointmaps and features within the ``small`` pointmap limit
    (2e-4)."""
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    cfg = _config("v1", depth=2)
    V, K = 4, 3
    images = _inputs(V)[0]
    cpu_model = build_model(cfg, device="cpu", seed=0)
    gpu_model = build_model(cfg, device="cuda", seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict())
    outs = {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = InferenceEngine(model, Bucket(384, 512), num_keyframes=K,
                              chunk=4, amp=False, device=name)
        with torch.inference_mode():
            x, pos = eng.encode_batch(torch.as_tensor(images, device=eng.device))
            mem = eng.build_memory(x[:K], pos[:K], refine_iterations=1)
            outs[name] = [t.cpu().numpy()
                          for t in eng.render_batch(x, pos, mem)]
    row = {"phase": "small", "model": "v1_refine", "compare": "cuda_vs_cpu"}
    for i, key in enumerate(("pointmaps_raw", "feats")):
        diff = float(np.abs(outs["cuda"][i] - outs["cpu"][i]).max())
        row[key] = {"max_abs_err": diff, "atol": 2e-4, "ok": diff <= 2e-4}
    emit(row)
    if not (row["pointmaps_raw"]["ok"] and row["feats"]["ok"]):
        raise AssertionError(f"small v1_refine: card and CPU disagree {row}")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _pinned_queries(calls: list, pin=None):
    """Stand in for ``models/mask_transformer.py::select_queries``: each
    call makes its own selection and records the scores (on the host) and
    its indices in ``calls``; with ``pin`` (one selection per call, from
    another run) the call returns ``pin[i]`` on the scores' device."""
    from panst3r_torch.models import mask_transformer as mt

    real = mt.select_queries

    def select(score, k):
        own = real(score, k)
        calls.append({"score": score.detach().float().cpu(),
                      "top": own.cpu()})
        if pin is None:
            return own
        return pin[len(calls) - 1].to(own.device)

    mt.select_queries = select
    try:
        yield
    finally:
        mt.select_queries = real


def top_k_within(score, top, tol: float) -> bool:
    """Whether ``top`` (B, k) is a top-k of ``score`` (B, N), highest first,
    up to ``tol``: each selected score at least every other one less
    ``tol``, and each at most the one before it plus ``tol``."""
    import torch

    sel = torch.gather(score, 1, top)
    rest = score.scatter(1, top, -float("inf"))
    return bool((sel.amin(1) >= rest.amax(1) - tol).all()
                and (sel[:, 1:] <= sel[:, :-1] + tol).all())


def phase_small_two_stage():
    """A two-stage v1 config (``MaskTransformerConfig.two_stage``) at full
    width and depth 2, f32, V=4 / K=3, ``run`` on the card and on the CPU
    from the same weights, under ONE query selection: the card's own top
    ``num_queries`` is recorded and held to be a top-k of its own scores
    within 1e-4, then the CPU's indices stand in (``_pinned_queries``),
    since tokens whose scores differ by less than the two devices' rounding
    may swap places; logits and masks at the ``small`` v1 limits."""
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    rep = dataclasses.replace
    cfg = _config("v1", depth=2)
    cfg = rep(cfg, panoptic=rep(cfg.panoptic, mask_transformer=rep(
        cfg.panoptic.mask_transformer, two_stage=True)))
    V, K = 4, 3
    images, portrait, cls_emb = _inputs(V)
    cpu_model = build_model(cfg, device="cpu", seed=0)
    gpu_model = build_model(cfg, device="cuda", seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict())
    outs, calls = {}, {"cpu": [], "cuda": []}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        eng = InferenceEngine(model, Bucket(384, 512), num_keyframes=K,
                              chunk=4, amp=False, device=name)
        pin = None if name == "cpu" else [c["top"] for c in calls["cpu"]]
        with _pinned_queries(calls[name], pin):
            outs[name] = eng.run(images, portrait, cls_emb)
    own = calls["cuda"][0]
    row = {"phase": "small", "model": "v1_two_stage",
           "compare": "cuda_vs_cpu", "selections": len(calls["cuda"]),
           "card_top_equals_cpu": bool(torch.equal(
               own["top"], calls["cpu"][0]["top"])),
           "card_top_valid": top_k_within(own["score"], own["top"], 1e-4),
           "cpu_top_valid_on_card_scores": top_k_within(
               own["score"], calls["cpu"][0]["top"], 1e-4)}
    a, b = outs["cuda"], outs["cpu"]
    for key, atol, rtol in SMALL_LIMITS[1:]:
        diff = np.abs(a[key] - b[key])
        row[key] = {"max_abs_err": float(diff.max()), "atol": atol,
                    "rtol": rtol,
                    "ok": bool(np.all(diff <= atol + rtol * np.abs(b[key])))}
    emit(row)
    if not (row["selections"] == 1 and row["card_top_valid"]
            and row["cpu_top_valid_on_card_scores"]
            and row["pred_logits"]["ok"] and row["pred_masks"]["ok"]):
        raise AssertionError(f"small v1_two_stage: {row}")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ main --

# ------------------------------------------------ mixed aspect, demo --

def _mb_inputs(ncls=32):
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in MB_SHAPES]
    portrait = np.zeros(len(images), bool)
    portrait[list(MB_PORTRAIT)] = True
    return images, portrait, \
        rng.standard_normal((ncls, 768)).astype(np.float32)


def expected_multibucket_launches(cfg, buckets, K, chunk):
    """Launches per kernel for one MultiBucketEngine.run: per bucket, the
    encoder over its views in chunks; per keyframe bucket group, the
    memory updates on the [init, +1, ...] schedule; per bucket group of
    the keyframes, then of the other views, the render and DINO in chunks
    and one head call, which runs the v2 mixer (K1) and LoftUp (K4); the
    mask transformer's masked layers once, in the joint keyframe decode
    (the other views take the frozen queries)."""
    from panst3r_torch.engine.retrieval import select_keyframes_linspace
    from panst3r_torch.models.upscalers import LoftUpUpscalerConfig

    V = len(buckets)
    kf = select_keyframes_linspace(V, K)
    nk = [i for i in range(V) if i not in kf]

    def groups(idxs):
        out = {}
        for i in idxs:
            out.setdefault(buckets[i], []).append(i)
        return list(out.values())

    def chunks(n):
        return math.ceil(n / min(chunk, n))

    n_enc = sum(chunks(len(g)) for g in groups(range(V)))
    n_updates = sum(len(cfg.mem_batches(len(g))) for g in groups(kf))
    head_groups = groups(kf) + groups(nk)
    n_render = sum(chunks(len(g)) for g in head_groups)
    dec = cfg.decoder.depth
    pan = cfg.panoptic
    mixer = pan.input_mixer.num_layers if pan.input_mixer else 0
    loftup = pan.upscaler.num_layers \
        if isinstance(pan.upscaler, LoftUpUpscalerConfig) else 0
    return {
        "tower_self": n_enc * cfg.encoder.depth + n_render * cfg.dino.depth
        + (n_updates + n_render) * dec + len(head_groups) * mixer,
        "tower_cross": (n_updates + n_render) * dec,
        "masked_attn": pan.mask_transformer.dec_layers,
        "flash_fwd": len(head_groups) * loftup,
        "flash_bwd": 0,
        "tower_cross_int8": 0,
        "packed_flash": 0,
    }


def _mb_check(out, cfg, ncls) -> dict:
    """Shapes and finiteness of a MultiBucketEngine.run output."""
    Q = cfg.panoptic.mask_transformer.num_queries
    ok = {"pred_logits": (list(out["pred_logits"].shape) == [Q, ncls],
                          bool(np.isfinite(out["pred_logits"]).all()))}
    for key, shape_of in (("pointmaps_raw", lambda h, w: [h, w, 7]),
                          ("pred_masks", lambda h, w: [Q, h // 2, w // 2])):
        ok[key] = (all(list(o.shape) == shape_of(h, w) for o, (h, w)
                       in zip(out[key], MB_SHAPES)),
                   all(bool(np.isfinite(o).all()) for o in out[key]))
    return ok


# the depth of ``phase_multibucket``'s card-against-CPU check: its CPU side
# is the phase's time
MB_SMALL_DEPTH = 1


def phase_multibucket():
    """The mixed-aspect main path (full v1, bf16: ``run`` + ``fuse``, which
    brings every output to the host, and ``run_device`` + ``fuse``, and a
    profile of the latter), then an f32 check of the same scene at
    ``MB_SMALL_DEPTH``, card against CPU, for v1 and v2; returns the full
    scene's launch counts."""
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.core.profiling import profile_by_kernel
    from panst3r_torch.engine.inference import MultiBucketEngine
    from panst3r_torch.models.panst3r import build_model

    images, portrait, cls_emb = _mb_inputs()
    buckets = [Bucket(*im.shape[:2]) for im in images]
    K, chunk = 4, 4
    cfg = _config("v1")
    model = build_model(cfg, seed=0)
    eng = MultiBucketEngine(model, num_keyframes=K, chunk=chunk, amp=True)
    eng.fuse(eng.run(images, portrait, cls_emb))           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = eng.run(images, portrait, cls_emb)
    t1 = time.perf_counter()
    fused = eng.fuse(out)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _read_counts("multibucket")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the same scene kept on the card (run_device + fuse, as the v1 phase
    # times its scene), then one traced run
    t3 = time.perf_counter()
    eng.fuse(eng.run_device(images, portrait, cls_emb))
    torch.cuda.synchronize()
    on_device = time.perf_counter() - t3
    profile = profile_by_kernel(lambda: eng.fuse(
        eng.run_device(images, portrait, cls_emb)))
    profile["device_idle_share_untraced"] = 1 - profile["device_busy_ms"] \
        / (on_device * 1e3)
    want = expected_multibucket_launches(cfg, buckets, K, chunk)
    checks = _mb_check(out, cfg, cls_emb.shape[0])
    kf_buckets = sorted({buckets[i].shape for i in out["keyframes"]})
    pan_ok = [p.shape for p in fused[0]["pan"]] == list(MB_SHAPES)
    emit({"phase": "multibucket", "model": "v1", "views": len(images),
          "shapes": [list(b) for b in MB_SHAPES],
          "portrait": portrait.tolist(), "keyframes": out["keyframes"],
          "keyframe_buckets": kf_buckets,
          "memory_slots": sum(buckets[i].num_patches(16)
                              for i in out["keyframes"]),
          "run_s": t1 - t0, "fuse_s": t2 - t1, "run_plus_fuse_s": t2 - t0,
          "run_device_plus_fuse_s": on_device, "peak_mem_gib": peak,
          "n_segments": len(fused[0]["segments_info"]), "pan_ok": pan_ok,
          "checks": checks, "launches": counts, "expected_launches": want})
    emit({"phase": "multibucket_profile", **profile})
    bad = [k for k, (shape_ok, finite) in checks.items()
           if not (shape_ok and finite)]
    if bad or not pan_ok:
        raise AssertionError(f"multibucket: wrong or non-finite outputs: "
                             f"{bad}, pan shapes ok: {pan_ok}")
    if len(kf_buckets) < 2:
        raise AssertionError(f"multibucket: keyframes in {kf_buckets}")
    if counts != want:
        raise AssertionError(f"multibucket: launches {counts} != expected "
                             f"{want}")
    del eng, model, out, fused
    torch.cuda.empty_cache()

    for preset in ("v1", "v2"):
        cfg = _config(preset, depth=MB_SMALL_DEPTH)
        cpu_model = build_model(cfg, device="cpu", seed=0)
        gpu_model = build_model(cfg, device="cuda", seed=1)
        gpu_model.load_state_dict(cpu_model.state_dict())
        outs = {}
        for name, m in (("cuda", gpu_model), ("cpu", cpu_model)):
            e = MultiBucketEngine(m, num_keyframes=K, chunk=chunk, amp=False,
                                  device=name)
            _reset_counts()
            t0 = time.perf_counter()
            outs[name] = e.run(images, portrait, cls_emb)
            n = _read_counts()
            emit({"phase": "multibucket_small", "model": preset,
                  "device": name, "seconds": time.perf_counter() - t0,
                  "launches": n})
            if name == "cuda":
                want = expected_multibucket_launches(cfg, buckets, K, chunk)
                if n != want:
                    raise AssertionError(f"multibucket_small {preset}: "
                                         f"launches {n} != {want}")
        a, b = outs["cuda"], outs["cpu"]
        row = {"phase": "multibucket_small", "model": preset,
               "compare": "cuda_vs_cpu"}
        for key, atol, rtol in SMALL_LIMITS:
            pairs = list(zip(a[key], b[key])) if isinstance(a[key], list) \
                else [(a[key], b[key])]
            err = max(float(np.abs(x - y).max()) for x, y in pairs)
            ok = all(bool(np.all(np.abs(x - y) <= atol + rtol * np.abs(y)))
                     for x, y in pairs)
            row[key] = {"max_abs_err": err, "atol": atol, "rtol": rtol,
                        "ok": ok}
        emit(row)
        bad = [k for k in ("pointmaps_raw", "pred_logits", "pred_masks")
               if not row[k]["ok"]]
        if bad or a["keyframes"] != b["keyframes"]:
            raise AssertionError(f"multibucket_small {preset}: card and CPU "
                                 f"disagree on {bad}")
        del cpu_model, gpu_model, outs
        torch.cuda.empty_cache()
    return counts


def phase_demo():
    """The demo entry points at full v2 width: a checkpoint saved by
    ``core/checkpoint.py`` (bf16 weights, classes and class embeddings in
    its meta) into a temporary directory, ``build_engine`` from it,
    ``reconstruct_scene`` with QUBO and standard v2 fusion on uint8 views,
    and ``export_scene`` (the PLY and cameras.json; no PNG: nothing here
    imports PIL or PyYAML); returns the launch counts of the QUBO scene."""
    import tempfile

    import torch

    from panst3r_torch.apps import demo
    from panst3r_torch.apps.common import build_engine
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.core.checkpoint import save_checkpoint
    from panst3r_torch.models.panst3r import build_model

    before = {m.split(".")[0] for m in sys.modules}
    V, K, H, W = 8, 4, 384, 512
    cfg = _config("v2")
    rng = np.random.default_rng(1)
    classes = list(demo.SCANNET_CLASSES)
    emb = rng.standard_normal((len(classes),
                               cfg.panoptic.mask_transformer.lang_dim)) \
        .astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    images = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    portrait = np.zeros(V, bool)
    counts = None
    with tempfile.TemporaryDirectory() as tmp:
        model = build_model(cfg, seed=0).to(torch.bfloat16)
        t0 = time.perf_counter()
        save_checkpoint(tmp, "demo", model, cfg,
                        {"classes": classes, "cls_emb": emb})
        saved = {k: v.detach().clone() for k, v in
                 model.state_dict().items()}
        del model
        eng, got_classes, got_emb = build_engine(
            "v2", Bucket(H, W), checkpoint=f"{tmp}/demo", num_keyframes=K)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = all(torch.equal(v, saved[k])
                   for k, v in eng.model.state_dict().items())
        if got_classes != classes or not np.array_equal(got_emb, emb) \
                or not same:
            raise AssertionError("demo: build_engine did not restore the "
                                 "checkpoint's weights, classes and "
                                 "embeddings")
        del saved
        for fusion in ("qubo", "standard_v2"):
            if fusion == "qubo":
                _reset_counts()
            t0 = time.perf_counter()
            scene = demo.reconstruct_scene(eng, images, portrait, classes,
                                           got_emb, fusion=fusion)
            torch.cuda.synchronize()
            scene_s = time.perf_counter() - t0
            if fusion == "qubo":
                counts = _read_counts("demo")
            out_dir = f"{tmp}/{fusion}"
            t0 = time.perf_counter()
            demo.export_scene(out_dir, images, scene, overlays=False)
            export_s = time.perf_counter() - t0
            with open(f"{out_dir}/cameras.json") as f:
                cams = json.load(f)
            with open(f"{out_dir}/scene.ply") as f:
                head = [next(f) for _ in range(3)]
            n_points = int(head[2].split()[-1])
            rot = scene["cams2world"][:, :3, :3]
            checks = {
                "pan_shape": list(scene["pan"].shape) == [V, H, W],
                "poses_finite": bool(np.isfinite(scene["cams2world"]).all()
                                     and np.isfinite(scene["focals"]).all()),
                "rotations": bool(np.allclose(np.linalg.det(rot), 1.0,
                                              atol=1e-3)),
                "cameras_json": len(cams["focals"]) == V
                and bool(np.isfinite(np.asarray(cams["cams2world"])).all()),
                "ply": head[0].strip() == "ply" and n_points > 0,
            }
            emit({"phase": "demo", "model": "v2", "fusion": fusion,
                  "views": V, "checkpoint_to_engine_s": load_s,
                  "scene_s": scene_s, "export_s": export_s,
                  "n_segments": len(scene["segments_info"]),
                  "ply_points": n_points, "checks": checks,
                  **({"launches": counts} if fusion == "qubo" else {})})
            if not all(checks.values()):
                raise AssertionError(f"demo {fusion}: {checks}")
    new = ({m.split(".")[0] for m in sys.modules} - before) & {"PIL", "yaml"}
    if new:
        raise AssertionError(f"demo imported {sorted(new)}")
    want = expected_launches(cfg, V, K, 4)
    if counts != want:
        raise AssertionError(f"demo: launches {counts} != {want}")
    del eng
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------- text towers --

def _hf_text_state(width, layers, mlp, vocab, positions, seed, head):
    """An HF-named text-model state_dict (SigLIP with ``head``, else CLIP)
    of seeded weights: embeddings N(0, 0.02), linear weights N(0, 1/fan_in)
    with N(0, 0.02) biases, LayerNorm weights near 1 and biases near 0."""
    rng = np.random.default_rng(seed)

    def normal(*shape, s=1.0):
        return (rng.standard_normal(shape, dtype=np.float32) * s)

    def linear(name, n_in, n_out):
        sd[f"{name}.weight"] = normal(n_out, n_in, s=n_in ** -0.5)
        sd[f"{name}.bias"] = normal(n_out, s=0.02)

    def norm(name):
        sd[f"{name}.weight"] = 1.0 + normal(width, s=0.1)
        sd[f"{name}.bias"] = normal(width, s=0.1)

    p = "text_model"
    sd = {f"{p}.embeddings.token_embedding.weight":
          normal(vocab, width, s=0.02),
          f"{p}.embeddings.position_embedding.weight":
          normal(positions, width, s=0.02)}
    for i in range(layers):
        L = f"{p}.encoder.layers.{i}"
        norm(f"{L}.layer_norm1")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{L}.self_attn.{n}", width, width)
        norm(f"{L}.layer_norm2")
        linear(f"{L}.mlp.fc1", width, mlp)
        linear(f"{L}.mlp.fc2", mlp, width)
    norm(f"{p}.final_layer_norm")
    if head:
        linear(f"{p}.head", width, width)
    else:
        sd[f"{p}.embeddings.position_ids"] = np.arange(positions)[None]
    return sd


def _clip_files(directory: str, words, vocab_size: int) -> tuple:
    """vocab.json and merges.txt of a CLIP byte-BPE in the released
    layout: the byte characters and their word ends, the merges that
    build ``words``, unused tokens up to ``vocab_size`` - 2, then
    <|startoftext|> and <|endoftext|> as the last two ids."""
    from panst3r_torch.models.clip_text import _bytes_to_unicode

    chars = sorted(set(_bytes_to_unicode().values()))
    vocab = {c: i for i, c in enumerate(chars)}
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    merges = []
    for w in words:
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            if f"{parts[0]} {parts[1]}" not in merges:
                merges.append(f"{parts[0]} {parts[1]}")
            merged = parts[0] + parts[1]
            vocab.setdefault(merged, len(vocab))
            parts = [merged] + parts[2:]
    for i in range(len(vocab), vocab_size - 2):
        vocab[f"<unused{i}>"] = i
    vocab["<|startoftext|>"] = vocab_size - 2
    vocab["<|endoftext|>"] = vocab_size - 1
    vp, mp = f"{directory}/vocab.json", f"{directory}/merges.txt"
    with open(vp, "w") as f:
        json.dump(vocab, f)
    with open(mp, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return vp, mp


def _delta(before: dict) -> dict:
    """Launches per kernel since ``before`` (a ``_read_counts()``)."""
    return {k: n - before[k] for k, n in _read_counts().items()}


def phase_text():
    """The text towers at full width on the demo's class prompts: SigLIP
    (768, 12 layers, 12 heads, vocab 32000) through ``NativeTextTower``
    with ``WordPieces`` (K4 f32 once per layer: 12 launches a call) and
    CLIP (512, 12, 8, vocab 49408) through ``NativeClipTower`` on a
    vocabulary the phase writes (plain attention: no launch); seeded
    weights synthesized in HF naming and mapped by ``port_siglip_text`` /
    ``port_clip_text``; each card tower against the CPU's within TEXT_TOL;
    ``TextEncoder`` tables equal to the card tower's normalized output;
    then each card call timed.  Returns the launches of the path (the two
    tower calls and the two ``set_vocab`` calls)."""
    import tempfile

    import torch

    from panst3r_torch import port_checkpoint as pc
    from panst3r_torch.apps.demo import SCANNET_CLASSES
    from panst3r_torch.models import clip_text, siglip_text
    from panst3r_torch.models.text_encoder import (TextEncoder,
                                                   TextEncoderConfig)

    prompts = {name: text_prompts(name) for name in ("siglip", "clip")}
    towers, rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        c = siglip_text.SiglipTextConfig()
        ctx = pc.Port(_hf_text_state(c.width, c.layers, c.mlp_dim,
                                     c.vocab_size, c.max_positions, 0, True))
        tree = pc.port_siglip_text(ctx, c.layers)
        assert not ctx.unmapped(), ctx.unmapped()[:5]
        towers["siglip"] = [siglip_text.NativeTextTower(
            tree, WordPieces(c.vocab_size), c, device=d)
            for d in ("cpu", "cuda")]
        c = clip_text.ClipTextConfig()
        ctx = pc.Port(_hf_text_state(c.width, c.layers, c.mlp_dim,
                                     c.vocab_size, c.max_positions, 1,
                                     False))
        tree = pc.port_clip_text(ctx, c.layers)
        assert not ctx.unmapped(), ctx.unmapped()[:5]
        words = sorted({w for p in prompts["clip"] for w in p.split()})
        vp, mp = _clip_files(tmp, words, c.vocab_size)
        towers["clip"] = [clip_text.NativeClipTower(tree, vp, mp, c,
                                                    device=d)
                          for d in ("cpu", "cuda")]
        del tree, ctx
        _reset_counts()
        for name, (cpu, card) in towers.items():
            want = cpu(prompts[name])
            before = _read_counts()
            got = card(prompts[name])
            torch.cuda.synchronize()
            counts = _delta(before)
            expect = dict.fromkeys(counts, 0)
            if name == "siglip":
                expect["flash_fwd"] = card.model.config.layers
            # TextEncoder with the card tower: its table is the tower's
            # output, L2-normalized
            enc = TextEncoder(TextEncoderConfig(model_name=name),
                              tower_fn=card)
            enc.set_vocab(SCANNET_CLASSES)
            table = enc(SCANNET_CLASSES)
            ref = got / np.linalg.norm(got, axis=-1, keepdims=True)
            rows[name] = {
                "phase": "text", "tower": name,
                "prompts": len(prompts[name]), "shape": list(got.shape),
                "max_abs_err_vs_cpu": float(np.abs(got - want).max()),
                "limit": TEXT_TOL,
                "pooled_max_abs": float(np.abs(want).max()),
                "launches": counts, "expected_launches": expect,
                "encoder_table_max_abs_diff": float(
                    np.abs(table - ref).max()),
                "finite": bool(np.isfinite(got).all())}
        torch.cuda.synchronize()
        counts = _read_counts("text")
        rows["siglip"]["tokens_per_prompt"] = sorted(
            set(text_prompt_mask().sum(1).tolist()))
        for name, (_, card) in towers.items():
            row = rows[name]
            row["ms_per_call"] = time_ms(lambda: card(prompts[name]),
                                         reps=10)
            emit(row)
            if not (row["finite"] and row["max_abs_err_vs_cpu"] <= TEXT_TOL
                    and row["launches"] == row["expected_launches"]
                    and row["encoder_table_max_abs_diff"] <= 1e-6):
                raise AssertionError(f"text {name}: {row}")
    want = dict.fromkeys(counts, 0)
    want["flash_fwd"] = 2 * towers["siglip"][1].model.config.layers
    if counts != want:
        raise AssertionError(f"text: launches {counts} != {want}")
    del towers
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------ train app --

TRAIN_APP_HW = (432, 576)          # the phase's ScanNet++ frames (H, W)
# configs/train_v2.yaml's buckets, (W, H)
TRAIN_V2_RESOLUTIONS = ((512, 384), (512, 336), (512, 288), (512, 256),
                        (512, 160))


def write_scannetpp(root: str, classes, n_views: int = 5,
                    hw=TRAIN_APP_HW, seed: int = 0) -> None:
    """A ScanNet++-layout dataset (the layout ``data/scannetpp.py`` reads)
    of one scene: ``n_views`` jpg frames of ``hw`` with depth pngs and
    panoptic pngs of up to 12 instances of ``classes``, pinhole
    intrinsics, identity poses and a chain of covisible pairs
    (``n_views`` - 1 tuples)."""
    import os

    import cv2

    from panst3r_torch.data.utils import id2rgb

    H, W = hw
    rng = np.random.default_rng(seed)
    scene = "scene0000"
    for sub in ("images", "depth", "panoptic"):
        os.makedirs(f"{root}/{scene}/{sub}", exist_ok=True)
    inst_cls = rng.integers(0, len(classes), 13)
    yy, xx = np.mgrid[0:H, 0:W]
    names = []
    for v in range(n_views):
        name = f"frame{v:03d}"
        names.append(name)
        base = np.stack([(xx * (v + 1) // 4) % 256, (yy * 3 // 2) % 256,
                         ((xx + yy) // 3 + 40 * v) % 256], -1)
        img = np.clip(base + rng.integers(-20, 21, (H, W, 3)), 0, 255)
        cv2.imwrite(f"{root}/{scene}/images/{name}.jpg",
                    img.astype(np.uint8))
        cv2.imwrite(f"{root}/{scene}/depth/{name}.png",
                    rng.integers(500, 6000, (H, W)).astype(np.uint16))
        pan = np.zeros((H, W), np.int64)
        for i in range(1, 13):
            if rng.random() < 0.25:
                continue                      # not seen in this view
            h, w = rng.integers(H // 8, H // 2), rng.integers(W // 8, W // 2)
            y, x = rng.integers(0, H - h), rng.integers(0, W - w)
            pan[y:y + h, x:x + w] = i * 256 + inst_cls[i]
        cv2.imwrite(f"{root}/{scene}/panoptic/{name}.png",
                    cv2.cvtColor(id2rgb(pan), cv2.COLOR_RGB2BGR))
    K = [[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]]
    np.savez(f"{root}/all_metadata.npz", scenes=np.asarray([scene]),
             sceneids=np.zeros(n_views, int), images=np.asarray(names),
             intrinsics=np.asarray([K] * n_views, np.float32),
             trajectories=np.asarray([np.eye(4)] * n_views, np.float32),
             pairs=np.asarray([[v, v + 1, 0.8] for v in range(n_views - 1)]),
             cls_sep=256)
    with open(f"{root}/categories.json", "w") as f:
        json.dump([{"id": i, "name": c} for i, c in enumerate(classes)], f)


def every_bucket_seed(n_tuples: int, batch_size: int, n_buckets: int) -> int:
    """The least seed whose epoch 0 of ``data/loader.py::epoch_batches``
    over ``n_tuples`` draws each of ``n_buckets`` buckets once (its draws
    replayed: the permutation, then one bucket per batch)."""
    assert n_tuples // batch_size == n_buckets
    for seed in range(10_000):
        rng = np.random.default_rng(seed)
        rng.permutation(n_tuples)
        if sorted(int(rng.integers(n_buckets)) for _ in range(n_buckets)) \
                == list(range(n_buckets)):
            return seed
    raise AssertionError("no seed draws every bucket")


@contextlib.contextmanager
def _train_app_probes(rec: dict, trace_epoch=None):
    """Instrument ``apps/train.py`` for the block: each micro-step timed
    (the card synchronized before and after) with its bucket; the wait for
    each batch at the consumer (after prefetch) and its making in the
    loader; with ``trace_epoch``, that epoch traced (``profile_by_kernel``:
    the card's idle share)."""
    import torch

    from panst3r_torch.apps import train as tapp
    from panst3r_torch.core.profiling import profile_by_kernel

    real = {k: getattr(tapp, k) for k in ("make_train_step", "epoch_batches",
                                          "prefetch", "train_one_epoch")}

    def make_train_step(model, opt, loss, grid, **kw):
        step = real["make_train_step"](model, opt, loss, grid, **kw)

        def timed(batch, cls, gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(batch, cls, gen)
            torch.cuda.synchronize()
            rec["steps"].append({"hw": list(batch["images"].shape[2:4]),
                                 "s": time.perf_counter() - t0})
            return out
        return timed

    def timed_iter(it, key):
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            rec[key].append(time.perf_counter() - t0)
            yield item

    def train_one_epoch(state, steps, batches, *a, **kw):
        epoch = a[1]
        if epoch != trace_epoch:
            return real["train_one_epoch"](state, steps, batches, *a, **kw)
        res = {}
        prof = profile_by_kernel(lambda: res.setdefault("r", real[
            "train_one_epoch"](state, steps, batches, *a, **kw)), top=12)
        rec["trace"] = prof
        return res["r"]

    tapp.make_train_step = make_train_step
    tapp.epoch_batches = lambda *a, **kw: timed_iter(
        real["epoch_batches"](*a, **kw), "load_s")
    tapp.prefetch = lambda it, depth: timed_iter(
        real["prefetch"](it, depth), "wait_s")
    tapp.train_one_epoch = train_one_epoch
    try:
        yield
    finally:
        for k, v in real.items():
            setattr(tapp, k, v)


def _step_log(out_dir) -> list:
    with open(f"{out_dir}/log.txt") as f:
        return [json.loads(ln) for ln in f if '"train/loss"' in ln]


def phase_train_app():
    """The training entry point (``apps/train.py::train``) at full v2
    width and depth with configs/train_v2.yaml's recipe: the five buckets,
    V=5, B=2, accum_iter 2, ColorJitter, memory cores of 2-5 views, four
    spawned loader workers, random class embeddings, no warmup, on a
    ScanNet++-layout dataset the phase writes (4 tuples: 2 micro-steps an
    epoch, their buckets drawn per batch).  Two epochs in one run; one
    epoch, then a run that resumes at epoch 1: its losses and final
    weights against the straight run's; one epoch of 10 resampled tuples
    whose 5 batches draw every bucket (``every_bucket_seed``); each run's
    launches against ``expected_train_launches`` summed over the buckets
    its batches drew;
    log.txt and the last, 0 and final checkpoints; then ``final`` through
    ``build_engine`` and one v2 ``run_device`` scene with the launches
    of ``expected_launches``.  Returns the launches of the three runs."""
    import dataclasses as dc
    import os
    import tempfile

    import torch

    from panst3r_torch.apps import train as tapp
    from panst3r_torch.apps.common import build_engine
    from panst3r_torch.apps.demo import SCANNET_CLASSES
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.core.checkpoint import load_checkpoint

    cfg = _config("v2")
    V = 5
    with tempfile.TemporaryDirectory() as tmp:
        data = f"{tmp}/scannetpp"
        t0 = time.perf_counter()
        write_scannetpp(data, SCANNET_CLASSES, n_views=V)
        write_s = time.perf_counter() - t0
        base = tapp.ExperimentConfig(
            model_preset="v2", data_root=data,
            resolution=TRAIN_V2_RESOLUTIONS, num_views=V, aug_crop=16,
            transform="ColorJitter", min_memory_num_views=2,
            max_memory_num_views=5, train=train_config(epochs=2),
            keep_freq=10, print_freq=1, logger="tensorboard",
            loader_workers=4, loader_workers_mode="process",
            loader_prefetch=2, text_encoder="random")
        # the runs above draw 2 batches an epoch and need not reach every
        # bucket: one more epoch over 10 resampled tuples (5 batches) with
        # the first seed whose draws take each bucket once
        seed = every_bucket_seed(10, 2, len(TRAIN_V2_RESOLUTIONS))
        buckets = dc.replace(
            base, datasets=(tapp.DatasetSpec(root=data, ds_size=10),),
            keep_freq=0, train=dc.replace(base.train, seed=seed))
        recs = {}
        _reset_counts()
        for label, out, epochs, trace, b in (
                ("straight", "a", 2, 1, base), ("first", "b", 1, None, base),
                ("resumed", "b", 2, None, base),
                ("every_bucket", "c", 1, None, buckets)):
            exp = dc.replace(b, output_dir=f"{tmp}/{out}",
                             train=dc.replace(b.train, epochs=epochs))
            rec = recs[label] = {"steps": [], "load_s": [], "wait_s": []}
            before = _read_counts()
            t0 = time.perf_counter()
            with _train_app_probes(rec, trace):
                res = tapp.train(exp)
            seconds = time.perf_counter() - t0
            counts = _delta(before)
            want = dict.fromkeys(counts, 0)
            by_bucket = {}
            for st in rec["steps"]:
                h, w = st["hw"]
                for k, n in expected_train_launches(
                        cfg, V, (h // 16, w // 16)).items():
                    want[k] += n
                by_bucket.setdefault(f"{h}x{w}", []).append(st["s"])
            row = {"phase": "train_app", "run": label,
                   "start_epoch": res["start_epoch"], "epochs": epochs,
                   "seconds": seconds, "stats": res["stats"],
                   "micro_step_s_by_bucket": by_bucket,
                   "loader_make_s_per_batch": rec["load_s"],
                   "loader_wait_s_per_batch": rec["wait_s"],
                   "launches": counts, "expected_launches": want}
            if "trace" in rec:
                tr = rec["trace"]
                row["traced_epoch"] = {
                    "epoch": trace, "wall_ms": tr["wall_ms"],
                    "device_busy_ms": tr["device_busy_ms"],
                    "device_idle_share": tr["device_idle_share"],
                    "top": tr["top"][:8]}
            emit(row)
            rec["start_epoch"] = res["start_epoch"]
            if counts != want or not rec["steps"]:
                raise AssertionError(f"train_app {label}: launches {counts}"
                                     f" != {want}")
            torch.cuda.empty_cache()
        total = _read_counts("train_app")
        a, b = f"{tmp}/a", f"{tmp}/b"
        files = {d: sorted(os.listdir(d)) for d in (a, b)}
        la, lb = _step_log(a), _step_log(b)
        loss_rel = max(abs(x["train/loss"] - y["train/loss"])
                       / abs(y["train/loss"]) for x, y in zip(la, lb))
        wa, _, _ = load_checkpoint(a, "final")
        wb, _, _ = load_checkpoint(b, "final")
        diffs = [(wa[k].float() - wb[k].float()).abs() for k in wa]
        w_max = max(float(d.max()) for d in diffs)
        updates = len(la) // base.train.accum_iter
        w_limit = 2 * base.train.lr * updates
        hw = {k: [s["hw"] for s in r["steps"]] for k, r in recs.items()}
        checks = {
            "every_bucket": sorted(map(tuple, hw["every_bucket"])) == sorted(
                (h, w) for w, h in TRAIN_V2_RESOLUTIONS),
            "resumed_at_epoch_1": recs["first"]["start_epoch"] == 0
            and recs["resumed"]["start_epoch"] == 1,
            "files": all({"log.txt", "last", "0", "final"} <= set(f)
                         for f in files.values()),
            "steps_logged": len(la) == len(lb) == 4,
            "same_batches": hw["straight"] == hw["first"] + hw["resumed"],
            "losses": loss_rel <= RESUME_LOSS_RTOL,
            "weights": wa.keys() == wb.keys() and w_max <= w_limit,
            "weights_bit_equal": w_max == 0.0,
            "optimizer_state_in_last": os.path.exists(
                f"{b}/last/optimizer.pt")
            and not os.path.exists(f"{b}/final/optimizer.pt"),
        }
        row = {"phase": "train_app", "compare": "resumed_vs_straight",
               "files": files, "buckets_drawn": hw["straight"],
               "losses": [x["train/loss"] for x in la],
               "loss_max_rel_diff": loss_rel, "loss_limit": RESUME_LOSS_RTOL,
               "weights_max_abs_diff": w_max, "weights_limit": w_limit,
               "weights_bit_equal": w_max == 0.0,
               "params_differing": int(sum(int((d > 0).sum())
                                           for d in diffs)),
               "dataset_write_s": write_s}
        del wa, wb, diffs
        # the final checkpoint serves a scene
        t0 = time.perf_counter()
        eng, classes, emb = build_engine("v2", Bucket(384, 512),
                                         checkpoint=f"{b}/final",
                                         num_keyframes=4)
        load_s = time.perf_counter() - t0
        images, portrait, _ = _inputs(8)
        _reset_counts()
        out = eng.run_device(images, portrait, emb)
        torch.cuda.synchronize()
        counts = _read_counts()
        want = expected_launches(cfg, 8, 4, eng.chunk)
        finite = all(bool(torch.isfinite(v).all()) for v in out.values()
                     if isinstance(v, torch.Tensor) and v.is_floating_point())
        checks["final_serves"] = (classes == sorted(SCANNET_CLASSES)
                                  and emb.shape == (
                                      len(classes),
                                      cfg.panoptic.mask_transformer.lang_dim)
                                  and finite and counts == want)
        row.update(final_to_engine_s=load_s, final_scene_launches=counts,
                   final_scene_finite=finite, checks=checks)
        emit(row)
        if not all(checks.values()):
            raise AssertionError(f"train_app: {checks}")
        del eng, out
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------------ SLAM --

SLAM_HW = (384, 512)
# the card-against-CPU frontend check: raw pointmaps within small's
# run_device limit
SLAM_PM_ATOL = 2e-4
# stream against process on the card
SLAM_STREAM_ATOL = 1e-5
# the eval app's card-against-CPU check: IoU sums per class, and the
# share of pixels whose fused segment differs
EVAL_IOU_ATOL = 1e-3
EVAL_PIXEL_TOL = 1e-3


def expected_slam_launches(cfg, n_frames: int, n_keyframes: int):
    """Launches per kernel of ``apps/slam.py::run_slam`` over ``n_frames``
    frames of which ``n_keyframes`` became keyframes: the encoder once per
    frame and once more for frame 0's render at the end; a render per
    frame after the first and frame 0's; a memory update for the first
    pair and for every later keyframe.  Each render and update runs the
    decoder (K1 and K2 per layer); no DINO, no head."""
    dec = cfg.decoder.depth
    calls = n_frames + n_keyframes - 1            # renders + updates
    return {"tower_self": cfg.encoder.depth * (n_frames + 1) + dec * calls,
            "tower_cross": dec * calls, "tower_cross_int8": 0,
            "masked_attn": 0, "flash_fwd": 0, "flash_bwd": 0,
            "packed_flash": 0}


def slam_frames(n: int, seed: int = 0) -> np.ndarray:
    """n uint8 frames of ``SLAM_HW`` of a camera panning over one seeded
    image: frame i is the image rolled 16·i pixels along its width (the
    drift of tests/test_slam.py's long sessions)."""
    base = np.random.default_rng(seed).integers(0, 256, (*SLAM_HW, 3),
                                                dtype=np.uint8)
    return np.stack([np.roll(base, 16 * i, axis=1) for i in range(n)])


@contextlib.contextmanager
def _frame_probe(rec: list):
    """Each ``IncrementalFrontend.process`` call timed, the card
    synchronized before and after: (seconds, is_keyframe)."""
    import torch

    from panst3r_torch.engine import slam

    real = slam.IncrementalFrontend.process

    def timed(self, image, frame_id):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, image, frame_id)
        torch.cuda.synchronize()
        rec.append((time.perf_counter() - t0, out["is_keyframe"]))
        return out
    slam.IncrementalFrontend.process = timed
    try:
        yield
    finally:
        slam.IncrementalFrontend.process = real


def _slam_engine(cfg, device="cuda", amp=True, seed=0):
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    return InferenceEngine(build_model(cfg, device=device, seed=seed),
                           Bucket(*SLAM_HW), chunk=1, amp=amp,
                           device=device)


def phase_slam():
    """The SLAM app at full v1 width (bf16, 384x512, chunk 1, the app's
    settings): ``run_slam`` on 40 drifting uint8 frames with the pose
    graph and BA, launches against ``expected_slam_launches``, frames/s,
    ms per plain and per keyframe frame, the backends' seconds and costs,
    the peak memory.  Then a 60-frame session with at most 6 keyframes
    (interval only): ``stream`` against ``process`` frame by frame, the
    protected keyframes kept, the slots a permutation, ``valid`` counting
    the occupied tokens.  Then both backends twice on the same pointmaps:
    the same bits.  Then depth 2 in f32, card against CPU: 8 always-novel
    frames, at most 4 keyframes.  Returns the launches of ``run_slam``."""
    import torch

    from panst3r_torch.apps.slam import run_slam
    from panst3r_torch.engine import ba as balib
    from panst3r_torch.engine import slam

    cfg = _config("v1")
    eng = _slam_engine(cfg)
    frames = slam_frames(40)
    run_slam(eng, frames[:3], ba=True)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec, backend = [], {}
    real = {"refine_scene_poses": slam.refine_scene_poses,
            "refine_scene_ba": balib.refine_scene_ba}

    def timer(mod, name):
        def fn(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            backend[name] = time.perf_counter() - t0
            return out
        setattr(mod, name, fn)
    timer(slam, "refine_scene_poses")
    timer(balib, "refine_scene_ba")
    _reset_counts()
    try:
        with _frame_probe(rec):
            t0 = time.perf_counter()
            res = run_slam(eng, frames, ba=True)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
    finally:
        slam.refine_scene_poses = real["refine_scene_poses"]
        balib.refine_scene_ba = real["refine_scene_ba"]
    counts = _read_counts("slam")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kf = res["keyframes"]
    want = expected_slam_launches(cfg, len(frames), len(kf))
    plain = [s for s, k in rec[2:] if not k]
    key = [s for s, k in rec[2:] if k]
    frame_s = sum(s for s, _ in rec)
    finite = all(bool(np.isfinite(v).all())
                 for v in (*res["pointmaps"].values(), res["poses"]))
    row = {"phase": "slam", "frames": len(frames), "keyframes": kf,
           "seconds": total, "frames_per_s": len(frames) / frame_s,
           "ms_plain_frame": 1e3 * float(np.median(plain)) if plain
           else None,
           "ms_keyframe_frame": 1e3 * float(np.median(key)) if key
           else None,
           "ms_first_pair": [1e3 * s for s, _ in rec[:2]],
           "backend_s": backend, "gn_costs": res["gn_costs"],
           "ba_costs": res["ba_costs"], "peak_gib": peak,
           "memory_slots": 64 * eng.n_tokens, "finite": finite,
           "launches": counts, "expected_launches": want}
    emit(row)
    if counts != want or not finite or len(kf) < 3:
        raise AssertionError(f"slam: launches {counts} != {want}, "
                             f"finite={finite}, keyframes {kf}")

    # eviction: stream against process over 60 frames, 6 keyframes
    ev = slam_frames(60, seed=1)
    fronts, outs = {}, {}
    for mode in ("process", "stream"):
        fe = fronts[mode] = slam.IncrementalFrontend(
            eng, sim_threshold=-1.0, max_interval=5, max_keyframes=6)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "process":
            outs[mode] = [fe.process(f, i) for i, f in enumerate(ev)]
        else:
            outs[mode] = list(fe.stream(ev))
        torch.cuda.synchronize()
        outs[mode + "_s"] = time.perf_counter() - t0
    a, b = outs["process"], outs["stream"]
    st = fronts["stream"].state
    pm_err = max(float(np.abs(x["pointmaps_raw"] - y["pointmaps_raw"])
                       .max()) for x, y in zip(a[1:], b[1:]))
    checks = {
        "same_keyframes": [o["is_keyframe"] for o in a]
        == [o["is_keyframe"] for o in b]
        and st.keyframe_ids == fronts["process"].state.keyframe_ids,
        "pointmaps_max_abs_diff": pm_err,
        "evictions": sum(o["is_keyframe"] for o in a) - 6,
        "protected_kept": st.keyframe_ids[:2] == [0, 1],
        "slots_permutation": sorted(st.slots) == list(range(6)),
        "valid_equals_occupied": int(st.mem.valid.sum())
        == st.mem.count == 6 * eng.n_tokens,
    }
    checks["ok"] = (checks["same_keyframes"] and pm_err <= SLAM_STREAM_ATOL
                    and checks["evictions"] > 0 and checks["protected_kept"]
                    and checks["slots_permutation"]
                    and checks["valid_equals_occupied"])
    emit({"phase": "slam", "run": "eviction", "frames": len(ev),
          "keyframe_ids": st.keyframe_ids, "slots": st.slots,
          "process_s": outs["process_s"], "stream_s": outs["stream_s"],
          "checks": checks})
    if not checks["ok"]:
        raise AssertionError(f"slam eviction: {checks}")
    del fronts, outs

    # the backends repeat bit for bit on the card
    pm = res["pointmaps"]
    g1, g2 = (slam.refine_scene_poses(pm, device="cuda") for _ in range(2))
    b1, b2 = (balib.refine_scene_ba(pm, res["poses_init"], device="cuda")
              for _ in range(2))
    rep = {"pose_graph_equal": all(torch.equal(x, y)
                                   for x, y in zip(g1, g2)),
           "ba_equal": all(np.array_equal(x, y) for x, y in zip(b1, b2)),
           # run_slam's call on the same pointmaps
           "init_equal_run": bool(np.array_equal(g1[1].cpu().numpy(),
                                                 res["poses_init"]))}
    emit({"phase": "slam", "run": "backends_twice", **rep})
    if not all(rep.values()):
        raise AssertionError(f"slam backends differ run to run: {rep}")
    del eng
    torch.cuda.empty_cache()

    # depth 2, f32: card against CPU
    small = _config("v1", depth=2)
    engs = {d: _slam_engine(small, d, amp=False, seed=0)
            for d in ("cpu", "cuda")}
    engs["cuda"].model.load_state_dict(engs["cpu"].model.state_dict())
    few = slam_frames(8, seed=2)
    got = {}
    for d, e in engs.items():
        fe = slam.IncrementalFrontend(e, sim_threshold=1.1, max_interval=2,
                                      max_keyframes=4)
        got[d] = ([fe.process(f, i) for i, f in enumerate(few)],
                  list(fe.state.keyframe_ids), list(fe.state.slots))
    err = max(float(np.abs(x["pointmaps_raw"] - y["pointmaps_raw"]).max())
              for x, y in zip(got["cuda"][0][1:], got["cpu"][0][1:]))
    row = {"phase": "slam", "compare": "cuda_vs_cpu", "depth": 2,
           "frames": len(few), "keyframe_ids": got["cuda"][1],
           "slots": got["cuda"][2], "pointmaps_max_abs_err": err,
           "atol": SLAM_PM_ATOL}
    row["ok"] = (got["cuda"][1:] == got["cpu"][1:] and err <= SLAM_PM_ATOL)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"slam card vs CPU: {row}")
    del engs
    torch.cuda.empty_cache()
    return counts


def phase_slam_app():
    """The daemon's SLAM session over HTTP on 127.0.0.1 at full v1 width
    (bf16): ``/slam/start``, six ``/slam/frame`` and ``/slam/finish``; the
    finish's poses for all six frames against ``run_slam`` on the same
    frames without BA (the app's thresholds); seconds per request;
    launches against ``expected_slam_launches``.  Returns the launches of
    the session."""
    import io
    import threading
    import urllib.request

    import torch

    from panst3r_torch.apps.serve import SceneServer, make_server
    from panst3r_torch.apps.slam import run_slam

    cfg = _config("v1")
    eng = _slam_engine(cfg)
    frames = slam_frames(6, seed=3)
    want = run_slam(eng, frames)                        # also the warm-up
    srv = make_server(SceneServer(eng, np.zeros((4, 768), np.float32)),
                      "127.0.0.1", 0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def post(path, body=b""):
        t0 = time.perf_counter()
        req = urllib.request.Request(url + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = r.read()
        times.setdefault(path, []).append(time.perf_counter() - t0)
        return np.load(io.BytesIO(out)) if out[:2] == b"PK" else out

    times = {}
    try:
        _reset_counts()
        started = post("/slam/start")
        kf = []
        for i, f in enumerate(frames):
            buf = io.BytesIO()
            np.savez(buf, image=f)
            if bool(post("/slam/frame", buf.getvalue())["is_keyframe"]):
                kf.append(i)
        fin = dict(post("/slam/finish"))
        counts = _read_counts("slam_app")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    expected = expected_slam_launches(cfg, len(frames), len(kf))
    checks = {"started": started == b"ok",
              "frame_ids": fin["frame_ids"].tolist() == list(range(6)),
              "keyframes": fin["keyframe_ids"].tolist() == kf
              == want["keyframes"],
              "poses_max_abs_diff": float(np.abs(fin["poses"]
                                                 - want["poses"]).max())}
    checks["ok"] = (checks["started"] and checks["frame_ids"]
                    and checks["keyframes"] and fin["poses"].shape
                    == (6, 4, 4) and checks["poses_max_abs_diff"] <= 1e-5)
    emit({"phase": "slam_app", "frames": len(frames), "request_s": times,
          "launches": counts, "expected_launches": expected,
          "checks": checks})
    if not checks["ok"] or counts != expected:
        raise AssertionError(f"slam_app: {checks}, launches {counts}")
    del eng
    torch.cuda.empty_cache()
    return counts


def write_benchmark_scene(root: str, classes, n_views: int = 4,
                          hw=TRAIN_APP_HW, seed: int = 0) -> None:
    """One scene in the rendered-test layout ``data/benchmarks.py`` reads:
    ``categories.json``, ``scene00/color/*.jpg`` and combined
    ``scene00/panoptic/*.png`` maps (id2rgb of instance·256 + class): 12
    rectangles over a background segment of class 1, no void pixel (so
    that every predicted segment is scored)."""
    import os

    import cv2

    from panst3r_torch.data.utils import id2rgb

    H, W = hw
    rng = np.random.default_rng(seed)
    for sub in ("color", "panoptic"):
        os.makedirs(f"{root}/scene00/{sub}", exist_ok=True)
    inst_cls = rng.integers(1, len(classes), 13)
    yy, xx = np.mgrid[0:H, 0:W]
    for v in range(n_views):
        base = np.stack([(xx * (v + 2) // 5) % 256, (yy * 2) % 256,
                         ((xx + 2 * yy) // 3 + 30 * v) % 256], -1)
        img = np.clip(base + rng.integers(-20, 21, (H, W, 3)), 0, 255)
        cv2.imwrite(f"{root}/scene00/color/{v:04d}.jpg",
                    img.astype(np.uint8))
        pan = np.full((H, W), 13 * 256 + 1, np.int64)
        for i in range(1, 13):
            h, w = rng.integers(H // 8, H // 2), rng.integers(W // 8, W // 2)
            y, x = rng.integers(0, H - h), rng.integers(0, W - w)
            pan[y:y + h, x:x + w] = i * 256 + inst_cls[i]
        cv2.imwrite(f"{root}/scene00/panoptic/{v:04d}.png",
                    cv2.cvtColor(id2rgb(pan), cv2.COLOR_RGB2BGR))
    with open(f"{root}/categories.json", "w") as f:
        json.dump([{"id": i, "name": c} for i, c in enumerate(classes)], f)


def eval_agreement(engs: dict, views, classes, emb, evaluate_scene,
                   hw=(384, 512)) -> dict:
    """The eval path on the engines ``engs["cuda"]`` and ``engs["cpu"]``
    (the same weights) over one scene: the fused segments (ids and
    classes) equal and at most ``EVAL_PIXEL_TOL`` of the fused maps'
    pixels differing; scored against the CPU's fused output taken as
    ground truth, every CPU segment a TP and the card's TP / FP / FN per
    class equal to the CPU's, IoU sums within ``EVAL_IOU_ATOL``; and
    ``evaluate_scene`` against the scene's written ground truth equal the
    same way."""
    import dataclasses as dc
    from collections import defaultdict

    from panst3r_torch.data.loader import canonicalize_views
    from panst3r_torch.engine.eval import PQStat, scene_pq

    def differing(a, b):
        return {c: (dc.astuple(a[c]), dc.astuple(b[c]))
                for c in sorted(set(a) | set(b))
                if dc.astuple(a[c])[1:] != dc.astuple(b[c])[1:]
                or abs(a[c].iou_sum - b[c].iou_sum) > EVAL_IOU_ATOL}

    written = {d: evaluate_scene(e, views, classes, emb)
               for d, e in engs.items()}
    canon = canonicalize_views(views)
    fused = {d: e.fuse(e.run_device(canon["images"].astype(np.float32),
                                     canon["portrait"], emb), hw)[0]
             for d, e in engs.items()}
    segs = {d: [(s["id"], s["category_id"]) for s in f["segments_info"]]
            for d, f in fused.items()}
    pans = {d: np.asarray(f["pan"], np.int64) for d, f in fused.items()}
    gt = [{"id": i, "category_id": c, "iscrowd": 0} for i, c in segs["cpu"]]
    vs_cpu = {}
    for d in fused:
        vs_cpu[d] = defaultdict(PQStat)
        scene_pq(pans[d], fused[d]["segments_info"], pans["cpu"], gt,
                 vs_cpu[d])
    a, b = vs_cpu["cuda"], vs_cpu["cpu"]
    row = {"segments_cpu": segs["cpu"],
           "segments_equal": segs["cuda"] == segs["cpu"],
           "pan_pixels_differing": float((pans["cuda"] != pans["cpu"])
                                         .mean()),
           "pan_pixel_limit": EVAL_PIXEL_TOL,
           "vs_cpu_fused": {c: dc.astuple(a[c]) for c in sorted(a)},
           "tp_cpu": sum(st.tp for st in b.values()),
           "differing_vs_cpu_fused": differing(a, b),
           "cpu_vs_written": {c: dc.astuple(st) for c, st in
                              sorted(written["cpu"].items())},
           "differing_vs_written": differing(written["cuda"],
                                             written["cpu"]),
           "atol": EVAL_IOU_ATOL}
    row["ok"] = bool(row["segments_equal"] and row["tp_cpu"]
                     and row["tp_cpu"] == len(segs["cpu"])
                     and not row["differing_vs_cpu_fused"]
                     and not row["differing_vs_written"]
                     and row["pan_pixels_differing"] <= EVAL_PIXEL_TOL)
    return row


def phase_eval():
    """The PQ evaluation: ``apps/eval.py::main`` at full v1 width on a
    ScanNet++-layout scene (``write_scannetpp``, 4 views a sample, K = 4)
    with standard v2 fusion and with QUBO, then at full v2 width on a
    rendered-test-layout scene (``--benchmark scannet``, LoftUp's f32 K4);
    the PQ dict, seconds per scene and launches (``expected_launches``) of
    each.  Then the train app with ``eval_every=1``: one epoch of two v2
    micro-steps with the train_v2 recipe, the PQ of two samples in its
    stats (the engine in f32).  Then at depth 2 in f32, card against CPU
    on the benchmark scene, class embeddings under which four queries
    pass fusion's threshold (``segment_classes``), held by
    ``eval_agreement``.  Returns the launches of the three ``main`` runs."""
    import tempfile

    import torch

    from panst3r_torch.apps import eval as eval_app
    from panst3r_torch.apps import train as tapp
    from panst3r_torch.apps.demo import SCANNET_CLASSES
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.data.benchmarks import BenchmarkScenes
    from panst3r_torch.data.loader import canonicalize_views
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    real = eval_app.evaluate_scene
    scene_s = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        scene_s.append(time.perf_counter() - t0)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        spp, bench = f"{tmp}/scannetpp", f"{tmp}/bench"
        write_scannetpp(spp, SCANNET_CLASSES, n_views=5)
        write_benchmark_scene(bench, ["void"] + SCANNET_CLASSES)
        eval_app.evaluate_scene = timed
        _reset_counts()
        try:
            for preset, root, bm, fusion in (
                    ("v1", spp, "scannetpp", "standard_v2"),
                    ("v1", spp, "scannetpp", "qubo"),
                    ("v2", bench, "scannet", "standard_v2")):
                scene_s.clear()
                before = _read_counts()
                t0 = time.perf_counter()
                res = eval_app.main([
                    "--data-root", root, "--preset", preset,
                    "--benchmark", bm, "--fusion", fusion,
                    "--num-scenes", "1", "--num-views", "4",
                    "--num-keyframes", "4", "--resolution", "512", "384"])
                seconds = time.perf_counter() - t0
                counts = _delta(before)
                want = expected_launches(_config(preset), 4, 4, 4)
                emit({"phase": "eval", "preset": preset, "benchmark": bm,
                      "fusion": fusion, "pq": res, "main_s": seconds,
                      "scene_s": list(scene_s), "launches": counts,
                      "expected_launches": want})
                if counts != want or not np.isfinite(res["PQ"]):
                    raise AssertionError(f"eval {preset} {fusion}: launches"
                                         f" {counts} != {want}, {res}")
        finally:
            eval_app.evaluate_scene = real
        total = _read_counts("eval")

        # the train app with the evaluation every epoch
        exp = tapp.ExperimentConfig(
            model_preset="v2", data_root=spp,
            resolution=TRAIN_V2_RESOLUTIONS, num_views=5, aug_crop=16,
            transform="ColorJitter", min_memory_num_views=2,
            max_memory_num_views=5, train=train_config(epochs=1),
            keep_freq=0, print_freq=1, logger="jsonl", loader_workers=4,
            loader_workers_mode="process", loader_prefetch=2,
            text_encoder="random", eval_every=1, eval_scenes=2,
            eval_keyframes=4, output_dir=f"{tmp}/train")
        before = _read_counts()
        t0 = time.perf_counter()
        out = tapp.train(exp)
        seconds = time.perf_counter() - t0
        counts = _delta(before)
        stats = out["stats"]
        row = {"phase": "eval", "run": "train_app_eval_every_1",
               "seconds": seconds, "stats": stats, "launches": counts}
        emit(row)
        if "eval_PQ" not in stats or not np.isfinite(stats["eval_PQ"]) \
                or not counts["flash_fwd"]:
            raise AssertionError(f"eval in the train app: {row}")
        torch.cuda.empty_cache()

        # depth 2, f32: card against CPU on the benchmark scene
        cfg = _config("v1", depth=2)
        ds = BenchmarkScenes(bench, "scannet", resolution=(512, 384),
                             num_views=4)
        classes = ds.classes
        views = ds[0]
        canon = canonicalize_views(views)
        cpu_model = build_model(cfg, device="cpu", seed=0)
        gpu_model = build_model(cfg, device="cuda", seed=1)
        gpu_model.load_state_dict(cpu_model.state_dict())
        engs = {d: InferenceEngine(m, Bucket(384, 512), num_keyframes=4,
                                   chunk=4, amp=False, device=d)
                for d, m in (("cuda", gpu_model), ("cpu", cpu_model))}
        emb = segment_classes(engs["cpu"], canon["images"],
                              canon["portrait"], ncls=len(classes))

        row = {"phase": "eval", "compare": "cuda_vs_cpu", "depth": 2,
               **eval_agreement(engs, views, classes, emb, real)}
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"eval card vs CPU: {row}")
    del engs, cpu_model, gpu_model
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------ multi_gpu --

# two ranks on the one card: the TP scene (V, K), the DP / mem scenes
# (V, K), the v2 depth-2 micro-step's batch (B, V, H, W), BA at SLAM's
# sizes (keyframes, anchors; every 8th pixel of 384x512 observed)
MULTI_GPU_HW = (384, 512)
MULTI_GPU_TP = (4, 2)
MULTI_GPU_DP = (8, 4)
MULTI_GPU_TRAIN = (2, 3, 160, 512)
MULTI_GPU_BA = (16, 8192)
MULTI_GPU_LR = 1e-3
# the limits of the data-parallel step against one rank on the whole
# batch (``dryrun.step_agreement``): the loss (relative), the summed
# gradients (over the largest), the weights where the gradient stands
# above f32 noise (elsewhere Adam's first step moves a weight by +-lr
# whatever the noise: ``weight_diff_noise`` is printed, not held)
DP_STEP_LIMITS = {"loss": 1e-6, "grad_diff": 1e-4, "weight_diff": 1e-6}


def _ba_problem(K, A, per_view, seed=0):
    """A BA problem of K poses and A anchors, ``per_view`` observations a
    view, noisy initial poses (pose 0 kept: the gauge)."""
    import torch

    from panst3r_torch.engine.slam import se3_exp, se3_inv

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((A, 3)).astype(np.float32) * 2.0
    gt = se3_exp(torch.as_tensor(rng.standard_normal((K, 6)) * 0.3,
                                 dtype=torch.float32)).numpy()
    ov = np.repeat(np.arange(K, dtype=np.int32), per_view)
    oa = rng.integers(0, A, K * per_view).astype(np.int32)
    inv = se3_inv(torch.as_tensor(gt)).numpy()
    xl = (np.einsum("oij,oj->oi", inv[ov, :3, :3], X[oa])
          + inv[ov, :3, 3]).astype(np.float32)
    noise = (rng.standard_normal((K, 6)) * 0.05).astype(np.float32)
    noise[0] = 0.0
    poses0 = (se3_exp(torch.as_tensor(noise)).numpy() @ gt).astype(
        np.float32)
    anchors0 = (X + rng.standard_normal(X.shape).astype(np.float32)
                * 0.02).astype(np.float32)
    return poses0, anchors0, ov, oa, xl, np.ones(len(ov), np.float32)


def phase_multi_gpu():
    """The multi-device layer on this one card: two gloo ranks on cuda:0
    run every check in one spawn (``dryrun.jobs_worker``; the kernels were
    built before, so the ranks only load them), then one NCCL rank.
    Each check is a sharded path against the same work on one rank, both
    timed in the rank (a rehearsal of the schedules, not a multi-card
    speed).  Returns rank 0's launches of the TP ``serve_device`` call."""
    import torch

    from panst3r_torch.core import distributed, dryrun
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.ops.tower_attention import supports_tower_attention

    t_phase = time.perf_counter()
    emit({"phase": "multi_gpu", "device_count": torch.cuda.device_count(),
          "ranks": 2, "backend": "gloo", "device": "cuda:0"})
    cfg, (Vt, Kt), (Vd, Kd) = _config("v1"), MULTI_GPU_TP, MULTI_GPU_DP
    H, W = MULTI_GPU_HW
    N = (H // 16) * (W // 16)
    eng, images, portrait, cls8 = _v1_engine(Vd, Kd, H, W)
    cls4 = segment_classes(eng, images[:Vt], portrait[:Vt])
    del eng
    torch.cuda.empty_cache()
    v1 = dryrun.ModelFactory(cfg, seed=0)
    bucket = Bucket(H, W)
    B, Vb, Hb, Wb = MULTI_GPU_TRAIN
    v2cfg = _config("v2", depth=2)
    v2 = dryrun.ModelFactory(v2cfg, seed=0)
    batch = dryrun.tiny_batch(
        B, Vb, hw=(Hb, Wb), ncls=32,
        lang_dim=v2cfg.panoptic.mask_transformer.lang_dim)
    grid = (Hb // 16, Wb // 16)
    mask_cls, mask_pred = dryrun.fusion_inputs(
        0, 1, Vd, cfg.panoptic.mask_transformer.num_queries, H // 2, W // 2,
        ncls=32, live=8)
    Kb, Ab = MULTI_GPU_BA
    ba = _ba_problem(Kb, Ab, (H // 8) * (W // 8))
    jobs = {
        "tp_serve_f32": (dryrun.serve_worker, (
            v1, {"images": images[:Vt], "portrait": portrait[:Vt],
                 "cls_emb": cls4}, bucket, Kt, 4, False, {}, ("tp",)),
            {"raw": False}),
        "tp_serve": (dryrun.serve_worker, (
            v1, {"images": images[:Vt], "portrait": portrait[:Vt],
                 "cls_emb": cls4}, bucket, Kt, 4, True, {}, ("tp",)),
            {"raw": False}),
        "dp_serve_many_and_mem_render": (dryrun.serve_worker, (
            v1, {"images": images, "portrait": portrait, "cls_emb": cls8,
                 "scenes": np.stack([images, np.roll(images, 1, axis=0)]),
                 "portraits": np.stack([portrait] * 2)}, bucket, Kd, 4,
            True, {"fusion_res": "hybrid", "with_cameras": True},
            ("dp", "mem")), {}),
        "dp_train_step": (dryrun.dp_step_worker, (
            v2, batch, grid, MULTI_GPU_LR), {}),
        "fusion_sharded": (dryrun.fusion_worker, (
            mask_cls, mask_pred, (H, W), {}), {}),
        "bundle_adjust_sharded": (dryrun.ba_worker, ba, {"iters": 8}),
    }
    t0 = time.perf_counter()
    try:
        ranks = distributed.launch(
            dryrun.jobs_worker, 2, "gloo", "cuda",
            [(dryrun.strict_f32, (), {})] + list(jobs.values()),
            timeout=600)
    except RuntimeError as e:
        # any error fails the phase, a collective gloo refuses for a CUDA
        # tensor too: that check would not be rehearsed on the card
        emit({"phase": "multi_gpu", "error": str(e)[-4000:],
              "gloo_in_error": "gloo" in str(e).lower()})
        raise
    spawn_s = time.perf_counter() - t0
    results = {name: [r[i + 1] for r in ranks]
               for i, name in enumerate(jobs)}
    bad, rows = [], {}

    def record(name, ok, r0, **extra):
        rows[name] = {"ok": bool(ok), "seconds": r0.get("seconds"),
                      "seconds_one_rank": r0.get("seconds_one_rank"),
                      "job_seconds": per_rank[0].get("job_seconds"),
                      **extra}
        if not ok:
            bad.append(name)

    for name, per_rank in results.items():
        r0 = per_rank[0]
        if name == "tp_serve_f32":
            # f32 at full depth: the Megatron split reassociates f32 sums
            # only; the raw outputs within 1e-4 relative, the decoded
            # wire as below
            tp = [r["tp"] for r in per_rank]
            want = expected_serve_launches(cfg, Vt, Kt, N)
            close = all(t["raw_max_abs_diff"][k]
                        <= 1e-4 * max(1.0, t["raw_max_abs"][k])
                        for t in tp for k in t["raw_max_abs"])
            ok = close and all(t["pan_agree"] > 0.99
                               and t["conf_max_abs_diff_agreeing"] <= 0.05
                               and t["launches"] == want for t in tp)
            record(name, ok, tp[0], pan_agree=[t["pan_agree"] for t in tp],
                   conf_max_abs_diff=[t["conf_max_abs_diff"] for t in tp],
                   conf_max_abs_diff_agreeing=[
                       t["conf_max_abs_diff_agreeing"] for t in tp],
                   n_segments=tp[0]["n_segments"],
                   raw_max_abs_diff=tp[0]["raw_max_abs_diff"],
                   raw_max_abs=tp[0]["raw_max_abs"],
                   launches_per_rank=[t["launches"] for t in tp],
                   expected_launches=want)
        elif name == "tp_serve":
            # bf16 at full depth: the row-parallel sums are rounded once,
            # as one rank's.  A pixel near a tie between two queries
            # changes segment under any reassociation and then carries
            # the other query's conf (in f32 too: one pixel of the scene,
            # conf 0.149 apart, NVIDIA H100 80GB HBM3, 700 W), so conf is
            # held where the two wires agree on the segment
            tp = [r["tp"] for r in per_rank]
            want = expected_serve_launches(cfg, Vt, Kt, N)
            local = [(c.embed_dim // 2, c.num_heads // 2) for c in
                     (cfg.encoder, cfg.dino)] + [(cfg.decoder.dim // 2,
                                                  cfg.decoder.num_heads // 2)]
            gates = all(supports_tower_attention(N, C, h)
                        for C, h in local)
            ok = (gates and all(t["pan_agree"] > 0.99
                                and t["conf_max_abs_diff_agreeing"] <= 0.05
                                and t["launches"] == want for t in tp)
                  and tp[0]["n_segments"] > 0)
            record(name, ok, tp[0], pan_agree=[t["pan_agree"] for t in tp],
                   conf_max_abs_diff=[t["conf_max_abs_diff"] for t in tp],
                   conf_max_abs_diff_agreeing=[
                       t["conf_max_abs_diff_agreeing"] for t in tp],
                   n_segments=tp[0]["n_segments"],
                   raw_max_abs_diff=tp[0]["raw_max_abs_diff"],
                   raw_max_abs=tp[0]["raw_max_abs"],
                   launches_per_rank=[t["launches"] for t in tp],
                   expected_launches=want, local_shapes_on_k1=gates)
        elif name == "dp_serve_many_and_mem_render":
            dp = [r["dp"] for r in per_rank]
            mem = [r["mem"] for r in per_rank]
            record("dp_serve_many", all(d["wires_equal"] for d in dp), dp[0],
                   wire_bytes=int(dp[0]["wires"].nbytes))
            # each rank holds half of the bank, which gathers whole
            record("mem_render", all(
                m["wire_equal"] and m["run_equal"] and m["bank_equal"]
                and 2 * m["bank_bytes"] == m["bank_bytes_one_rank"]
                for m in mem), mem[0],
                **{k: mem[0][k] for k in ("bank_bytes", "bank_bytes_one_rank",
                                          "peak_bytes",
                                          "peak_bytes_one_rank")})
        elif name == "dp_train_step":
            lim = DP_STEP_LIMITS
            agree = [{"loss": abs(r["loss"] - r["loss_one"])
                      / abs(r["loss_one"]),
                      **{k: r[k] for k in lim if k != "loss"}}
                     for r in per_rank]
            ok = (per_rank[0]["loss"] == per_rank[1]["loss"]
                  and all(a[k] <= lim[k] for a in agree for k in lim))
            record(name, ok, r0, loss=[r["loss"] for r in per_rank],
                   loss_one=r0["loss_one"], agreement=agree, limits=lim,
                   weight_diff_noise=[r["weight_diff_noise"]
                                      for r in per_rank])
        elif name == "fusion_sharded":
            n_seg = int(np.asarray(r0["selected"]).sum())
            record(name, n_seg > 0 and all(r["bit_equal"] for r in per_rank),
                   r0, n_segments=n_seg)
        elif name == "bundle_adjust_sharded":
            pose_diff = max(float(np.abs(r["poses"] - r["poses_one"]).max())
                            for r in per_rank)
            cost_rel = max(float(np.abs(r["costs"] - r["costs_one"]).max()
                                 / r["costs_one"][0]) for r in per_rank)
            record(name, pose_diff <= 1e-4 and cost_rel <= 1e-3, r0,
                   pose_max_abs_diff=pose_diff, cost_max_rel_diff=cost_rel,
                   costs=[float(c) for c in r0["costs"]],
                   observations=int(len(ba[2])), anchors=Ab, keyframes=Kb)
    for name, row in rows.items():
        emit({"phase": "multi_gpu", "check": name, **row})

    # the production backend on one rank: NCCL's collectives and the
    # data-parallel step with a group of one
    t0 = time.perf_counter()
    nccl = distributed.launch(
        dryrun.jobs_worker, 1, "nccl", "cuda",
        [(dryrun.strict_f32, (), {}),
         (dryrun.nccl_worker, (v2, batch, grid, MULTI_GPU_LR), {})],
        timeout=300)[0][1]
    nccl_ok = (nccl["backend"] == "nccl" and nccl["all_reduce_ok"]
               and nccl["all_gather_ok"] and nccl["bit_equal"])
    emit({"phase": "multi_gpu", "check": "nccl_one_rank", "ok": nccl_ok,
          "spawn_seconds": time.perf_counter() - t0,
          **{k: nccl[k] for k in ("backend", "world", "all_reduce_ok",
                                  "all_gather_ok", "bit_equal", "loss",
                                  "loss_one", "seconds",
                                  "seconds_one_rank")}})
    if not nccl_ok:
        bad.append("nccl_one_rank")
    launches = (rows.get("tp_serve", {}).get("launches_per_rank")
                or [{}])[0]
    emit({"phase": "multi_gpu", "seconds": time.perf_counter() - t_phase,
          "spawn_seconds": spawn_s, "launches_rank0": launches})
    if bad:
        raise AssertionError(f"multi_gpu: failed checks {bad}")
    return launches


# --------------------------------------------------- checkpoint tools --

CKPT_SERVE = (8, 4, 384, 512)     # the serve scene from the file: V, K, H, W


def reference_sd_module():
    """``tests/torch_reference_sd.py``, loaded from its path: the card's
    machine has another package named ``tests`` on its path."""
    import importlib.util
    import pathlib

    name = "torch_reference_sd"
    if name not in sys.modules:
        path = pathlib.Path(__file__).resolve().parent / "tests" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


@contextlib.contextmanager
def sampled_rss(every: float = 0.1):
    """Yields {pid: peak resident bytes} of this process ("self") and of
    each pid the caller adds to it, read from /proc/<pid>/statm every
    ``every`` seconds on a thread (a child's peak: the high-water marks
    of a forked child can carry its parent's)."""
    import os
    import threading

    peak = {"self": 0}
    stop = threading.Event()
    page = os.sysconf("SC_PAGE_SIZE")

    def sample():
        while not stop.is_set():
            for pid in list(peak):
                try:
                    with open(f"/proc/{pid}/statm") as f:
                        rss = int(f.read().split()[1]) * page
                except (OSError, ValueError, IndexError):
                    continue
                peak[pid] = max(peak[pid], rss)
            stop.wait(every)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield peak
    finally:
        stop.set()
        thread.join()


def _ckpt_expected(cfg) -> dict:
    """Launches of verify_port's ``card_parity`` and ``forward`` stages:
    each runs a scene of PARITY_VIEWS views, all of them keyframes, at
    PARITY_HW as ``run_device`` runs it (one chunk)."""
    from panst3r_torch.tools import verify_port as vp

    V = vp.PARITY_VIEWS
    return expected_launches(cfg, V, V, V, grid=tuple(
        d // cfg.encoder.patch_size for d in vp.PARITY_HW))


def phase_checkpoint():
    """The checkpoint interop tools at full v1 and v2 width and depth on a
    reference-named state_dict synthesized from seed 0
    (``tests/torch_reference_sd.py``; no published weights are in the
    repository), saved as a ``.pth``: ``python -m
    panst3r_torch.port_checkpoint`` on it; ``tools/verify_port.py`` on the
    card (verdict ok, ``card_parity`` and ``forward`` run, their launches
    as ``_ckpt_expected``); the CLI's ``ported_params.npz`` into a model
    on the host (``apps/eval.py::load_ported_npz``) and ``export_model``
    of it against the file as template reproducing the file bit for bit
    (so ``dump_jax_params`` inverts ``load_jax_params`` at full width),
    all three beside ``verify_port`` on a thread;
    ``build_engine`` on the file and one ``serve_device`` scene
    (``CKPT_SERVE``) with launches as ``expected_serve_launches``, LoftUp's
    K4 all f32.  Seconds of each step (``verify_port``'s stages and the
    thread's steps share the host's cores: times under contention, not
    each step's own) and the host's memory: this process's and the
    command line's peak resident size over the preset (``sampled_rss``)
    and this process's high-water mark since it started.  Returns the v2
    serve scene's launches."""
    import concurrent.futures
    import tempfile

    import torch

    from panst3r_torch.apps.common import build_engine
    from panst3r_torch.apps.eval import load_ported_npz
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.models.panst3r import PanSt3R
    from panst3r_torch.port_checkpoint import peak_host_gib, state_dict_of
    from panst3r_torch.tools import verify_port
    from panst3r_torch.tools.export_checkpoint import export_model

    reference_state_dict = reference_sd_module().reference_state_dict
    V, K, H, W = CKPT_SERVE
    counts = {}
    for preset in ("v1", "v2"):
        cfg = _config(preset)
        secs, checks = {}, {}
        with tempfile.TemporaryDirectory() as tmp, sampled_rss() as rss:
            ref = f"{tmp}/reference.pth"
            t0 = time.perf_counter()
            sd = {k: v.cpu() for k, v in reference_state_dict(
                cfg, seed=0, device="cuda").items()}
            torch.save({"weights": sd}, ref)
            secs["synthesize_and_save"] = time.perf_counter() - t0
            n_scalars = sum(v.numel() for v in sd.values())

            template = state_dict_of(sd)

            def cli_then_export():
                """The port's command line, then its ``ported_params.npz``
                in a model on the host and that model exported against
                the file: host work, run beside ``verify_port``."""
                t = time.perf_counter()
                cli = subprocess.Popen(
                    [sys.executable, "-m", "panst3r_torch.port_checkpoint",
                     "--torch", ref, "--out", f"{tmp}/port"],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
                rss[cli.pid] = 0
                _, stderr = cli.communicate()
                secs["port_cli"] = time.perf_counter() - t
                if cli.returncode:
                    raise AssertionError(f"checkpoint {preset}: port CLI "
                                         f"failed: {stderr[-3000:]}")
                t = time.perf_counter()
                with torch.device("meta"):
                    model = PanSt3R(cfg)
                model = load_ported_npz(model.to_empty(device="cpu"),
                                        f"{tmp}/port/ported_params.npz")
                secs["load_ported_npz"] = time.perf_counter() - t
                t = time.perf_counter()
                out, erep = export_model(model, template)
                secs["export"] = time.perf_counter() - t
                bad = [k for k, v in template.items()
                       if k not in erep["passthrough"]
                       and out[k].tobytes() != v.tobytes()]
                return rss.pop(cli.pid), {
                    "bad_keys": bad[:5], "missing": erep["missing"],
                    "passthrough": erep["passthrough"],
                    "ok": not bad and not erep["missing"]
                    and erep["exported_keys"] + len(erep["passthrough"])
                    == len(template)}

            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                side = pool.submit(cli_then_export)
                rep = verify_port.main(["--torch", ref,
                                        "--out", f"{tmp}/verify"])
                secs["verify"] = time.perf_counter() - t0
                cli_peak, checks["export"] = side.result()
            secs["verify_beside_cli_and_export"] = time.perf_counter() - t0
            del sd, template
            with open(f"{tmp}/port/port_report.json") as f:
                report = json.load(f)
            checks["port_report"] = {
                "unmapped": len(report["unmapped"]),
                "ignored": report["ignored"],
                "ok": not report["unmapped"]
                and report["ported_keys"] + len(report["ignored"])
                == report["total_keys"]}

            stages = {st["stage"]: st for st in rep["stages"]}
            for name, st in stages.items():
                secs[f"verify_{name}"] = st["stage_seconds"]
            want = _ckpt_expected(cfg)
            checks["verify"] = {
                "verdict": rep["verdict"],
                "statuses": {k: st["status"] for k, st in stages.items()},
                "card_parity": stages.get("card_parity", {}).get("modules"),
                "launches": {k: stages.get(k, {}).get("launches")
                             for k in ("card_parity", "forward")},
                "expected": want}
            checks["verify"]["ok"] = (
                rep["verdict"] == "ok"
                and all(stages.get(k, {}).get("status") == "ok"
                        for k in ("port", "roundtrip", "card_parity",
                                  "forward"))
                and all(v == want for v in
                        checks["verify"]["launches"].values()))
            if not checks["verify"]["ok"]:
                emit({"phase": "checkpoint", "model": preset,
                      "verify_report": rep})

            t0 = time.perf_counter()
            eng, _, _ = build_engine(preset, Bucket(H, W), checkpoint=ref,
                                     num_keyframes=K)
            torch.cuda.synchronize()
            secs["build_engine"] = time.perf_counter() - t0
            images, portrait, cls_emb = _inputs(
                V, H, W, lang_dim=cfg.panoptic.mask_transformer.lang_dim)
            eng.serve_device(images, portrait, cls_emb)           # warm-up
            _reset_counts()
            t0 = time.perf_counter()
            wire = eng.serve_device(images, portrait, cls_emb)
            torch.cuda.synchronize()
            secs["serve_scene"] = time.perf_counter() - t0
            # the returned scene's f32 share (LoftUp's K4) stays in
            # F32_LAUNCHES["checkpoint"] for the kernels line
            counts[preset] = _read_counts("checkpoint")
            f32 = F32_LAUNCHES["checkpoint"]
            dec = eng.unpack_wire(wire, V)
            want = expected_serve_launches(cfg, V, K, eng.n_tokens)
            checks["serve"] = {
                "launches": counts[preset], "expected": want,
                "launches_f32": f32, "pan_shape": list(dec["pan"].shape),
                "ok": counts[preset] == want
                and f32.get("flash_fwd", 0) == want.get("flash_fwd", 0)
                and list(dec["pan"].shape) == [V, H, W]
                and bool(np.isfinite(dec["conf"]).all())}
            del eng
            torch.cuda.empty_cache()
        emit({"phase": "checkpoint", "model": preset, "scalars": n_scalars,
              "keys": report["total_keys"], "seconds": secs,
              "host_gib": {"phase_peak": rss["self"] / 2 ** 30,
                           "port_cli_peak": cli_peak / 2 ** 30,
                           "process_peak": peak_host_gib()},
              "checks": checks})
        bad = [k for k, c in checks.items() if not c["ok"]]
        if bad:
            raise AssertionError(f"checkpoint {preset}: failed checks {bad}: "
                                 f"{ {k: checks[k] for k in bad} }")
    return counts["v2"]


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

    def small():
        phase_small("v1")
        phase_small("v2")
        phase_small_train()
        phase_small_serve()
        phase_small_serve_many("v1")
        phase_small_serve_many("v2")
        phase_small_refine()
        phase_small_two_stage()

    def ab_packed():
        launches["ab_packed"], launches["ab_packed_f32"] = phase_ab_packed()

    launches, rows = {}, {}
    for name, phase in (("kernels", phase_kernels), ("small", small),
                        ("v1", functools.partial(phase_full, "v1")),
                        ("v2", functools.partial(phase_full, "v2")),
                        ("train_v2", phase_train_v2), ("serve", phase_serve),
                        ("serve_long", phase_serve_long),
                        ("ab_packed", ab_packed),
                        ("multibucket", phase_multibucket),
                        ("demo", phase_demo),
                        ("serve_many", phase_serve_many),
                        ("refine", phase_refine),
                        ("retrieval_head", phase_retrieval_head),
                        ("serve_app", phase_serve_app),
                        ("text", phase_text),
                        ("train_app", phase_train_app),
                        ("slam", phase_slam), ("slam_app", phase_slam_app),
                        ("eval", phase_eval), ("multi_gpu", phase_multi_gpu),
                        ("tiny", phase_tiny),
                        ("dino_large", phase_dino_large),
                        ("checkpoint", phase_checkpoint)):
        if name not in phases:
            continue
        t = time.perf_counter()
        out = phase()
        emit({"phase": "seconds", "name": name,
              "seconds": time.perf_counter() - t})
        if name == "kernels":
            rows = out
        elif name not in ("small", "ab_packed"):
            launches[name] = out

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
        # its f32 run), K4, K5 and the f32 K1-K3 on train_v2, the bf16 K4
        # on dino_large, NO_PATH on none, the others on serve_long
        path = {"packed_flash": "ab_packed",
                "packed_flash_f32": "ab_packed_f32",
                "flash_fwd": "train_v2", "flash_bwd": "train_v2",
                "flash_fwd_bf16": "dino_large",
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
