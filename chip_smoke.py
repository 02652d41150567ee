#!/usr/bin/env python3
"""Smoke run of panst3r_torch on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py            # every phase; needs one card
    python3 chip_smoke.py --phases kernels

Run from the root of a checkout.  It builds the CUDA kernels of
``panst3r_torch/csrc`` with nvcc (into the git-ignored
``panst3r_torch/_build``), then runs, each phase printing JSON lines:

1. ``kernels``: K1 (tower_self), K2 (tower_cross) and K3 (masked_attn)
   against their plain PyTorch versions at the main path's shapes, in f32
   and bf16, with the max abs error and its limit, the kernel's time, the
   plain version's time, one PyTorch library call on the same work
   (``scaled_dot_product_attention``, a yardstick only — the port never
   calls it) and the least time the card could take (``bound_ms``);
2. ``small``: v1 widths at depth 2, f32, V=4 / K=3 at 384x512, the same
   seeded weights on the card (kernels) and on the CPU (plain versions),
   outputs compared;
3. ``v1``: the full v1 main path (``InferenceEngine.run_device`` + ``fuse``,
   bf16, V=8 / K=4 at 384x512, random seeded weights), stage times, peak
   memory, finiteness and shapes, and each kernel's launch count against
   the count the config and schedule imply;

then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failed phase raises, and the script exits non-zero without
the last line.  Without a CUDA device, or outside a checkout, it exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
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
    "masked_attn": "panst3r_tpu/ops/pallas/masked_attention.py:119",
}


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


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    # no options.  B = chunk = 4 views, N = 24*32 = 768 tokens.
    for label, C, H, rope, cls in (("encoder_rope", 1024, 16, True, False),
                                   ("dino_cls", 1024, 16, False, True),
                                   ("decoder_rope", 768, 12, True, False),
                                   ("plain", 1024, 16, False, False)):
        B, N = 4, 768
        qkv = torch.cat([rnd(B, N, 2 * C, s=QK_STD), rnd(B, N, C)], -1)
        tabs = rope2d_tables(_grid_pos(B, 24, 32, dev), 64) if rope else None
        ckv = (rnd(B, 1, C, s=QK_STD), rnd(B, 1, C)) if cls else None
        q, k, v = (heads(t, 64) for t in qkv.split(C, -1))
        nbytes = qkv.numel() * es + B * N * C * es \
            + (2 * B * N * 64 * 4 if rope else 0) + (2 * B * C * es if cls else 0)
        cases.append(dict(
            kernel="tower_self", case=label,
            fn=lambda qkv=qkv, H=H, tabs=tabs, ckv=ckv:
                ta.tower_self_attention(qkv, H, tabs=tabs, cls_kv=ckv),
            ref=lambda qkv=qkv, H=H, tabs=tabs, ckv=ckv:
                ta.tower_self_attention_ref(qkv, H, tabs=tabs, cls_kv=ckv),
            f32=lambda qkv=qkv, H=H, tabs=tabs, ckv=ckv:
                ta.tower_self_attention_ref(
                    qkv.float(), H, tabs=tabs,
                    cls_kv=None if ckv is None else tuple(map(f32, ckv))),
            lib=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
            flops=4.0 * B * H * N * (N + (1 if cls else 0)) * 64,
            bytes=nbytes))

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
            flops=4.0 * Nq * live * C, bytes=nbytes))

    valid = torch.ones(1, 3840, dtype=torch.bool, device=dev)
    valid[:, 1536:3072] = False
    k2("update_bias", 1, 768, 3840, valid)
    k2("render", 1, 3072, 3072,
       torch.ones(1, 3072, dtype=torch.bool, device=dev))
    valid = torch.rand(2, 2950, generator=g, device=dev) > 0.1
    valid[0, 640:1600] = False
    valid[1, 2000:] = False
    k2("ragged_dead_tiles", 2, 1000, 2950, valid)

    # K3: mask-transformer cross-attention, 200 queries x 4 views x 768
    # tokens, 8 heads of 96, object-like blocked mask with dead tiles and
    # some fully blocked rows.
    B, H, Nq, Nk, D = 1, 8, 200, 3072, 96
    q, k = rnd(B, H, Nq, D, s=QK_STD), rnd(B, H, Nk, D, s=QK_STD)
    v = rnd(B, H, Nk, D)
    blocked = torch.ones(B, Nq, Nk, dtype=torch.bool, device=dev)
    starts = torch.randint(0, Nk - 400, (8,), generator=g, device=dev)
    for qi in range(Nq):
        s = int(starts[qi % 8])
        blocked[:, qi, s:s + 100 + 30 * (qi % 8)] = False
    blocked &= torch.rand(B, Nq, Nk, generator=g, device=dev) > 0.02
    blocked[:, 150:160] = True                         # fully blocked rows
    _, count = ma.plan_blocks(blocked, ma.BLOCK_Q, ma.BLOCK_K, 256, Nk)
    live_tiles = int(count.sum())
    live_kb = int((~blocked.view(B, Nq, Nk // 64, 64).all(-1).all(1)).sum())
    nbytes = (2 * q.numel() + 2 * H * live_kb * 64 * D) * es + blocked.numel()
    cases.append(dict(
        kernel="masked_attn", case="mask_transformer",
        fn=lambda: ma.masked_mha(q, k, v, blocked),
        ref=lambda: ma.masked_mha_ref(q, k, v, blocked),
        f32=lambda: ma.masked_mha_ref(f32(q), f32(k), f32(v), blocked),
        lib=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=~blocked[:, None]),
        pallas_sums=lambda: _masked_mha_pallas_sums(q, k, v, blocked),
        flops=4.0 * H * live_tiles * 64 * 64 * D, bytes=nbytes))
    return cases


def phase_kernels():
    import torch

    dev = torch.device("cuda")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for c in kernel_cases(dtype, dev):
            name, label = c["kernel"], c["case"]
            counter = _counters()[name]
            n0 = counter.launches
            out = c["fn"]()
            torch.cuda.synchronize()
            want = c["ref"]().float()
            err = float((out.float() - want).abs().max())
            if dtype == torch.float32:
                check = {"limit": F32_TOL, "ok": err <= F32_TOL}
            else:
                check = bf16_check(out.float(), want, c["f32"]().float())
            finite = bool(torch.isfinite(out).all())
            row = {
                "phase": "kernels", "kernel": name, "case": label,
                "dtype": dname, "shape": list(out.shape),
                "max_abs_err": err, "finite": finite, "check": check,
                "ref_max_abs": float(want.abs().max()),
                "ref_rms": float(want.square().mean().sqrt()),
                "kernel_ms": time_ms(c["fn"], reps=20),
                "plain_ms": time_ms(c["ref"], reps=5),
                "library_ms": time_ms(c["lib"], reps=20),
            }
            if "pallas_sums" in c:
                # how far the kernel's (and its plain version's) bf16 sums
                # sit from the Pallas kernel's summation
                ps = c["pallas_sums"]().float()
                row["pallas_sums_max_abs_diff"] = {
                    "kernel": float((out.float() - ps).abs().max()),
                    "plain": float((want - ps).abs().max())}
            # the check plus warm-up and timed launches, from the counter
            row["launches"] = counter.launches - n0
            row["bound_ms"], row["bound_by"] = bound_ms(c["flops"],
                                                        c["bytes"], dname)
            emit(row)
            if not (finite and check["ok"]):
                raise AssertionError(f"{name} {label} {dname}: max abs err "
                                     f"{err}, check {check}, finite={finite}")
            rows[(name, label, dname)] = row
    return rows


# ------------------------------------------------------------ phases 2-3 --

def _v1(depth=None):
    from panst3r_torch.models.presets import panst3r_v1_config

    cfg = panst3r_v1_config()
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
    from panst3r_torch.ops.masked_attention import masked_mha
    from panst3r_torch.ops.tower_attention import (tower_cross_attention,
                                                   tower_self_attention)

    return {"tower_self": tower_self_attention,
            "tower_cross": tower_cross_attention,
            "masked_attn": masked_mha}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def expected_launches(cfg, V, K, chunk):
    n_chunks = math.ceil(V / chunk)
    n_updates = len(cfg.mem_batches(K))
    dec = cfg.decoder.depth
    return {
        "tower_self": n_chunks * (cfg.encoder.depth + cfg.dino.depth)
        + (n_updates + n_chunks) * dec,
        "tower_cross": (n_updates + n_chunks) * dec,
        "masked_attn": cfg.panoptic.mask_transformer.dec_layers,
    }


def phase_small():
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    cfg = _v1(depth=2)
    V, K = 4, 3
    images, portrait, cls_emb = _inputs(V)
    cpu_model = build_model(cfg, device="cpu", seed=0)
    gpu_model = build_model(cfg, device="cuda", seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict())
    outs = {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = InferenceEngine(model, Bucket(384, 512), num_keyframes=K,
                              chunk=4, amp=False, device=name)
        _reset_counts()
        t0 = time.perf_counter()
        outs[name] = eng.run(images, portrait, cls_emb)
        counts = _read_counts()
        emit({"phase": "small", "device": name,
              "seconds": time.perf_counter() - t0, "launches": counts})
        if name == "cuda":
            want = expected_launches(cfg, V, K, 4)
            if counts != want:
                raise AssertionError(f"small: launches {counts} != {want}")
    a, b = outs["cuda"], outs["cpu"]
    row = {"phase": "small", "compare": "cuda_vs_cpu"}
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
    if bad or a["keyframes"] != b["keyframes"]:
        raise AssertionError(f"small: card and CPU disagree on {bad}")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()


def _profile(fn, top: int = 15):
    """One traced run: device time by kernel name (CUPTI through
    torch.profiler) and the device's idle share of the traced wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):          # the tracer's own start-up
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "top": [{"name": k[:90], "ms": ms, "calls": n}
                    for k, (ms, n) in rows]}


def phase_v1():
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    cfg = _v1()
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
    counts = _read_counts()
    stage["fuse"] = t2 - t1

    # the same run once more without stage synchronization
    t3 = time.perf_counter()
    eng.fuse(eng.run_device(images, portrait, cls_emb), (H, W))
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t3

    profile = _profile(lambda: eng.fuse(
        eng.run_device(images, portrait, cls_emb), (H, W)))

    Q, ncls = cfg.panoptic.mask_transformer.num_queries, cls_emb.shape[0]
    shapes = {"pointmaps_raw": (V, H, W, 7), "pred_logits": (Q, ncls),
              "pred_masks": (V, Q, H // 2, W // 2)}
    checks = {k: (list(out[k].shape) == list(s),
                  bool(torch.isfinite(out[k].float()).all()))
              for k, s in shapes.items()}
    pan = fused[0]["pan"]
    want = expected_launches(cfg, V, K, chunk)
    emit({"phase": "v1", "views": V, "keyframes": out["keyframes"],
          "setup_s": setup_s, "stage_s": stage,
          "run_plus_fuse_s": t2 - t0, "run_plus_fuse_nosync_s": e2e,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "n_segments": len(fused[0]["segments_info"]),
          "pan_shape": list(pan.shape), "checks": checks,
          "launches": counts, "expected_launches": want})
    # the tracer slows the host; the untraced run's wall is the fairer
    # denominator for the device's idle share
    profile["device_idle_share_untraced"] = 1 - profile["device_busy_ms"] \
        / (e2e * 1e3)
    emit({"phase": "v1_profile", **profile})
    bad = [k for k, (shape_ok, finite) in checks.items()
           if not (shape_ok and finite)]
    if bad or tuple(pan.shape) != (V, H, W):
        raise AssertionError(f"v1: wrong or non-finite outputs: {bad}")
    if counts != want:
        raise AssertionError(f"v1: launches {counts} != expected {want}")
    return counts


# ------------------------------------------------------------------ main --

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,small,v1")
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

    rows = phase_kernels() if "kernels" in phases else {}
    if "small" in phases:
        phase_small()
    launches = phase_v1() if "v1" in phases else {}

    main_case = {"tower_self": "encoder_rope", "tower_cross": "render",
                 "masked_attn": "mask_transformer"}
    kernels = []
    for name, case in main_case.items():
        r = rows.get((name, case, "bfloat16"), {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"panst3r_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches.get(name),
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("kernel_ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"),
        })
    emit({"kernels": kernels})
    if phases != {"kernels", "small", "v1"}:
        print("chip_smoke: partial run, no result line", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
