"""FLOPs, seconds and MFU per stage of one scene on the card (the port of
tools/mfu_report.py).

    python -m panst3r_torch.tools.mfu_report                  # v1, V=8, K=4
    python -m panst3r_torch.tools.mfu_report --preset v2 --views 8 --keyframes 4

At 384×512 with random weights from seed 0 (bf16, ``chunk`` 4, 32
classes): each stage's TFLOP (``InferenceEngine.stage_flops``, the JAX
counter's stages), its synchronized seconds (``run_device``'s stage times
and ``fuse``) and its MFU against the card's dense bf16 peak
(``ops/flops.py``); then the whole scene's FLOPs and MFU over its wall
time (``run_device`` + ``fuse``, one synchronization at the end) and over
the device's busy time (``core/profiling.py::profile_by_kernel``), the
second being ``bench.py``'s ``device_mfu``.  It needs the card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

# run_device's stage names (and "fuse") -> the stage_flops keys they run
STAGE_KEYS = {"encoder": ("encoder",), "dino": ("dino",),
              "memory": ("memory",), "render": ("render",),
              "panoptic": ("pan_joint", "pan_queries"), "fuse": ("fusion",)}


def stage_mfu(stage_flops: dict, stage_s: dict, card=None) -> dict:
    """{stage: {tflop, seconds, mfu}} for the stages of ``STAGE_KEYS``
    found in ``stage_s`` (seconds by ``run_device`` stage name)."""
    from panst3r_torch.ops import flops

    out = {}
    for stage, keys in STAGE_KEYS.items():
        if stage not in stage_s:
            continue
        fl = sum(stage_flops[k] for k in keys)
        out[stage] = {"tflop": fl / 1e12, "seconds": stage_s[stage],
                      "mfu": flops.mfu(fl, stage_s[stage], card=card)}
    return out


def report(preset: str = "v1", V: int = 8, K: int = 4, H: int = 384,
           W: int = 512, ncls: int = 32) -> dict:
    import torch

    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.core.profiling import profile_by_kernel
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models import presets
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.ops import flops

    card = torch.cuda.get_device_name(0)
    flops.peaks(card)                       # raises on an unknown card
    cfg = getattr(presets, f"panst3r_{preset}_config")()
    eng = InferenceEngine(build_model(cfg, seed=0), Bucket(H, W),
                          num_keyframes=K, chunk=4, amp=True)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    portrait = np.zeros(V, bool)
    cls_emb = rng.standard_normal((ncls, 768)).astype(np.float32)

    def scene(stage_times=None):
        out = eng.run_device(images, portrait, cls_emb,
                             stage_times=stage_times)
        t0 = time.perf_counter()
        eng.fuse(out, (H, W))
        if stage_times is not None:
            stage_times["fuse"] = time.perf_counter() - t0

    scene()                                           # warm-up
    stage_s = {}
    scene(stage_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = profile_by_kernel(scene)
    st = eng.stage_flops(V, K)
    total = sum(st.values())
    busy = prof["device_busy_ms"] / 1e3
    return {"preset": preset, "views": V, "keyframes": K, "hw": [H, W],
            "device": card, "stage_flops": st,
            "stages": stage_mfu(st, stage_s, card),
            "scene_flops": total, "scene_wall_s": wall,
            "mfu_wall": flops.mfu(total, wall, card=card),
            "device_busy_s": busy,
            "mfu_device": flops.mfu(total, busy, card=card) if busy else None,
            "device_idle_share": prof["device_idle_share"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="v1", choices=("v1", "v2"))
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--keyframes", type=int, default=4)
    args = ap.parse_args(argv)
    res = report(args.preset, args.views, args.keyframes)
    print(f"{'stage':10s} {'TFLOP':>8s} {'s':>8s} {'MFU':>7s}")
    for name, r in res["stages"].items():
        print(f"{name:10s} {r['tflop']:8.4f} {r['seconds']:8.4f} "
              f"{100 * r['mfu']:6.2f}%")
    print(f"scene {res['scene_flops'] / 1e12:.4f} TFLOP in "
          f"{res['scene_wall_s']:.4f} s: MFU {100 * res['mfu_wall']:.2f}% "
          f"over wall, {100 * (res['mfu_device'] or 0):.2f}% over the "
          f"device's busy {res['device_busy_s']:.4f} s")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
