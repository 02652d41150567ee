"""Reconstruction demo: images → panoptic 3D point cloud (counterpart of
panst3r_tpu/apps/demo.py).

Load images → landscape canonical → resize into one bucket → inference
engine → panoptic fusion (QUBO for ``--fusion qubo``, the standard v2
fusion for every other name, as the JAX demo does) → focal and pose
recovery → export:

  - scene.ply          point cloud coloured by RGB blended with the
                       panoptic overlay
  - panoptic_<i>.png   per-view segment overlays
  - cameras.json       per-view focal, cam2world, segments_info, labels

Run:  python -m panst3r_torch.apps.demo --images dir/ --out out_scene/
      [--preset v1|v2|tiny|tiny_v2] [--checkpoint ckpt] [--fusion qubo]
      [--device cpu]

PIL is imported only where images are read or PNGs written.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from panst3r_torch.core.bucketing import (DEFAULT_BUCKETS, bucket_for_shape,
                                          transpose_to_landscape)
from panst3r_torch.engine.fusion import panoptic_fusion, qubo_fusion
from panst3r_torch.engine.pose import recover_cameras
from panst3r_torch.models.decoder import postprocess

# ScanNet-style class set (the reference demo's scannet subset)
SCANNET_CLASSES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "other furniture", "ceiling",
]
# the --fusion names: "qubo" runs qubo_fusion, every other panoptic_fusion
FUSIONS = ("standard_v1", "standard_v2", "qubo")


def load_images(paths: list[str], bucket=None):
    """Read → landscape canonical → resize into a common bucket (the first
    image's, unless given) → normalized to [-1, 1].  Returns (images (V, H,
    W, 3) f32, portrait (V,) bool, bucket)."""
    from PIL import Image

    raws = []
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"))
        img, portrait = transpose_to_landscape(img)
        raws.append((img, bool(portrait)))
    if bucket is None:
        h, w = raws[0][0].shape[:2]
        bucket = bucket_for_shape(h, w, DEFAULT_BUCKETS)
    imgs, portraits = [], []
    for img, portrait in raws:
        pil = Image.fromarray(img).resize((bucket.width, bucket.height),
                                          Image.LANCZOS)
        imgs.append(np.asarray(pil, np.float32) / 255.0 * 2.0 - 1.0)
        portraits.append(portrait)
    return np.stack(imgs), np.asarray(portraits), bucket


def segment_colors(n: int, seed: int = 0) -> np.ndarray:
    """n grid-sampled RGB colours, shuffled by ``seed``."""
    N = int(np.ceil((n + 1) ** (1 / 3)))
    coords = np.linspace(0, 1, max(N, 2))
    r, g, b = np.meshgrid(coords, coords, coords)
    colors = np.c_[r.ravel(), g.ravel(), b.ravel()][1:]
    np.random.default_rng(seed).shuffle(colors)
    return (colors[:n] * 255).astype(np.uint8)


def panoptic_overlay(rgb: np.ndarray, pan: np.ndarray, colors: np.ndarray,
                     alpha: float = 0.5) -> np.ndarray:
    """rgb (H, W, 3) uint8; pan (H, W) segment ids (0 = void)."""
    out = rgb.astype(np.float32)
    seg_rgb = np.zeros_like(out)
    mask = pan > 0
    seg_rgb[mask] = colors[(pan[mask] - 1) % len(colors)]
    out[mask] = out[mask] * (1 - alpha) + seg_rgb[mask] * alpha
    return out.astype(np.uint8)


def write_ply(path: str | Path, points: np.ndarray, colors: np.ndarray):
    """ASCII PLY of coloured points."""
    points = points.reshape(-1, 3)
    colors = colors.reshape(-1, 3).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(points)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for (x, y, z), (r, g, b) in zip(points, colors):
            f.write(f"{x:.4f} {y:.4f} {z:.4f} {r} {g} {b}\n")


def reconstruct_scene(engine, images, portrait, classes: list[str],
                      cls_emb: np.ndarray, fusion: str = "standard_v2",
                      num_keyframes=None) -> dict:
    """The demo pipeline on a prepared image stack (V, H, W, 3), uint8 or
    normalized float: ``run_device``, fusion and camera recovery on the
    engine's device; host numpy results."""
    out = engine.run_device(images, portrait, cls_emb,
                            num_keyframes=num_keyframes)
    H, W = images.shape[1:3]
    fuse = qubo_fusion if fusion == "qubo" else panoptic_fusion
    with torch.inference_mode():
        pan = fuse(out["pred_logits"][None].float(),
                   out["pred_masks"][None].float(), (H, W))[0]
        pointmaps = postprocess(out["pointmaps_raw"].float())
        focals, cams2world = recover_cameras(pointmaps, (H, W))
    for seg in pan["segments_info"]:
        seg["category_name"] = classes[seg["category_id"]]
    return {
        "pointmaps": {k: v.cpu().numpy() for k, v in pointmaps.items()},
        "pan": np.asarray(pan["pan"]),
        "segments_info": pan["segments_info"],
        "conf": np.asarray(pan["conf"]),
        "focals": focals.cpu().numpy(),
        "cams2world": cams2world.cpu().numpy(),
        "keyframes": out["keyframes"],
    }


def export_scene(out_dir: str | Path, images, scene: dict,
                 conf_threshold: float = 1.5, alpha: float = 0.5,
                 max_points: int = 500_000, overlays: bool = True):
    """Writes scene.ply, cameras.json and (``overlays``) the per-view
    panoptic_<i>.png.  ``images``: the stack given to reconstruct_scene."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    V, H, W = scene["pan"].shape

    images = np.asarray(images)
    rgb = images if images.dtype == np.uint8 \
        else ((images * 0.5 + 0.5) * 255).astype(np.uint8)
    n_segs = max([s["id"] for s in scene["segments_info"]], default=0)
    colors = segment_colors(max(n_segs, 1))

    if overlays:
        from PIL import Image

        for i in range(V):
            ov = panoptic_overlay(rgb[i], scene["pan"][i], colors, alpha)
            Image.fromarray(ov).save(out_dir / f"panoptic_{i:03d}.png")

    pts = scene["pointmaps"]["pts3d"].reshape(-1, 3)
    conf = scene["pointmaps"]["conf"].reshape(-1)
    base = rgb.reshape(-1, 3).astype(np.float32)
    pan_flat = scene["pan"].reshape(-1)
    seg_col = np.zeros_like(base)
    m = pan_flat > 0
    seg_col[m] = colors[(pan_flat[m] - 1) % len(colors)]
    blend = np.where(m[:, None], base * (1 - alpha) + seg_col * alpha, base)

    keep = conf > conf_threshold
    if keep.sum() > max_points:
        idx = np.random.default_rng(0).choice(np.nonzero(keep)[0],
                                              max_points, replace=False)
        keep = np.zeros_like(keep)
        keep[idx] = True
    write_ply(out_dir / "scene.ply", pts[keep], blend[keep])

    # 3D labels at segment medoids, each from at most 512 of the segment's
    # confident points
    rng_l = np.random.default_rng(0)
    labels = []
    for seg in scene["segments_info"]:
        m = (pan_flat == seg["id"]) & (conf > conf_threshold)
        if not m.any():
            m = pan_flat == seg["id"]
        if not m.any():
            continue
        p = pts[m]
        if len(p) > 512:
            p = p[rng_l.choice(len(p), 512, replace=False)]
        d = np.linalg.norm(p[:, None] - p[None], axis=-1).sum(1)
        labels.append({
            "id": int(seg["id"]),
            "name": seg.get("category_name", str(seg["category_id"])),
            "pos": [float(v) for v in p[int(d.argmin())]],
        })

    meta = {
        "focals": scene["focals"].tolist(),
        "cams2world": scene["cams2world"].tolist(),
        "segments_info": scene["segments_info"],
        "keyframes": scene["keyframes"],
        "image_size": [int(H), int(W)],
        "labels": labels,
    }
    (out_dir / "cameras.json").write_text(json.dumps(meta, indent=2))


def main(argv=None):
    from panst3r_torch.apps.common import PRESETS, build_engine

    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True,
                    help="directory of images or file list")
    ap.add_argument("--out", default="./demo_out")
    ap.add_argument("--preset", default="v1", choices=PRESETS)
    ap.add_argument("--checkpoint", default=None,
                    help="a save_checkpoint directory or a reference "
                         "torch checkpoint file")
    ap.add_argument("--trust-checkpoint", action="store_true",
                    help="unpickle a torch checkpoint file without the "
                         "weights_only restriction (runs code the file "
                         "names; only for files you trust)")
    ap.add_argument("--num-keyframes", type=int, default=16)
    ap.add_argument("--fusion", default="standard_v2", choices=FUSIONS)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    p = Path(args.images)
    paths = sorted(str(f) for f in p.iterdir()
                   if f.suffix.lower() in (".jpg", ".jpeg", ".png")) \
        if p.is_dir() else [s for s in p.read_text().splitlines() if s]
    images, portrait, bucket = load_images(paths)
    engine, classes, cls_emb = build_engine(
        args.preset, bucket, checkpoint=args.checkpoint,
        num_keyframes=args.num_keyframes, classes=SCANNET_CLASSES,
        device=args.device, trust_pickle=args.trust_checkpoint)
    scene = reconstruct_scene(engine, images, portrait, classes, cls_emb,
                              fusion=args.fusion,
                              num_keyframes=args.num_keyframes)
    export_scene(args.out, images, scene)
    print(f"exported {args.out}/scene.ply + overlays "
          f"({len(scene['segments_info'])} segments)")


if __name__ == "__main__":
    main()
