"""Online SLAM app: frames in order → trajectory, keyframes and pointmaps
(counterpart of panst3r_tpu/apps/slam.py).

Frames stream through the incremental frontend (``engine/slam.py``: one
encoder pass and one render per frame, keyframes banked in the memory),
then the pose-graph backend refines the poses, and with ``--ba`` the
pointmap-anchored bundle adjustment (``engine/ba.py``) refines them
further.

    python -m panst3r_torch.apps.slam --images frames/ --out slam_out/
        [--preset v1|tiny] [--checkpoint ckpt] [--gt-trajectory gt.npz]
        [--ba] [--device cpu]

Writes ``trajectory.npz`` (poses, poses_init, keyframes) and
``slam.json`` (keyframes, GN costs, ATE against ``--gt-trajectory``).
The engine and the backend run on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def run_slam(engine, images: np.ndarray, sim_threshold: float = 0.9,
             max_interval: int = 5, refine: bool = True, ba: bool = False,
             ba_voxel: float = 0.05, ba_stride: int = 8) -> dict:
    """images (N, H, W, 3) canonical frames in order (uint8 or normalized
    float).  Returns {pointmaps (postprocessed, numpy), keyframes[,
    poses_init, poses, gn_costs[, ba_costs]]}."""
    from panst3r_torch.engine.slam import (IncrementalFrontend,
                                           refine_scene_poses)
    from panst3r_torch.models.decoder import postprocess

    frontend = IncrementalFrontend(engine, sim_threshold=sim_threshold,
                                   max_interval=max_interval)
    raw, keyframes = [], []
    for i, img in enumerate(images):
        out = frontend.process(img, i)
        if out["is_keyframe"]:
            keyframes.append(i)
        raw.append(out["pointmaps_raw"])

    # frame 0 has no pointmaps until the memory starts: render it against
    # the final memory
    if raw[0] is None:
        raw[0] = frontend.render(images[0])

    post = postprocess(torch.as_tensor(np.stack(raw), dtype=torch.float32))
    pointmaps = {k: v.numpy() for k, v in post.items()}

    result = {"pointmaps": pointmaps, "keyframes": keyframes}
    if refine:
        refined, init, costs = refine_scene_poses(pointmaps,
                                                  device=engine.device)
        result["poses_init"] = init.cpu().numpy()
        result["poses"] = refined.cpu().numpy()
        result["gn_costs"] = costs.cpu().numpy().tolist()
        if ba:
            from panst3r_torch.engine.ba import refine_scene_ba

            ba_poses, ba_costs = refine_scene_ba(
                pointmaps, result["poses"], stride=ba_stride, voxel=ba_voxel,
                device=engine.device)
            result["poses"] = ba_poses
            result["ba_costs"] = ba_costs.tolist()
    return result


def main(argv=None):
    from panst3r_torch.apps.common import build_engine
    from panst3r_torch.apps.demo import load_images
    from panst3r_torch.engine.eval import ate_rmse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", required=True)
    ap.add_argument("--out", default="./slam_out")
    ap.add_argument("--preset", default="v1", choices=["v1", "tiny"])
    ap.add_argument("--checkpoint", default=None,
                    help="a save_checkpoint directory or a reference torch "
                         "checkpoint file")
    ap.add_argument("--gt-trajectory", default=None,
                    help="npz with (N, 4, 4) cam2world 'poses'")
    ap.add_argument("--sim-threshold", type=float, default=0.9)
    ap.add_argument("--max-interval", type=int, default=5)
    ap.add_argument("--ba", action="store_true",
                    help="pointmap-anchored bundle adjustment after the "
                         "pose-graph refinement (engine/ba.py)")
    ap.add_argument("--ba-voxel", type=float, default=0.05)
    ap.add_argument("--ba-stride", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    paths = sorted(str(f) for f in Path(args.images).iterdir()
                   if f.suffix.lower() in (".jpg", ".jpeg", ".png"))
    images, _, bucket = load_images(paths)
    engine, _, _ = build_engine(args.preset, bucket,
                                checkpoint=args.checkpoint,
                                device=args.device)
    engine.chunk = 1
    result = run_slam(engine, images, args.sim_threshold, args.max_interval,
                      ba=args.ba, ba_voxel=args.ba_voxel,
                      ba_stride=args.ba_stride)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "trajectory.npz", poses=result["poses"],
             poses_init=result["poses_init"],
             keyframes=np.asarray(result["keyframes"]))
    meta = {"keyframes": result["keyframes"],
            "gn_costs": result["gn_costs"], "num_frames": len(images)}
    if args.gt_trajectory:
        gt = np.load(args.gt_trajectory)["poses"]
        meta["ate_rmse"] = ate_rmse(result["poses"], gt)
        meta["ate_rmse_init"] = ate_rmse(result["poses_init"], gt)
    (out_dir / "slam.json").write_text(json.dumps(meta, indent=2))
    print(json.dumps({k: v for k, v in meta.items() if k != "gn_costs"}))
    return meta


if __name__ == "__main__":
    main()
