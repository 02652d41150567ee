"""PQ evaluation app (counterpart of panst3r_tpu/apps/eval.py): the
inference engine over dataset scenes, mask fusion (v1, v2 or QUBO), then
PQ / SQ / RQ over all scenes (direct multi-view prediction).

    python -m panst3r_torch.apps.eval --data-root dir [--preset v1|v2|tiny]
        [--benchmark scannetpp|hypersim|replica|scannet]
        [--checkpoint ckpt] [--ported-npz ported_params.npz]
        [--text random|siglip|siglip2|clip|table.npz]
        [--fusion standard_v1|standard_v2|qubo] [--device cpu]

``--benchmark scannetpp`` reads the preprocessed training layout
(``data/scannetpp.py``); the others the rendered test views
(``data/benchmarks.py``), and the result then carries the paper's PQ
(``reference_pq``) and the difference (``vs_reference``).  The engine
runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np
import torch

from panst3r_torch.data.loader import canonicalize_views
from panst3r_torch.engine.eval import (PQStat, gt_segments_from_maps,
                                       scene_pq, summarize)
from panst3r_torch.engine.fusion import panoptic_fusion_v1, qubo_fusion

FUSIONS = ("standard_v1", "standard_v2", "qubo")


def evaluate_scene(engine, views: list[dict], classes: list[str],
                   cls_emb: np.ndarray, fusion: str = "standard_v2",
                   per_class: dict | None = None) -> dict:
    """One scene's views (the loader's view dicts) through the engine and
    the fusion, scored against their ground truth; adds into
    ``per_class`` (made when None) and returns it.  ``standard_v2`` fuses
    the ``run_device`` output on the device (``engine.fuse``);
    ``standard_v1`` and ``qubo`` take ``run``'s host output back to the
    engine's device for their fusion."""
    canon = canonicalize_views(views)
    images = canon["images"].astype(np.float32)
    H, W = images.shape[1:3]
    if fusion == "standard_v2":
        out = engine.run_device(images, canon["portrait"], cls_emb)
        res = engine.fuse(out, (H, W))[0]
    else:
        out = engine.run(images, canon["portrait"], cls_emb)
        fuse = {"standard_v1": panoptic_fusion_v1,
                "qubo": qubo_fusion}[fusion]
        with torch.inference_mode():
            res = fuse(torch.as_tensor(out["pred_logits"][None],
                                       device=engine.device),
                       torch.as_tensor(out["pred_masks"][None],
                                       device=engine.device), (H, W))[0]

    gt_pan, gt_segments = gt_segments_from_maps(
        canon["pan_inst_id"].astype(np.int64), canon["pan_cls_id"],
        canon["class_set"].split(";"), classes,
        crowd_inst_ids=canon.get("crowd_inst_ids"))
    if per_class is None:
        per_class = defaultdict(PQStat)
    scene_pq(np.asarray(res["pan"], np.int64), res["segments_info"],
             gt_pan, gt_segments, per_class)
    return per_class


def load_ported_npz(model, npz_path: str):
    """Fill ``model`` from a flat-keyed flax tree (``a/b/c`` keys, as
    ``python -m panst3r_torch.port_checkpoint`` writes
    ``ported_params.npz``)
    through ``weights.load_jax_params``: a port parameter the file does
    not fill, a leaf without a port parameter, or a shape mismatch
    raises."""
    from panst3r_torch.port_checkpoint import unflatten
    from panst3r_torch.weights import load_jax_params

    with np.load(npz_path) as flat:
        tree = unflatten((k, flat[k]) for k in flat.files)
        n = len(flat.files)
    load_jax_params(model, tree)
    print(f"ported weights: applied {n} leaves")
    return model


def build_cls_embeddings(classes, lang_dim: int, text: str) -> np.ndarray:
    """The (len(classes), lang_dim) f32 class table: ``random`` (unit
    vectors from ``default_rng(0)``), a text tower's name (``siglip``,
    ``siglip2``, ``clip``, through ``TextEncoder``), or an ``.npz`` of
    {classes, embeddings} (a ``TextEncoder.state()`` dump)."""
    if text.endswith(".npz"):
        data = np.load(text, allow_pickle=True)
        table = {c: e for c, e in zip(list(data["classes"]),
                                      data["embeddings"])}
        emb = np.stack([table[c] for c in classes]).astype(np.float32)
        return emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    if text != "random":
        from panst3r_torch.models.text_encoder import (TextEncoder,
                                                       TextEncoderConfig)

        te = TextEncoder(TextEncoderConfig(model_name=text,
                                           fixed_vocab=False))
        return np.asarray(te(classes), np.float32)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((len(classes), lang_dim)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=-1, keepdims=True)


def main(argv=None):
    from panst3r_torch.apps.common import load_weights, preset_config
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.data.scannetpp import ScanNetppPanoptic
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="a save_checkpoint directory or a reference torch "
                         "checkpoint file (apps/common.py::load_weights)")
    ap.add_argument("--ported-npz", default=None,
                    help="ported_params.npz (flax-named flat keys)")
    ap.add_argument("--preset", default="v1", choices=["v1", "v2", "tiny"])
    ap.add_argument("--benchmark", default="scannetpp",
                    choices=["scannetpp", "hypersim", "replica", "scannet"],
                    help="scannetpp = preprocessed training-format scenes; "
                         "the others = rendered test views")
    ap.add_argument("--text", default="random",
                    help="random | siglip | siglip2 | clip | table.npz")
    ap.add_argument("--num-scenes", type=int, default=50)
    ap.add_argument("--num-views", type=int, default=4)
    ap.add_argument("--num-keyframes", type=int, default=4)
    ap.add_argument("--resolution", type=int, nargs=2, default=[512, 384])
    ap.add_argument("--fusion", default="standard_v2", choices=FUSIONS)
    ap.add_argument("--stuff-classes", default=None,
                    help="comma-separated class names counted as stuff in "
                         "the PQ_th / PQ_st split (default: the dataset's "
                         "isthing flags when it has them, else all things)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    W, H = args.resolution
    if args.benchmark == "scannetpp":
        dataset = ScanNetppPanoptic(args.data_root, resolution=(W, H),
                                    num_views=args.num_views, aug_crop=0)
        classes = sorted(set(dataset.classes))
    else:
        from panst3r_torch.data.benchmarks import BenchmarkScenes

        dataset = BenchmarkScenes(args.data_root, args.benchmark,
                                  resolution=(W, H),
                                  num_views=args.num_views)
        classes = dataset.classes

    cfg = preset_config(args.preset)
    model = build_model(cfg, device=args.device, seed=0)
    meta = load_weights(model, args.checkpoint) if args.checkpoint else {}
    if args.ported_npz:
        load_ported_npz(model, args.ported_npz)
    if "classes" in meta:
        classes = list(meta["classes"])
    lang_dim = cfg.panoptic.mask_transformer.lang_dim
    if "cls_emb" in meta and args.text == "random":
        # trained weights pair with the table they were trained with
        cls_emb = np.asarray(meta["cls_emb"], np.float32)
    else:
        cls_emb = build_cls_embeddings(classes, lang_dim, args.text)
    engine = InferenceEngine(model, Bucket(H, W),
                             num_keyframes=args.num_keyframes, amp=True,
                             device=args.device)

    # the Things / Stuff split: the flag, else the dataset's isthing flags,
    # else every class a thing (the reference fusion's isthing=True)
    if args.stuff_classes is not None:
        stuff = {s.strip() for s in args.stuff_classes.split(",")
                 if s.strip()}
    else:
        cats = getattr(dataset, "categories", None) or []
        stuff = {c["name"] for c in cats if not c.get("isthing", 1)}
    things = {i for i, c in enumerate(classes) if c not in stuff}

    per_class = defaultdict(PQStat)
    n = min(args.num_scenes, len(dataset))
    for i in range(n):
        evaluate_scene(engine, dataset[i], classes, cls_emb, args.fusion,
                       per_class)
        if (i + 1) % 10 == 0:
            print(f"[{i + 1}/{n}] {summarize(per_class)}", flush=True)

    result = summarize(per_class, things=things)
    if args.benchmark != "scannetpp":
        from panst3r_torch.data.benchmarks import REFERENCE_PQ

        # the tiny preset has no published number: v1's stands in
        ref = REFERENCE_PQ.get((args.preset, args.benchmark),
                               REFERENCE_PQ.get(("v1", args.benchmark)))
        if ref is not None:
            result["reference_pq"] = ref
            result["vs_reference"] = round(result.get("PQ", 0.0) - ref, 2)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
