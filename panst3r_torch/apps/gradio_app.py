"""Gradio web UI for the reconstruction demo (counterpart of
panst3r_tpu/apps/gradio_app.py; gradio is an optional dependency).

Wraps the demo's pipeline (``apps/demo.py``) in an upload-images →
reconstruct → download-PLY/overlays interface, and points the user at
the built-in WebGL viewer (``apps/viewer.py``) for the 3D scene.  The
engine runs on the card unless ``--device cpu``.  Without gradio,
``main`` refuses and names the demo and the viewer instead.

Run:  python -m panst3r_torch.apps.gradio_app --preset v1 [--checkpoint ...]
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path


def build_ui(engine_factory, classes, cls_emb):
    """The Blocks UI; ``engine_factory(bucket)`` returns an engine for the
    uploaded images' bucket."""
    import gradio as gr

    from panst3r_torch.apps.demo import (FUSIONS, export_scene, load_images,
                                         reconstruct_scene)

    def run(files, num_keyframes, fusion):
        images, portrait, bucket = load_images([f.name for f in files])
        engine = engine_factory(bucket)
        scene = reconstruct_scene(engine, images, portrait, classes,
                                  cls_emb, fusion=fusion,
                                  num_keyframes=int(num_keyframes))
        out_dir = Path(tempfile.mkdtemp(prefix="panst3r_"))
        export_scene(out_dir, images, scene)
        overlays = sorted(str(p) for p in out_dir.glob("panoptic_*.png"))
        seg_table = [[s["id"], s.get("category_name", s["category_id"])]
                     for s in scene["segments_info"]]
        return overlays, str(out_dir / "scene.ply"), seg_table

    with gr.Blocks(title="panst3r_torch") as ui:
        gr.Markdown("# panst3r_torch — multi-view panoptic 3D reconstruction")
        files = gr.File(file_count="multiple", label="images")
        nkf = gr.Slider(2, 64, value=16, step=1, label="keyframes")
        fusion = gr.Radio(list(FUSIONS), value="standard_v2", label="fusion")
        btn = gr.Button("Reconstruct")
        gallery = gr.Gallery(label="panoptic overlays")
        ply = gr.File(label="scene.ply (open with apps/viewer.py)")
        table = gr.Dataframe(headers=["segment", "class"])
        btn.click(run, [files, nkf, fusion], [gallery, ply, table])
    return ui


def main(argv=None):
    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit(
            "gradio is not installed in this environment; use the core "
            "pipeline instead:\n  python -m panst3r_torch.apps.demo ... and "
            "view with\n  python -m panst3r_torch.apps.viewer --scene ...")

    from panst3r_torch.apps.common import PRESETS, build_engine
    from panst3r_torch.apps.demo import SCANNET_CLASSES
    from panst3r_torch.core.bucketing import DEFAULT_BUCKETS

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="v1", choices=PRESETS)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    engines = {}

    def engine_factory(bucket):
        """One engine per bucket (the classes and their embeddings are the
        same for every one)."""
        if bucket not in engines:
            engines[bucket] = build_engine(
                args.preset, bucket, checkpoint=args.checkpoint,
                classes=SCANNET_CLASSES, device=args.device)
        return engines[bucket][0]

    engine_factory(DEFAULT_BUCKETS[0])
    _, classes, cls_emb = engines[DEFAULT_BUCKETS[0]]
    build_ui(engine_factory, classes, cls_emb).launch(server_port=args.port)


if __name__ == "__main__":
    main()
