"""One-command verification of a reference checkpoint's port (the port of
tools/verify_port.py).  Given a reference-named ``.pth`` (or a flat
``.npz`` state_dict), it runs these stages and writes one JSON report,
``<out>/verify_report.json`` (``stages``, each with its ``status`` and a
``reason`` or ``error`` where it did not pass, and a ``verdict``):

1. ``port``: ``port_checkpoint.port_checkpoint``; it fails loudly on
   naming drift: every missing module and unmapped key is listed with its
   closest candidates (difflib), never skipped silently.
2. ``roundtrip``: the id-valued forward port and the reverse export
   (``tools/export_checkpoint.py``) must reproduce the input bit for bit.
3. ``card_parity``: the checkpoint at its own dims (head counts by the
   croco convention, head dim 64) in one port model on the card and one
   on the CPU, compared in f32 stack by stack (encoder, DINOv2, memory
   decoder, panoptic head) on a seeded 2-view scene, each stack given the
   same input on both devices, within ``chip_smoke.py``'s limits
   (``PARITY_LIMITS``).  ``--device cpu``: skipped, with the reason.
4. ``forward``: the preset whose dims the checkpoint has (v1, or v2 when
   it has ``panoptic_decoder.input_mixer.*``) loads the ported tree
   through ``apps/eval.py::load_ported_npz`` and runs a small scene
   (``run_device``, bf16); its outputs must be finite.  Other dims:
   skipped.
5. ``pq`` (with ``--data-root``): ``apps/eval.py`` over the benchmark's
   scenes with the ported weights; it fails when the PQ is more than one
   point below the published number (``data/benchmarks.py::
   REFERENCE_PQ``).

The verdict is ``ok`` when every stage is ``ok`` or ``skipped``.

    python -m panst3r_torch.tools.verify_port --torch ckpt.pth --out rep/ \\
        [--rope-layout half|interleaved] [--rename-json m.json] \\
        [--skip-card-parity] [--skip-forward] [--device cpu] \\
        [--data-root scenes/ --benchmark scannet --num-scenes 20]

The stages that run a model run on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import difflib
import json
import os
import tempfile
import time

import numpy as np

from panst3r_torch import port_checkpoint as port

EXPECTED_MODULES = {
    "must3r_encoder.": "MUSt3R ViT encoder",
    "must3r_decoder.": "MUSt3R memory decoder",
    "dino_encoder.": "DINOv2 semantic encoder",
    "panoptic_decoder.": "panoptic head",
}

# chip_smoke.py's limits, card against CPU in f32: DINO_RTOL (max |diff|
# over max |CPU value|) for the towers' tokens and the decoder's features;
# the ``small`` phase's absolute limits (and relative for the masks) for
# the pointmaps and the head's outputs
PARITY_LIMITS = {"rel": 1e-4, "pointmaps_raw": (2e-4, 0.0),
                 "pred_logits": (2e-3, 0.0), "pred_masks": (1e-2, 1e-2)}
PARITY_HW = (256, 256)          # 16 x 16 patches: K1's gate takes them
PARITY_VIEWS = 2


def _suggest(missing: str, pool, n=3):
    return difflib.get_close_matches(missing, list(pool), n=n, cutoff=0.3)


def load_sd(path: str, trust_pickle: bool = False) -> dict:
    """A state_dict of numpy arrays from a flat ``.npz`` or a torch file
    (``port_checkpoint.read_checkpoint``: weights_only unless
    ``trust_pickle``)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    return port.state_dict_of(port.read_checkpoint(path, trust_pickle))


def stage_port(sd: dict, rename=None, rope_layout="half") -> dict:
    out: dict = {"stage": "port"}
    prefixes = {k.split(".")[0] + "." for k in sd}
    missing_modules = []
    for exp, desc in EXPECTED_MODULES.items():
        if not any(k.startswith(exp) for k in sd):
            missing_modules.append({
                "expected_prefix": exp, "component": desc,
                "checkpoint_has": sorted(prefixes),
                "closest": _suggest(exp.rstrip("."),
                                    {p.rstrip(".") for p in prefixes})})
    out["missing_modules"] = missing_modules

    try:
        ported, report = port.port_checkpoint(sd, rename=rename,
                                              rope_layout=rope_layout)
    except KeyError as e:
        cands = e.args[0] if e.args else ()
        cands = list(cands) if isinstance(cands, (tuple, list)) else [cands]
        out["status"] = "error"
        out["error"] = {
            "missing_key_candidates_tried": cands,
            "closest_in_checkpoint": {c: _suggest(c, sd) for c in cands},
            "hint": "bridge naming drift with --rename-json "
                    "{\"regex\": \"replacement\"}",
        }
        return out

    unmapped = report["unmapped"]
    used = report_used(sd, report)
    out["ported_keys"] = report["ported_keys"]
    out["total_keys"] = report["total_keys"]
    out["ignored"] = report["ignored"]
    out["unmapped"] = [{"key": k, "closest_consumed": _suggest(k, used)}
                       for k in unmapped[:50]]
    out["unmapped_count"] = len(unmapped)
    ok = not unmapped and not missing_modules
    out["status"] = "ok" if ok else "fail"
    if not ok:
        out["reason"] = (f"{len(unmapped)} unmapped keys, "
                         f"{len(missing_modules)} missing modules")
    out["_ported_tree"] = ported          # stripped before the JSON dump
    return out


def report_used(sd, report):
    ignored, un = set(report["ignored"]), set(report["unmapped"])
    return [k for k in sd if k not in ignored and k not in un]


def stage_roundtrip(sd: dict, ported: dict, rename=None,
                    rope_layout="half") -> dict:
    """The reverse export of the ported tree, with the input as its
    template, must reproduce every consumed key bit for bit."""
    from panst3r_torch.tools.export_checkpoint import export_checkpoint

    out = {"stage": "roundtrip"}
    try:
        exported, rep = export_checkpoint(ported, sd, rename=rename,
                                          rope_layout=rope_layout)
        passthrough = set(rep["passthrough"])
        bad = [{"key": k, "problem": "values differ"}
               for k, v in sd.items() if k not in passthrough
               and not np.array_equal(exported[k], np.asarray(v))]
        out["passthrough"] = sorted(passthrough)
        out["missing_flax_leaves"] = rep["missing"]
        out["mismatches"] = bad[:20]
        out["status"] = "ok" if not bad and not rep["missing"] else "fail"
        if out["status"] != "ok":
            out["reason"] = (f"{len(bad)} keys differ, {len(rep['missing'])}"
                             f" tree leaves missing")
    except Exception as e:  # keep the pipeline going; report the failure
        out["status"] = "error"
        out["error"] = repr(e)
    return out


# ------------------------------------------------------- checkpoint dims --

def _dim(sd, key, axis=0) -> int:
    return int(np.shape(sd[key])[axis])


def _has(sd, prefix) -> bool:
    return any(k.startswith(prefix) for k in sd)


def config_from_state_dict(sd: dict, enc_heads=None, dec_heads=None):
    """A ``PanSt3RConfig`` at the dims of a reference-named state_dict
    (keys after any renames).  Head counts are not recoverable from a
    state_dict: the croco towers, the decoder, DINO and the mixer take
    head dim 64 (``enc_heads`` / ``dec_heads`` override the encoder's and
    the decoder's), the mask transformer and LoftUp head dim 96, as the
    published presets have.  A component the state_dict lacks keeps its
    default config (its module is built and never run)."""
    import dataclasses

    from panst3r_torch.models.decoder import MemoryDecoderConfig
    from panst3r_torch.models.dino import DinoEncoderConfig
    from panst3r_torch.models.encoder import ViTEncoderConfig
    from panst3r_torch.models.input_mixer import InputMixerConfig
    from panst3r_torch.models.mask_transformer import MaskTransformerConfig
    from panst3r_torch.models.panoptic_decoder import PanopticDecoderConfig
    from panst3r_torch.models.panst3r import PanSt3RConfig
    from panst3r_torch.models.upscalers import (LoftUpUpscalerConfig,
                                                PixelShuffleUpscalerConfig)

    def heads(dim, per=64):
        return max(1, dim // per)

    cfg = PanSt3RConfig()
    if _has(sd, "must3r_encoder."):
        p = "must3r_encoder." + ("enc_blocks" if _has(
            sd, "must3r_encoder.enc_blocks.") else "blocks")
        dim = _dim(sd, f"{p}.0.norm1.weight")
        cfg = dataclasses.replace(cfg, encoder=ViTEncoderConfig(
            patch_size=_dim(sd, "must3r_encoder.patch_embed.proj.weight", 2),
            embed_dim=dim, depth=port._infer_depth(sd, p + ".{}.norm1.weight"),
            num_heads=enc_heads or heads(dim),
            mlp_ratio=_dim(sd, f"{p}.0.mlp.fc1.weight") / dim))
    if _has(sd, "must3r_decoder."):
        p = "must3r_decoder"
        dim = _dim(sd, f"{p}.dec_blocks.0.norm1.weight")
        cfg = dataclasses.replace(cfg, decoder=MemoryDecoderConfig(
            enc_dim=_dim(sd, f"{p}.decoder_embed.weight", 1), dim=dim,
            depth=port._infer_depth(sd, p + ".dec_blocks.{}.norm1.weight"),
            num_heads=dec_heads or heads(dim),
            mlp_ratio=_dim(sd, f"{p}.dec_blocks.0.mlp.fc1.weight") / dim,
            patch_size=int(round(np.sqrt(_dim(sd, f"{p}.head.proj.weight")
                                         / 7)))))
    if _has(sd, "dino_encoder."):
        p = "dino_encoder.dinov2"
        dim = _dim(sd, f"{p}.embeddings.cls_token", 2)
        cfg = dataclasses.replace(cfg, dino=DinoEncoderConfig(
            patch_size=_dim(
                sd, f"{p}.embeddings.patch_embeddings.projection.weight", 2),
            embed_dim=dim, num_heads=heads(dim),
            depth=port._infer_depth(sd,
                                    p + ".encoder.layer.{}.norm1.weight"),
            mlp_ratio=_dim(sd, f"{p}.encoder.layer.0.mlp.fc1.weight") / dim,
            pos_grid=int(round(np.sqrt(_dim(
                sd, f"{p}.embeddings.position_embeddings", 1) - 1)))))
    pan = PanopticDecoderConfig()
    p = "panoptic_decoder"
    if _has(sd, f"{p}.mask_transformer."):
        m = f"{p}.mask_transformer"
        hid = _dim(sd, f"{m}.query_feat.weight", 1)
        pan = dataclasses.replace(pan, mask_transformer=MaskTransformerConfig(
            hidden_dim=hid, ff_dim=_dim(sd, f"{m}.ffn_layers.0.linear1.weight"),
            mask_dim=_dim(sd, f"{m}.mask_embed.layers.2.weight"),
            num_queries=_dim(sd, f"{m}.query_feat.weight"),
            num_heads=heads(hid, 96),
            dec_layers=port._infer_depth(
                sd, m + ".ffn_layers.{}.norm.weight"),
            lang_dim=_dim(sd, f"{m}.lang_embed.weight"),
            fpn_dims=(hid,) * _dim(sd, f"{m}.level_embed.weight")))
    if f"{p}.input_mixer.in_proj.weight" in sd:
        m = f"{p}.input_mixer"
        hid = _dim(sd, f"{m}.in_proj.weight")
        pan = dataclasses.replace(pan, input_mixer=InputMixerConfig(
            hidden_dim=hid, num_heads=heads(hid),
            num_layers=port._infer_depth(sd, m + ".mixer_blk.{}.norm1.weight"),
            ff_dim_mult=_dim(sd, f"{m}.mixer_blk.0.mlp.fc1.weight") / hid))
    if f"{p}.upscaler.ca_transformer_norm.weight" in sd:
        u = f"{p}.upscaler"
        dim = _dim(sd, f"{u}.lr_input_proj.0.weight")
        pan = dataclasses.replace(pan, upscaler=LoftUpUpscalerConfig(
            dim=dim, num_heads=heads(dim, 96),
            n_freqs=_dim(sd, f"{u}.fourier_feat.1.biases", 2),
            num_layers=port._infer_depth(
                sd, u + ".ca_transformer_blocks.{}.norm2.weight")))
    elif f"{p}.upscaler.proj_8.fc1.weight" in sd:
        u = f"{p}.upscaler"
        in_dim = _dim(sd, f"{u}.proj_8.fc1.weight", 1)
        pan = dataclasses.replace(pan, upscaler=PixelShuffleUpscalerConfig(
            hidden_dim_factor=_dim(sd, f"{u}.proj_8.fc1.weight") / in_dim,
            fp_dim=(_dim(sd, f"{u}.proj_16.fc2.weight"),
                    _dim(sd, f"{u}.proj_8.fc2.weight") // 4,
                    _dim(sd, f"{u}.proj_4.fc2.weight") // 4,
                    _dim(sd, f"{u}.proj_2.fc2.weight") // 4)))
    if f"{p}.nocls_token" in sd:
        pan = dataclasses.replace(pan, label_mode="softmax",
                                  text_embed_dim=_dim(sd, f"{p}.nocls_token"))
    return dataclasses.replace(cfg, panoptic=pan)


def _has_head(sd) -> bool:
    p = "panoptic_decoder"
    return (f"{p}.mask_transformer.query_feat.weight" in sd
            and (f"{p}.upscaler.proj_8.fc1.weight" in sd
                 or f"{p}.upscaler.ca_transformer_norm.weight" in sd))


def _scene(cfg, seed=0):
    """``PARITY_VIEWS`` seeded uint8 views at ``PARITY_HW``, portrait
    flags and unit class embeddings."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (PARITY_VIEWS, *PARITY_HW, 3),
                          dtype=np.uint8)
    emb = rng.standard_normal(
        (8, cfg.panoptic.mask_transformer.lang_dim)).astype(np.float32)
    return images, np.zeros(PARITY_VIEWS, bool), emb / np.linalg.norm(
        emb, axis=-1, keepdims=True)


def reset_launches() -> None:
    from panst3r_torch.core.dryrun import kernel_wrappers

    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_f32"):
            fn.launches_f32 = 0


def read_launches() -> dict:
    from panst3r_torch.core.dryrun import kernel_wrappers

    return {k: fn.launches for k, fn in kernel_wrappers().items()}


@contextlib.contextmanager
def _no_tf32():
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _model(cfg, ported: dict, device):
    """A port ``PanSt3R`` at ``cfg`` on ``device``, each of its four
    stacks that the ported tree has filled from it (a stack the tree
    lacks stays unset: it is not run)."""
    import torch

    from panst3r_torch.models.panst3r import PanSt3R
    from panst3r_torch.weights import load_jax_params

    with torch.device("meta"):
        model = PanSt3R(cfg)
    model = model.to_empty(device=device).eval()
    for name, sub in ported.items():
        if sub:
            load_jax_params(getattr(model, name), sub)
    return model


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def stage_card_parity(sd: dict, ported: dict, enc_heads=None,
                      dec_heads=None, device="cuda") -> dict:
    """Each stack of the checkpoint on the card against the CPU, in f32,
    each given the CPU's input (``PARITY_LIMITS``); ``launches``: the
    card's kernel launches over the stacks, which run as ``run_device``
    runs them on a scene of ``PARITY_VIEWS`` views, all keyframes.
    Skipped unless ``device`` is a CUDA device."""
    import torch

    if torch.device(device).type != "cuda":
        return {"stage": "card_parity", "status": "skipped",
                "reason": f"device {device}: the stage compares the card "
                          f"against the CPU"}
    return compare_devices(sd, ported, device, enc_heads, dec_heads)


def compare_devices(sd: dict, ported: dict, device, enc_heads=None,
                    dec_heads=None) -> dict:
    """``stage_card_parity``'s comparison of ``device`` against the CPU."""
    import torch

    out: dict = {"stage": "card_parity", "modules": {}}
    try:
        from panst3r_torch.core.bucketing import Bucket
        from panst3r_torch.engine.inference import InferenceEngine
        from panst3r_torch.ops.image import image_cast

        cfg = config_from_state_dict(sd, enc_heads, dec_heads)
        images, portrait, emb = _scene(cfg)
        V = images.shape[0]
        devs = {"cuda": torch.device(device), "cpu": torch.device("cpu")}
        eng = {k: InferenceEngine(_model(cfg, ported, d), Bucket(*PARITY_HW),
                                  num_keyframes=V, chunk=V, amp=False,
                                  device=d) for k, d in devs.items()}
        res: dict = {k: {} for k in devs}
        t0 = time.perf_counter()
        with torch.inference_mode(), _no_tf32():
            reset_launches()
            for k, d in devs.items():
                e = eng[k]
                img = torch.as_tensor(images, device=d)
                r = res[k]
                if "must3r_encoder" in ported:
                    r["x"], r["pos"] = e.encode_batch(img)
                if "dino_encoder" in ported:
                    r["dino"] = e.dino_batch(img)
            cpu = res["cpu"]
            for k, d in devs.items():
                e, r = eng[k], res[k]
                if "must3r_decoder" in ported and "x" in cpu:
                    x, pos = cpu["x"].to(d), cpu["pos"].to(d)
                    mem = e.build_memory(x, pos)
                    r["pointmaps_raw"], r["y"] = e.render_batch(x, pos, mem)
            heads = _has_head(sd) and {"x", "y", "dino"} <= set(cpu)
            for k, d in devs.items() if heads else ():
                idx = torch.arange(V, device=d)
                head = eng[k]._heads(
                    image_cast(torch.as_tensor(images, device=d),
                               False)[None],
                    *(cpu[n].to(d)[None] for n in ("x", "y", "dino", "pos")),
                    torch.as_tensor(portrait, device=d)[None],
                    torch.as_tensor(emb, device=d), idx[None],
                    idx[:0][None])
                res[k].update(pred_logits=head["pred_logits"][0],
                              pred_masks=head["pred_masks"][0])
            if devs["cuda"].type == "cuda":
                torch.cuda.synchronize()
            out["launches"] = read_launches()
        out["seconds"] = time.perf_counter() - t0
        gpu = {k: v.cpu() for k, v in res["cuda"].items()}
        checks = {}

        def rel(stack, key):
            checks[stack] = {"max_rel_err": _rel(gpu[key], cpu[key]),
                             "limit": PARITY_LIMITS["rel"]}
            checks[stack]["ok"] = checks[stack]["max_rel_err"] \
                <= PARITY_LIMITS["rel"]

        def close(stack, key):
            atol, rtol = PARITY_LIMITS[key]
            diff = (gpu[key] - cpu[key]).abs()
            checks[stack] = {"max_abs_err": float(diff.max()),
                             "atol": atol, "rtol": rtol,
                             "ok": bool((diff <= atol + rtol
                                         * cpu[key].abs()).all())}
        for stack, key, check in (
                ("must3r_encoder", "x", rel), ("dino_encoder", "dino", rel),
                ("must3r_decoder", "y", rel),
                ("pointmaps_raw", "pointmaps_raw", close),
                ("pred_logits", "pred_logits", close),
                ("pred_masks", "pred_masks", close)):
            if key in cpu:
                check(stack, key)
        out["modules"] = checks
        out["dims"] = {"encoder": [cfg.encoder.embed_dim, cfg.encoder.depth,
                                   cfg.encoder.num_heads],
                       "decoder": [cfg.decoder.dim, cfg.decoder.depth,
                                   cfg.decoder.num_heads],
                       "dino": [cfg.dino.embed_dim, cfg.dino.depth],
                       "views": V, "hw": list(PARITY_HW)}
        bad = [k for k, c in checks.items() if not c["ok"]]
        out["status"] = "ok" if checks and not bad else "fail"
        if out["status"] != "ok":
            out["reason"] = f"card and CPU disagree on {bad}" if bad \
                else "no stack to compare"
    except Exception as e:
        out["status"] = "error"
        out["error"] = repr(e)
    return out


def preset_of(sd: dict, ported: dict):
    """The registered preset whose parameter tree has exactly the ported
    tree's leaves and shapes (v2 when the checkpoint has an input mixer,
    else v1), or None."""
    import torch

    from panst3r_torch.models import presets
    from panst3r_torch.models.panst3r import PanSt3R
    from panst3r_torch.weights import dump_jax_params

    name = "v2" if _has(sd, "panoptic_decoder.input_mixer.") else "v1"
    cfg = getattr(presets, f"panst3r_{name}_config")()
    with torch.device("meta"):
        want = dump_jax_params(PanSt3R(cfg))
    shapes = {k: np.shape(v) for k, v in port.flatten(want)}
    got = {k: np.shape(v) for k, v in port.flatten(ported)}
    return (name, cfg) if got == shapes else None


def stage_forward(sd: dict, ported: dict, device="cuda",
                  npz: str | None = None) -> dict:
    """The matching preset from the ported tree (``npz``: the tree as
    ``ported_params.npz``, written to a temporary file when not given;
    read by ``load_ported_npz``) on one ``run_device`` scene of
    ``PARITY_VIEWS`` views; ``launches``: that scene's kernel launches."""
    import torch

    out: dict = {"stage": "forward"}
    try:
        from panst3r_torch.apps.eval import load_ported_npz
        from panst3r_torch.core.bucketing import Bucket
        from panst3r_torch.engine.inference import InferenceEngine
        from panst3r_torch.models.panst3r import build_model

        match = preset_of(sd, ported)
        if match is None:
            out["status"] = "skipped"
            out["reason"] = ("checkpoint dims match no registered preset "
                             "(v1 / v2); the forward stage needs a preset")
            return out
        name, cfg = match
        model = build_model(cfg, device=device, seed=0)
        with tempfile.TemporaryDirectory() as tmp:
            if npz is None:
                npz = os.path.join(tmp, "ported_params.npz")
                np.savez(npz, **dict(port.flatten(ported)))
            load_ported_npz(model, npz)
        eng = InferenceEngine(model, Bucket(*PARITY_HW),
                              num_keyframes=PARITY_VIEWS, chunk=PARITY_VIEWS,
                              amp=True, device=device)
        images, portrait, emb = _scene(cfg, seed=1)
        reset_launches()
        t0 = time.perf_counter()
        res = eng.run_device(images, portrait, emb)
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = read_launches()
        out["preset"] = name
        out["finite"] = all(bool(torch.isfinite(v.float()).all())
                            for v in res.values() if torch.is_tensor(v))
        out["status"] = "ok" if out["finite"] else "fail"
        if not out["finite"]:
            out["reason"] = "non-finite outputs"
    except Exception as e:
        out["status"] = "error"
        out["error"] = repr(e)
    return out


def stage_pq(sd: dict, npz: str, args, device="cuda") -> dict:
    """PQ over the benchmark's scenes (``apps/eval.py``) with the ported
    weights; fails more than one point below the published PQ."""
    out: dict = {"stage": "pq"}
    try:
        from panst3r_torch.apps import eval as eval_app

        v2 = _has(sd, "panoptic_decoder.input_mixer.")
        pq = eval_app.main(
            ["--data-root", args.data_root, "--benchmark", args.benchmark,
             "--preset", "v2" if v2 else "v1", "--ported-npz", npz,
             "--num-scenes", str(args.num_scenes), "--device", str(device)])
        out.update(pq)
        vs = pq.get("vs_reference")
        if vs is None:
            out["status"] = "ok"
            out["note"] = ("no REFERENCE_PQ entry for this (preset, "
                           "benchmark): PQ recorded, not judged")
        else:
            out["status"] = "ok" if vs >= -1.0 else "fail"
            if vs < -1.0:
                out["reason"] = f"PQ {vs} points from the published number"
    except Exception as e:
        out["status"] = "error"
        out["error"] = repr(e)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Verify the port of a reference PanSt3R checkpoint")
    ap.add_argument("--torch", required=True,
                    help=".pth checkpoint (or .npz state_dict)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--rope-layout", choices=port.ROPE_LAYOUTS,
                    default="half")
    ap.add_argument("--rename-json", default=None)
    ap.add_argument("--skip-card-parity", action="store_true")
    ap.add_argument("--skip-forward", action="store_true")
    ap.add_argument("--data-root", default=None,
                    help="benchmark scenes root -> run the PQ stage")
    ap.add_argument("--benchmark", default="scannet",
                    choices=["scannetpp", "hypersim", "replica", "scannet"])
    ap.add_argument("--num-scenes", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    ap.add_argument("--trust-pickle", action="store_true",
                    help="unpickle the .pth with weights_only=False")
    args = ap.parse_args(argv)

    from panst3r_torch.core.device import resolve_device

    device = resolve_device(args.device)
    rename = port.read_rename(args.rename_json)
    t0 = time.perf_counter()
    sd = load_sd(args.torch, args.trust_pickle)
    report: dict = {"checkpoint": args.torch, "num_keys": len(sd),
                    "device": str(device), "stages": [],
                    "load_seconds": time.perf_counter() - t0}

    def run(fn, *a, **kw):
        t = time.perf_counter()
        stage = fn(*a, **kw)
        stage.setdefault("stage_seconds", time.perf_counter() - t)
        report["stages"].append(stage)
        return stage

    p = run(stage_port, sd, rename=rename, rope_layout=args.rope_layout)
    ported = p.pop("_ported_tree", None)
    if ported is not None:
        os.makedirs(args.out, exist_ok=True)
        npz = os.path.join(args.out, "ported_params.npz")
        np.savez(npz, **dict(port.flatten(ported)))
        run(stage_roundtrip, sd, ported, rename=rename,
            rope_layout=args.rope_layout)
        # the stages below read the checkpoint's dims under its renames
        named = port.Port(sd, rename=rename).sd
        if not args.skip_card_parity:
            run(stage_card_parity, named, ported, device=device)
        if not args.skip_forward:
            run(stage_forward, named, ported, device=device, npz=npz)
        if args.data_root:
            run(stage_pq, named, npz, args, device)

    statuses = [s["status"] for s in report["stages"]]
    report["verdict"] = ("ok" if all(s in ("ok", "skipped")
                                     for s in statuses) else "fail")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "verify_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"[verify_port] {report['verdict'].upper()} — stages: "
          + ", ".join(f"{s['stage']}={s['status']}"
                      for s in report["stages"]))
    print(f"report: {path}")
    return report


if __name__ == "__main__":
    main()
