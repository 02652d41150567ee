"""Checkpoints and the demo in the port against the JAX package (CPU, f32):
the reference state_dict loader, the port's own checkpoints, QUBO fusion,
build_engine, reconstruct_scene and export_scene.  QUBO parity follows
tests/test_qubo_parity.py and reuses its transcriptions of the reference."""
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from panst3r_torch.apps import demo as tdemo
from panst3r_torch.apps.common import build_engine
from panst3r_torch.core.bucketing import Bucket as TBucket
from panst3r_torch.core.checkpoint import (latest_checkpoint,
                                           load_checkpoint, save_checkpoint)
from panst3r_torch.engine.fusion import qubo_fusion, qubo_weights, \
    solve_qubo_sa
from panst3r_torch.models import presets as tpresets
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.panst3r import build_model
from panst3r_torch.port_checkpoint import load_reference_state_dict
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.apps import demo as jdemo
from panst3r_tpu.core.bucketing import Bucket as JBucket
from panst3r_tpu.engine.fusion import qubo_weights as j_qubo_weights
from panst3r_tpu.models import presets as jpresets
from panst3r_tpu.models.mask_transformer import MaskTransformerConfig
from panst3r_tpu.models.upscalers import LoftUpUpscalerConfig as JLoftUp
from panst3r_torch.models.upscalers import LoftUpUpscalerConfig as TLoftUp
from tests.test_port import _fake_reference_mask_transformer_sd
from tests.test_port_full import (TEncoder, TInputMixer, TLoftUp as TRefLoftUp,
                                  TMemoryDecoder, TMlp)
from tests.test_qubo_parity import (brute_force_qubo,
                                    reference_qubo_selection,
                                    reference_weight_from_masks)
from tools.port_torch_checkpoint import port_checkpoint
from tests.torch_release import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
H, W = 32, 48


# ------------------------------------------------ reference state_dicts --

def _v2_loftup(mod):
    """tiny_v2 with LoftUp at the reference's 20 Fourier frequencies and two
    blocks (the reference module's shape)."""
    cfg = mod.tiny_v2_config()
    up = (JLoftUp if mod is jpresets else TLoftUp)(
        dim=16, n_freqs=20, num_heads=2, num_layers=2)
    return dataclasses.replace(cfg, panoptic=dataclasses.replace(
        cfg.panoptic, upscaler=up))


PRESETS = {"v1": (tpresets.tiny_config, jpresets.tiny_config),
           "v2": (lambda: _v2_loftup(tpresets), lambda: _v2_loftup(jpresets))}


def _dinov2_sd(dino, prefix: str) -> dict:
    """The keys and shapes of HF ``Dinov2Model`` (transformers'
    modeling_dinov2 naming) at ``dino``'s widths."""
    C, hid = dino.embed_dim, int(dino.embed_dim * dino.mlp_ratio)
    p = dino.patch_size
    sd = {f"{prefix}.embeddings.cls_token": (1, 1, C),
          f"{prefix}.embeddings.mask_token": (1, C),
          f"{prefix}.embeddings.position_embeddings":
              (1, dino.pos_grid ** 2 + 1, C),
          f"{prefix}.embeddings.patch_embeddings.projection.weight":
              (C, 3, p, p),
          f"{prefix}.embeddings.patch_embeddings.projection.bias": (C,),
          f"{prefix}.layernorm.weight": (C,),
          f"{prefix}.layernorm.bias": (C,)}
    for i in range(dino.depth):
        L = f"{prefix}.encoder.layer.{i}"
        for name, (o, n) in (("attention.attention.query", (C, C)),
                             ("attention.attention.key", (C, C)),
                             ("attention.attention.value", (C, C)),
                             ("attention.output.dense", (C, C)),
                             ("mlp.fc1", (hid, C)), ("mlp.fc2", (C, hid))):
            sd[f"{L}.{name}.weight"] = (o, n)
            sd[f"{L}.{name}.bias"] = (o,)
        for name in ("norm1", "norm2"):
            sd[f"{L}.{name}.weight"] = sd[f"{L}.{name}.bias"] = (C,)
        sd[f"{L}.layer_scale1.lambda1"] = (C,)
        sd[f"{L}.layer_scale2.lambda1"] = (C,)
    return sd


def _shapes(module, prefix):
    return {f"{prefix}.{k}": tuple(v.shape)
            for k, v in module.state_dict().items()}


def reference_shapes(cfg) -> dict:
    """{key: shape} of a reference-shaped state_dict at ``cfg``'s widths,
    from the reference-named torch modules of tests/test_port_full.py
    (built on the meta device) and HF Dinov2Model's naming (as
    tests/test_port_full.py:579-612 does)."""
    enc, dec, dino = cfg.encoder, cfg.decoder, cfg.dino
    pan = cfg.panoptic
    sd = {}
    with torch.device("meta"):
        sd.update(_shapes(TEncoder(enc.embed_dim, enc.depth, enc.num_heads),
                          "must3r_encoder"))
        sd.update(_shapes(TMemoryDecoder(enc.embed_dim, dec.dim, dec.depth,
                                         dec.num_heads), "must3r_decoder"))
        sd.update(_dinov2_sd(dino, "dino_encoder.dinov2"))
        in_dim = enc.embed_dim + dec.dim + dino.embed_dim
        if pan.input_mixer is not None:
            mix = pan.input_mixer
            sd.update(_shapes(TInputMixer(in_dim, mix.hidden_dim,
                                          mix.num_heads, mix.num_layers),
                              "panoptic_decoder.input_mixer"))
            up = pan.upscaler
            sd.update(_shapes(TRefLoftUp(mix.hidden_dim, up.dim,
                                         up.num_heads, up.n_freqs),
                              "panoptic_decoder.upscaler"))
        else:
            # the reference PixelShuffle upscaler's four MLPs, at the widths
            # of the port's module for this config
            shapes = {k: tuple(v.shape) for k, v in TPanSt3R(cfg)
                      .panoptic_decoder.upscaler.named_parameters()}
            for name in ("proj_8", "proj_4", "proj_2", "proj_16"):
                hid, din = shapes[f"{name}.fc1.weight"]
                sd.update(_shapes(TMlp(din, hid,
                                       shapes[f"{name}.fc2.weight"][0]),
                                  f"panoptic_decoder.upscaler.{name}"))
    mt = pan.mask_transformer
    sd.update({k: np.shape(v) for k, v in
               _fake_reference_mask_transformer_sd(
                   np.random.default_rng(0), MaskTransformerConfig(
                       hidden_dim=mt.hidden_dim, ff_dim=mt.ff_dim,
                       mask_dim=mt.mask_dim, num_queries=mt.num_queries,
                       num_heads=mt.num_heads, dec_layers=mt.dec_layers,
                       lang_dim=mt.lang_dim, fpn_dims=mt.fpn_dims)).items()})
    return sd


def reference_state_dict(cfg, seed: int = 0) -> dict:
    """A reference-shaped state_dict at ``cfg``'s widths
    (``reference_shapes``), every value drawn from a numpy seed: weights
    scaled by 1/sqrt(fan-in), norm scales near 1, small biases."""
    sd = reference_shapes(cfg)
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in sorted(sd.items()):
        if len(shape) >= 2 and not k.endswith(("embeddings", "_token",
                                               "position_embeddings")) \
                and "query_" not in k and "level_embed" not in k:
            fan_in = int(np.prod(shape[1:]))
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif k.endswith("weight") and len(shape) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif k.endswith(("bias", "_token", "position_embeddings")):
            a = 0.05 * rng.standard_normal(shape)
        elif k.endswith("lambda1"):
            a = 0.2 + 0.05 * rng.standard_normal(shape)
        elif k.endswith("cls_logit_scale"):
            a = np.asarray(1.0 + 0.1 * rng.standard_normal())
        else:                  # query_feat / query_embed / level_embed
            a = rng.standard_normal(shape)
        out[k] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("preset", ["v1", "v2"])
def test_reference_state_dict_loads_and_matches_jax(preset):
    """0 unmapped keys, and every parameter equal to the JAX tool's tree
    through load_jax_params.  The forward of the weights so loaded is held
    against the JAX model on the same tree by tests/test_torch_multibucket.py
    (test_multibucket_engine_and_fusion_match_jax)."""
    tcfg_fn, _ = PRESETS[preset]
    sd = reference_state_dict(tcfg_fn())
    model = TPanSt3R(tcfg_fn())
    report = load_reference_state_dict(
        model, {k: torch.from_numpy(v) for k, v in sd.items()})
    assert report["unmapped"] == []
    assert report["ported_keys"] + len(report["ignored"]) == len(sd)
    tree, jreport = port_checkpoint(sd)
    assert jreport["unmapped"] == []
    want = load_jax_params(TPanSt3R(tcfg_fn()), tree)
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 want.named_parameters()):
        assert torch.equal(p, q), name


def test_reference_checkpoint_file_loads_safely(tmp_path):
    """A reference checkpoint file with its training arguments (an
    argparse.Namespace) loads under weights_only; a file that pickles any
    other object is refused unless trust_pickle is set."""
    import argparse
    import pickle

    from panst3r_torch.apps.common import load_weights

    cfg = tpresets.tiny_config()
    weights = {k: torch.from_numpy(v)
               for k, v in reference_state_dict(cfg).items()}
    torch.save({"args": argparse.Namespace(lr=1e-4), "weights": weights},
               tmp_path / "ref.pth")
    model = TPanSt3R(cfg)
    assert load_weights(model, tmp_path / "ref.pth") == {}
    torch.save({"extra": _Unlisted(), "weights": weights},
               tmp_path / "other.pth")
    with pytest.raises(pickle.UnpicklingError):
        load_weights(TPanSt3R(cfg), tmp_path / "other.pth")
    with pytest.warns(UserWarning, match="weights_only=False"):
        load_weights(TPanSt3R(cfg), tmp_path / "other.pth",
                     trust_pickle=True)


class _Unlisted:
    """An object torch.load's weights_only allow-list does not admit."""


# ------------------------------------------------------------ checkpoints --

def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    cfg = tpresets.tiny_v2_config()
    model = build_model(cfg, device="cpu", seed=3)
    cls_emb = np.random.default_rng(0).standard_normal((4, 24)) \
        .astype(np.float32)
    meta = {"classes": ["a", "b", "c", "d"], "cls_emb": cls_emb, "epoch": 7}
    assert latest_checkpoint(tmp_path) is None
    save_checkpoint(tmp_path, "last", model, cfg, meta)
    assert latest_checkpoint(tmp_path) == "last"
    state, cfg2, meta2 = load_checkpoint(tmp_path, "last")
    assert cfg2 == cfg
    assert meta2["classes"] == meta["classes"] and meta2["epoch"] == 7
    np.testing.assert_array_equal(meta2["cls_emb"], cls_emb)
    own = model.state_dict()
    assert set(state) == set(own)
    for k, v in own.items():
        assert torch.equal(state[k], v), k
    fresh = build_model(cfg, device="cpu", seed=4)
    fresh.load_state_dict(state)
    for (k, p), (_, q) in zip(fresh.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(p, q), k


def test_build_engine_pairs_weights_with_meta(tmp_path):
    cfg = tpresets.tiny_config()
    model = build_model(cfg, device="cpu", seed=5)
    cls_emb = np.random.default_rng(2).standard_normal((3, 24)) \
        .astype(np.float32)
    save_checkpoint(tmp_path, "ckpt", model, cfg,
                    {"classes": ["x", "y", "z"], "cls_emb": cls_emb})
    eng, classes, emb = build_engine("tiny", TBucket(H, W),
                                     checkpoint=str(tmp_path / "ckpt"),
                                     amp=False, device="cpu")
    assert classes == ["x", "y", "z"]
    np.testing.assert_array_equal(emb, cls_emb)
    for (k, p), (_, q) in zip(eng.model.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(p, q), k
    # without a checkpoint: the JAX package's random unit embeddings
    _, classes, emb = build_engine("tiny", TBucket(H, W), amp=False,
                                   device="cpu", seed=9)
    rng = np.random.default_rng(9)
    want = rng.standard_normal((32, 24)).astype(np.float32)
    want /= np.linalg.norm(want, axis=-1, keepdims=True)
    assert classes == [f"class_{i}" for i in range(32)]
    np.testing.assert_array_equal(emb, want)


# ------------------------------------------------------------------ QUBO --

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("prob_weighted", [False, True])
def test_qubo_weights_match_jax_and_reference(seed, prob_weighted):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(9, 2, 10, 12)).astype(np.float32)
    probs = rng.uniform(size=(9, 4)).astype(np.float32)
    _, ref = reference_weight_from_masks(masks, probs,
                                         prob_weighted=prob_weighted)
    want = np.asarray(j_qubo_weights(jnp.asarray(masks), jnp.asarray(probs),
                                     prob_weighted=prob_weighted))
    got = qubo_weights(torch.from_numpy(masks), torch.from_numpy(probs),
                       prob_weighted=prob_weighted).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qubo_sa_finds_brute_force_optimum(seed):
    rng = np.random.default_rng(seed)
    N = 10
    Wm = rng.uniform(size=(N, N))
    Wm = (Wm + Wm.T) / 2
    np.fill_diagonal(Wm, -np.abs(np.diag(Wm)) - 0.1)
    x_star, e_star = brute_force_qubo(Wm)
    sol, e = solve_qubo_sa(torch.tensor(Wm, dtype=torch.float32), seed=seed,
                           num_iters=2000, num_restarts=8)
    assert float(e) == pytest.approx(e_star, abs=1e-4)
    np.testing.assert_array_equal(sol.numpy().astype(np.float64), x_star)


def test_qubo_fusion_selection_matches_reference():
    """qubo_fusion on well-separated masks against the reference parse of
    the brute-force optimum (tests/test_qubo_parity.py's instance)."""
    rng = np.random.default_rng(3)
    B, V, Q, NC = 1, 2, 6, 4
    h, w, Hf, Wf = 8, 12, 16, 24
    logits = np.full((B, V, Q, h, w), -6.0, np.float32)
    logits[0, :, 0, :4, :6] = 6.0
    logits[0, :, 1, 4:, :6] = 6.0
    logits[0, :, 2, :, 6:] = 6.0
    logits[0, :, 3:] += rng.standard_normal((V, 3, h, w)).astype(np.float32)
    mask_cls = rng.standard_normal((B, Q, NC)).astype(np.float32) * 2

    out = qubo_fusion(torch.from_numpy(mask_cls), torch.from_numpy(logits),
                      (Hf, Wf), num_restarts=8, seed=0)[0]
    masks = jax.nn.sigmoid(jnp.asarray(logits[0], jnp.float32))
    masks = np.asarray(jax.image.resize(masks, (V, Q, Hf, Wf), "bilinear"))
    masks = masks.transpose(1, 0, 2, 3)
    probs = 1 / (1 + np.exp(-mask_cls[0].astype(np.float64)))
    _, Wm = reference_weight_from_masks(masks, probs)
    x_star, _ = brute_force_qubo(Wm)
    pan_ref, infos_ref, conf_ref = reference_qubo_selection(
        masks, probs.astype(np.float32), x_star)
    np.testing.assert_array_equal(out["pan"], pan_ref)
    for key in ("query_id", "category_id", "area"):
        assert [i[key] for i in out["segments_info"]] == \
            [i[key] for i in infos_ref]
    for o, r in zip(out["segments_info"], infos_ref):
        assert o["class_prob"] == pytest.approx(r["class_prob"], rel=1e-4)
        assert o["mask_conf"] == pytest.approx(r["mask_conf"], rel=1e-4)
    np.testing.assert_allclose(out["conf"], conf_ref, atol=1e-5)


def test_qubo_double_sigmoid_temperature_quirk():
    """With a temperature the reference sigmoids twice; kept."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((1, 1, 4, 6, 8)).astype(np.float32)
    mask_cls = rng.standard_normal((1, 4, 3)).astype(np.float32)
    out = qubo_fusion(torch.from_numpy(mask_cls), torch.from_numpy(logits),
                      (12, 16), temperature=0.1, num_restarts=4, seed=0)[0]
    s = 1 / (1 + np.exp(-mask_cls[0]))
    ss = 1 / (1 + np.exp(-s))
    expected = np.exp(ss / 0.1) / np.exp(ss / 0.1).sum(-1, keepdims=True)
    assert out["segments_info"]
    for info in out["segments_info"]:
        assert info["class_prob"] == pytest.approx(
            float(expected[info["query_id"]].max()), rel=1e-4)


# ------------------------------------------------------------------ demo --

def _write_views(root: pathlib.Path, rng) -> list[str]:
    """Three landscape views and one portrait view as PNG files."""
    from PIL import Image

    paths = []
    for i, (h, w) in enumerate(((H, W), (H, W), (W, H), (H, W))):
        p = root / f"view_{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(p)
        paths.append(str(p))
    return paths


class _SharedRun:
    """Hands the JAX demo the port engine's ``run`` output, so that both
    demos fuse and recover cameras from the same engine outputs (the
    engines themselves are held to each other by
    tests/test_torch_inference.py and tests/test_torch_multibucket.py)."""

    def __init__(self, engine):
        self.engine = engine

    def run(self, images, portrait, cls_emb, num_keyframes=None):
        return self.engine.run(images, portrait, cls_emb,
                               num_keyframes=num_keyframes)


def test_reconstruct_scene_matches_jax(tmp_path):
    """The demo on PNG views: weights from a reference state_dict file
    (build_engine → load_reference_state_dict), standard fusion and
    cameras against the JAX demo's on the same engine outputs; then the
    port's export."""
    rng = np.random.default_rng(0)
    paths = _write_views(tmp_path, rng)
    images, portrait, bucket = tdemo.load_images(paths, TBucket(H, W))
    jimages, jportrait, _ = jdemo.load_images(paths, JBucket(H, W))
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(portrait, [False, False, True, False])
    np.testing.assert_array_equal(portrait, jportrait)

    sd = reference_state_dict(tpresets.tiny_config(), seed=1)
    torch.save({"weights": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "ref.pth")
    teng, classes, cls_emb = build_engine(
        "tiny", bucket, checkpoint=str(tmp_path / "ref.pth"),
        num_keyframes=3, amp=False, classes=tdemo.SCANNET_CLASSES,
        device="cpu")
    assert classes == tdemo.SCANNET_CLASSES
    want = jdemo.reconstruct_scene(_SharedRun(teng), images, portrait,
                                   classes, cls_emb)
    got = tdemo.reconstruct_scene(teng, images, portrait, classes, cls_emb)
    assert got["keyframes"] == want["keyframes"]
    np.testing.assert_allclose(got["pointmaps"]["pts3d"],
                               want["pointmaps"]["pts3d"], atol=2e-4,
                               rtol=1e-4)
    assert got["segments_info"] == want["segments_info"]
    assert np.mean(got["pan"] == want["pan"]) >= 0.995
    np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-2)
    np.testing.assert_allclose(got["focals"], want["focals"], rtol=1e-3)
    np.testing.assert_allclose(got["cams2world"], want["cams2world"],
                               atol=1e-3)

    tdemo.export_scene(tmp_path / "out", images, got)
    meta = json.loads((tmp_path / "out" / "cameras.json").read_text())
    assert len(meta["focals"]) == 4 and meta["image_size"] == [H, W]
    assert (tmp_path / "out" / "panoptic_003.png").exists()
    head = (tmp_path / "out" / "scene.ply").read_text().split("\n")
    assert head[0] == "ply"
    n = int(head[2].split()[-1])
    assert len(head) == 10 + n + 1     # header, vertices, final newline

    for fusion in ("qubo", "standard_v1"):
        other = tdemo.reconstruct_scene(teng, images, portrait, classes,
                                        cls_emb, fusion=fusion)
        assert other["pan"].shape == (4, H, W)
        tdemo.export_scene(tmp_path / fusion, images, other, overlays=False)
        assert not list((tmp_path / fusion).glob("*.png"))


def test_reconstruct_scene_standard_v1_matches_jax(tmp_path):
    """``fusion="standard_v1"`` fuses as the JAX demo does for every name
    but "qubo" (the standard v2 fusion): segments, pan, conf and cameras
    against the JAX demo's on the same engine outputs, under the checks of
    ``test_reconstruct_scene_matches_jax``."""
    rng = np.random.default_rng(0)
    images, portrait, bucket = tdemo.load_images(
        _write_views(tmp_path, rng), TBucket(H, W))
    sd = reference_state_dict(tpresets.tiny_config(), seed=1)
    torch.save({"weights": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "ref.pth")
    teng, classes, cls_emb = build_engine(
        "tiny", bucket, checkpoint=str(tmp_path / "ref.pth"),
        num_keyframes=3, amp=False, classes=tdemo.SCANNET_CLASSES,
        device="cpu")
    # class embeddings under which a few queries pass fusion's class
    # threshold, so that the fusions have segments to disagree on
    cls_emb = chip_smoke.segment_classes(teng, images, portrait,
                                         ncls=len(classes))
    want = jdemo.reconstruct_scene(_SharedRun(teng), images, portrait,
                                   classes, cls_emb, fusion="standard_v1")
    got = tdemo.reconstruct_scene(teng, images, portrait, classes, cls_emb,
                                  fusion="standard_v1")
    assert want["segments_info"]
    assert got["segments_info"] == want["segments_info"]
    assert np.mean(got["pan"] == want["pan"]) >= 0.995
    np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-2)
    np.testing.assert_allclose(got["focals"], want["focals"], rtol=1e-3)
    np.testing.assert_allclose(got["cams2world"], want["cams2world"],
                               atol=1e-3)


def test_main_writes_the_scene(tmp_path):
    """The command line on two views whose aspect picks the smallest
    default bucket (160x512)."""
    from PIL import Image

    rng = np.random.default_rng(1)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (20, 64, 3), dtype=np.uint8)) \
            .save(tmp_path / f"v{i}.png")
    tdemo.main(["--images", str(tmp_path), "--out", str(tmp_path / "o"),
                "--preset", "tiny", "--num-keyframes", "2", "--device",
                "cpu"])
    meta = json.loads((tmp_path / "o" / "cameras.json").read_text())
    assert meta["image_size"] == [160, 512]
    assert (tmp_path / "o" / "scene.ply").exists()
    assert (tmp_path / "o" / "panoptic_001.png").exists()


_NO_YAML_PIL = r"""
import importlib, pkgutil, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("yaml", "PIL"):
            raise ImportError("refused import: " + name)
        return None
sys.meta_path.insert(0, Refuse())
import panst3r_torch
for m in pkgutil.walk_packages(panst3r_torch.__path__, "panst3r_torch."):
    importlib.import_module(m.name)
import chip_smoke
print("ok")
"""


def test_no_yaml_or_pil_at_module_level():
    """The card's machine has no PyYAML: no port module, nor chip_smoke.py,
    imports it (or PIL) when it is imported."""
    res = subprocess.run([sys.executable, "-c", _NO_YAML_PIL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
