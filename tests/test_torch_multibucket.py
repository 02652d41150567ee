"""Mixed-aspect scenes in the port against the JAX package (CPU, f32):
bucketing, the config file helpers, the multi-bucket mask transformer,
MultiBucketEngine.run at tiny and tiny_v2, and panoptic_fusion_multi_ar.
The limits are those of the JAX tests mirrored (tests/test_bucketing.py,
tests/test_multibucket.py, tests/test_multibucket_engine.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch.core import bucketing as tb
from panst3r_torch.core import config as tcfg
from panst3r_torch.engine.fusion import (
    panoptic_fusion_multi_ar as t_fusion_multi_ar)
from panst3r_torch.engine.inference import InferenceEngine as TEngine
from panst3r_torch.engine.inference import MultiBucketEngine as TMulti
from panst3r_torch.models import presets as tpresets
from panst3r_torch.models.mask_transformer import MaskTransformer as TMT
from panst3r_torch.models.mask_transformer import (
    MaskTransformerConfig as TMTCfg)
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.panst3r import build_model
from panst3r_torch.port_checkpoint import load_reference_state_dict
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.core import bucketing as jb
from panst3r_tpu.engine.fusion import (
    panoptic_fusion_multi_ar as j_fusion_multi_ar)
from panst3r_tpu.engine.inference import MultiBucketEngine as JMulti
from panst3r_tpu.models.mask_transformer import MaskTransformer as JMT
from panst3r_tpu.models.mask_transformer import (
    MaskTransformerConfig as JMTCfg)
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from tests.test_torch_demo import PRESETS as REF_PRESETS
from tests.test_torch_demo import reference_state_dict
from tests.test_torch_models import _apply, _init
from tools.port_torch_checkpoint import port_checkpoint
from tests.torch_release import release_memory  # noqa: F401

H, W, H2, W2, NCLS = 32, 48, 32, 32, 5


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- buckets --

def test_bucket_helpers_match_jax():
    assert [b.shape for b in tb.DEFAULT_BUCKETS] == \
        [b.shape for b in jb.DEFAULT_BUCKETS]
    b = tb.Bucket(384, 512)
    assert b.grid(16) == (24, 32) and b.num_patches(16) == 768
    with pytest.raises(AssertionError):
        tb.Bucket(512, 384)
    for h, w in ((384, 512), (512, 384), (150, 512), (3000, 4000),
                 (336, 512), (512, 160), (100, 100)):
        assert tb.landscape_shape(h, w) == jb.landscape_shape(h, w)
        assert tb.bucket_for_shape(h, w).shape == \
            jb.bucket_for_shape(h, w).shape
    img = np.zeros((512, 384, 3), np.uint8)
    for mod in (tb, jb):
        out, portrait = mod.transpose_to_landscape(img)
        assert out.shape == (384, 512, 3) and portrait
    flags = np.array([[False, True, True]])
    for bucket in (tb.Bucket(384, 512), tb.Bucket(160, 512)):
        want = np.asarray(jb.true_shape_of(jb.Bucket(*bucket.shape),
                                           jnp.asarray(flags)[..., None]))
        got = tb.true_shape_of(bucket, torch.from_numpy(flags)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tb.true_shape_of(bucket, True),
                                      bucket.shape[::-1])


@pytest.mark.parametrize("bs", [1, 2, 4, 15, None])
def test_micro_batched_matches_jax(bs):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4)).astype(np.float32)
    y = rng.standard_normal((3, 5, 4)).astype(np.float32)

    def fn(a, b):
        return a * 2 + b, (a - b).sum(-1)

    want = jb.micro_batched(fn, bs)(jnp.asarray(x), jnp.asarray(y))
    got = tb.micro_batched(fn, bs)(_t(x), _t(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    single = tb.micro_batched(lambda a: a * 3, bs)(_t(x))
    np.testing.assert_allclose(single.numpy(), x * 3, atol=1e-6)


@pytest.mark.parametrize("preset", ["panst3r_v1_config", "panst3r_v2_config",
                                    "tiny_config", "tiny_v2_config"])
def test_config_yaml_json_round_trip(tmp_path, preset):
    cfg = getattr(tpresets, preset)()
    for save, load, name in ((tcfg.save_yaml, tcfg.load_yaml, "c.yaml"),
                             (tcfg.save_json, tcfg.load_json, "c.json")):
        save(cfg, tmp_path / name)
        assert load(tmp_path / name) == cfg


# ------------------------------------------------------ mask transformer --

_MT_KW = dict(hidden_dim=32, ff_dim=64, mask_dim=16, num_queries=8,
              num_heads=4, dec_layers=2, lang_dim=24, fpn_dims=(32,))


def _bucket_inputs(rng, V, gh, gw, mask_hw, portrait=False):
    fpn = rng.standard_normal((1, V, gh, gw, 32)).astype(np.float32)
    mask_f = rng.standard_normal((1, V, *mask_hw, 16)).astype(np.float32)
    port = np.zeros((1, V), bool)
    port[0, -1] = portrait
    return fpn, mask_f, port


@pytest.fixture(scope="module")
def mt_two_buckets():
    rng = np.random.default_rng(0)
    cls = rng.standard_normal((NCLS, 24)).astype(np.float32)
    b1 = _bucket_inputs(rng, 2, 2, 3, (16, 24), portrait=True)
    b2 = _bucket_inputs(rng, 1, 3, 3, (24, 24))
    jm = JMT(JMTCfg(**_MT_KW))
    jargs = ([[jnp.asarray(b1[0]), jnp.asarray(b2[0])]],
             [jnp.asarray(b1[1]), jnp.asarray(b2[1])], jnp.asarray(cls),
             [jnp.asarray(b1[2]), jnp.asarray(b2[2])])
    params = _init(jm, *jargs)
    tm = load_jax_params(TMT(TMTCfg(**_MT_KW)), params).eval()
    return jm, params, tm, jargs, (b1, b2, cls)


@torch.no_grad()
def test_multibucket_mask_transformer_matches_jax(mt_two_buckets):
    jm, params, tm, jargs, (b1, b2, cls) = mt_two_buckets
    want = _apply(jm, params, *jargs)
    got = tm([[_t(b1[0]), _t(b2[0])]], [_t(b1[1]), _t(b2[1])], _t(cls),
             [_t(b1[2]), _t(b2[2])])
    np.testing.assert_allclose(got["pred_logits"].numpy(),
                               np.asarray(want["pred_logits"]), atol=2e-3)
    assert isinstance(got["pred_masks"], list)
    assert [tuple(m.shape) for m in got["pred_masks"]] == \
        [(1, 2, 8, 16, 24), (1, 1, 8, 24, 24)]
    for g, w in zip(got["pred_masks"], want["pred_masks"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-2,
                                   rtol=1e-2)
    for ga, wa in zip(got["aux_outputs"], want["aux_outputs"]):
        for g, w in zip(ga["pred_masks"], wa["pred_masks"]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-2,
                                       rtol=1e-2)
    # the joint blocked mask: the fully-blocked-row rule after the buckets'
    # key axes are concatenated
    out0 = _t(np.asarray(params["params"]["query_feat"])[None])
    from panst3r_torch.ops.image import resize
    af = [resize(_t(m), (1, m.shape[1], gh, gw, 16), "bilinear")
          for m, (gh, gw) in ((b1[1], (2, 3)), (b2[1], (3, 3)))]
    _, _, tblk = tm.prediction_heads(out0, [_t(b1[1]), _t(b2[1])], _t(cls),
                                     attn_feats=af)
    _, _, jblk = _apply(jm, params, jnp.asarray(out0.numpy()),
                        [jnp.asarray(b1[1]), jnp.asarray(b2[1])],
                        jnp.asarray(cls), attn_grids=[(2, 3), (3, 3)],
                        method=JMT.prediction_heads)
    assert tuple(tblk.shape) == (1, 8, 2 * 6 + 9)
    np.testing.assert_array_equal(tblk.numpy(), np.asarray(jblk))


@torch.no_grad()
def test_singleton_list_equals_single_bucket(mt_two_buckets):
    _, _, tm, _, (b1, _, cls) = mt_two_buckets
    single = tm([_t(b1[0])], _t(b1[1]), _t(cls), _t(b1[2]))
    listed = tm([[_t(b1[0])]], [_t(b1[1])], _t(cls), [_t(b1[2])])
    assert torch.equal(single["pred_logits"], listed["pred_logits"])
    assert torch.equal(single["pred_masks"], listed["pred_masks"][0])


# ---------------------------------------------------------------- engine --

def _scene(rng):
    """The mixed (H, W) + (32, 32) scene of tests/test_multibucket_engine.py
    (float views), one view flagged portrait."""
    images = [(rng.standard_normal((h, w, 3)) * 0.2).astype(np.float32)
              for h, w in ((H, W), (H2, W2), (H, W), (H2, W2))]
    portrait = np.array([False, False, True, False])
    cls_emb = rng.standard_normal((NCLS, 24)).astype(np.float32)
    return images, portrait, cls_emb


@pytest.mark.parametrize("preset", ["tiny_config", "tiny_v2_config"])
def test_multibucket_engine_and_fusion_match_jax(preset):
    """MultiBucketEngine.run on both sides on the weights of one synthesized
    reference state_dict: the JAX model on the JAX tool's tree
    (port_checkpoint), the port's model through load_reference_state_dict.
    tiny_v2 takes LoftUp at the reference module's shape (two blocks, 20
    frequencies).
    Then panoptic_fusion_multi_ar on shared logits (the JAX engine's output
    fused by both packages).  One JAX run per preset."""
    tcfg_fn, jcfg_fn = REF_PRESETS[{"tiny_config": "v1",
                                    "tiny_v2_config": "v2"}[preset]]
    rng = np.random.default_rng(0)
    images, portrait, cls_emb = _scene(rng)
    sd = reference_state_dict(tcfg_fn())
    tree, _ = port_checkpoint(sd)
    jeng = JMulti(JPanSt3R(jcfg_fn()),
                  {"params": jax.tree_util.tree_map(jnp.asarray, tree)},
                  num_keyframes=3, chunk=2, amp=False)
    want = jeng.run(images, portrait, cls_emb)
    tmodel = TPanSt3R(tcfg_fn())
    assert load_reference_state_dict(tmodel, sd)["unmapped"] == []
    teng = TMulti(tmodel, num_keyframes=3, chunk=2, amp=False, device="cpu")
    got = teng.run(images, portrait, cls_emb)
    assert got["keyframes"] == want["keyframes"] == [0, 1, 3]
    assert got["true_shapes"] == want["true_shapes"]
    for g, w in zip(got["pointmaps_raw"], want["pointmaps_raw"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-4)
    np.testing.assert_allclose(got["pred_logits"], want["pred_logits"],
                               atol=2e-3)
    for g, w in zip(got["pred_masks"], want["pred_masks"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-2, rtol=1e-2)

    shapes = want["true_shapes"]
    jf = j_fusion_multi_ar(want["pred_logits"], want["pred_masks"],
                           shapes)[0]
    tf = t_fusion_multi_ar(_t(want["pred_logits"]),
                           [_t(np.array(m)) for m in want["pred_masks"]],
                           shapes)[0]
    assert tf["segments_info"] == jf["segments_info"]
    for g, w, (h, w_) in zip(tf["pan"], jf["pan"], shapes):
        assert g.shape == (h, w_)
        assert np.mean(g == w) >= 0.995
    for g, w in zip(tf["conf"], jf["conf"]):
        np.testing.assert_allclose(g, w, atol=1e-2)
    # the port's engine fuses its own run on its device
    assert [p.shape for p in teng.fuse(got)[0]["pan"]] == shapes


def test_single_bucket_multi_engine_matches_engine():
    """All views in one bucket: the multi-bucket engine equals the port's
    own InferenceEngine.run."""
    rng = np.random.default_rng(1)
    model = build_model(tpresets.tiny_config(), device="cpu", seed=0)
    images = rng.integers(0, 256, (4, H, W, 3), dtype=np.uint8)
    portrait = np.array([False, True, False, False])
    cls_emb = rng.standard_normal((NCLS, 24)).astype(np.float32)
    single = TEngine(model, tb.Bucket(H, W), num_keyframes=2, chunk=2,
                     amp=False, device="cpu")
    multi = TMulti(model, num_keyframes=2, chunk=2, amp=False, device="cpu")
    a = single.run(images, portrait, cls_emb)
    b = multi.run(list(images), portrait, cls_emb)
    assert a["keyframes"] == b["keyframes"]
    np.testing.assert_allclose(np.stack(b["pointmaps_raw"]),
                               a["pointmaps_raw"], atol=2e-4)
    np.testing.assert_allclose(b["pred_logits"], a["pred_logits"], atol=2e-3)
    np.testing.assert_allclose(np.stack(b["pred_masks"]), a["pred_masks"],
                               atol=1e-2, rtol=1e-2)
    fused = multi.fuse(multi.run_device(list(images), portrait, cls_emb))
    assert [p.shape for p in fused[0]["pan"]] == [(H, W)] * 4
