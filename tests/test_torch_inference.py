"""The whole slice: panst3r_torch InferenceEngine.run + fuse against the
panst3r_tpu InferenceEngine on the tiny preset (CPU, f32), same weights and
the same uint8 views; plus an amp smoke test of the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from panst3r_torch.core.bucketing import Bucket as TBucket
from panst3r_torch.engine.inference import InferenceEngine as TEngine
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.panst3r import build_model
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.core.bucketing import Bucket as JBucket
from panst3r_tpu.engine.inference import InferenceEngine as JEngine
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.presets import tiny_config as j_tiny
from tests.test_torch_models import random_params
from tests.torch_release import release_memory  # noqa: F401

H, W, V, K, NCLS = 32, 48, 5, 3, 5


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    portrait = np.zeros(V, bool)
    portrait[3] = True
    cls_emb = rng.standard_normal((NCLS, 24)).astype(np.float32)
    jmodel = JPanSt3R(j_tiny())
    params = random_params(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)),
        jnp.zeros((1, 2), bool), jnp.asarray(cls_emb), (H // 16, W // 16))))
    jeng = JEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                   JBucket(H, W), num_keyframes=K, chunk=2, amp=False)
    tmodel = load_jax_params(TPanSt3R(t_tiny()), params)
    teng = TEngine(tmodel, TBucket(H, W), num_keyframes=K, chunk=2,
                   amp=False, device="cpu")
    return jeng, teng, (images, portrait, cls_emb)


def test_run_matches_jax_engine(engines):
    jeng, teng, inputs = engines
    want = jeng.run(*inputs)
    got = teng.run(*inputs)
    assert got["keyframes"] == want["keyframes"] == [0, 2, 4]
    np.testing.assert_allclose(got["pointmaps_raw"], want["pointmaps_raw"],
                               atol=2e-4)
    for k in ("pts3d", "pts3d_local", "conf"):
        np.testing.assert_allclose(got["pointmaps"][k], want["pointmaps"][k],
                                   atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got["pred_logits"], want["pred_logits"],
                               atol=2e-3)
    np.testing.assert_allclose(got["pred_masks"], want["pred_masks"],
                               atol=1e-2, rtol=1e-2)


def test_fuse_matches_jax_engine(engines):
    jeng, teng, inputs = engines
    want = jeng.fuse(jeng.run_device(*inputs), (H, W))[0]
    got = teng.fuse(teng.run_device(*inputs), (H, W))[0]
    assert got["segments_info"] == want["segments_info"]
    # masks are fused in bf16 on both sides: allow 0.5% of pixels to flip
    # where a bf16 rounding step moves a pixel across a threshold
    agree = np.mean(got["pan"] == want["pan"])
    assert agree >= 0.995, agree
    np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-2)


def test_amp_smoke():
    rng = np.random.default_rng(1)
    model = build_model(t_tiny(), device="cpu", seed=0)
    eng = TEngine(model, TBucket(H, W), num_keyframes=2, chunk=2, amp=True,
                  device="cpu")
    images = rng.integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    out = eng.run(images, np.zeros(3, bool),
                  rng.standard_normal((NCLS, 24)).astype(np.float32))
    assert out["pointmaps"]["pts3d"].shape == (3, H, W, 3)
    assert out["pred_masks"].shape == (3, 16, H // 2, W // 2)
    assert out["pred_logits"].shape == (16, NCLS)
    for v in (out["pointmaps_raw"], out["pred_masks"], out["pred_logits"]):
        assert np.isfinite(v).all()
