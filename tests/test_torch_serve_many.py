"""The rest of serving in panst3r_torch against panst3r_tpu (CPU, f32) on
the tiny preset: memory refinement (``build_memory(refine_iterations)``,
the decoder's feedback MLP) against the JAX engine's;
``serve_many_device`` against the port's own ``serve_device`` per scene
(RGB and packed YUV420 scenes, as tests/test_serve.py holds the JAX
package) and against the JAX engine's ``serve_many_device`` (the one JAX
whole-pipeline compile here); the daemon end to end on the CPU engine, as
tests/test_apps.py drives the JAX one, with ``/slam/*`` refused."""
import io
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch.apps.serve import SceneServer, make_server
from panst3r_torch.core.bucketing import Bucket as TBucket
from panst3r_torch.engine.inference import InferenceEngine as TEngine
from panst3r_torch.engine.inference import fetch_wire
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_torch.ops.image import rgb_to_yuv420
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.core.bucketing import Bucket as JBucket
from panst3r_tpu.engine.inference import InferenceEngine as JEngine
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.presets import tiny_config as j_tiny
from tests.test_torch_models import random_params
from tests.test_torch_serve import _agree
from tests.torch_release import release_memory  # noqa: F401

H, W, V, K, NCLS, S = 32, 48, 5, 3, 6, 2


@pytest.fixture(scope="module")
def engines():
    """The tiny preset in both packages with the same random weights."""
    jmodel = JPanSt3R(j_tiny())
    params = random_params(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)),
        jnp.zeros((1, 2), bool), jnp.zeros((NCLS, 24)), (H // 16, W // 16))))
    jeng = JEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                   JBucket(H, W), num_keyframes=K, chunk=2, amp=False)
    teng = TEngine(load_jax_params(TPanSt3R(t_tiny()), params),
                   TBucket(H, W), num_keyframes=K, chunk=2, amp=False,
                   device="cpu")
    return jeng, teng


def _scenes(seed=0):
    """S scenes of V views: a scene and its views reversed (as
    tests/test_serve.py builds them), portrait flags per scene."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    scenes = np.stack([images, images[::-1].copy()])
    portrait = np.zeros((S, V), bool)
    portrait[0, 1] = portrait[1, 3] = True
    cls_emb = rng.standard_normal((NCLS, 24)).astype(np.float32)
    return scenes, portrait, cls_emb


@torch.no_grad()
def test_build_memory_refinement_matches_jax(engines):
    """One refinement pass over K=3 keyframes with chunk 2 (the keyframes
    rendered in a call of two and one of one): the memory's banks, slot
    validity and positions, then every view rendered against it, within
    the tolerances of tests/test_torch_inference.py; 0 passes leave the
    memory as it was, and a pass changes it."""
    jeng, teng = engines
    images = np.random.default_rng(0).integers(0, 256, (K, H, W, 3),
                                               dtype=np.uint8)
    x, pos = teng.encode_batch(torch.as_tensor(images))
    jx, jpos = jnp.asarray(x.numpy()), jnp.asarray(pos.numpy())

    base = teng.build_memory(x, pos)
    assert torch.equal(teng.build_memory(x, pos, refine_iterations=0).y,
                       base.y)

    def jax_refined(x, pos):            # one compile: the build, the render
        mem = jeng.build_memory(x, pos, refine_iterations=1)
        return mem, jeng._render_chunked(x, pos, mem)

    jmem, (jpm, jf) = jax.jit(jax_refined)(jx, jpos)
    tmem = teng.build_memory(x, pos, refine_iterations=1)
    assert tmem.count == K * teng.n_tokens
    np.testing.assert_allclose(tmem.y.numpy(), np.asarray(jmem.y),
                               atol=2e-4)
    np.testing.assert_array_equal(tmem.valid.numpy(), np.asarray(jmem.valid))
    np.testing.assert_array_equal(tmem.pos.numpy(), np.asarray(jmem.pos))
    assert (tmem.y - base.y).abs().max() > 1e-3

    tpm, tf = teng.render_batch(x, pos, tmem)
    np.testing.assert_allclose(tpm.numpy(), np.asarray(jpm), atol=2e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-4)

    # a batch of two scenes refines each as it would alone
    two = teng.build_memory(torch.stack([x, x.flip(0)]),
                            torch.stack([pos, pos.flip(0)]),
                            refine_iterations=1)
    np.testing.assert_allclose(two.y[:, :1].numpy(), tmem.y.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_serve_many_matches_serve_device(engines, packed):
    """Each scene's wire of the batched program is byte-equal to its own
    ``serve_device`` wire, from RGB and from packed YUV420 scenes."""
    teng = engines[1]
    scenes, portrait, cls_emb = _scenes()
    if packed:
        scenes = np.stack([rgb_to_yuv420(s) for s in scenes])
    wires = fetch_wire(teng.serve_many_device(scenes, portrait, cls_emb))
    assert wires.shape[0] == S
    for s in range(S):
        single = fetch_wire(teng.serve_device(scenes[s], portrait[s],
                                              cls_emb))
        np.testing.assert_array_equal(wires[s], single)
    assert teng.unpack_wire(wires[0], V)["selected"].any()


def test_serve_many_matches_jax(engines):
    """The port's and the JAX engine's ``serve_many_device`` on the same
    scenes (hybrid wire with cameras): pan, seg_ids, labels and selected
    equal, conf within 1/255, cameras within 1e-3."""
    jeng, teng = engines
    scenes, portrait, cls_emb = _scenes(1)
    kw = dict(fusion_res="hybrid", with_cameras=True)
    wj = np.asarray(jeng.serve_many_device(scenes, portrait, cls_emb, **kw))
    wt = fetch_wire(teng.serve_many_device(scenes, portrait, cls_emb, **kw))
    assert wt.shape == wj.shape and wt.dtype == wj.dtype
    for s in range(S):
        dj = jeng.unpack_wire(wj[s], V, with_cameras=True)
        dt = teng.unpack_wire(wt[s], V, with_cameras=True)
        _agree(dt, dj, 1.0 / 255)
        for k in ("focals", "cam2world"):
            np.testing.assert_allclose(dt[k], dj[k], rtol=1e-3, atol=1e-3)


def _post(port, path, body=b""):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req) as r:
        return r.read()


def test_serving_daemon_end_to_end(engines):
    """POST a scene to the daemon on the CPU engine: the answer equals
    ``unpack_wire(serve_device(...))``; a malformed body, a ``/slam/frame``
    before ``/slam/start``, a ``/slam/finish`` after one frame and one
    without a session get a 400 that names the reason; ``/slam/start``
    and a ``/slam/frame`` answer; the server stays up."""
    teng = engines[1]
    scenes, portrait, cls_emb = _scenes(2)
    images = scenes[0]
    srv = make_server(SceneServer(teng, cls_emb), "127.0.0.1", 0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert r.read() == b"ok"
        buf = io.BytesIO()
        np.savez(buf, images=images, portrait=portrait[0])
        out = np.load(io.BytesIO(_post(port, "/reconstruct?cameras=1",
                                       buf.getvalue())))
        ref = teng.unpack_wire(teng.serve_device(
            images, portrait[0], cls_emb, with_cameras=True), V,
            with_cameras=True)
        assert out["pan"].shape == (V, H, W)
        np.testing.assert_array_equal(out["pan"], ref["pan"])
        np.testing.assert_allclose(out["cam2world"], ref["cam2world"])

        buf = io.BytesIO()
        np.savez(buf, images=images)
        out = np.load(io.BytesIO(_post(
            port, "/reconstruct?keyframes=retrieval&fusion=mask",
            buf.getvalue())))
        ref = teng.unpack_wire(teng.serve_device(
            images, np.zeros(V, bool), cls_emb, keyframe_mode="retrieval",
            fusion_res="mask"), V, with_keyframes=K)
        np.testing.assert_array_equal(out["keyframes"], ref["keyframes"])
        np.testing.assert_array_equal(out["pan"], ref["pan"])

        buf = io.BytesIO()
        np.savez(buf, image=images[0])
        frame = buf.getvalue()
        for path, body, reason in (
                ("/reconstruct", b"junk", b"error"),
                ("/slam/frame", frame, b"POST /slam/start first"),
                ("/slam/finish", b"", b"no SLAM session")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, path, body)
            assert e.value.code == 400
            assert reason in e.value.read()
        assert _post(port, "/slam/start") == b"ok"
        out = np.load(io.BytesIO(_post(port, "/slam/frame", frame)))
        assert bool(out["is_keyframe"]) and "pts3d" not in out
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/slam/finish")
        assert e.value.code == 400 and b">= 2 frames" in e.value.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert r.read() == b"ok"
    finally:
        srv.shutdown()
        srv.server_close()
