"""The serving wire path of panst3r_torch against panst3r_tpu (CPU, f32):
packed YUV420 input, camera recovery, retrieval keyframes, the wire
packing on one shared pipeline output, and one whole ``serve_device`` of
the tiny preset against the JAX engine's (the only JAX whole-pipeline
compile here); then the port's own paths against each other
(``run_fused`` / ``run_device``, the latency paths, the stream, YUV input,
the v2 head)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch.core.bucketing import Bucket as TBucket
from panst3r_torch.engine import pose as tpose
from panst3r_torch.engine import retrieval as tret
from panst3r_torch.engine.inference import InferenceEngine as TEngine
from panst3r_torch.engine.inference import fetch_wire
from panst3r_torch.models.decoder import postprocess as t_post
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.panst3r import build_model
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_torch.models.presets import tiny_v2_config as t_tiny_v2
from panst3r_torch.ops import image as timg
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.core.bucketing import Bucket as JBucket
from panst3r_tpu.engine import pose as jpose
from panst3r_tpu.engine import retrieval as jret
from panst3r_tpu.engine.inference import InferenceEngine as JEngine
from panst3r_tpu.engine.inference import _image_cast as j_image_cast
from panst3r_tpu.models.decoder import postprocess as j_post
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.presets import tiny_config as j_tiny
from panst3r_tpu.ops import image as jimg
from tests.test_torch_models import random_params

H, W, V, K, NCLS = 32, 48, 5, 3, 6
FUSION_RES = ("full", "mask", "hybrid", "hybrid4")


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


def _scene(seed=0, ncls=NCLS, n=V):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    portrait = np.zeros(n, bool)
    portrait[1] = True
    cls_emb = rng.standard_normal((ncls, 24)).astype(np.float32)
    return images, portrait, cls_emb


def _port_engine(preset=t_tiny, amp=False):
    return TEngine(build_model(preset(), device="cpu", seed=0),
                   TBucket(H, W), num_keyframes=K, chunk=2, amp=amp,
                   device="cpu")


def _agree(a, b, conf_atol):
    for k in ("pan", "seg_ids", "labels", "selected"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["conf"], b["conf"], atol=conf_atol + 1e-6)


# ---------------------------------------------------------------- YUV ----

def test_yuv420_matches_jax():
    """Pack, unpack, decode and the packed branch of the input cast are
    bit-exact against the JAX functions (f32); under amp the packed input
    is its decoded uint8 RGB exactly."""
    images = _scene(1)[0]
    packed = timg.rgb_to_yuv420(images)
    np.testing.assert_array_equal(packed, jimg.rgb_to_yuv420(images))
    assert packed.shape == (V, H * 3 // 2, W)
    tp = torch.as_tensor(packed)
    np.testing.assert_array_equal(
        timg.yuv420_to_rgb(tp).numpy(),
        np.asarray(jimg.yuv420_to_rgb(jnp.asarray(packed))))
    decoded = timg.yuv420_decode(tp)
    np.testing.assert_array_equal(
        decoded.numpy(),
        np.asarray(jnp.rint(jimg.yuv420_to_rgb(jnp.asarray(packed)))
                   .astype(jnp.uint8)))
    np.testing.assert_array_equal(
        timg.image_cast(tp, amp=False).numpy(),
        np.asarray(j_image_cast(jnp.asarray(packed), False)))
    assert torch.equal(timg.image_cast(tp, amp=True),
                       timg.image_cast(decoded, amp=True))
    assert not timg.is_packed_yuv(images[0])    # one (H, W, 3) RGB image


# --------------------------------------------------------------- pose ----

def test_pose_matches_jax():
    """Weiszfeld focals, weighted Kabsch and the camera recovery within
    1e-4 relative of the JAX functions, batched over views."""
    rng = np.random.default_rng(2)
    raw = rng.standard_normal((3, 16, 24, 7)).astype(np.float32) * 0.3
    raw[..., 5] += 1.0                        # points in front of the camera
    raw[..., 2] += 1.0
    jp = {k: np.asarray(v) for k, v in j_post(jnp.asarray(raw)).items()}
    tp = t_post(torch.as_tensor(raw))
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-5,
                                   atol=1e-6)
    f_j, c2w_j = jpose.recover_cameras({k: jnp.asarray(v)
                                        for k, v in jp.items()}, (16, 24))
    f_t, c2w_t = tpose.recover_cameras(tp, (16, 24))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-4)
    np.testing.assert_allclose(c2w_t.numpy(), np.asarray(c2w_j), rtol=1e-4,
                               atol=1e-4)
    pp = np.array([12.0, 8.0], np.float32)
    for i in range(3):
        np.testing.assert_allclose(
            float(tpose.estimate_focal_weiszfeld(
                tp["pts3d_local"][i], torch.as_tensor(pp))),
            float(jpose.estimate_focal_weiszfeld(
                jnp.asarray(jp["pts3d_local"][i]), jnp.asarray(pp))),
            rtol=1e-4)
    src = rng.standard_normal((50, 3)).astype(np.float32)
    w = rng.random(50).astype(np.float32)
    R0 = np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
    R0 *= np.sign(np.linalg.det(R0))
    dst = src @ R0.T + np.float32([0.5, -1.0, 2.0])
    Rj, tj = jpose.rigid_points_registration(*map(jnp.asarray, (src, dst,
                                                                 w)))
    Rt, tt = tpose.rigid_points_registration(*map(torch.as_tensor,
                                                  (src, dst, w)))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), R0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    T = c2w_t[0]
    pts = torch.as_tensor(src)
    np.testing.assert_allclose(
        tpose.geotrf(T, pts).numpy(),
        np.asarray(jpose.geotrf(jnp.asarray(T.numpy()), jnp.asarray(src))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- retrieval ----

def test_retrieval_keyframes_match_jax():
    """Pooled-cosine similarity, FPS and the greedy ordering: the same
    keyframe lists as the JAX package on the host and on the device."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((4, 30, 16)).astype(np.float32)
    tokens = np.concatenate([base, base[:3] + 0.3 * rng.standard_normal(
        (3, 30, 16)).astype(np.float32)])                  # 7 views
    sim_t = tret.view_similarity(torch.as_tensor(tokens)).numpy()
    sim_j = np.asarray(jret.view_similarity(jnp.asarray(tokens)))
    np.testing.assert_allclose(sim_t, sim_j, atol=1e-6)
    for n in (1, 3, 5, 7):
        host = tret.select_keyframes_retrieval(torch.as_tensor(tokens), n)
        assert host == jret.select_keyframes_retrieval(jnp.asarray(tokens),
                                                       n)
        dev = tret.select_keyframes_retrieval_device(torch.as_tensor(tokens),
                                                     n)
        assert dev.tolist() == np.asarray(
            jret.select_keyframes_retrieval_device(jnp.asarray(tokens),
                                                   n)).tolist()
        assert sorted(dev.tolist()) == sorted(host)
    dist = 1.0 - sim_j
    for thresh in (None, 0.5):
        assert tret.farthest_point_sampling(dist, 5, dist_thresh=thresh) \
            == jret.farthest_point_sampling(dist, 5, dist_thresh=thresh)
    assert tret.select_keyframes_linspace(50, 16) == \
        jret.select_keyframes_linspace(50, 16)


# --------------------------------------------------------------- wire ----

def _pipeline_output(seed, ncls):
    """A run_fused-like output dict in numpy: logits, mask logits at half
    resolution, raw pointmaps, device keyframes."""
    rng = np.random.default_rng(seed)
    Q = 16
    raw = rng.standard_normal((V, H, W, 7)).astype(np.float32) * 0.3
    raw[..., 2] += 1.0
    raw[..., 5] += 1.0
    return {"pred_logits": rng.standard_normal((Q, ncls)).astype(np.float32),
            "pred_masks": (rng.standard_normal((V, Q, H // 2, W // 2)) * 3)
            .astype(np.float32),
            "pointmaps_raw": raw,
            "keyframes_dev": np.array([0, 4, 2], np.int32)}


@pytest.mark.parametrize("fusion_res,cameras,kf_mode,ncls", [
    ("full", False, "linspace", NCLS), ("mask", False, "linspace", NCLS),
    ("hybrid", True, "linspace", NCLS), ("hybrid4", False, "retrieval", NCLS),
    ("full", True, "retrieval", NCLS), ("hybrid", False, "linspace", 300)])
def test_pack_wire_matches_jax(engines, fusion_res, cameras, kf_mode, ncls):
    """JAX's ``_make_pack_wire`` and the port's ``_pack_wire`` on one shared
    output: the same wire dtype and length; pan, seg_ids, labels, selected
    and keyframes byte-equal, conf within one quantization step, camera
    floats within 1e-4; each package's ``unpack_wire`` reads both."""
    jeng, teng = engines
    out = _pipeline_output(ncls, ncls)
    cls_emb = np.zeros((ncls, 24), np.float32)
    pack = jeng._make_pack_wire(V, "sigmoid", 2, fusion_res, cameras,
                                kf_mode)
    wj = np.asarray(pack({k: jnp.asarray(v) for k, v in out.items()},
                         jnp.asarray(cls_emb)))
    with torch.inference_mode():
        wt = fetch_wire(teng._pack_wire(
            {k: torch.as_tensor(v).long() if k == "keyframes_dev"
             else torch.as_tensor(v) for k, v in out.items()},
            torch.as_tensor(cls_emb), V, "sigmoid", 2, fusion_res, cameras,
            kf_mode))
    assert wt.dtype == wj.dtype == (np.uint16 if ncls >= 255 else np.uint8)
    assert wt.shape == wj.shape
    kw = dict(with_cameras=cameras,
              with_keyframes=K if kf_mode == "retrieval" else 0)
    dt, dj = teng.unpack_wire(wt, V, **kw), teng.unpack_wire(wj, V, **kw)
    _agree(dt, dj, 1.0 / 255)
    ref = jeng.unpack_wire(wj, V, **kw)
    for k in dj:
        np.testing.assert_array_equal(dj[k], ref[k])
    if kf_mode == "retrieval":
        np.testing.assert_array_equal(dt["keyframes"], [0, 4, 2])
    if cameras:
        for k in ("focals", "cam2world"):
            np.testing.assert_allclose(dt[k], dj[k], rtol=1e-4, atol=1e-4)


def test_serve_device_matches_jax(engines):
    """One scene through the whole wire in both packages (tiny preset, f32,
    with cameras): pan, seg_ids, labels and selected equal, conf within
    1/255, cameras within 1e-3.  The one JAX whole-pipeline compile of
    this file."""
    jeng, teng = engines
    images, portrait, cls_emb = _scene()
    wj = np.asarray(jeng.serve_device(images, portrait, cls_emb,
                                      with_cameras=True))
    wt = fetch_wire(teng.serve_device(images, portrait, cls_emb,
                                      with_cameras=True))
    dj = jeng.unpack_wire(wj, V, with_cameras=True)
    dt = teng.unpack_wire(wt, V, with_cameras=True)
    _agree(dt, dj, 1.0 / 255)
    assert dj["selected"].any()
    for k in ("focals", "cam2world"):
        np.testing.assert_allclose(dt[k], dj[k], rtol=1e-3, atol=1e-3)


# ------------------------------------------------- port-internal paths ----

def test_run_fused_matches_run_device(engines):
    """The one-batch towers and the single render call give the staged
    path's outputs; the wire unpacks to ``fuse_device`` of ``run_fused``
    bit for bit (conf within its 8-bit quantization)."""
    teng = engines[1]
    images, portrait, cls_emb = _scene(4)
    fused = teng.run_fused(images, portrait, cls_emb)
    staged = teng.run_device(images, portrait, cls_emb)
    assert fused["keyframes"] == staged["keyframes"] == [0, 2, 4]
    for k, atol in (("pointmaps_raw", 1e-5), ("pred_logits", 1e-5),
                    ("pred_masks", 1e-4)):
        np.testing.assert_allclose(fused[k].numpy(), staged[k].numpy(),
                                   atol=atol, err_msg=k)
    pan, conf, seg, lab, sel = (t.numpy() for t in teng.fuse_device(
        fused, (H, W)))
    dec = teng.unpack_wire(teng.serve_device(images, portrait, cls_emb), V)
    _agree(dec, {"pan": pan[0], "conf": conf[0], "seg_ids": seg[0],
                 "labels": lab[0], "selected": sel[0]}, 1.0 / 255)
    for fr, s in (("hybrid", 2), ("hybrid4", 4)):
        d = teng.unpack_wire(teng.serve_device(images, portrait, cls_emb,
                                               fusion_res=fr), V)
        c = dec["conf"].reshape(V, H // s, s, W // s, s).mean((2, 4))
        _agree(d, dict(dec, conf=c.repeat(s, 1).repeat(s, 2)), 2.0 / 255)


LATENCY_KW = {"plain": {},
              "hybrid_cameras": {"fusion_res": "hybrid",
                                 "with_cameras": True}}


@pytest.mark.parametrize("kw,fn", [
    *((kw, fn) for kw in LATENCY_KW
      for fn in ("serve_latency_device", "serve_latency_overlap")),
    ("stream", None)])
def test_latency_paths_and_stream_match_serve_device(engines, kw, fn):
    """The chunked latency paths give ``serve_device``'s wire with every
    option (one case per option set and path): pan, seg_ids, labels and
    selected equal, conf within 1/255, cameras within 1e-4 (the towers run
    per upload chunk, and the CPU's matrix products round a 1-view batch's
    tokens ~1e-6 apart from a 5-view batch's); the overlap path with every
    view a keyframe gives the wire itself; the stream (its own case)
    yields the sequential wires in order, survives an early abandon and
    raises a failed scene at the consumer."""
    teng = engines[1]
    images, portrait, cls_emb = _scene(5)
    if kw != "stream":
        kw = LATENCY_KW[kw]
        cams = kw.get("with_cameras", False)
        want = teng.unpack_wire(teng.serve_device(images, portrait, cls_emb,
                                                  **kw), V, cams)
        for chunk in (1, 2, 4):
            got = teng.unpack_wire(getattr(teng, fn)(
                images, portrait, cls_emb, chunk=chunk, **kw), V, cams)
            _agree(got, want, 1.0 / 255)
            if cams:
                for k in ("focals", "cam2world"):
                    np.testing.assert_allclose(got[k], want[k],
                                               rtol=1e-4, atol=1e-4)
        if fn == "serve_latency_overlap" and not kw:
            w_all = fetch_wire(teng.serve_latency_overlap(
                images, portrait, cls_emb, num_keyframes=V))
            np.testing.assert_array_equal(w_all, fetch_wire(
                teng.serve_device(images, portrait, cls_emb,
                                  num_keyframes=V)))
        return

    scenes = [np.roll(images, s + 1, axis=0).copy() for s in range(4)]
    seq = [teng.unpack_wire(teng.serve_device(s, portrait, cls_emb,
                                              fusion_res="hybrid"), V)
           for s in scenes]
    stream = list(teng.serve_stream(scenes, portrait, cls_emb,
                                    queue_depth=2, fusion_res="hybrid"))
    assert len(stream) == 4
    for a, b in zip(stream, seq):
        _agree(a, b, 0.0)
    raw = list(teng.serve_stream(scenes[:2], portrait, cls_emb,
                                 unpack=False))
    assert all(isinstance(w, np.ndarray) for w in raw)
    gen = teng.serve_stream(scenes, portrait, cls_emb, fusion_res="hybrid")
    first = next(gen)
    gen.close()
    _agree(first, seq[0], 0.0)
    bad = scenes[:1] + [images[:, :16]]          # the wrong bucket shape
    with pytest.raises(Exception):
        list(teng.serve_stream(bad, portrait, cls_emb, queue_depth=1))


@pytest.mark.parametrize("amp", [False, True])
def test_yuv_wire_equals_decoded_rgb_wire(amp):
    """serve(pack(x)) equals serve(decode(pack(x))) byte for byte on every
    path, in f32 and under amp."""
    eng = _port_engine(amp=amp)
    images, portrait, cls_emb = _scene(6)
    packed = timg.rgb_to_yuv420(images)
    decoded = timg.yuv420_decode(torch.as_tensor(packed)).numpy()
    want = fetch_wire(eng.serve_device(decoded, portrait, cls_emb))
    for fn in (eng.serve_device, eng.serve_latency_device,
               eng.serve_latency_overlap):
        np.testing.assert_array_equal(
            fetch_wire(fn(packed, portrait, cls_emb)), want)


def test_v2_serve_wire_matches_run_device():
    """The v2 head (InputMixer + LoftUp) through the wire: equal to its own
    staged ``run_device`` + ``fuse_device``, ids only of selected
    segments."""
    eng = _port_engine(t_tiny_v2)
    images, portrait, cls_emb = _scene(7)
    dec = eng.unpack_wire(eng.serve_device(images, portrait, cls_emb), V)
    pan, conf, seg, lab, sel = (t.numpy() for t in eng.fuse_device(
        eng.run_device(images, portrait, cls_emb), (H, W)))
    _agree(dec, {"pan": pan[0], "conf": conf[0], "seg_ids": seg[0],
                 "labels": lab[0], "selected": sel[0]}, 1.0 / 255)
    live = set(dec["seg_ids"][dec["selected"]].tolist()) | {0}
    assert set(np.unique(dec["pan"]).tolist()) <= live


def test_retrieval_wire_matches_staged_retrieval(engines):
    """``keyframe_mode="retrieval"`` picks the keyframes on the device, as
    ``run_device(use_retrieval=True)`` does on the host, and ships them."""
    teng = engines[1]
    images, portrait, cls_emb = _scene(8)
    dec = teng.unpack_wire(teng.serve_device(
        images, portrait, cls_emb, keyframe_mode="retrieval"), V,
        with_keyframes=K)
    out = teng.run_device(images, portrait, cls_emb, use_retrieval=True)
    assert dec["keyframes"].tolist() == out["keyframes"]
    pan = teng.fuse_device(out, (H, W))[0].numpy()[0]
    np.testing.assert_array_equal(dec["pan"], pan)


def test_later_slices_raise(engines):
    """An unknown ``fusion_res`` raises; the daemon's ``/slam/*`` paths
    (engine/slam.py) serve: ``/slam/start`` answers ok, and a
    ``/slam/finish`` before two frames answers 400 with the reason."""
    import threading
    import urllib.error
    import urllib.request

    from panst3r_torch.apps.serve import SceneServer, make_server

    teng = engines[1]
    images, portrait, cls_emb = _scene()
    with pytest.raises(ValueError, match="fusion_res"):
        teng.serve_device(images, portrait, cls_emb, fusion_res="half")
    srv = make_server(SceneServer(teng, cls_emb), "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(urllib.request.Request(
                f"{url}/slam/start", data=b"", method="POST")) as r:
            assert r.read() == b"ok"
        req = urllib.request.Request(f"{url}/slam/finish", data=b"",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 400
        assert b">= 2 frames" in e.value.read()
    finally:
        srv.shutdown()
        srv.server_close()
