"""SLAM and bundle adjustment: panst3r_torch's memory edits, SE(3)
helpers, pose-graph Gauss-Newton, bundle adjustment, incremental frontend,
``run_slam`` and the daemon's ``/slam/*`` paths against panst3r_tpu on the
same numpy inputs (CPU, f32, the tiny preset)."""
import functools
import io
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import panst3r_torch.engine.ba as tba
import panst3r_torch.engine.slam as tslam
import panst3r_torch.models.memory as tmem
import panst3r_tpu.engine.ba as jba
import panst3r_tpu.engine.slam as jslam
import panst3r_tpu.models.memory as jmem
from panst3r_torch.apps.serve import SceneServer, make_server
from panst3r_torch.apps.slam import run_slam as t_run_slam
from panst3r_torch.core.bucketing import Bucket as TBucket
from panst3r_torch.engine.inference import InferenceEngine as TEngine
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.apps.slam import run_slam as j_run_slam
from panst3r_tpu.core.bucketing import Bucket as JBucket
from panst3r_tpu.engine.inference import InferenceEngine as JEngine
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.presets import tiny_config as j_tiny
from tests.test_torch_models import random_params
from tests.torch_release import release_memory  # noqa: F401

H, W = 32, 48

CPU = "cpu"


def _t(x):
    return torch.as_tensor(np.array(x))


# ------------------------------------------------------------- memory ----

def _mem_equal(tm, jm):
    np.testing.assert_array_equal(tm.y.numpy(), np.asarray(jm.y))
    np.testing.assert_array_equal(tm.pos.numpy(), np.asarray(jm.pos))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    assert tm.count == int(jm.count)


def test_memory_edits_match_jax():
    """insert, begin_overwrite (evict + cursor), insert into the freed
    window, end_overwrite, evict of an interior window, insert_at: y, pos,
    valid and count equal JAX's after every edit."""
    rng = np.random.default_rng(0)
    tm = tmem.init_memory(2, 1, 8, 4)
    jm = jmem.init_memory(2, 1, 8, 4)
    ys = [rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
          for _ in range(5)]
    ps = [np.full((1, 2, 2), i + 1, np.int32) for i in range(5)]
    steps = [
        ("insert", 0), ("insert", 1), ("insert", 2),
        ("begin", (2, 2)), ("insert", 3), ("end", 6),
        ("evict", (0, 2)), ("insert_at", (4, 0)),
        ("begin", (4, 2)), ("end", 6),
    ]
    for op, arg in steps:
        if op == "insert":
            tmem.insert(tm, _t(ys[arg]), _t(ps[arg]))
            jm = jmem.insert(jm, jnp.asarray(ys[arg]), jnp.asarray(ps[arg]))
        elif op == "begin":
            tmem.begin_overwrite(tm, *arg)
            jm = jmem.begin_overwrite(jm, *arg)
        elif op == "end":
            tmem.end_overwrite(tm, arg)
            jm = jmem.end_overwrite(jm, arg)
        elif op == "evict":
            tmem.evict(tm, *arg)
            jm = jmem.evict(jm, *arg)
        else:
            i, start = arg
            tmem.insert_at(tm, _t(ys[i]), _t(ps[i]), start)
            jm = jmem.insert_at(jm, jnp.asarray(ys[i]), jnp.asarray(ps[i]),
                                start)
        _mem_equal(tm, jm)
    # a dead window inside the live range after the last begin/end
    assert not tm.valid[0, 4:6].any() and tm.valid[0, :4].all()
    with pytest.raises(ValueError):
        tmem.evict(tm, 7, 2)


# ------------------------------------------------------------- SE(3) ----

def _xis(rng, n=7, scale=0.8):
    xi = rng.standard_normal((n, 6)) * scale
    xi[0, 3:] = 0.0                    # zero rotation
    xi[1, 3:] *= 1e-8                  # below the small-angle switch
    return xi.astype(np.float32)


@pytest.mark.parametrize("name", ["hat", "se3_exp", "so3_log", "se3_log",
                                  "se3_inv", "se3_adjoint", "se3_ad",
                                  "jl_inv"])
def test_se3_helpers_match_jax(name):
    rng = np.random.default_rng(1)
    xi = _xis(rng)
    T = tslam.se3_exp(_t(xi)).numpy()
    arg = {"hat": xi[:, :3], "se3_exp": xi, "so3_log": T[:, :3, :3],
           "se3_log": T, "se3_inv": T, "se3_adjoint": T, "se3_ad": xi,
           "jl_inv": xi}[name]
    want = np.asarray(jax.jit(getattr(jslam, name))(jnp.asarray(arg)))
    got = getattr(tslam, name)(_t(arg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------------ pose-graph GN ----

def _graph(kind):
    """The graphs of tests/test_slam.py: the noisy loop (V=8, 15 iters) and
    the rotation-coupled one (V=6, 12 iters)."""
    rng = np.random.default_rng(0)
    V, step, noise, iters = {"loop": (8, (0.2, 0.5), (0.05, 0.1), 15),
                             "coupled": (6, (0.4, 1.0), (0.15, 0.3),
                                         12)}[kind]
    gt = [np.eye(4)]
    for _ in range(1, V):
        gt.append(gt[-1] @ _se3(rng, 1, *step)[0])
    gt = np.stack(gt)
    edges = np.asarray([(i, i + 1) for i in range(V - 1)]
                       + [(0, i) for i in range(2, V)], np.int32)
    rel = np.stack([np.linalg.inv(gt[j]) @ gt[i] for i, j in edges])
    noisy = np.stack([g @ _se3(rng, 1, *noise)[0] for g in gt])
    noisy[0] = gt[0]
    w = rng.uniform(0.5, 2.0, len(edges)).astype(np.float32)
    return (noisy.astype(np.float32), edges, rel.astype(np.float32), w,
            iters, gt)


@pytest.mark.parametrize("kind", ["loop", "coupled"])
def test_pose_graph_gauss_newton_matches_jax(kind):
    noisy, edges, rel, w, iters, gt = _graph(kind)
    want, wcost = jslam.pose_graph_gauss_newton(
        jnp.asarray(noisy), jnp.asarray(edges), jnp.asarray(rel),
        jnp.asarray(w), iters=iters)
    got, cost = tslam.pose_graph_gauss_newton(noisy, edges, rel, w,
                                              iters=iters, device=CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(cost.numpy(), np.asarray(wcost), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), gt, atol=1e-3)


def _se3(rng, n, rot, trans):
    """n random poses, exp of (trans·N(0,1), rot·N(0,1))."""
    xi = np.concatenate([rng.standard_normal((n, 3)) * trans,
                         rng.standard_normal((n, 3)) * rot], -1)
    return tslam.se3_exp(_t(xi)).numpy()


def _pointmaps(V=5, h=H, w=W, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    pts_local = rng.standard_normal((V, h, w, 3)).astype(np.float32)
    gt = np.concatenate([np.eye(4)[None], _se3(rng, V - 1, 0.2, 0.5)])
    pts_global = np.einsum("vab,vhwb->vhwa", gt[:, :3, :3], pts_local) \
        + gt[:, None, None, :3, 3]
    pts_local = pts_local + noise * rng.standard_normal(pts_local.shape)
    conf = rng.uniform(1.5, 3.0, (V, h, w))
    return {"pts3d_local": pts_local.astype(np.float32),
            "pts3d": pts_global.astype(np.float32),
            "conf": conf.astype(np.float32)}


def test_refine_scene_poses_matches_jax():
    """Five views at the frontend's 32x48, 10 iterations (``run_slam``'s
    call)."""
    pm = _pointmaps(noise=0.03)
    want = jslam.refine_scene_poses(pm)
    got = tslam.refine_scene_poses(pm, device=CPU)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-4,
                                   rtol=1e-4)


def test_backend_needs_a_device():
    """Without a card the backend raises unless it is asked for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    noisy, edges, rel, w, _, _ = _graph("loop")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tslam.pose_graph_gauss_newton(noisy, edges, rel, w, iters=1)


# ---------------------------------------------------------------- BA ----

def _synthetic(rng, K=5, A=64, obs_per_view=48, pose_noise=0.08):
    """tests/test_ba.py's synthetic problem: anchors seen from K poses,
    exact local observations, noisy poses (pose 0 exact) and anchors."""
    X = rng.standard_normal((A, 3)).astype(np.float32) * 2.0
    poses_gt = _se3(rng, K, 0.3, 0.3)
    obs_view = np.repeat(np.arange(K, dtype=np.int32), obs_per_view)
    obs_anchor = rng.integers(0, A, K * obs_per_view).astype(np.int32)
    Tin = tslam.se3_inv(_t(poses_gt)).numpy()
    x_local = (np.einsum("oij,oj->oi", Tin[obs_view, :3, :3],
                         X[obs_anchor])
               + Tin[obs_view, :3, 3]).astype(np.float32)
    noise = rng.standard_normal((K, 6)).astype(np.float32) * pose_noise
    noise[0] = 0.0
    poses0 = (tslam.se3_exp(_t(noise)).numpy() @ poses_gt).astype(
        np.float32)
    anchors0 = X + rng.standard_normal(X.shape).astype(np.float32) * 0.02
    return (poses0, anchors0, obs_view, obs_anchor, x_local,
            np.ones(len(obs_view), np.float32))


@pytest.mark.parametrize("pad", [0, 13])
def test_bundle_adjust_matches_jax(pad):
    """tests/test_ba.py's synthetic problem (K=5, A=64), and the same with
    zero-weight padding observations."""
    rng = np.random.default_rng(0)
    poses0, anchors0, ov, oa, xl, w = _synthetic(rng)
    if pad:
        ov = np.concatenate([ov, np.zeros(pad, np.int32)])
        oa = np.concatenate([oa, np.zeros(pad, np.int32)])
        xl = np.concatenate([xl, np.ones((pad, 3), np.float32) * 7])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    iters = 4 if pad else 10
    want = jba.bundle_adjust(*(jnp.asarray(a) for a in (
        poses0, anchors0, ov, oa, xl, w)), iters=iters)
    got = tba.bundle_adjust(poses0, anchors0, ov, oa, xl, w, iters=iters,
                            device=CPU)
    for g, w_ in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-3, atol=1e-6 * float(want[2][0]))


def _merge_scene():
    """tests/test_ba.py's voxel-merge scene: three views of one quantized
    surface, consistent global maps, noisy poses."""
    rng = np.random.default_rng(0)
    K, h, w = 3, 16, 24
    X = (rng.integers(0, 20, (h * w, 3)) * 0.25 + 0.1).astype(np.float32)
    poses_gt = _se3(rng, K, 0.2, 0.2)
    Tin = tslam.se3_inv(_t(poses_gt)).numpy()
    pts_local = np.einsum("kij,nj->kni", Tin[:, :3, :3], X) \
        + Tin[:, None, :3, 3]
    noise = rng.standard_normal((K, 6)).astype(np.float32) * 0.05
    noise[0] = 0.0
    poses0 = tslam.se3_exp(_t(noise)).numpy() @ poses_gt
    pts_global = np.einsum("kij,knj->kni", poses_gt[:, :3, :3], pts_local) \
        + poses_gt[:, None, :3, 3]
    conf = rng.uniform(1.0, 3.0, (K, h, w)).astype(np.float32)
    pm = {"pts3d": pts_global.reshape(K, h, w, 3).astype(np.float32),
          "pts3d_local": pts_local.reshape(K, h, w, 3).astype(np.float32),
          "conf": conf}
    return pm, poses0.astype(np.float32)


@pytest.mark.parametrize("max_anchors", [None, 40])
def test_voxel_anchors_equal_jax(max_anchors):
    pm, _ = _merge_scene()
    K = pm["conf"].shape[0]
    conf = np.where(pm["conf"] >= 1.5, pm["conf"], 0.0).reshape(K, -1)
    args = (pm["pts3d"].reshape(K, -1, 3), conf, 0.25, max_anchors)
    for g, w_ in zip(tba.voxel_anchors(*args), jba.voxel_anchors(*args)):
        np.testing.assert_array_equal(g, w_)


def test_refine_scene_ba_matches_jax():
    pm, poses0 = _merge_scene()
    kw = dict(stride=1, voxel=0.25, iters=8, max_anchors=256)
    want = jba.refine_scene_ba(pm, poses0, **kw)
    got = tba.refine_scene_ba(pm, poses0, device=CPU, **kw)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3,
                               atol=1e-6 * float(want[1][0]))


# ----------------------------------------------------------- frontend ----

@pytest.fixture(scope="module")
def engines():
    """One JAX engine (chunk 1, f32) and the port's on the same weights."""
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((6, H, W, 3)) * 0.2).astype(np.float32)
    jmodel = JPanSt3R(j_tiny())
    params = random_params(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)),
        jnp.zeros((1, 2), bool), jnp.zeros((4, 24)), (H // 16, W // 16))))
    jeng = JEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                   JBucket(H, W), num_keyframes=4, chunk=1, amp=False)
    teng = TEngine(load_jax_params(TPanSt3R(t_tiny()), params),
                   TBucket(H, W), num_keyframes=4, chunk=1, amp=False,
                   device=CPU)
    return jeng, teng, images


@pytest.fixture(scope="module")
def jax_session(engines):
    """JAX's frontend over 6 always-novel frames with at most 4 keyframes
    (frames 4 and 5 evict): per frame the output, the keyframe ids and
    slots."""
    jeng, _, images = engines
    fe = jslam.IncrementalFrontend(jeng, sim_threshold=1.1, max_interval=2,
                                   max_keyframes=4)
    outs = []
    for i in range(6):
        o = fe.process(images[i], i)
        outs.append((o, list(fe.state.keyframe_ids), list(fe.state.slots)))
    return outs


def _frontend(teng, **kw):
    return tslam.IncrementalFrontend(
        teng, **{"sim_threshold": 1.1, "max_interval": 2,
                 "max_keyframes": 4, **kw})


def test_frontend_matches_jax(engines, jax_session):
    _, teng, images = engines
    fe = _frontend(teng)
    for i, (want, kf, slots) in enumerate(jax_session):
        got = fe.process(images[i], i)
        assert got["is_keyframe"] == want["is_keyframe"]
        assert fe.state.keyframe_ids == kf and fe.state.slots == slots
        if want["pointmaps_raw"] is None:
            assert got["pointmaps_raw"] is None
        else:
            np.testing.assert_allclose(got["pointmaps_raw"],
                                       want["pointmaps_raw"], atol=1e-4)
    # eviction happened: frames 0 and 1 are protected, slots a permutation
    assert fe.state.keyframe_ids == [0, 1, 4, 5]
    assert sorted(fe.state.slots) == [0, 1, 2, 3]
    assert fe.state.mem.count == 4 * teng.n_tokens
    assert bool(fe.state.mem.valid.all())


@pytest.mark.parametrize("settings", [
    dict(), dict(sim_threshold=-1.0, max_interval=3, max_keyframes=3)])
def test_stream_equals_process(engines, settings):
    """The pipelined ``stream`` gives ``process``'s keyframes, slots and
    pointmaps frame by frame (the second setting evicts on the interval
    alone over 12 rolled frames)."""
    _, teng, images = engines
    frames = [images[i] for i in range(6)] if not settings else \
        [np.roll(images[0], 3 * i, axis=1) for i in range(12)]
    sync = _frontend(teng, **settings)
    want = [sync.process(f, i) for i, f in enumerate(frames)]
    strm = _frontend(teng, **settings)
    got = list(strm.stream(frames))
    assert [o["frame_id"] for o in got] == list(range(len(frames)))
    for g, w_ in zip(got, want):
        assert g["is_keyframe"] == w_["is_keyframe"]
        if w_["pointmaps_raw"] is None:
            assert g["pointmaps_raw"] is None
        else:
            np.testing.assert_array_equal(g["pointmaps_raw"],
                                          w_["pointmaps_raw"])
    assert strm.state.keyframe_ids == sync.state.keyframe_ids
    assert strm.state.slots == sync.state.slots
    if settings:
        assert sum(o["is_keyframe"] for o in want) > 3   # evicted


def test_run_slam_matches_jax(engines, monkeypatch):
    """Five always-novel frames; both apps' frontends hold 4 keyframes (the
    fixture's memory size, so frame 4 evicts and the JAX programs are the
    fixture's)."""
    jeng, teng, images = engines
    for mod in (jslam, tslam):
        monkeypatch.setattr(mod, "IncrementalFrontend", functools.partial(
            mod.IncrementalFrontend, max_keyframes=4))
    kw = dict(sim_threshold=1.1, max_interval=5)
    want = j_run_slam(jeng, images[:5], **kw)
    got = t_run_slam(teng, images[:5], **kw)
    assert got["keyframes"] == want["keyframes"]
    for k in ("poses_init", "poses"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4)
    np.testing.assert_allclose(got["pointmaps"]["pts3d"],
                               want["pointmaps"]["pts3d"], atol=1e-4)


# ------------------------------------------------------------- daemon ----

def _post(port, path, **arrays):
    buf = io.BytesIO()
    if arrays:
        np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req) as r:
        body = r.read()
    return np.load(io.BytesIO(body)) if body[:2] == b"PK" else body


def test_daemon_slam_session(engines):
    """``/slam/start``, five ``/slam/frame`` and ``/slam/finish`` over
    HTTP: keyframes promote, every frame after the first returns
    pointmaps, the finish gives poses for all five frames (frame 0
    rendered against the final memory) equal to ``run_slam``'s; a frame
    before a session and a finish after one frame answer 400 with the
    reason."""
    _, teng, images = engines
    srv = make_server(SceneServer(teng, np.zeros((4, 24), np.float32)),
                      "127.0.0.1", 0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/slam/frame", image=images[0])
        assert e.value.code == 400 and b"/slam/start" in e.value.read()

        assert _post(port, "/slam/start?max_interval=2") == b"ok"
        n_kf = 0
        for i in range(5):
            out = _post(port, "/slam/frame", image=images[i])
            n_kf += int(out["is_keyframe"])
            assert ("pts3d" in out) == (i > 0)
            if i > 0:
                assert out["pts3d"].shape == (H, W, 3)
                assert out["pts3d"].dtype == np.float16
        assert n_kf >= 2
        fin = _post(port, "/slam/finish")
        assert fin["poses"].shape == (5, 4, 4)
        assert fin["frame_ids"].tolist() == [0, 1, 2, 3, 4]
        assert fin["keyframe_ids"][0] == 0
        want = t_run_slam(teng, images[:5], sim_threshold=0.9,
                          max_interval=2)
        np.testing.assert_allclose(fin["poses"], want["poses"], atol=1e-5)
        assert fin["keyframe_ids"].tolist() == want["keyframes"]

        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/slam/finish")            # no session any more
        assert e.value.code == 400
        assert _post(port, "/slam/start") == b"ok"
        _post(port, "/slam/frame", image=images[0])
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/slam/finish")
        assert e.value.code == 400 and b">= 2 frames" in e.value.read()
    finally:
        srv.shutdown()
        srv.server_close()
