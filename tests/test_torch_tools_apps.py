"""The port's viewer, gradio app, progress routing, host rasterizer and
ScanNet++ preprocessing against the JAX package's (all host code: no
card, no kernel).

- ``apps/viewer.py`` serves a scene written by the port's
  ``apps/demo.py::export_scene`` (as tests/test_cli.py serves the JAX
  one);
- ``apps/gradio_app.py::main`` refuses without gradio, as the JAX app
  does;
- ``native.rasterize_mesh`` and ``native._rasterize_numpy`` bit-equal to
  the JAX functions on tests/test_native.py's meshes;
- ``tools/preprocess_scannetpp.py`` against the JAX script on
  tests/test_preprocess.py's synthesized scene: every written file equal
  (images and PNGs byte for byte, npz arrays element for element), then
  read by ``panst3r_torch/data/scannetpp.py``;
- ``core/progress.py`` against JAX's.
"""
import json
import os
import os.path as osp
import sys
import threading
import urllib.request

import numpy as np
import pytest

from panst3r_torch import native as t_native
from panst3r_tpu import native as j_native
from tests.test_native import K, _square_mesh
from tests.test_preprocess import _make_raw_scene
from tests.torch_release import release_memory  # noqa: F401

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", "tools"))

import preprocess_scannetpp as j_pp  # noqa: E402


def _scene(V=2, H=8, W=12):
    """A small scene in ``reconstruct_scene``'s output format."""
    rng = np.random.default_rng(0)
    pan = rng.integers(0, 3, (V, H, W)).astype(np.int32)
    return {
        "pointmaps": {"pts3d": rng.standard_normal((V, H, W, 3)).astype(
            np.float32), "conf": rng.random((V, H, W)).astype(np.float32)
            + 1.0},
        "pan": pan,
        "segments_info": [{"id": 1, "category_id": 0,
                           "category_name": "wall"},
                          {"id": 2, "category_id": 3,
                           "category_name": "chair"}],
        "conf": np.ones((V, H, W), np.float32),
        "focals": np.full(V, 10.0, np.float32),
        "cams2world": np.tile(np.eye(4, dtype=np.float32), (V, 1, 1)),
        "keyframes": [0],
    }


def test_viewer_serves_exported_scene(tmp_path):
    from panst3r_torch.apps.demo import export_scene
    from panst3r_torch.apps.viewer import make_server

    images = np.full((2, 8, 12, 3), 100, np.uint8)
    export_scene(tmp_path, images, _scene(), conf_threshold=1.5,
                 overlays=False)
    srv = make_server(str(tmp_path), port=0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        def get(path):
            return urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}").read().decode()

        assert "panst3r_torch viewer" in get("/")
        ply = get("/scene.ply")
        assert ply.startswith("ply") and ply == (tmp_path /
                                                 "scene.ply").read_text()
        meta = json.loads(get("/cameras.json"))
        assert meta["image_size"] == [8, 12]
        assert {s["category_name"] for s in meta["segments_info"]} == \
            {"wall", "chair"}
    finally:
        srv.shutdown()
        srv.server_close()


def test_gradio_app_refuses_without_gradio():
    """gradio is not installed here: both apps exit with the same
    message, naming their own package's demo and viewer."""
    try:
        import gradio  # noqa: F401
        pytest.skip("gradio is installed")
    except ImportError:
        pass
    from panst3r_torch.apps import gradio_app as t_app
    from panst3r_tpu.apps import gradio_app as j_app

    msgs = []
    for app in (t_app, j_app):
        with pytest.raises(SystemExit) as e:
            app.main([])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1].replace("panst3r_tpu", "panst3r_torch")


def _meshes():
    v, f, l = _square_mesh()
    yield v, f, l
    v1, f1, l1 = _square_mesh(z=2.0, label=1)
    v2, f2, l2 = _square_mesh(z=1.0, label=2)
    yield (np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4]),
           np.concatenate([l1, l2]))
    rng = np.random.default_rng(0)
    n = 40
    verts = rng.standard_normal((n, 3)).astype(np.float32)
    verts[:, 2] = np.abs(verts[:, 2]) + 1.0
    yield (verts, rng.integers(0, n, (30, 3)).astype(np.int32),
           rng.integers(1, 9, 30).astype(np.int32))


def test_rasterizer_bit_equal_to_jax():
    if t_native._build_rasterizer() is None or j_native._build() is None:
        pytest.skip("no C++ toolchain")
    for verts, faces, labels in _meshes():
        for fn in ("rasterize_mesh", "_rasterize_numpy"):
            got = getattr(t_native, fn)(verts, faces, labels, K, 48, 64)
            want = getattr(j_native, fn)(verts, faces, labels, K, 48, 64)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w), fn


def _files(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_preprocess_matches_jax_and_loads(tmp_path):
    from panst3r_torch.data.scannetpp import ScanNetppPanoptic
    from panst3r_torch.tools import preprocess_scannetpp as t_pp

    root = _make_raw_scene(str(tmp_path / "raw"))
    classes = tmp_path / "classes.txt"
    classes.write_text("wall\nchair\n")
    outs = {}
    for name, pp in (("jax", j_pp), ("torch", t_pp)):
        outs[name] = str(tmp_path / name)
        pp.main(["--root", root, "--pairs-dir", osp.join(root, "pairs"),
                 "--output-dir", outs[name], "--class-list", str(classes),
                 "--target-resolution", "128", "96"])
    files = _files(outs["jax"])
    assert files == _files(outs["torch"]) and len(files) == 9
    for rel in files:
        a, b = (osp.join(outs[n], rel) for n in ("jax", "torch"))
        if rel.endswith(".npz"):
            with np.load(a, allow_pickle=True) as x, \
                    np.load(b, allow_pickle=True) as y:
                assert sorted(x.files) == sorted(y.files), rel
                for k in x.files:
                    assert x[k].dtype == y[k].dtype, (rel, k)
                    if x[k].dtype == object:
                        assert all(np.array_equal(p, q)
                                   for p, q in zip(x[k], y[k])), (rel, k)
                    else:
                        assert np.array_equal(x[k], y[k]), (rel, k)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel
    ds = ScanNetppPanoptic(outs["torch"], resolution=(64, 48), num_views=2,
                           aug_crop=0)
    views = ds[0]
    assert len(views) == 2
    assert set(np.unique(views[0]["pan_inst_id"])) <= {0, 1, 2}
    assert len(set(np.unique(views[0]["pan_inst_id"])) - {0}) >= 1


def test_progress_matches_jax():
    from panst3r_torch.core import progress as t_prog
    from panst3r_tpu.core import progress as j_prog

    for mod in (t_prog, j_prog):
        calls = []

        def handler(it, desc="", total=None):
            calls.append((desc, total))
            return [2 * x for x in it]

        assert list(mod.report(range(3), desc="a")) == [0, 1, 2]
        with mod.route(handler):
            assert mod.report(range(3), desc="b", total=3) == [0, 2, 4]
            results = []
            th = threading.Thread(target=lambda: results.append(
                list(mod.report(range(2)))))
            th.start()
            th.join()
            assert results == [[0, 1]]        # another thread's context
        assert list(mod.report(range(2))) == [0, 1]
        assert calls == [("b", 3)]
