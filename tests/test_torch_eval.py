"""The PQ evaluation: panst3r_torch's ``engine/eval.py``,
``data/benchmarks.py``, ``apps/eval.py`` and the train app's ``eval_every``
against panst3r_tpu on the same numpy inputs (CPU, f32, the tiny
preset)."""
import dataclasses
import json
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import panst3r_torch.data.benchmarks as tbench
import panst3r_torch.engine.eval as tev
import panst3r_tpu.apps.eval as japp_eval
import panst3r_tpu.data.benchmarks as jbench
import panst3r_tpu.engine.eval as jev
from panst3r_torch.apps import eval as tapp_eval
from panst3r_torch.apps import train as tapp
from panst3r_torch.core.bucketing import Bucket as TBucket
from panst3r_torch.core.checkpoint import load_checkpoint
from panst3r_torch.engine.criterion import PanopticLossConfig
from panst3r_torch.engine.inference import InferenceEngine as TEngine
from panst3r_torch.engine.train import TrainConfig
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_torch.weights import _convert
from panst3r_tpu.core.bucketing import Bucket as JBucket
from panst3r_tpu.engine.inference import InferenceEngine as JEngine
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.presets import tiny_config as j_tiny
from tests.test_benchmarks import _make_benchmark_root
from tests.test_data import _make_scannetpp
from tests.test_eval_panopticapi_parity import _random_scene
from tests.torch_release import release_memory  # noqa: F401

H, W = 32, 48

# ------------------------------------------------------- engine/eval.py --


def _segs(ids_cats, crowd=()):
    return [{"id": i, "category_id": c, "iscrowd": int(i in crowd)}
            for i, c in ids_cats]


def _scenes(case):
    """The scenes of tests/test_eval.py and
    tests/test_eval_panopticapi_parity.py: [(pred, pred_segments, gt,
    gt_segments)], and the thing ids for ``summarize``."""
    z = np.zeros
    if case == "perfect":
        pan = z((2, 8, 8), np.int64)
        pan[:, :4, :4], pan[:, 4:, 4:] = 1, 2
        segs = _segs([(1, 3), (2, 5)])
        return [(pan, segs, pan, segs)], None
    if case == "missed_and_spurious":
        gt, pred = z((1, 8, 8), np.int64), z((1, 8, 8), np.int64)
        gt[:, :4, :] = 1
        pred[:, 6:, :] = 7
        return [(pred, _segs([(7, 0)]), gt, _segs([(1, 0)]))], None
    if case == "wrong_class":
        pan = z((1, 8, 8), np.int64)
        pan[:, :4, :] = 1
        return [(pan, _segs([(1, 2)]), pan, _segs([(1, 0)]))], None
    if case == "iou_threshold":
        gt = z((1, 10, 10), np.int64)
        gt[:, :, :6] = 1
        out = []
        for a, b in ((3, 9), (2, 8)):            # IoU 0.5, then 40/60
            pred = z((1, 10, 10), np.int64)
            pred[:, :, a:b] = 9
            out.append((pred, _segs([(9, 1)]), gt, _segs([(1, 1)])))
        return out, None
    if case in ("crowd_absorbs", "crowd_other_class"):
        gt, pred = z((1, 10, 10), np.int64), z((1, 10, 10), np.int64)
        gt[:, :5, :] = 1
        pred[:, :5, :6] = 4
        pred[:, 7:, :] = 5
        cat = 2 if case == "crowd_absorbs" else 3
        return [(pred, _segs([(4, cat), (5, 2)]), gt,
                 _segs([(1, 2)], crowd=(1,)))], None
    if case == "things_stuff":
        pan = z((1, 8, 8), np.int64)
        pan[:, :4, :], pan[:, 4:, :] = 1, 2
        segs = _segs([(1, 0), (2, 5)])
        return [(pan, segs, pan, segs)], {0}
    if case == "crowd_overwrite_quirk":
        gt, pred = z((1, 10, 12), np.int64), z((1, 10, 12), np.int64)
        gt[:, :5, :6], gt[:, :5, 6:] = 1, 2
        pred[:, :5, :6] = 7
        return [(pred, _segs([(7, 0)]), gt,
                 _segs([(1, 0), (2, 0)], crowd=(1, 2)))], None
    seed = int(case.split("_")[1])               # random_<seed>
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        gt, pred, gt_segms, pred_segms = _random_scene(rng, 6)
        out.append((pred, [{"id": i, "category_id": v["category_id"]}
                           for i, v in pred_segms.items()],
                    gt, [{"id": i, **v} for i, v in gt_segms.items()]))
    return out, {0, 1, 2}


CASES = ["perfect", "missed_and_spurious", "wrong_class", "iou_threshold",
         "crowd_absorbs", "crowd_other_class", "things_stuff",
         "crowd_overwrite_quirk"] + [f"random_{s}" for s in range(8)]


def _assert_stats_equal(got: dict, want: dict, iou_atol=0.0):
    cats = {c for c, s in {**got, **want}.items()
            if s.tp + s.fp + s.fn or s.iou_sum}
    for c in cats:
        g, w = got.get(c, tev.PQStat()), want.get(c, jev.PQStat())
        assert (g.tp, g.fp, g.fn) == (w.tp, w.fp, w.fn), c
        assert abs(g.iou_sum - w.iou_sum) <= iou_atol, (c, g, w)


@pytest.mark.parametrize("case", CASES)
def test_scene_pq_and_summarize_match_jax(case):
    scenes, things = _scenes(case)
    for i, (pred, ps, gt, gs) in enumerate(scenes):
        # the iou_threshold case scores each prediction on its own
        fresh = case == "iou_threshold" or i == 0
        if fresh:
            got, want = defaultdict(tev.PQStat), defaultdict(jev.PQStat)
        tot_t = tev.scene_pq(pred, ps, gt, gs, got)
        tot_j = jev.scene_pq(pred, ps, gt, gs, want)
        assert dataclasses.astuple(tot_t) == dataclasses.astuple(tot_j)
        _assert_stats_equal(got, want)
    assert tev.summarize(got, things) == jev.summarize(want, things)


@pytest.mark.parametrize("align,scale", [(True, True), (True, False),
                                         (False, True)])
def test_ate_rmse_and_umeyama_match_jax(align, scale):
    rng = np.random.default_rng(3)
    gt = np.tile(np.eye(4), (12, 1, 1))
    gt[:, :3, 3] = rng.standard_normal((12, 3))
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    pred = gt.copy()
    pred[:, :3, 3] = 1.7 * gt[:, :3, 3] @ R.T + 0.3 \
        + 0.01 * rng.standard_normal((12, 3))
    for g, w in zip(tev.umeyama_alignment(pred[:, :3, 3], gt[:, :3, 3],
                                          scale),
                    jev.umeyama_alignment(pred[:, :3, 3], gt[:, :3, 3],
                                          scale)):
        np.testing.assert_allclose(g, w, atol=1e-6)
    assert abs(tev.ate_rmse(pred, gt, align, scale)
               - jev.ate_rmse(pred, gt, align, scale)) <= 1e-6


@pytest.mark.parametrize("crowd", [None, [3]])
def test_gt_segments_from_maps_match_jax(crowd):
    inst = np.zeros((2, 4, 4), np.int64)
    cls = np.zeros((2, 4, 4), np.int64)
    inst[:, :2, :2], cls[:, :2, :2] = 3, 1
    inst[1, 2:, 2:], cls[1, 2:, 2:] = 5, 0
    args = (inst, cls, ["wall", "chair"], ["chair", "wall", "floor"])
    g = tev.gt_segments_from_maps(*args, crowd_inst_ids=crowd)
    w = jev.gt_segments_from_maps(*args, crowd_inst_ids=crowd)
    np.testing.assert_array_equal(g[0], w[0])
    assert g[1] == w[1]


# -------------------------------------------------- data/benchmarks.py --

@pytest.mark.parametrize("combined", [True, False])
def test_benchmark_scenes_equal_jax(tmp_path, combined):
    _make_benchmark_root(tmp_path, combined)
    kw = dict(resolution=(48, 32), num_views=2)
    got = tbench.BenchmarkScenes(str(tmp_path), "replica", **kw)
    want = jbench.BenchmarkScenes(str(tmp_path), "replica", **kw)
    assert len(got) == len(want) == 2 and got.classes == want.classes
    for i in range(len(want)):
        for g, w in zip(got[i], want[i]):
            assert g.keys() == w.keys()
            for k in ("img", "pan_inst_id", "pan_cls_id"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            assert g["class_set"] == w["class_set"]
    assert tbench.REFERENCE_PQ == jbench.REFERENCE_PQ
    assert tbench.BENCHMARK_CLASS_SET == jbench.BENCHMARK_CLASS_SET


def test_eval_main_keys_match_jax(tmp_path):
    """``main`` on a written Replica-layout scene at the tiny preset on the
    CPU: the JSON's keys are those JAX's ``main`` prints (``summarize``
    with the things split, then the reference fields) and its
    ``reference_pq`` is JAX's."""
    _make_benchmark_root(tmp_path, combined=True)
    res = tapp_eval.main([
        "--data-root", str(tmp_path), "--benchmark", "replica",
        "--preset", "tiny", "--num-scenes", "1", "--num-views", "2",
        "--num-keyframes", "2", "--resolution", "48", "32",
        "--device", "cpu"])
    keys = set(jev.summarize(defaultdict(jev.PQStat), things=set()))
    assert set(res) == keys | {"reference_pq", "vs_reference"}
    assert res["reference_pq"] == jbench.REFERENCE_PQ[("v1", "replica")]
    assert np.isfinite(res["PQ"]) and json.dumps(res)


def test_eval_main_ported_npz_loads_like_reference_state_dict(
        tmp_path, monkeypatch):
    """``--ported-npz``: a reference checkpoint at the tiny widths through
    ``tools/port_torch_checkpoint.py`` to ``ported_params.npz``, then
    ``main``: the model it evaluates holds exactly the weights
    ``load_reference_state_dict`` gives.  The same file without one leaf
    raises instead of leaving that parameter at its initial value."""
    from panst3r_torch.port_checkpoint import load_reference_state_dict
    from tests.test_torch_demo import reference_state_dict
    from tools import port_torch_checkpoint as port_tool

    sd = {k: torch.from_numpy(v)
          for k, v in reference_state_dict(t_tiny()).items()}
    torch.save({"weights": sd}, tmp_path / "ref.pth")
    port_tool.main(["--torch", str(tmp_path / "ref.pth"),
                    "--out", str(tmp_path / "ported")])
    npz = tmp_path / "ported" / "ported_params.npz"
    loaded = []
    real = tapp_eval.load_ported_npz

    def capture(model, path):
        real(model, path)
        loaded.append({n: p.detach().clone()
                       for n, p in model.named_parameters()})
        return model

    monkeypatch.setattr(tapp_eval, "load_ported_npz", capture)
    data = tmp_path / "bench"
    data.mkdir()
    _make_benchmark_root(data, combined=True)
    tapp_eval.main([
        "--data-root", str(data), "--benchmark", "replica",
        "--preset", "tiny", "--ported-npz", str(npz), "--num-scenes", "1",
        "--num-views", "2", "--num-keyframes", "2",
        "--resolution", "48", "32", "--device", "cpu"])
    want = TPanSt3R(t_tiny())
    load_reference_state_dict(want, sd)
    (got,) = loaded
    assert set(got) == {n for n, _ in want.named_parameters()}
    for n, p in want.named_parameters():
        assert torch.equal(got[n], p), n

    with np.load(npz) as flat:
        partial = {k: flat[k] for k in flat.files[1:]}
    np.savez(tmp_path / "partial.npz", **partial)
    with pytest.raises(KeyError, match="not in the flax tree"):
        real(TPanSt3R(t_tiny()), str(tmp_path / "partial.npz"))


# ---------------------------------------- apps/eval.py and eval_every ----

def _flax_from_port(state: dict, shapes):
    """The flax tree (of ``shapes``) holding a port state_dict's values:
    ``weights._convert`` of each leaf's element indices gives where each
    element lives in the port."""
    def fill(path, s):
        keys = tuple(p.key for p in path)[1:]          # drop "params"
        idx = np.arange(int(np.prod(s.shape))).reshape(s.shape)
        out = np.empty(idx.size, np.float32)
        for name, ix in _convert(keys, idx):
            out[np.asarray(ix).reshape(-1)] = \
                state[name].float().numpy().reshape(-1)
        return out.reshape(s.shape)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _experiment(data, out, eval_every):
    return tapp.ExperimentConfig(
        model_preset="tiny", data_root=str(data), resolution=((48, 32),),
        num_views=2, aug_crop=4, transform="ColorJitter",
        train=TrainConfig(epochs=1, warmup_epochs=0, lr=1e-3, batch_size=2,
                          accum_iter=1, max_instances=8,
                          loss=PanopticLossConfig(num_points=32)),
        output_dir=str(out), keep_freq=0, print_freq=1, logger="jsonl",
        text_encoder="random", loader_workers=0, eval_every=eval_every,
        eval_scenes=2, eval_keyframes=2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One tiny train-app epoch without and one with ``eval_every=1`` on
    the same written scenes; the JAX engine and the port's on the final
    weights."""
    tmp = tmp_path_factory.mktemp("eval_every")
    data = tmp / "data"
    _make_scannetpp(str(data), n_views=6, hw=(H, W))
    runs = {}
    for every in (0, 1):
        exp = _experiment(data, tmp / f"e{every}", every)
        runs[every] = (exp, tapp.train(exp, device="cpu"))
    exp = runs[1][0]
    state, _, meta = load_checkpoint(tmp / "e1", "final")
    jmodel = JPanSt3R(j_tiny())
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)),
        jnp.zeros((1, 2), bool), jnp.zeros((2, 24)), (H // 16, W // 16)))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    _flax_from_port(state, shapes))
    jeng = JEngine(jmodel, params, JBucket(H, W), num_keyframes=2,
                   amp=False)
    tmodel = TPanSt3R(t_tiny())
    tmodel.load_state_dict(state)
    teng = TEngine(tmodel, TBucket(H, W), num_keyframes=2, amp=False,
                   device="cpu")
    dataset = tapp.build_datasets(exp)
    return dict(tmp=tmp, runs=runs, meta=meta, jeng=jeng, teng=teng,
                dataset=dataset)


def _lines(out):
    return [{k: v for k, v in json.loads(ln).items() if k != "time"}
            for ln in (out / "log.txt").read_text().splitlines()]


def test_eval_every_leaves_training_unchanged(trained):
    """An epoch with the evaluation gives the losses, the final weights
    and the optimizer state (moments, accumulator, counters) of the epoch
    without it, bit for bit."""
    tmp = trained["tmp"]
    steps = [[r for r in _lines(tmp / f"e{e}") if "train/loss" in r]
             for e in (0, 1)]
    assert steps[0] == steps[1] and len(steps[0]) == 2
    assert [r for r in _lines(tmp / "e1") if "eval/PQ" in r]
    for name in ("final", "last"):
        wa, _, _ = load_checkpoint(tmp / "e0", name)
        wb, _, _ = load_checkpoint(tmp / "e1", name)
        assert wa.keys() == wb.keys()
        assert all(torch.equal(wa[k], wb[k]) for k in wa)
    oa, ob = (torch.load(tmp / f"e{e}" / "last" / "optimizer.pt",
                         weights_only=True) for e in (0, 1))

    def flat(x, p=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from flat(v, f"{p}/{k}")
        else:
            yield p, x
    fa, fb = dict(flat(oa)), dict(flat(ob))
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k
    stats = trained["runs"][1][1]["stats"]
    assert {"eval_PQ", "eval_SQ", "eval_RQ", "eval_num_classes"} \
        <= set(stats)
    assert not any(k.startswith("eval") for k in trained["runs"][0][1][
        "stats"])
    epoch_lines = [r for r in _lines(tmp / "e1") if "epoch" in r]
    assert "train_eval_PQ" in epoch_lines[0]


def test_eval_every_stats_match_jax(trained):
    """The run's ``eval_*`` stats equal JAX's ``evaluate_scene`` +
    ``summarize`` on the same weights and the same last two samples."""
    ds, meta = trained["dataset"], trained["meta"]
    classes, cls_emb = list(meta["classes"]), np.asarray(meta["cls_emb"])
    per_class = defaultdict(jev.PQStat)
    for i in range(len(ds) - 2, len(ds)):
        japp_eval.evaluate_scene(trained["jeng"], ds[i], classes, cls_emb,
                                 per_class=per_class)
    want = jev.summarize(per_class)
    stats = trained["runs"][1][1]["stats"]
    got = {k[len("eval_"):]: v for k, v in stats.items()
           if k.startswith("eval_")}
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])


@pytest.mark.parametrize("fusion", ["standard_v2", "standard_v1", "qubo"])
def test_evaluate_scene_matches_jax(trained, fusion):
    """``evaluate_scene`` on a written ScanNet++ sample (2 views, both
    keyframes, as tests/test_apps.py's eval test keeps every view a
    keyframe): equal TP / FP / FN per class, IoU sums within 1e-5."""
    ds, meta = trained["dataset"], trained["meta"]
    classes, cls_emb = list(meta["classes"]), np.asarray(meta["cls_emb"])
    views = ds[0]
    got = tapp_eval.evaluate_scene(trained["teng"], views, classes, cls_emb,
                                   fusion)
    want = japp_eval.evaluate_scene(trained["jeng"], views, classes,
                                    cls_emb, fusion)
    assert sum(s.tp + s.fp + s.fn for s in want.values()) > 0
    _assert_stats_equal(got, want, iou_atol=1e-5)


def test_build_cls_embeddings_match_jax(tmp_path):
    classes = ["wall", "chair", "table"]
    np.testing.assert_array_equal(
        tapp_eval.build_cls_embeddings(classes, 24, "random"),
        japp_eval.build_cls_embeddings(classes, 24, "random"))
    table = tmp_path / "table.npz"
    rng = np.random.default_rng(0)
    np.savez(table, classes=np.asarray(classes[::-1] + ["door"]),
             embeddings=rng.standard_normal((4, 24)).astype(np.float32))
    np.testing.assert_array_equal(
        tapp_eval.build_cls_embeddings(classes, 24, str(table)),
        japp_eval.build_cls_embeddings(classes, 24, str(table)))
