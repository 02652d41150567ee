"""The port's training app against the JAX package's (CPU): the exact LAP
solver (native and scipy branches), the random class table, the dataset
mix, the experiment files, and the app itself at the tiny preset — one
epoch, then a resumed run of a second, bit-equal to two epochs in one run,
with the JAX app's log.txt keys and checkpoint names.  No JAX train step
or JAX app runs here (tests/test_train_cli.py and tests/test_torch_train.py
hold those)."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import panst3r_tpu.apps.train as japp
import panst3r_tpu.native as jnative
from panst3r_torch import native as tnative
from panst3r_torch.apps import train as tapp
from panst3r_torch.apps.common import build_engine
from panst3r_torch.core import config as tcfg
from panst3r_torch.core.bucketing import Bucket
from panst3r_torch.core.checkpoint import load_checkpoint
from panst3r_torch.engine.criterion import PanopticLossConfig
from panst3r_torch.engine.train import TrainConfig
from panst3r_torch.ops.lap import exact_lap
from panst3r_tpu.core import config as jcfg
from panst3r_tpu.ops.lap import exact_lap as j_exact_lap
from tests.test_data import _make_scannetpp
from tests.torch_release import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _costs():
    rng = np.random.default_rng(0)
    out = [rng.standard_normal((6, 6)), rng.random((9, 4)) * 10,
           rng.random((3, 7)), rng.integers(0, 4, (8, 8)).astype(float)]
    inf = rng.random((5, 5))
    inf[0, 1:] = np.inf                  # forbidden pairs, still feasible
    return out + [inf]


@pytest.mark.parametrize("branch", ["native", "scipy"])
def test_exact_lap_matches_jax_and_scipy(branch, monkeypatch):
    """Equal to the JAX package's exact_lap (both run the same solver, or
    both scipy's) and at scipy's optimum, exactly."""
    if branch == "scipy":
        monkeypatch.setattr(tnative, "lap_jv", lambda cost: None)
        monkeypatch.setattr(jnative, "lap_jv", lambda cost: None)
    else:
        assert tnative.lap_jv(np.eye(2)) is not None, "g++ build failed"
    for cost in _costs():
        r, c = exact_lap(cost)
        jr, jc = j_exact_lap(cost)
        assert r.dtype == c.dtype == np.int64
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(c, jc)
        sr, sc = linear_sum_assignment(cost)
        assert cost[r, c].sum() == cost[sr, sc].sum()
        assert len(set(r.tolist())) == len(r) == min(cost.shape)
    with pytest.raises(ValueError):
        exact_lap(np.full((2, 2), np.nan))


def test_native_lap_builds_into_the_package_build_dir():
    tnative._build_lap()
    built = list(tnative.BUILD_DIR.glob("liblap-*.so"))
    assert built and all(p.parent == ROOT / "panst3r_torch" / "_build"
                         for p in built)


def test_random_class_table_matches_jax():
    """The table of ``text_encoder="random"`` (and of a tower of another
    width): panst3r_tpu/apps/train.py:218-222, transcribed, bit for bit."""
    classes = ["chair", "floor", "table", "wall"]
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((len(classes), 24))
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    want = emb.astype(np.float32)
    got = tapp.class_embeddings("random", classes, 24)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # siglip is 768 wide: a 24-wide model takes the random table too
    np.testing.assert_array_equal(
        tapp.class_embeddings("siglip", classes, 24), want)


@pytest.mark.parametrize("name", ["train_v1.yaml", "train_v2.yaml"])
def test_experiment_files_load_as_in_jax(name):
    t = tcfg.load_yaml(ROOT / "configs" / name)
    j = jcfg.load_yaml(ROOT / "configs" / name)
    assert isinstance(t, tapp.ExperimentConfig)
    assert tcfg.to_dict(t) == jcfg.to_dict(j)


def test_build_datasets_mix_matches_jax(tmp_path):
    """A two-root mix (``ds_size`` and ``repeat``): the same length,
    vocabulary and, key by key, the same samples as the JAX package's."""
    roots = []
    for name, classes in (("a", ("wall", "chair")), ("b", ("floor",
                                                            "table"))):
        roots.append(tmp_path / name)
        _make_scannetpp(str(roots[-1]), n_views=4, hw=(32, 48),
                        class_names=classes)
    kw = dict(resolution=((48, 32), (32, 32)), num_views=2, aug_crop=4,
              transform="ColorJitter")
    t = tapp.build_datasets(tapp.ExperimentConfig(datasets=(
        tapp.DatasetSpec(root=str(roots[0]), ds_size=4),
        tapp.DatasetSpec(root=str(roots[1]), repeat=2)), **kw))
    j = japp.build_datasets(japp.ExperimentConfig(datasets=(
        japp.DatasetSpec(root=str(roots[0]), ds_size=4),
        japp.DatasetSpec(root=str(roots[1]), repeat=2)), **kw))
    assert len(t) == len(j) == 4 + 6
    assert t.classes == j.classes == ["chair", "floor", "table", "wall"]
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        for key in [(i, i % 2) for i in range(len(t))]:
            for a, b in zip(t[key], j[key]):
                np.testing.assert_array_equal(a["img"], b["img"])
                np.testing.assert_array_equal(a["pan_inst_id"],
                                              b["pan_inst_id"])
                assert a["label"] == b["label"]


def _experiment(data_root, out_dir, epochs):
    return tapp.ExperimentConfig(
        model_preset="tiny", data_root=str(data_root),
        # two buckets: one step function each, drawn per batch
        resolution=((48, 32), (32, 32)), num_views=2, aug_crop=4,
        transform="ColorJitter", min_memory_num_views=2,
        max_memory_num_views=2,
        # accum_iter 3 over 2 micro-steps an epoch: the accumulator and
        # Adam's counters cross the epoch boundary, so a resume must carry
        # the optimizer state
        train=TrainConfig(epochs=epochs, warmup_epochs=0, lr=1e-3,
                          batch_size=2, accum_iter=3, max_instances=8,
                          loss=PanopticLossConfig(num_points=32)),
        output_dir=str(out_dir), keep_freq=1, print_freq=1, logger="jsonl",
        text_encoder="random", loader_workers=2,
        loader_workers_mode="thread")


def _log(out_dir):
    lines = [json.loads(ln) for ln in
             (out_dir / "log.txt").read_text().splitlines()]
    steps = [{k: v for k, v in r.items() if k != "time"}
             for r in lines if "step" in r]
    epochs = [r for r in lines if "epoch" in r]
    return steps, epochs


def test_train_resumes_bit_equal(tmp_path):
    """The tiny preset on the CPU: ``main`` from a YAML for one epoch, then
    ``main --epochs 2`` resumes from ``last`` at epoch 1; its log lines and
    final weights equal, bit for bit, those of two epochs in one run."""
    data = tmp_path / "data"
    _make_scannetpp(str(data), n_views=6, hw=(32, 48))   # 5 pairs
    runs = {}
    for name, epochs in (("straight", 2), ("resumed", 1)):
        out = tmp_path / name
        path = tmp_path / f"{name}.yaml"
        tcfg.save_yaml(_experiment(data, out, epochs), path)
        res = tapp.main(["--config", str(path), "--device", "cpu"])
        assert res["start_epoch"] == 0
        if name == "resumed":
            res = tapp.main(["--config", str(path), "--device", "cpu",
                             "--epochs", "2"])
            assert res["start_epoch"] == 1
        runs[name] = out
    a, b = runs["straight"], runs["resumed"]
    sa, ea = _log(a)
    sb, eb = _log(b)
    assert sa == sb and ea == eb and len(sa) == 4
    wa, _, ma = load_checkpoint(a, "final")
    wb, _, mb = load_checkpoint(b, "final")
    assert wa.keys() == wb.keys()
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert ma["epoch"] == mb["epoch"] == 2
    np.testing.assert_array_equal(ma["cls_emb"], mb["cls_emb"])
    # the frozen towers are stored in bf16, the head in f32
    assert wa["panoptic_decoder.mask_transformer.query_feat"].dtype \
        == torch.float32
    assert wa["must3r_encoder.patch_embed.weight"].dtype == torch.bfloat16

    # the JAX app's names: keep_freq=1 keeps every epoch; final holds no
    # optimizer state; log.txt's step and epoch records
    for out in (a, b):
        assert {p.name for p in out.iterdir()} == {
            "config.yaml", "log.txt", "last", "0", "1", "final"}
        assert (out / "last" / "optimizer.pt").exists()
        assert not (out / "final" / "optimizer.pt").exists()
    losses = {f"loss_{n}{s}" for n in ("ce", "mask", "dice")
              for s in ("", "_0", "_1")}           # dec_layers 2
    assert set(sa[0]) == {"step", "train/loss", "train/iter", "train/lr",
                          "train/panoptic_loss"} | {f"train/{k}"
                                                    for k in losses}
    assert [r["train/iter"] for r in sa] == [0.0, 0.5, 1.0, 1.5]
    assert [set(r) for r in ea] == [{"epoch", "train_loss"}] * 2
    assert all(np.isfinite(r["train_loss"]) for r in ea)

    # final serves through apps/common.py::build_engine
    eng, classes, emb = build_engine("tiny", Bucket(32, 48),
                                     checkpoint=str(a / "final"),
                                     num_keyframes=2, amp=False,
                                     device="cpu")
    assert classes == ["chair", "wall"]
    rng = np.random.default_rng(0)
    out = eng.run_device(rng.integers(0, 256, (3, 32, 48, 3), np.uint8),
                         np.zeros(3, bool), emb)
    assert all(torch.isfinite(v).all() for v in out.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point())


def test_unsupported_options_raise(tmp_path):
    """A mesh over more ranks than the one process there is does not
    cover the world: ``MeshSpec.resolve``'s ValueError, as in the JAX
    train app."""
    exp = _experiment(tmp_path, tmp_path / "o", 1)
    for change in (dict(mesh_data=2), dict(mesh_mem=2),
                   dict(mesh_model=2)):
        with pytest.raises(ValueError, match="does not cover"):
            tapp.train(dataclasses.replace(exp, **change), device="cpu")
