"""The port's data pipeline against the JAX package's (CPU, numpy): the
dataset algebra, the covisibility tuple sampler, the crop / rescale with
its intrinsics, ColorJitter (with cv2's HSV and with the numpy one), the
panoptic id packing, ScanNet++ samples byte for byte on the files of
tests/test_data.py::_make_scannetpp, and the epoch iterator for every
worker mode, with prefetch re-raising a producer's error."""
import numpy as np
import pytest

import panst3r_tpu.data.cropping as jcrop
import panst3r_tpu.data.transforms as jtf
from panst3r_torch.data import base as tbase
from panst3r_torch.data import cropping as tcrop
from panst3r_torch.data import loader as tloader
from panst3r_torch.data import transforms as ttf
from panst3r_torch.data.scannetpp import ScanNetppPanoptic as TScanNetpp
from panst3r_torch.data.utils import id2rgb, rgb2id
from panst3r_tpu.data import base as jbase
from panst3r_tpu.data import loader as jloader
from panst3r_tpu.data.scannetpp import ScanNetppPanoptic as JScanNetpp
from panst3r_tpu.data.utils import id2rgb as j_id2rgb
from tests.test_data import _make_scannetpp
from tests.torch_release import release_memory  # noqa: F401


def _fake(mod):
    class Fake(mod.EasyDataset):
        def __init__(self, n, tag):
            self.n, self.tag = n, tag

        def __len__(self):
            return self.n

        def __getitem__(self, idx):
            return (self.tag, idx)

        @property
        def classes(self):
            return [self.tag]
    return Fake


def test_dataset_algebra_matches_jax():
    made = {}
    for name, mod in (("t", tbase), ("j", jbase)):
        F = _fake(mod)
        a, b = F(3, "a"), F(2, "b")
        made[name] = [a + b, 3 * a, 10 @ a, 7 @ (a + 2 * b) + b]
    for t, j in zip(made["t"], made["j"]):
        assert type(t).__name__ == type(j).__name__
        assert len(t) == len(j) and t.classes == j.classes
        for epoch in (0, 1, 5):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            for i in range(len(t)):
                assert t[i] == j[i]
                assert t[(i, 1)] == j[(i, 1)]        # a (idx, res) key


def test_select_tuple_from_pairs_matches_jax():
    pairs = {0: {1, 2, 3}, 1: {0, 2}, 2: {0, 1}, 3: {0, 4, 5}, 4: {3},
             5: {3}, 6: set()}
    for seed in range(6):
        for num_views, mem in ((4, 4), (5, 2), (6, 3), (3, 9)):
            for i1, i2 in ((0, 1), (3, 4), (6, 6)):
                got = [mod.select_tuple_from_pairs(
                    lambda v: pairs[v], lambda v, r: (v, float(r.random())),
                    num_views, mem, np.random.default_rng(seed), i1, i2)
                    for mod in (tbase, jbase)]
                assert got[0] == got[1]


@pytest.mark.parametrize("with_cv2", [True, False])
def test_crop_resize_matches_jax(with_cv2, monkeypatch):
    """Images, masks and intrinsics equal, bit for bit, for landscape,
    portrait and square inputs, with and without the aug_crop jitter, with
    cv2's NEAREST masks and with the numpy index."""
    if not with_cv2:
        monkeypatch.setattr(tcrop, "cv2", None)
        monkeypatch.setattr(jcrop, "cv2", None)
    rng = np.random.default_rng(1)
    for H, W, res, aug in ((480, 640, (512, 384), 0), (120, 160, (64, 48), 8),
                           (160, 120, (64, 48), 8), (100, 100, (64, 48), 0),
                           (100, 104, (64, 48), 3)):
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        masks = (rng.random((H, W)).astype(np.float32),
                 rng.integers(0, 5, (H, W)).astype(np.int32))
        K = np.array([[100.0, 0, W / 2 + 3], [0, 100.0, H / 2 - 2],
                      [0, 0, 1]], np.float32)
        for seed in range(3):
            outs = [mod.crop_resize_if_necessary(
                img, masks, K, res, rng=np.random.default_rng(seed),
                aug_crop=aug) for mod in (tcrop, jcrop)]
            (ti, tm, tk), (ji, jm, jk) = outs
            assert ti.size == ji.size
            np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
            for a, b in zip(tm, jm):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(tk, jk)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_color_jitter_matches_jax(with_cv2, monkeypatch):
    """The same draws and ops as the JAX package's, bit for bit, through
    cv2's HSV converter and through the numpy transcription."""
    if not with_cv2:
        monkeypatch.setattr(ttf, "_cv2", None)
        monkeypatch.setattr(jtf, "_cv2", None)
    else:
        assert ttf._cv2 is not None and jtf._cv2 is not None
    img = np.random.default_rng(0).random((31, 45, 3)).astype(np.float32)
    for seed in range(8):
        a = ttf.TRANSFORMS["ColorJitter"](img, np.random.default_rng(seed))
        b = jtf.TRANSFORMS["ColorJitter"](img, np.random.default_rng(seed))
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert set(ttf.TRANSFORMS) == set(jtf.TRANSFORMS)


def test_panoptic_id_packing():
    ids = np.random.default_rng(0).integers(0, 2 ** 24, (7, 9))
    np.testing.assert_array_equal(id2rgb(ids), j_id2rgb(ids))
    np.testing.assert_array_equal(rgb2id(id2rgb(ids)), ids)


def _pair(root, **kw):
    return (TScanNetpp(str(root), **kw), JScanNetpp(str(root), **kw))


def _assert_views_equal(a, b):
    assert len(a) == len(b)
    for va, vb in zip(a, b):
        assert va.keys() == vb.keys()
        for k in va:
            if isinstance(va[k], np.ndarray):
                assert va[k].dtype == vb[k].dtype, k
                np.testing.assert_array_equal(va[k], vb[k], err_msg=k)
            else:
                assert va[k] == vb[k], k


def test_scannetpp_samples_match_jax(tmp_path):
    """``ds[(i, r)]`` byte-equal to the JAX dataset's for every index, both
    resolutions and two epochs, with ColorJitter and a random memory core."""
    _make_scannetpp(str(tmp_path), n_views=6, hw=(64, 96))
    t, j = _pair(tmp_path, resolution=[(64, 48), (48, 32)], num_views=4,
                 aug_crop=8, transform="ColorJitter",
                 min_memory_num_views=2, max_memory_num_views=4)
    assert t.classes == j.classes == ["wall", "chair"]
    assert len(t) == len(j) == 5
    for epoch in (0, 3):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(t)):
            for r in (0, 1):
                _assert_views_equal(t[(i, r)], j[(i, r)])
    _assert_views_equal(t[2], j[2])


def _assert_batches_equal(ta, ja):
    assert len(ta) == len(ja) > 0
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["portrait"], b["portrait"])
        for f in ("labels", "masks", "valid", "output_mask"):
            np.testing.assert_array_equal(getattr(a["targets"], f),
                                          np.asarray(getattr(b["targets"],
                                                             f)))


@pytest.mark.parametrize("workers,mode", [(0, "process"), (2, "thread"),
                                          (2, "process")])
def test_epoch_batches_match_jax(tmp_path, workers, mode):
    """The port's batches, with any worker pool, through prefetch, equal
    the JAX package's serial batches: order, bucket and contents."""
    _make_scannetpp(str(tmp_path), n_views=6, hw=(32, 48))
    t, j = _pair(tmp_path, resolution=[(48, 32), (32, 32)], num_views=2,
                 aug_crop=4, transform="ColorJitter")
    for epoch in (0, 1):
        want = list(jloader.epoch_batches(j, 2, j.classes, 8, epoch,
                                          seed=5, num_resolutions=2))
        got = list(tloader.prefetch(tloader.epoch_batches(
            t, 2, t.classes, 8, epoch, seed=5, num_resolutions=2,
            workers=workers, workers_mode=mode), depth=2))
        _assert_batches_equal(got, want)
    # rank sharding: rank 1 of 2 takes the odd places of the permutation
    got = list(tloader.epoch_batches(t, 1, t.classes, 8, 0, rank=1,
                                     world_size=2))
    want = list(jloader.epoch_batches(j, 1, j.classes, 8, 0, rank=1,
                                      world_size=2))
    _assert_batches_equal(got, want)


def test_prefetch_reraises_the_producers_error():
    def boom():
        yield 1
        raise RuntimeError("loader failure")

    it = tloader.prefetch(boom(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="loader failure"):
        next(it)
