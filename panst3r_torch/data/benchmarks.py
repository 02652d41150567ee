"""Benchmark scene reader for the PQ evaluation: the rendered test views of
Hypersim, Replica and ScanNet (counterpart of
panst3r_tpu/data/benchmarks.py).

Scene layout (detected per scene directory):

  <root>/<scene>/
      color|rgb|images/          *.jpg|*.png   rendered test views
      one of:
        panoptic|pan/            *.png   combined map: rgb2id →
                                          inst = id // cls_sep,
                                          cls = id % cls_sep
        semantic|semantics|semantic_class|sem/   *.png  class id per pixel
        + instance|instances|semantic_instance|inst/  *.png  instance id
  <root>/categories.json   [{"id": int, "name": str}, ...]  (or pass
                            ``classes=``)

Views are cropped and resized to the bucket as training data is (Lanczos
for RGB, NEAREST for the id maps, ``data/cropping.py``), so PQ is measured
at the bucket's resolution on prediction and ground truth alike.  PIL is
imported where files are read.
"""
from __future__ import annotations

import json
import os.path as osp
from glob import glob
from typing import Optional, Sequence

import numpy as np

from panst3r_torch.data.cropping import crop_resize_if_necessary
from panst3r_torch.data.utils import rgb2id

CLS_SEP = 256

_IMG_DIRS = ("color", "rgb", "images")
_SEM_DIRS = ("semantic", "semantics", "semantic_class", "sem")
_INST_DIRS = ("instance", "instances", "semantic_instance", "inst")
_PAN_DIRS = ("panoptic", "pan")

# the vocabulary each benchmark is evaluated against (the reference demo's
# class-set names)
BENCHMARK_CLASS_SET = {"hypersim": "scannet", "replica": "scannet",
                       "scannet": "scannet", "scannetpp": "scannet"}


def _find_dir(scene_dir: str, candidates: Sequence[str]) -> Optional[str]:
    for c in candidates:
        d = osp.join(scene_dir, c)
        if osp.isdir(d):
            return d
    return None


def _frames(d: str) -> list[str]:
    return sorted(glob(osp.join(d, "*.jpg")) + glob(osp.join(d, "*.png"))
                  + glob(osp.join(d, "*.jpeg")))


def _read_id_map(path: str, combined: bool) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path))
    if combined:
        assert img.ndim == 3, f"panoptic map must be RGB (id2rgb): {path}"
        return rgb2id(img).astype(np.int64)
    if img.ndim == 3:                       # an id stored in RGB channels
        return rgb2id(img).astype(np.int64)
    return img.astype(np.int64)


class BenchmarkScenes:
    """The scenes under ``root``, each item a list of view dicts in the
    loader's contract (``img`` in [-1, 1], ``pan_inst_id``,
    ``pan_cls_id``, ``class_set``), as ``apps/eval.py::evaluate_scene``
    takes them."""

    def __init__(self, root: str, benchmark: str = "scannet",
                 resolution=(512, 384), num_views: Optional[int] = None,
                 classes: Optional[Sequence[str]] = None,
                 cls_sep: int = CLS_SEP):
        self.root = root
        self.benchmark = benchmark
        self.resolution = tuple(resolution)
        self.num_views = num_views
        self.cls_sep = cls_sep
        self.scenes = sorted(
            d for d in glob(osp.join(root, "*")) if osp.isdir(d))
        if not self.scenes:
            raise FileNotFoundError(f"no scene directories under {root}")
        if classes is not None:
            self.classes = list(classes)
        else:
            with open(osp.join(root, "categories.json")) as f:
                cats = json.load(f)
            by_id = {int(c["id"]): c["name"] for c in cats}
            self.classes = [by_id.get(i, f"class_{i}")
                            for i in range(max(by_id) + 1)]

    def __len__(self) -> int:
        return len(self.scenes)

    def _scene_dirs(self, scene_dir: str):
        img_dir = _find_dir(scene_dir, _IMG_DIRS)
        assert img_dir, f"no image dir in {scene_dir} (tried {_IMG_DIRS})"
        pan_dir = _find_dir(scene_dir, _PAN_DIRS)
        sem_dir = _find_dir(scene_dir, _SEM_DIRS)
        inst_dir = _find_dir(scene_dir, _INST_DIRS)
        assert pan_dir or (sem_dir and inst_dir), (
            f"{scene_dir}: need panoptic/ or semantic/+instance/ maps")
        return img_dir, pan_dir, sem_dir, inst_dir

    def __getitem__(self, idx: int) -> list[dict]:
        from PIL import Image

        img_dir, pan_dir, sem_dir, inst_dir = self._scene_dirs(
            self.scenes[idx])
        frames = _frames(img_dir)
        if self.num_views is not None:
            sel = np.linspace(0, len(frames) - 1,
                              min(self.num_views, len(frames)))
            frames = [frames[int(i)] for i in sel.round()]

        views = []
        for f in frames:
            stem = osp.splitext(osp.basename(f))[0]

            def gt_path(d):
                cands = glob(osp.join(d, stem + ".*"))
                assert cands, f"no GT map for {stem} in {d}"
                return cands[0]

            if pan_dir:
                pan = _read_id_map(gt_path(pan_dir), combined=True)
                inst, cls = pan // self.cls_sep, pan % self.cls_sep
            else:
                cls = _read_id_map(gt_path(sem_dir), combined=False)
                inst = _read_id_map(gt_path(inst_dir), combined=False)

            image = Image.open(f).convert("RGB")
            # a centred crop and resize to the bucket: the rendered views
            # carry no intrinsics, so the principal point is the centre
            W0, H0 = image.size
            K = np.asarray([[1.0, 0, W0 / 2], [0, 1.0, H0 / 2], [0, 0, 1]],
                           np.float32)
            image, (inst, cls), _ = crop_resize_if_necessary(
                image, [inst, cls], K, self.resolution,
                rng=np.random.default_rng(0), aug_crop=0)
            views.append({
                "img": np.asarray(image, np.float32) / 127.5 - 1.0,
                "pan_inst_id": np.asarray(inst, np.int64),
                "pan_cls_id": np.asarray(cls, np.int64),
                "class_set": ";".join(self.classes),
            })
        return views


# the paper's published PQ (direct multi-view prediction on the rendered
# test views, without LUDVIG), for the eval app's vs_reference
REFERENCE_PQ = {
    ("v1", "hypersim"): 56.5, ("v1", "replica"): 62.0,
    ("v1", "scannet"): 65.7,
    ("v2", "hypersim"): 59.6, ("v2", "replica"): 61.8,
    ("v2", "scannet"): 63.0,
}
