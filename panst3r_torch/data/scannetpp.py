"""ScanNet++ panoptic multi-view dataset (counterpart of
panst3r_tpu/data/scannetpp.py).

Reads the preprocessed layout: ``all_metadata.npz`` (scenes, sceneids,
images, intrinsics, trajectories, covisibility pairs, cls_sep, optional
per-scene crowd instance ids) and ``categories.json`` at the root, and per
view ``<scene>/images/<name>.jpg``, ``depth/<name>.png`` (mm) and
``panoptic/<name>.png`` (rgb2id: instance = id // cls_sep, class =
id % cls_sep).  Images are read with cv2; a sample depends only on
(seed, epoch, index).
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np

from panst3r_torch.data.base import EasyDataset, select_tuple_from_pairs
from panst3r_torch.data.cropping import crop_resize_if_necessary
from panst3r_torch.data.utils import rgb2id

CLS_SEP = 256


def _imread(path: str, flags: str = "rgb") -> np.ndarray:
    import cv2

    if flags == "unchanged":
        return cv2.imread(path, cv2.IMREAD_UNCHANGED)
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class ScanNetppPanoptic(EasyDataset):
    def __init__(self, ROOT: str, resolution=(512, 384), num_views: int = 5,
                 aug_crop: int = 16, seed: int = 777,
                 transform: str | None = None,
                 min_memory_num_views: int | None = None,
                 max_memory_num_views: int | None = None):
        from panst3r_torch.data.transforms import TRANSFORMS

        self.ROOT = ROOT
        self.resolution = (resolution if isinstance(resolution[0],
                                                    (list, tuple))
                           else [resolution])
        self.num_views = num_views
        self.aug_crop = aug_crop
        self.seed = seed
        # The memory core's size per sample (the reference's
        # min/max_memory_num_views): the first M views of a tuple form the
        # covisibility-connected core, the rest are its neighbours.  It
        # shapes the tuple only: the training forward builds memory over
        # every view.  Neither set: a fixed full-size core; only max set:
        # min is 2; only min set: max is num_views; 0 and None are unset.
        mx = num_views if not max_memory_num_views \
            else max(2, min(max_memory_num_views, num_views))
        mn = (mx if not max_memory_num_views else 2) \
            if not min_memory_num_views \
            else max(2, min(min_memory_num_views, num_views))
        if mn > mx:
            raise ValueError(
                f"min_memory_num_views={min_memory_num_views} > "
                f"max_memory_num_views={max_memory_num_views} "
                f"(num_views={num_views})")
        self.min_memory_num_views = mn
        self.max_memory_num_views = mx
        # photometric augmentation per view, before the normalization
        self.transform = TRANSFORMS[transform]
        self.epoch = 0
        self.is_metric_scale = True
        self._load_data()

        self.pairs_per_image = [set() for _ in range(len(self.images))]
        for i1, i2 in self.pairs:
            self.pairs_per_image[i1].add(int(i2))
            self.pairs_per_image[i2].add(int(i1))

    def _load_data(self):
        with np.load(osp.join(self.ROOT, "all_metadata.npz"),
                     allow_pickle=True) as data:
            self.scenes = data["scenes"]
            self.sceneids = data["sceneids"]
            self.images = data["images"]
            self.intrinsics = data["intrinsics"].astype(np.float32)
            self.trajectories = data["trajectories"].astype(np.float32)
            self.pairs = data["pairs"][:, :2].astype(int)
            self.cls_sep = (int(data["cls_sep"]) if "cls_sep" in data
                            else CLS_SEP)
            self.scene_crowd_inst_ids = (
                [np.asarray(c, np.int64)
                 for c in data["scene_crowd_inst_ids"]]
                if "scene_crowd_inst_ids" in data else None)
        with open(osp.join(self.ROOT, "categories.json")) as f:
            self.categories = json.load(f)
        self._classes = [cat["name"] for cat in self.categories]

    @property
    def classes(self):
        return self._classes

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.pairs)

    def _load_view(self, idx: int, view_idx: int, resolution,
                   rng: np.random.Generator) -> dict:
        scene_id = self.sceneids[view_idx]
        scene_dir = osp.join(self.ROOT, str(self.scenes[scene_id]))
        basename = str(self.images[view_idx])

        rgb = _imread(osp.join(scene_dir, "images", basename + ".jpg"))
        depth = _imread(osp.join(scene_dir, "depth", basename + ".png"),
                        "unchanged").astype(np.float32) / 1000.0
        depth[~np.isfinite(depth)] = 0

        pan_id = rgb2id(_imread(osp.join(scene_dir, "panoptic",
                                         basename + ".png")))
        inst_id = pan_id // self.cls_sep
        cls_id = pan_id % self.cls_sep

        K = self.intrinsics[view_idx]
        image, (depth, inst_id, cls_id), K = crop_resize_if_necessary(
            rgb, (depth, inst_id, cls_id), K, resolution, rng=rng,
            aug_crop=self.aug_crop)

        img = np.asarray(image, np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img, rng)
        img = img * 2.0 - 1.0  # dust3r's normalization
        return dict(
            img=img,
            depthmap=depth.astype(np.float32),
            camera_pose=self.trajectories[view_idx],
            camera_intrinsics=K.astype(np.float32),
            dataset="ScanNet++",
            label=f"{self.scenes[scene_id]}_{basename}",
            pan_inst_id=inst_id.astype(np.int32),
            pan_cls_id=cls_id.astype(np.int32),
            class_set=";".join(self._classes),
            crowd_inst_ids=(self.scene_crowd_inst_ids[scene_id]
                            if self.scene_crowd_inst_ids is not None
                            else np.zeros(0, np.int64)),
        )

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx, res_idx = idx
        else:
            res_idx = 0
        resolution = self.resolution[res_idx]
        rng = np.random.default_rng(self.seed + self.epoch * 100003 + idx)
        idx1, idx2 = self.pairs[idx]
        mem_views = int(rng.integers(self.min_memory_num_views,
                                     self.max_memory_num_views + 1))
        views = select_tuple_from_pairs(
            lambda v: self.pairs_per_image[v],
            lambda v, r: self._load_view(idx, v, resolution, r),
            self.num_views, mem_views, rng, int(idx1), int(idx2))
        for v in views:
            v["memory_num_views"] = mem_views
        return views
