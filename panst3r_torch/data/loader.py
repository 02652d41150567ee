"""Batch collation: view dicts → fixed-shape training batches (the port's
own copy of ``canonicalize_views`` and ``collate_batch`` of
panst3r_tpu/data/loader.py; numpy only).  ``engine/train.py::batch_to``
moves a batch to the card.  The datasets, cropping, transforms and the
epoch iterator wait for the next training slice.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from panst3r_torch.data.targets import prepare_targets
from panst3r_torch.engine.criterion import Targets


def canonicalize_views(views: Sequence[dict]) -> dict:
    """Stack one sample's views, portrait views transposed to landscape:
    images (V, H, W, 3), portrait (V,), pan_inst_id / pan_cls_id
    (V, H, W), class_set, crowd_inst_ids."""
    imgs, portraits, insts, clss = [], [], [], []
    for v in views:
        img, inst, cls = v["img"], v["pan_inst_id"], v["pan_cls_id"]
        portrait = img.shape[0] > img.shape[1]
        if portrait:
            img, inst, cls = (np.swapaxes(a, 0, 1) for a in (img, inst, cls))
        imgs.append(img)
        insts.append(inst)
        clss.append(cls)
        portraits.append(portrait)
    return {
        "images": np.stack(imgs),
        "portrait": np.asarray(portraits, bool),
        "pan_inst_id": np.stack(insts),
        "pan_cls_id": np.stack(clss),
        "class_set": views[0]["class_set"],
        "crowd_inst_ids": np.asarray(
            views[0].get("crowd_inst_ids", np.zeros(0, np.int64))),
    }


def collate_batch(samples: Sequence[Sequence[dict]], classes: list[str],
                  max_instances: int) -> dict:
    """samples: per-sample view lists of one resolution → {images (B, V,
    H, W, 3) f32, portrait (B, V), targets: Targets of numpy arrays}."""
    canon = [canonicalize_views(v) for v in samples]
    tgt = [prepare_targets(c["pan_inst_id"], c["pan_cls_id"],
                           c["class_set"].split(";"), classes, max_instances)
           for c in canon]
    targets = Targets(*(np.stack([t[k] for t in tgt]) for k in
                        ("labels", "masks", "valid", "output_mask")))
    return {"images": np.stack([c["images"] for c in canon])
            .astype(np.float32),
            "portrait": np.stack([c["portrait"] for c in canon]),
            "targets": targets}
