"""Host-side target preparation for the panoptic criterion (the port's own
copy of panst3r_tpu/data/targets.py; numpy only).

Per-sample instance-id / class-id maps become binary per-instance
multi-view masks, global class labels and the per-dataset ``output_mask``,
padded to a fixed ``max_instances``.
"""
from __future__ import annotations

import numpy as np


def prepare_targets(inst_ids: np.ndarray, cls_ids: np.ndarray,
                    class_set: list[str], classes: list[str],
                    max_instances: int) -> dict:
    """inst_ids/cls_ids: (V, H, W) int maps of one sample (instance 0 is
    unlabelled); ``class_set``: names of the local class ids; ``classes``:
    the global vocabulary.  Returns labels (T,) int32, masks (T, V, H, W)
    f32, valid (T,) bool and output_mask (ncls,) bool; instances past
    ``max_instances`` are dropped."""
    class2id = {c: i for i, c in enumerate(classes)}
    V, H, W = inst_ids.shape
    labels = np.zeros(max_instances, np.int32)
    masks = np.zeros((max_instances, V, H, W), np.float32)
    valid = np.zeros(max_instances, bool)
    t = 0
    for iid in np.unique(inst_ids):
        if iid == 0:
            continue
        mask = inst_ids == iid
        label_all = cls_ids[mask]
        if not (label_all == label_all[0]).all():
            raise ValueError(f"different classes within instance id={iid}")
        if t >= max_instances:
            break
        labels[t] = class2id[class_set[label_all[0]]]
        masks[t] = mask
        valid[t] = True
        t += 1
    output_mask = np.isin(np.asarray(classes), np.asarray(class_set))
    return {"labels": labels, "masks": masks, "valid": valid,
            "output_mask": output_mask}
