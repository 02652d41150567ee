"""Panoptic ids packed in 24-bit RGB (counterpart of
panst3r_tpu/data/utils.py; panopticapi's rgb2id / id2rgb)."""
from __future__ import annotations

import numpy as np


def rgb2id(color: np.ndarray) -> np.ndarray:
    color = color.astype(np.int32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    id_map = id_map.copy()
    rgb = np.zeros((*id_map.shape, 3), np.uint8)
    for i in range(3):
        rgb[..., i] = id_map % 256
        id_map //= 256
    return rgb
