"""Photometric training augmentation on the host (counterpart of
panst3r_tpu/data/transforms.py).

The reference recipe's ``transform: ColorJitter`` is torchvision's
``ColorJitter(brightness=0.5, contrast=0.5, saturation=0.5, hue=0.1)``
applied per view before the [-1, 1] normalization.  The ops follow
torchvision.transforms.functional's float semantics; the factors and the
op order are drawn from the dataset's numpy generator, so a sample depends
only on (seed, epoch, index).  Every op takes and returns float32 RGB in
[0, 1], (H, W, 3).
"""
from __future__ import annotations

import numpy as np

_GRAY_W = np.asarray([0.2989, 0.587, 0.114], np.float32)


def _blend(img1: np.ndarray, img2, ratio: float) -> np.ndarray:
    # torchvision _blend: ratio*img1 + (1-ratio)*img2, clamped to [0, 1]
    out = ratio * img1 + (1.0 - ratio) * img2
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def _grayscale(img: np.ndarray) -> np.ndarray:
    return (img @ _GRAY_W).astype(np.float32)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, 0.0, factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = float(_grayscale(img).mean())
    return _blend(img, mean, factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, _grayscale(img)[..., None], factor)


def _rgb_to_hsv(img: np.ndarray):
    # torchvision _rgb2hsv (float path)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    eqc = maxc == minc
    cr = maxc - minc
    ones = np.ones_like(maxc)
    s = cr / np.where(eqc, ones, maxc)
    cr_divisor = np.where(eqc, ones, cr)
    rc = (maxc - r) / cr_divisor
    gc = (maxc - g) / cr_divisor
    bc = (maxc - b) / cr_divisor
    hr = (maxc == r) * (bc - gc)
    hg = ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    hb = ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    h = hr + hg + hb
    h = (h / 6.0 + 1.0) % 1.0
    return h.astype(np.float32), s.astype(np.float32), maxc.astype(np.float32)


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    # torchvision _hsv2rgb (float path)
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.astype(np.int32) % 6
    p = np.clip(v * (1.0 - s), 0.0, 1.0)
    q = np.clip(v * (1.0 - s * f), 0.0, 1.0)
    t = np.clip(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    order = np.asarray([[0, 1, 2], [3, 0, 2], [2, 0, 1],
                        [2, 3, 0], [1, 2, 0], [0, 2, 3]])
    stacked = np.stack([v, t, p, q], axis=-1)          # (H, W, 4)
    idx = order[i]                                     # (H, W, 3)
    return np.take_along_axis(stacked, idx, axis=-1).astype(np.float32)


try:
    import cv2 as _cv2
except ImportError:          # pragma: no cover
    _cv2 = None


def adjust_hue(img: np.ndarray, hue_shift: float) -> np.ndarray:
    """hue_shift in [-0.5, 0.5] (torchvision's convention).  With cv2, its
    float HSV converter (the same sector formulas, ~1.5e-6 from the numpy
    transcription, and about ten times faster); else the numpy
    transcription of torchvision's float path."""
    img = np.clip(img, 0.0, 1.0).astype(np.float32, copy=False)
    if _cv2 is not None:
        hsv = _cv2.cvtColor(img, _cv2.COLOR_RGB2HSV)   # H in [0, 360)
        hsv[..., 0] = (hsv[..., 0] + hue_shift * 360.0) % 360.0
        return np.clip(_cv2.cvtColor(hsv, _cv2.COLOR_HSV2RGB), 0.0, 1.0)
    h, s, v = _rgb_to_hsv(img)
    h = (h + hue_shift) % 1.0
    return _hsv_to_rgb(h, s, v)


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5, hue: float = 0.1) -> np.ndarray:
    """torchvision ColorJitter: the four ops in a random order, each with a
    uniform factor (brightness / contrast / saturation in
    [max(0, 1-x), 1+x], hue in [-hue, hue])."""
    order = rng.permutation(4)
    bf = rng.uniform(max(0.0, 1.0 - brightness), 1.0 + brightness)
    cf = rng.uniform(max(0.0, 1.0 - contrast), 1.0 + contrast)
    sf = rng.uniform(max(0.0, 1.0 - saturation), 1.0 + saturation)
    hf = rng.uniform(-hue, hue)
    img = np.asarray(img, np.float32)
    for op in order:
        if op == 0:
            img = adjust_brightness(img, bf)
        elif op == 1:
            img = adjust_contrast(img, cf)
        elif op == 2:
            img = adjust_saturation(img, sf)
        else:
            img = adjust_hue(img, hf)
    return img


TRANSFORMS = {
    None: None,
    "imgnorm": None,            # dust3r ImgNorm: normalization only
    "color_jitter": color_jitter,
    "ColorJitter": color_jitter,  # the reference configs' spelling
}
