"""Joint image / mask / intrinsics crop and rescale (counterpart of
panst3r_tpu/data/cropping.py): principal-point-centred cropping, a
Lanczos (down) or bicubic (up) image rescale with NEAREST masks (cv2's
when it imports, else a numpy index), and the intrinsics that follow.
PIL is imported inside the functions, so importing this module needs only
numpy.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def camera_matrix_of_crop(intrinsics: np.ndarray, input_size, output_size,
                          scaling: float = 1.0,
                          offset_factor: float = 0.5) -> np.ndarray:
    """Intrinsics after scaling, then a centred crop to output_size."""
    K = intrinsics.copy()
    K[0, 0] *= scaling
    K[1, 1] *= scaling
    K[0, 2] *= scaling
    K[1, 2] *= scaling
    margin_x = max(0, (input_size[0] * scaling - output_size[0]))
    margin_y = max(0, (input_size[1] * scaling - output_size[1]))
    K[0, 2] -= margin_x * offset_factor
    K[1, 2] -= margin_y * offset_factor
    return K


def bbox_from_intrinsics_in_out(K_in: np.ndarray, K_out: np.ndarray,
                                output_size) -> tuple[int, int, int, int]:
    """The crop box that maps K_in to K_out at the given output size."""
    l = int(round(K_in[0, 2] - K_out[0, 2]))  # noqa: E741
    t = int(round(K_in[1, 2] - K_out[1, 2]))
    return (l, t, l + int(output_size[0]), t + int(output_size[1]))


def crop_image_and_masks(image, masks, intrinsics: np.ndarray, crop_bbox):
    """Crop a PIL image and its aligned masks; shift the principal point."""
    l, t, r, b = crop_bbox  # noqa: E741
    image = image.crop((l, t, r, b))
    masks = [m[t:b, l:r] for m in masks]
    K = intrinsics.copy()
    K[0, 2] -= l
    K[1, 2] -= t
    return image, masks, K


def rescale_image_and_masks(image, masks, intrinsics: np.ndarray,
                            output_resolution, force: bool = True):
    """Rescale so that (W, H) >= output_resolution: Lanczos (down) or
    bicubic (up) for the image, NEAREST for the masks."""
    from PIL import Image

    input_resolution = np.array(image.size)
    output_resolution = np.array(output_resolution)
    scale_final = max(output_resolution / image.size) + 1e-8
    if scale_final >= 1 and not force:
        return image, masks, intrinsics
    out = np.floor(input_resolution * scale_final).astype(int)
    resample = Image.LANCZOS if scale_final < 1 else Image.BICUBIC
    image = image.resize(tuple(out), resample=resample)
    masks_out = []
    for m in masks:
        if cv2 is not None:
            masks_out.append(cv2.resize(m, tuple(out),
                                        interpolation=cv2.INTER_NEAREST))
        else:
            yi = (np.arange(out[1]) * m.shape[0] / out[1]).astype(int)
            xi = (np.arange(out[0]) * m.shape[1] / out[0]).astype(int)
            masks_out.append(m[yi][:, xi])
    K = camera_matrix_of_crop(intrinsics, input_resolution, out,
                              scaling=scale_final, offset_factor=0.0)
    return image, masks_out, K


def crop_resize_if_necessary(image, masks, intrinsics: np.ndarray,
                             resolution, rng: np.random.Generator,
                             aug_crop: int = 0):
    """The reference's ``_crop_resize_if_necessary``: a crop centred on the
    principal point, the target resolution transposed for portrait views
    (and at random for square ones), the rescale (plus an ``aug_crop``
    jitter), then a centred crop.  ``image``: a PIL image or an (H, W, 3)
    uint8 array; returns (PIL image, masks, intrinsics)."""
    from PIL import Image

    if not isinstance(image, Image.Image):
        image = Image.fromarray(image)

    W, H = image.size
    cx, cy = np.round(intrinsics[:2, 2]).astype(int)
    min_margin_x = min(cx, W - cx)
    min_margin_y = min(cy, H - cy)
    l, t = cx - min_margin_x, cy - min_margin_y  # noqa: E741
    r, b = cx + min_margin_x, cy + min_margin_y
    image, masks, intrinsics = crop_image_and_masks(
        image, masks, intrinsics, (l, t, r, b))

    W, H = image.size
    assert resolution[0] >= resolution[1]
    if H > 1.1 * W:
        resolution = resolution[::-1]                       # portrait
    elif 0.9 < H / W < 1.1 and resolution[0] != resolution[1]:
        if rng.integers(2):                                 # square: random
            resolution = resolution[::-1]

    target_resolution = np.array(resolution)
    if aug_crop > 1:
        target_resolution = target_resolution + rng.integers(0, aug_crop)
    image, masks, intrinsics = rescale_image_and_masks(
        image, masks, intrinsics, target_resolution)

    K2 = camera_matrix_of_crop(intrinsics, image.size, resolution,
                               offset_factor=0.5)
    bbox = bbox_from_intrinsics_in_out(intrinsics, K2, resolution)
    image, masks, K2 = crop_image_and_masks(image, masks, intrinsics, bbox)
    return image, masks, K2
