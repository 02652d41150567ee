"""Resolution buckets, landscape canonicalization and micro-batching
(counterpart of panst3r_tpu/core/bucketing.py).

Images are stored landscape (W >= H); a per-view ``portrait`` flag records
that the semantic image is the transpose.  Every image is resized into one
of a small, fixed set of landscape resolutions (``DEFAULT_BUCKETS``, the
reference's training bucket list); a scene that mixes them runs through
``engine/inference.py::MultiBucketEngine``.  ``micro_batched`` bounds
activation memory by running a function over fixed-size chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """A landscape resolution bucket (height <= width)."""

    height: int
    width: int

    def __post_init__(self):
        assert self.width >= self.height, "buckets are landscape-canonical"

    @property
    def shape(self) -> tuple[int, int]:
        return (self.height, self.width)

    def grid(self, patch_size: int) -> tuple[int, int]:
        assert self.height % patch_size == 0 and self.width % patch_size == 0
        return (self.height // patch_size, self.width // patch_size)

    def num_patches(self, patch_size: int) -> int:
        h, w = self.grid(patch_size)
        return h * w


# The reference training bucket list, landscape form.
DEFAULT_BUCKETS: tuple[Bucket, ...] = (
    Bucket(384, 512),
    Bucket(336, 512),
    Bucket(288, 512),
    Bucket(256, 512),
    Bucket(160, 512),
)


def landscape_shape(h: int, w: int) -> tuple[int, int, bool]:
    """Canonicalize (h, w) to landscape; returns (h', w', was_portrait)."""
    if h > w:
        return w, h, True
    return h, w, False


def bucket_for_shape(h: int, w: int,
                     buckets: Sequence[Bucket] = DEFAULT_BUCKETS) -> Bucket:
    """Pick the bucket whose aspect ratio best matches a (landscape) shape."""
    h, w, _ = landscape_shape(h, w)
    ar = w / h
    return min(buckets, key=lambda b: abs(b.width / b.height - ar))


def true_shape_of(bucket: Bucket, portrait) -> torch.Tensor:
    """Per-view (H, W) 'true shape' given the portrait flag (a bool or a
    bool tensor of any shape; the result appends a trailing axis of 2)."""
    portrait = torch.as_tensor(portrait, dtype=torch.bool)
    hw = torch.tensor(bucket.shape, dtype=torch.int32,
                      device=portrait.device)
    return torch.where(portrait[..., None], hw.flip(0), hw)


def _pad_leading(x: torch.Tensor, target: int) -> torch.Tensor:
    pad = target - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)


def micro_batched(fn: Callable, micro_bs: int | None, flatten: bool = True):
    """Chunked map (the JAX package's ``lax.map`` form, as a Python loop).

    ``fn`` maps a tuple of tensors with leading axis ``micro_bs`` to a
    tensor or tuple of tensors with the same leading axis.  The wrapper
    flattens the two leading axes of each input (if ``flatten``), pads to a
    multiple of ``micro_bs`` by repeating the last row, runs ``fn`` over
    the chunks in order, then unpads and unflattens.  With
    ``micro_bs=None`` the function is applied in a single chunk.
    """

    def wrapper(*arrays):
        lead = arrays[0].shape[:2] if flatten else arrays[0].shape[:1]
        flat = [a.reshape(-1, *a.shape[len(lead):]) for a in arrays]
        n = flat[0].shape[0]
        bs = micro_bs if micro_bs is not None else n
        bs = min(bs, n)
        n_pad = -(-n // bs) * bs
        flat = [_pad_leading(a, n_pad) for a in flat]

        if n_pad == n and n_pad // bs == 1:
            out = fn(*flat)
        else:
            outs = [fn(*[a[i:i + bs] for a in flat])
                    for i in range(0, n_pad, bs)]
            if isinstance(outs[0], tuple):
                out = tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
            else:
                out = torch.cat(outs, dim=0)

        def _restore(o):
            o = o[:n]
            return o.reshape(*lead, *o.shape[1:])

        if isinstance(out, tuple):
            return tuple(_restore(o) for o in out)
        return _restore(out)

    return wrapper


def transpose_to_landscape(images: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side canonicalization of one (H, W, C) image: returns
    (landscape image, portrait flag)."""
    h, w = images.shape[:2]
    if h > w:
        return np.swapaxes(images, 0, 1), np.True_
    return images, np.False_
