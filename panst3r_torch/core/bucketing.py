"""Resolution buckets (counterpart of panst3r_tpu/core/bucketing.py:36-60).

Images are stored landscape (W >= H); a per-view ``portrait`` flag records
that the semantic image is the transpose.  The default bucket list and the
multi-bucket helpers wait for a later slice.
"""
from __future__ import annotations

import dataclasses


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
