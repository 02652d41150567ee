"""Point sampling for the mask losses (counterpart of
panst3r_tpu/ops/sampling.py): PointRend-style bilinear sampling at
normalized points and uncertainty-biased point selection.

``point_sample`` has torch ``grid_sample`` semantics with
``align_corners=False`` and zero padding (coordinates in [0, 1]² map to
pixel centres by x·W − 0.5; taps outside the map contribute 0), written as
the JAX package's four weighted taps rather than ``F.grid_sample``, so the
sums are the same.  The random draws are taken from an explicit
``torch.Generator``, or given by the caller (the tests pass JAX's draws).
"""
from __future__ import annotations

import torch


def _taps(x, y, H: int, W: int):
    """[(flat index, weight)] of the four bilinear taps at pixel
    coordinates (x, y); out-of-bounds taps get weight 0."""
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    out = []
    for xi, yi, w in ((x0, y0, (1 - wx1) * (1 - wy1)),
                      (x0 + 1, y0, wx1 * (1 - wy1)),
                      (x0, y0 + 1, (1 - wx1) * wy1),
                      (x0 + 1, y0 + 1, wx1 * wy1)):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xc = torch.clamp(xi, 0, W - 1).long()
        yc = torch.clamp(yi, 0, H - 1).long()
        out.append((yc * W + xc, w * inb))
    return out


def point_sample(features: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """features (N, H, W) or (N, C, H, W); points (N, P, 2) as (x, y) in
    [0, 1]².  Returns (N, P) or (N, C, P)."""
    squeeze = features.ndim == 3
    if squeeze:
        features = features[:, None]
    N, C, H, W = features.shape
    flat = features.reshape(N, C, H * W)
    out = 0
    for idx, w in _taps(points[..., 0] * W - 0.5, points[..., 1] * H - 0.5,
                        H, W):
        vals = torch.gather(flat, 2, idx[:, None].expand(N, C, -1))
        out = out + vals * w[:, None]
    return out[:, 0] if squeeze else out


def point_sample_shared(features: torch.Tensor,
                        points: torch.Tensor) -> torch.Tensor:
    """``point_sample`` for one point set shared by every row: features
    (K, H, W), points (P, 2) as (x, y).  Returns (K, P), equal to
    ``point_sample(features, points expanded to (K, P, 2))``."""
    K, H, W = features.shape
    flat = features.reshape(K, H * W)
    out = 0
    for idx, w in _taps(points[:, 0] * W - 0.5, points[:, 1] * H - 0.5, H, W):
        out = out + flat[:, idx] * w[None]
    return out


def uncertain_point_coords(logits: torch.Tensor, num_points: int,
                           oversample_ratio: float,
                           importance_sample_ratio: float,
                           generator: torch.Generator | None = None,
                           draws=None) -> torch.Tensor:
    """Uncertainty-biased points (reference panoptic.py:410-463).  logits
    (N, H, W); uncertainty = −|logit| at the sampled points; the most
    uncertain ``importance_sample_ratio·num_points`` of
    ``oversample_ratio·num_points`` uniform candidates, then uniform points
    for the rest.  ``draws``: the (candidates (N, S, 2), extra (N, R, 2))
    uniform draws, else drawn from ``generator``.  Returns (N, P, 2)."""
    N = logits.shape[0]
    num_sampled = int(num_points * oversample_ratio)
    num_uncertain = int(importance_sample_ratio * num_points)
    num_random = num_points - num_uncertain
    if draws is None:
        def uniform(n):
            return torch.rand((N, n, 2), generator=generator,
                              device=logits.device)
        draws = (uniform(num_sampled), uniform(num_random))
    coords, rand = draws
    uncertainty = -torch.abs(point_sample(logits, coords))
    idx = top_k_indices(uncertainty, num_uncertain)
    picked = torch.gather(coords, 1, idx[..., None].expand(-1, -1, 2))
    if num_random > 0:
        picked = torch.cat([picked, rand], dim=1)
    return picked


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last dim, ties to the
    lower index as ``lax.top_k`` breaks them (``torch.topk`` does not
    promise an order among ties): a stable descending sort."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]
