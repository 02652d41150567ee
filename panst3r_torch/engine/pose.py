"""Camera recovery from pointmaps: focal estimation and pose registration
(counterpart of panst3r_tpu/engine/pose.py, the main path's step 9).

- ``estimate_focal_weiszfeld``: robust (L1) focal from the camera-frame
  pointmap by Weiszfeld's iteratively reweighted least squares (dust3r
  ``estimate_focal_knowing_depth(..., focal_mode='weiszfeld')``).
- ``rigid_points_registration``: weighted Kabsch (roma's Procrustes
  without scaling), R and t minimizing Σ w ||R·src + t − dst||², with the
  determinant's sign fixed so that R is a rotation.

Both are batched over leading dims with plain tensor ops (the JAX package
vmaps them outside any kernel); ``torch.linalg.svd`` does the 3×3 SVDs.
"""
from __future__ import annotations

import torch


def estimate_focal_weiszfeld(pts3d_local: torch.Tensor, pp: torch.Tensor,
                             iterations: int = 10) -> torch.Tensor:
    """pts3d_local (..., H, W, 3) camera-frame pointmaps; pp (2,) principal
    point (x, y).  Returns the focal in pixels, shape (...)."""
    H, W = pts3d_local.shape[-3:-1]
    dev = pts3d_local.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - pp[0]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - pp[1]
    u = u.expand(H, W).reshape(-1)
    v = v.expand(H, W).reshape(-1)
    pts = pts3d_local.reshape(*pts3d_local.shape[:-3], H * W, 3)
    z = torch.clamp(pts[..., 2], min=1e-6)
    xz = pts[..., 0] / z
    yz = pts[..., 1] / z
    dot_num = u * xz + v * yz
    dot_den = xz * xz + yz * yz
    focal = dot_num.sum(-1) / torch.clamp(dot_den.sum(-1), min=1e-8)
    for _ in range(iterations):
        f = focal[..., None]
        dist = torch.sqrt((f * xz - u) ** 2 + (f * yz - v) ** 2)
        w = 1.0 / torch.clamp(dist, min=1e-8)
        focal = (w * dot_num).sum(-1) \
            / torch.clamp((w * dot_den).sum(-1), min=1e-8)
    return focal


def rigid_points_registration(src: torch.Tensor, dst: torch.Tensor,
                              weights: torch.Tensor):
    """Weighted Kabsch.  src/dst (..., N, 3); weights (..., N), clipped to
    ≥ 0.  Returns (R (..., 3, 3), t (..., 3))."""
    w = torch.clamp(weights, min=0.0)
    w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8))[..., None]
    mu_s = (w * src).sum(-2)
    mu_d = (w * dst).sum(-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = torch.matmul((w * sc).transpose(-1, -2), dc)         # (..., 3, 3)
    U, _, Vh = torch.linalg.svd(cov)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(torch.matmul(V, Ut))
    S = torch.ones(*det.shape, 3, dtype=cov.dtype, device=cov.device)
    S[..., 2] = torch.sign(det)
    R = torch.matmul(V * S[..., None, :], Ut)
    t = mu_d - torch.matmul(R, mu_s[..., None])[..., 0]
    return R, t


def recover_cameras(pointmaps: dict, true_shape) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Per-view focals (V,) and cam2world poses (V, 4, 4) from postprocessed
    pointmaps {pts3d, pts3d_local (V, H, W, 3), conf (V, H, W)}: Weiszfeld
    focal from the local pointmap, then the local → global registration
    weighted by conf − 1 (the reference demo's recipe)."""
    pts_l = pointmaps["pts3d_local"]
    pts_g = pointmaps["pts3d"]
    conf = pointmaps["conf"]
    V, H, W = conf.shape
    pp = torch.tensor([W / 2.0, H / 2.0], dtype=torch.float32,
                      device=conf.device)
    focals = estimate_focal_weiszfeld(pts_l, pp)
    R, t = rigid_points_registration(pts_l.reshape(V, -1, 3),
                                     pts_g.reshape(V, -1, 3),
                                     conf.reshape(V, -1) - 1.0)
    c2w = torch.zeros(V, 4, 4, dtype=torch.float32, device=conf.device)
    c2w[:, :3, :3] = R
    c2w[:, :3, 3] = t
    c2w[:, 3, 3] = 1.0
    return focals, c2w


def geotrf(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply an SE(3) (4, 4) to (..., 3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]
