"""Pointmap-anchored bundle adjustment with a Schur-complement reduction
(counterpart of panst3r_tpu/engine/ba.py).

Refines keyframe poses T_i ∈ SE(3) and a sparse set of 3D anchors X_a
against the network's per-view local pointmaps:

    r_o = w_o · (T_{v(o)} · x_o − X_{a(o)})      (one observation o per
                                                   sampled pixel)

Anchors are voxel-merged global points (``voxel_anchors``), so views that
see the same surface pull on the same variables.  Each observation
touches one pose, so the camera-camera Hessian is block-diagonal and all
coupling goes through the anchors, whose blocks are s·I₃: eliminating
them leaves the dense reduced camera system S = H_cc − U W⁻¹ Uᵀ of size
(6K, 6K).

Every accumulation over observations is a segment sum (``segment_sum``:
``index_put_`` with ``accumulate=True``, which sorts the indices and adds
each segment in a fixed order), so two runs on the card give the same
bits.  Left perturbations as in ``engine/slam.py``: T ← exp(ξ)·T,
d(T·x)/dξ = [I | −hat(T·x)].  The backend runs on the card unless
``device="cpu"``; ``bundle_adjust_sharded`` (observations over devices)
is not ported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from panst3r_torch.core.device import resolve_device
from panst3r_torch.engine.slam import hat, se3_exp

__all__ = ["bundle_adjust", "voxel_anchors", "refine_scene_ba"]


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: out[s] = Σ values[o] over segment_ids[o] =
    s, by ``index_put_(accumulate=True)`` (on the card: sorted by
    segment, each added in order; no atomics)."""
    out = torch.zeros((num_segments, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_put_((segment_ids,), values, accumulate=True)


def _gn_partials(poses, anchors, obs_view, obs_anchor, x_local, w,
                 K: int, A: int):
    """The Gauss-Newton sums over observations: (Hc (K, 6, 6), bc (K, 6),
    U (K·A, 6, 3), s (A,), ba (A, 3), cost ())."""
    R = poses[obs_view, :3, :3]                       # (O, 3, 3)
    t = poses[obs_view, :3, 3]
    y = (R @ x_local[..., None])[..., 0] + t          # (O, 3) T·x
    r = (y - anchors[obs_anchor]) * w[:, None]        # (O, 3)

    # J_pose = w·[I | −hat(y)] (O, 3, 6); J_point = −w·I₃
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(
        y.shape[0], 3, 3)
    Jp = torch.cat([eye, -hat(y)], -1) * w[:, None, None]
    JpT = Jp.transpose(-1, -2)                        # (O, 6, 3)

    Hc = segment_sum(JpT @ Jp, obs_view, K)
    bc = segment_sum((JpT @ r[..., None])[..., 0], obs_view, K)
    # U_{v,a} = Σ_o Jpᵀ·J_point = −w·Jpᵀ, (6, 3) per (view, anchor)
    U = segment_sum(-w[:, None, None] * JpT, obs_view * A + obs_anchor,
                    K * A)
    s = segment_sum(w * w, obs_anchor, A)             # H_aa = s·I₃
    ba = segment_sum(-w[:, None] * r, obs_anchor, A)
    return Hc, bc, U, s, ba, (r * r).sum()


def _gn_update(poses, anchors, Hc, bc, U, s, ba, damping: float):
    """The Schur-reduced update from the sums."""
    K, A = poses.shape[0], anchors.shape[0]
    dev = poses.device
    U = U.reshape(K, A, 6, 3)
    winv = 1.0 / (s + damping)                        # (A,)

    # S = blockdiag(Hc) − Σ_a winv_a·U_ia·U_jaᵀ ; b = bc − Σ_a winv·U·ba
    Uf = U.permute(0, 2, 1, 3).reshape(K * 6, A * 3)
    Uw = (U * winv[None, :, None, None]).permute(0, 2, 1, 3) \
        .reshape(K * 6, A * 3)
    S = -(Uw @ Uf.T).reshape(K, 6, K, 6)
    idx = torch.arange(K, device=dev)
    S[idx, :, idx, :] += Hc
    br = bc - (Uw @ ba.reshape(A * 3)).reshape(K, 6)

    # gauge: pin pose 0
    S[0] = 0.0
    S[:, :, 0] = 0.0
    S[0, :, 0] = torch.eye(6, device=dev)
    br[0] = 0.0

    Sf = S.reshape(6 * K, 6 * K) + damping * torch.eye(6 * K, device=dev)
    dc = -torch.linalg.solve(Sf, br.reshape(-1)).reshape(K, 6)
    # back-substitution: δa = −winv·(ba + Σ_i U_iaᵀ·δc_i)
    da = -winv[:, None] * (ba + (dc.reshape(1, K * 6) @ Uf)
                           .reshape(A, 3))
    return se3_exp(dc) @ poses, anchors + da


@torch.inference_mode()
def bundle_adjust(poses, anchors, obs_view, obs_anchor, x_local, weights,
                  iters: int = 8, damping: float = 1e-4, device=None):
    """poses (K, 4, 4) cam2world; anchors (A, 3); obs_view / obs_anchor
    (O,) int; x_local (O, 3) per-view local points; weights (O,) ≥ 0
    (0 = padding).  Returns (poses, anchors, costs (iters,)) on the
    device."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    poses, anchors = f32(poses), f32(anchors)
    obs_view = torch.as_tensor(obs_view, device=dev).long()
    obs_anchor = torch.as_tensor(obs_anchor, device=dev).long()
    x_local, weights = f32(x_local), f32(weights)
    K, A = poses.shape[0], anchors.shape[0]
    costs = []
    for _ in range(iters):
        *parts, cost = _gn_partials(poses, anchors, obs_view, obs_anchor,
                                    x_local, weights, K, A)
        poses, anchors = _gn_update(poses, anchors, *parts, damping)
        costs.append(cost)
    return poses, anchors, torch.stack(costs)


def voxel_anchors(pts_global: np.ndarray, conf: np.ndarray,
                  voxel: float, max_anchors: Optional[int] = None):
    """Shared anchors by voxel-merging global points (numpy, on the host).

    pts_global (K, N, 3) per-view global samples; conf (K, N).  The points
    of one voxel become one anchor at their conf-weighted mean; with
    ``max_anchors`` only the voxels with the most valid observations are
    kept.  Returns (anchors (A, 3) f32, obs_view (O,), obs_anchor (O,),
    valid (K·N,) bool); ``valid`` selects the caller's flattened
    per-observation arrays."""
    K, N = conf.shape
    flat = pts_global.reshape(-1, 3)
    keys = np.floor(flat / voxel).astype(np.int64)
    # the inverse's shape differs across numpy 2.0.x: flatten it
    anchor_of = np.unique(keys, axis=0, return_inverse=True)[1].reshape(-1)
    conf_ok = conf.reshape(-1) > 0
    # rank voxels by their VALID observations: conf-0 points buy no slot
    counts = np.bincount(anchor_of[conf_ok],
                         minlength=int(anchor_of.max()) + 1)
    if max_anchors is not None and counts.size > max_anchors:
        keep = np.argsort(-counts)[:max_anchors]
        remap = np.full(counts.size, -1, np.int64)
        remap[keep] = np.arange(keep.size)
        anchor_of = remap[anchor_of]
    valid = (anchor_of >= 0) & conf_ok
    A = int(anchor_of[valid].max()) + 1 if valid.any() else 0
    w = np.where(valid, conf.reshape(-1), 0.0).astype(np.float64)
    sums = np.zeros((A, 3))
    wsum = np.zeros(A)
    np.add.at(sums, anchor_of[valid], flat[valid] * w[valid, None])
    np.add.at(wsum, anchor_of[valid], w[valid])
    anchors = (sums / np.maximum(wsum, 1e-12)[:, None]).astype(np.float32)
    obs_view = np.repeat(np.arange(K, dtype=np.int32), N)
    return (anchors, obs_view[valid], anchor_of[valid].astype(np.int32),
            valid)


def refine_scene_ba(pointmaps: dict, poses_init, stride: int = 8,
                    voxel: float = 0.05, iters: int = 8,
                    damping: float = 1e-4, conf_threshold: float = 1.5,
                    max_anchors: Optional[int] = 8192, device=None):
    """BA of recovered keyframe poses against the network's pointmaps.

    pointmaps: {'pts3d' (K, H, W, 3) global, 'pts3d_local', 'conf'
    (K, H, W)} (numpy; ``InferenceEngine.run``'s postprocessed output);
    poses_init (K, 4, 4) cam2world.  Every ``stride``-th pixel is an
    observation; pixels with conf below ``conf_threshold`` (conf = 1 +
    exp(raw) > 1, so the threshold must exceed 1 to drop any) are left
    out.  Returns (poses (K, 4, 4), costs (iters,)) as numpy."""
    pts_g = np.asarray(pointmaps["pts3d"])[:, ::stride, ::stride]
    pts_l = np.asarray(pointmaps["pts3d_local"])[:, ::stride, ::stride]
    conf = np.asarray(pointmaps["conf"])[:, ::stride, ::stride]
    K = pts_g.shape[0]
    pts_g = pts_g.reshape(K, -1, 3)
    pts_l = pts_l.reshape(K, -1, 3)
    conf = conf.reshape(K, -1)
    conf = np.where(conf >= conf_threshold, conf, 0.0)

    anchors, obs_view, obs_anchor, valid = voxel_anchors(
        pts_g, conf, voxel, max_anchors)
    x_local = pts_l.reshape(-1, 3)[valid]
    w = np.sqrt(conf.reshape(-1))[valid].astype(np.float32)
    poses, _, costs = bundle_adjust(
        np.asarray(poses_init, np.float32), anchors, obs_view, obs_anchor,
        x_local.astype(np.float32), w, iters=iters, damping=damping,
        device=device)
    return poses.cpu().numpy(), costs.cpu().numpy()
