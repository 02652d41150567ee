"""Online SLAM: an incremental frontend over the token memory and a
pose-graph backend (counterpart of panst3r_tpu/engine/slam.py).

The **frontend** (``IncrementalFrontend``) decodes each frame against the
current keyframe memory (one encoder pass and one render per frame) and
promotes a frame to keyframe, a decoder update that banks its tokens,
when its pooled encoder descriptor is far enough from every keyframe's or
every ``max_interval`` frames.  The memory is sized for ``max_keyframes``
from the start; past that, the oldest unprotected keyframe's window is
reused (``models/memory.py::begin_overwrite``), so a dead window can sit
inside the live range until it is refilled.

The **backend** refines poses offline: ``refine_scene_poses`` registers
each view's local pointmap onto its global one (the demo's Procrustes),
measures relative poses along the edges and runs an on-manifold
Gauss-Newton over SE(3) (``pose_graph_gauss_newton``, 6×6-block normal
equations).  The Hessian is assembled as a product of the edge incidence
matrix with itself, not by scatter-adds, so two runs on the card give the
same bits.  The backend runs on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from panst3r_torch.core.device import resolve_device
from panst3r_torch.engine.pose import rigid_points_registration
from panst3r_torch.models import memory as memlib

# ----------------------------------------------------------- SE(3) utils --


def hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], -1),
        torch.stack([wz, zeros, -wx], -1),
        torch.stack([-wy, wx, zeros], -1),
    ], -2)


def _eye(n: int, like: torch.Tensor, shape=()) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(
        *shape, n, n)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi (..., 6) [rho, phi] → (..., 4, 4) SE(3)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta = torch.clamp(torch.linalg.vector_norm(phi, dim=-1, keepdim=True),
                        min=1e-12)
    K = hat(phi / theta)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    th = theta[..., None]
    eye = _eye(3, xi, K.shape[:-2])
    KK = K @ K
    R = eye + s * K + (1 - c) * KK
    # the left Jacobian: V = I + ((1-cosθ)/θ)K + ((θ-sinθ)/θ)K²
    V = eye + ((1 - c) / th) * K + ((th - s) / th) * KK
    T = torch.zeros(*xi.shape[:-1], 4, 4, dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def so3_log(R: torch.Tensor) -> torch.Tensor:
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1) / 2, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    scale = torch.where(
        theta < 1e-6, torch.full_like(theta, 0.5),
        theta / (2.0 * torch.sin(torch.clamp(theta, min=1e-12))))
    return w * scale[..., None]


def se3_log(T: torch.Tensor) -> torch.Tensor:
    phi = so3_log(T[..., :3, :3])
    theta = torch.clamp(torch.linalg.vector_norm(phi, dim=-1, keepdim=True),
                        min=1e-12)
    K = hat(phi / theta)
    th = theta[..., None]
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    eye = _eye(3, T, K.shape[:-2])
    Vinv = eye - 0.5 * th * K \
        + (1 - (th * (1 + c)) / (2 * s + 1e-12)) * (K @ K)
    small = (theta < 1e-6)[..., None]
    Vinv = torch.where(small, eye - 0.5 * hat(phi), Vinv)
    rho = (Vinv @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ T[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


# --------------------------------------------------------- pose graph GN --


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Ad(T) (..., 6, 6) in [rho, phi] order: [[R, hat(t)·R], [0, R]]."""
    R = T[..., :3, :3]
    top = torch.cat([R, hat(T[..., :3, 3]) @ R], -1)
    bot = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bot], -2)


def se3_ad(xi: torch.Tensor) -> torch.Tensor:
    """ad(xi) (..., 6, 6): [[hat(phi), hat(rho)], [0, hat(phi)]]."""
    hp, hr = hat(xi[..., 3:]), hat(xi[..., :3])
    top = torch.cat([hp, hr], -1)
    bot = torch.cat([torch.zeros_like(hp), hp], -1)
    return torch.cat([top, bot], -2)


def jl_inv(r: torch.Tensor) -> torch.Tensor:
    """The inverse left Jacobian of SE(3) to first order: I − ½·ad(r)."""
    return _eye(6, r, r.shape[:-1]) - 0.5 * se3_ad(r)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.inference_mode()
def pose_graph_gauss_newton(poses, edges, rel_meas, weights=None,
                            iters: int = 10, damping: float = 1e-6,
                            device=None):
    """On-manifold Gauss-Newton over SE(3) poses with relative-pose edges.

    poses (V, 4, 4) initial cam2world; edges (E, 2) int (i, j); rel_meas
    (E, 4, 4) measured T_j⁻¹·T_i; weights (E,).  Pose 0 is the gauge
    (held fixed).  Returns (refined poses (V, 4, 4), costs (iters,)) on
    the device.

    Residual r_e = log(A·T_i), A = (T_j·Z)⁻¹, under left perturbations
    T ← exp(ξ)·T: J_i = Jl⁻¹(r)·Ad(A), J_j = −J_i.  With the incidence
    matrix D (E, V) (+1 at i, −1 at j) the normal equations are
    H = Σ_e D_e·D_eᵀ ⊗ JᵀWJ and g = Σ_e D_e ⊗ JᵀWr, products with no
    scatter-add (the JAX package adds the blocks at [i, i], [j, j],
    [i, j], [j, i])."""
    dev = resolve_device(device)
    poses = _f32(poses, dev)
    rel_meas = _f32(rel_meas, dev)
    edges = torch.as_tensor(edges, device=dev).long()
    V, E = poses.shape[0], edges.shape[0]
    weights = (torch.ones(E, device=dev) if weights is None
               else _f32(weights, dev))
    i, j = edges[:, 0], edges[:, 1]
    inc = (torch.nn.functional.one_hot(i, V)
           - torch.nn.functional.one_hot(j, V)).float()        # (E, V)
    eye = torch.eye(6 * V, device=dev)
    costs = []
    for _ in range(iters):
        A = se3_inv(poses[j] @ rel_meas)                       # (E, 4, 4)
        r = se3_log(A @ poses[i])                              # (E, 6)
        J = jl_inv(r) @ se3_adjoint(A)                         # J_i = −J_j
        Jt = J.transpose(-1, -2)
        JtJ = (Jt @ J) * weights[:, None, None]
        Jtr = (Jt @ r[..., None])[..., 0] * weights[:, None]
        # H (V, 6, V, 6) and g (V, 6) as incidence products
        DD = inc[:, :, None] * inc[:, None, :]                 # (E, V, V)
        H = (DD.reshape(E, V * V).T @ JtJ.reshape(E, 36)) \
            .reshape(V, V, 6, 6).permute(0, 2, 1, 3)
        g = inc.T @ Jtr
        # gauge: pin node 0
        H[0] = 0.0
        H[:, :, 0] = 0.0
        H[0, :, 0] = torch.eye(6, device=dev)
        g[0] = 0.0
        Hf = H.reshape(6 * V, 6 * V) + damping * eye
        delta = -torch.linalg.solve(Hf, g.reshape(-1)).reshape(V, 6)
        costs.append((weights * (r * r).sum(-1)).sum())
        poses = se3_exp(delta) @ poses
    return poses, torch.stack(costs)


def measure_relative_poses(pts_local: torch.Tensor, pts_global: torch.Tensor,
                           conf: torch.Tensor, edges: torch.Tensor):
    """Edge measurements from pointmap registration: per view T_i =
    Procrustes(local_i → global_i) weighted by conf − 1 (the demo's
    recipe); per edge (i, j) rel = T_j⁻¹·T_i.  Returns (init poses
    (V, 4, 4), rel (E, 4, 4), edge weights: the mean confidence of the
    two views)."""
    V = conf.shape[0]
    R, t = rigid_points_registration(pts_local.reshape(V, -1, 3),
                                     pts_global.reshape(V, -1, 3),
                                     conf.reshape(V, -1) - 1.0)
    T = torch.zeros(V, 4, 4, dtype=torch.float32, device=conf.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    T[:, 3, 3] = 1.0
    rel = se3_inv(T[edges[:, 1]]) @ T[edges[:, 0]]
    mean = conf.reshape(V, -1).mean(-1)
    return T, rel, (mean[edges[:, 0]] + mean[edges[:, 1]]) / 2.0


@torch.inference_mode()
def refine_scene_poses(pointmaps: dict, edges: Optional[np.ndarray] = None,
                       iters: int = 10, device=None):
    """The backend: registration init, then pose-graph Gauss-Newton.

    pointmaps: {pts3d (V, H, W, 3), pts3d_local, conf (V, H, W)} (numpy or
    tensors); edges default to the chain plus loop closures to view 0.
    Returns (refined (V, 4, 4), init (V, 4, 4), costs (iters,)) on the
    device."""
    dev = resolve_device(device)
    conf = _f32(pointmaps["conf"], dev)
    V = conf.shape[0]
    if edges is None:
        edges = np.asarray([(i, i + 1) for i in range(V - 1)]
                           + [(0, i) for i in range(2, V)], np.int64)
    edges = torch.as_tensor(edges, device=dev).long()
    T0, rel, w = measure_relative_poses(
        _f32(pointmaps["pts3d_local"], dev), _f32(pointmaps["pts3d"], dev),
        conf, edges)
    refined, costs = pose_graph_gauss_newton(T0, edges, rel, w, iters=iters,
                                             device=dev)
    return refined, T0, costs


# ------------------------------------------------------------- frontend --


@dataclasses.dataclass
class FrontendState:
    """Online state: the token memory and its bookkeeping."""

    mem: object
    keyframe_ids: list
    kf_descriptors: list       # pooled encoder descriptors, one a keyframe
    slots: list = dataclasses.field(default_factory=list)  # memory window
    frame_count: int = 0


class IncrementalFrontend:
    """Per-frame processing against a growing keyframe memory on the
    engine's device.  A frame becomes a keyframe (a decoder update into
    the memory) when the cosine of its descriptor to every keyframe's is
    below ``sim_threshold``, or ``max_interval`` frames after the last
    keyframe.  The memory holds ``max_keyframes`` windows of the engine's
    ``n_tokens``; the first ``protected`` keyframes are never evicted,
    and a keyframe past capacity reuses the oldest other one's window."""

    def __init__(self, engine, sim_threshold: float = 0.85,
                 max_interval: int = 10, max_keyframes: int = 64,
                 protected: int = 2):
        self.engine = engine
        self.sim_threshold = sim_threshold
        self.max_interval = max_interval
        self.max_keyframes = max_keyframes
        self.protected = protected
        self.state: Optional[FrontendState] = None
        self._since_kf = 0
        self._copy_stream = None

    def _descriptor(self, x):
        d = (torch.sign(x) * torch.sqrt(torch.abs(x))).mean(0)
        return d / torch.clamp(torch.linalg.vector_norm(d), min=1e-8)

    def _encode(self, image):
        eng = self.engine
        x, pos = eng.encode_batch(torch.as_tensor(np.asarray(image)[None],
                                                  device=eng.device))
        return x, pos, self._descriptor(x[0].float())

    def _render(self, x, pos):
        return self.engine.render_batch(x, pos, self.state.mem)[0][0]

    def _bootstrap(self, x, pos, desc, frame_id):
        """Frame 0: kept until frame 1 arrives (the memory starts from a
        pair of views)."""
        self._pending = (x, pos)
        self.state = FrontendState(mem=None, keyframe_ids=[frame_id],
                                   kf_descriptors=[desc])

    @torch.inference_mode()
    def process(self, image: np.ndarray, frame_id: int) -> dict:
        """image (H, W, 3) canonical, uint8 or normalized float.  Returns
        {is_keyframe, pointmaps_raw (H, W, 7) f32 numpy, None for the
        first frame}."""
        x, pos, desc = self._encode(image)
        if self.state is None:
            self._bootstrap(x, pos, desc, frame_id)
            return {"is_keyframe": True, "pointmaps_raw": None}
        if self.state.mem is None:
            return {"is_keyframe": True,
                    "pointmaps_raw": _numpy(self._init_memory_pair(
                        x, pos, desc, frame_id))}
        pm = self._render(x, pos)
        make_kf = self._maybe_insert(x, pos, desc, frame_id,
                                     float(self._sims_max(desc)))
        return {"is_keyframe": make_kf, "pointmaps_raw": _numpy(pm)}

    @torch.inference_mode()
    def render(self, image: np.ndarray) -> np.ndarray:
        """(H, W, 7) raw pointmaps of ``image`` against the current
        memory, which is left as it is (the first frame's, once the
        session is over)."""
        x, pos, _ = self._encode(image)
        return _numpy(self._render(x, pos))

    def _sims_max(self, desc):
        """The largest cosine to the keyframe descriptors, on the
        device."""
        return (torch.stack(self.state.kf_descriptors) @ desc).max()

    def _maybe_insert(self, x, pos, desc, frame_id, sims_max: float) -> bool:
        """The keyframe policy and the memory update (process and stream
        share it)."""
        eng = self.engine
        st = self.state
        st.frame_count += 1
        self._since_kf += 1
        make_kf = (sims_max < self.sim_threshold
                   or self._since_kf >= self.max_interval)
        if make_kf:
            N = eng.n_tokens
            if len(st.keyframe_ids) >= self.max_keyframes:
                # evict the oldest unprotected keyframe; its window takes
                # the new one
                victim = self.protected
                slot = st.slots.pop(victim)
                st.keyframe_ids.pop(victim)
                st.kf_descriptors.pop(victim)
                memlib.begin_overwrite(st.mem, slot * N, N)
            else:
                slot = len(st.keyframe_ids)
            eng.model.decoder_update(x[None], pos[None], st.mem, eng.grid)
            occupied = max(len(st.slots) + 1, slot + 1)
            memlib.end_overwrite(st.mem, occupied * N)
            st.keyframe_ids.append(frame_id)
            st.kf_descriptors.append(desc)
            st.slots.append(slot)
            self._since_kf = 0
        return bool(make_kf)

    def _fetch(self, t: torch.Tensor):
        """Start the copy of ``t`` to the host: on the card into pinned
        memory on a side stream (after the work that makes ``t``), so it
        overlaps whatever is launched next; returns (host tensor, event to
        wait on, or None on the CPU)."""
        if t.device.type != "cuda":
            return t, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(t.device)
        side = self._copy_stream
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(side):
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        t.record_stream(side)
        return host, done

    @staticmethod
    def _fetched(host, done):
        if done is not None:
            done.synchronize()
        return host

    def stream(self, frames, start_id: int = 0, fetch_dtype=None):
        """Pipelined processing; yields one dict per frame, in order, with
        the same keyframe decisions and pointmaps as ``process``.  Frame
        t's pointmaps and its similarity go to the host while frame t+1 is
        encoded; t's keyframe decision is taken after t+1's encode is
        launched and before t+1's render, so t+1 renders against the
        memory ``process`` would give it.  ``fetch_dtype`` (a torch dtype,
        e.g. ``torch.float16``) casts the pointmaps on the device before
        the copy."""
        pending = None

        def finish(p):
            fid, x, pos, desc, sims, pm = p
            make_kf = self._maybe_insert(x, pos, desc, fid,
                                         float(self._fetched(*sims)))
            return {"frame_id": fid, "is_keyframe": make_kf,
                    "pointmaps_raw": _numpy(self._fetched(*pm))}

        for i, image in enumerate(frames):
            fid = start_id + i
            with torch.inference_mode():
                x, pos, desc = self._encode(image)
                if self.state is None:
                    self._bootstrap(x, pos, desc, fid)
                    out = {"frame_id": fid, "is_keyframe": True,
                           "pointmaps_raw": None}
                elif self.state.mem is None:
                    out = {"frame_id": fid, "is_keyframe": True,
                           "pointmaps_raw": _numpy(self._init_memory_pair(
                               x, pos, desc, fid))}
                else:
                    out = finish(pending) if pending is not None else None
                    pm = self._render(x, pos)
                    if fetch_dtype is not None:
                        pm = pm.to(fetch_dtype)
                    pending = (fid, x, pos, desc,
                               self._fetch(self._sims_max(desc)),
                               self._fetch(pm))
            if out is not None:
                yield out
        if pending is not None:
            with torch.inference_mode():
                out = finish(pending)
            yield out

    def _init_memory_pair(self, x, pos, desc, frame_id):
        """Frame 1: the memory from the kept frame 0 and this one, then
        this frame rendered against it."""
        eng = self.engine
        c = eng.model.config
        px, ppos = self._pending
        self._pending = None
        mem = memlib.init_memory(c.decoder.depth, 1,
                                 self.max_keyframes * eng.n_tokens,
                                 c.decoder.dim, dtype=eng.dtype,
                                 device=eng.device)
        eng.model.decoder_update(torch.cat([px, x])[None],
                                 torch.cat([ppos, pos])[None], mem, eng.grid)
        st = self.state
        st.mem = mem
        st.keyframe_ids.append(frame_id)
        st.kf_descriptors.append(desc)
        st.slots = [0, 1]
        return self._render(x, pos)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.cpu().numpy()
