"""Keyframe selection (counterpart of panst3r_tpu/engine/retrieval.py):
linspace, and retrieval by pooled-cosine view similarity + farthest point
sampling + greedy max-overlap ordering, on the host (``run_device``) and
on the device (the serve wire's ``keyframe_mode="retrieval"``).  Both take
the first maximum on ties, as ``np.argmax`` and ``jnp.argmax`` do.  The
trained retrieval head (``RetrievalHead`` + ASMK) waits for a later slice.
"""
from __future__ import annotations

import numpy as np
import torch


def select_keyframes_linspace(n_views: int, num_keyframes) -> list[int]:
    """Uniform keyframe selection."""
    if num_keyframes is None or num_keyframes >= n_views:
        return list(range(n_views))
    return np.linspace(0, n_views - 1, num_keyframes, dtype=int).tolist()


def view_similarity(tokens: torch.Tensor) -> torch.Tensor:
    """tokens (V, N, C) encoder features → (V, V) cosine similarity of
    signed-sqrt mean-pooled descriptors."""
    desc = torch.sign(tokens) * torch.sqrt(torch.abs(tokens))
    desc = desc.mean(dim=1)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1,
                                                       keepdim=True),
                              min=1e-8)
    return desc @ desc.T


def farthest_point_sampling(dist: np.ndarray, n: int, start: int = 0,
                            dist_thresh: float | None = None) -> list[int]:
    """Greedy FPS on a distance matrix; selected views are excluded (−1),
    and with ``dist_thresh`` sampling stops once every view is that close
    to a selected one."""
    N = dist.shape[0]
    n = min(n, N)
    selected = [start]
    min_d = dist[start].astype(np.float64).copy()
    min_d[start] = -1.0
    for _ in range(n - 1):
        nxt = int(np.argmax(min_d))
        if dist_thresh is not None and min_d[nxt] < dist_thresh:
            break
        selected.append(nxt)
        min_d = np.minimum(min_d, dist[nxt])
        min_d[nxt] = -1.0
    return selected


def select_keyframes_retrieval(tokens: torch.Tensor, num_keyframes: int,
                               head=None) -> list[int]:
    """Keyframes by retrieval on the host: FPS over 1 − sim for coverage,
    then greedy max-overlap ordering (connected-first memory build)."""
    if head is not None:
        raise NotImplementedError(
            "the trained retrieval head (RetrievalHead + ASMK) waits for a "
            "later slice of the port; only pooled-cosine retrieval exists")
    sim = view_similarity(tokens.float()).cpu().numpy()
    anchor_idx = farthest_point_sampling(1.0 - sim, num_keyframes)
    sub = sim[np.ix_(anchor_idx, anchor_idx)].astype(np.float64)
    np.fill_diagonal(sub, 0.0)
    order = [int(np.argmax(sub.sum(-1)))]
    sub[:, order[0]] = -np.inf
    while len(order) < len(anchor_idx):
        rows = sub[np.asarray(order)]
        nxt = int(np.unravel_index(np.argmax(rows), rows.shape)[1])
        order.append(nxt)
        sub[:, nxt] = -np.inf
    return [anchor_idx[k] for k in order]


def select_keyframes_retrieval_device(tokens: torch.Tensor,
                                      num_keyframes: int) -> torch.Tensor:
    """The same selection as tensor ops on the tokens' device, with no
    host round trip: (K,) int64 view indices.  Equal to the host path on
    non-degenerate descriptors (f32 here against the host's f64 ordering
    sums only differs on exact ties)."""
    sim = view_similarity(tokens.float())                        # (V, V)
    K = num_keyframes
    dev = sim.device
    dist = 1.0 - sim

    def row(m, i):        # m[i] for a 0-d index tensor, without a sync
        return m.index_select(0, i[None])[0]

    anchors = torch.zeros(K, dtype=torch.int64, device=dev)      # start 0
    min_d = dist[0].clone()
    min_d[0] = -1.0
    for i in range(1, K):
        nxt = torch.argmax(min_d)
        anchors[i] = nxt
        min_d = torch.minimum(min_d, row(dist, nxt)).index_fill(
            0, nxt[None], -1.0)

    sub = sim[anchors][:, anchors] * (1.0 - torch.eye(K, device=dev))
    first = torch.argmax(sub.sum(-1))
    order = torch.zeros(K, dtype=torch.int64, device=dev)
    order[0] = first
    chosen = torch.zeros(K, dtype=torch.bool, device=dev).index_fill(
        0, first[None], True)
    rowmax = row(sub, first)
    neg = torch.full_like(rowmax, -float("inf"))
    for i in range(1, K):
        nxt = torch.argmax(torch.where(chosen, neg, rowmax))
        order[i] = nxt
        chosen = chosen.index_fill(0, nxt[None], True)
        rowmax = torch.maximum(rowmax, row(sub, nxt))
    return anchors[order]
