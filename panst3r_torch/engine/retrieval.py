"""Keyframe selection (counterpart of panst3r_tpu/engine/retrieval.py):
linspace, and retrieval by view similarity + farthest point sampling +
greedy max-overlap ordering, on the host (``run_device``) and on the
device (the serve wire's ``keyframe_mode="retrieval"``).  Both take the
first maximum on ties, as ``np.argmax`` and ``jnp.argmax`` do.

Two similarities:

- ``view_similarity``: the cosine of signed-sqrt mean-pooled descriptors
  (no weights; the default, and the only one on the device);
- ``RetrievalHead`` + ``asmk_similarity``: the trained path (must3r's
  retrieval model without its backbone, and an ASMK codebook).  The
  whitening and projector products and the top-1 codebook assignment are
  tensor ops on the tokens' device; the per-word aggregation of the
  binarized residuals and the sparse word intersection run on the host in
  numpy, as in the JAX package.  ``port_checkpoint.port_retrieval_checkpoint``
  maps a retrieval checkpoint onto ``RetrievalHead``'s fields.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


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
                               head: Optional["RetrievalHead"] = None
                               ) -> list[int]:
    """Keyframes by retrieval on the host: FPS over 1 − sim for coverage,
    then greedy max-overlap ordering (connected-first memory build).  The
    similarity is ASMK's when ``head`` carries a codebook, else the pooled
    cosine."""
    if head is not None and head.codebook is not None:
        sim = asmk_similarity(head, tokens)
    else:
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


@dataclasses.dataclass
class RetrievalHead:
    """The trained retrieval projection: prewhiten (an affine map stored as
    (W (D, Dw), b (Dw,)): x ← x @ W + b), the projector MLP with exact GELU
    between its layers (optionally residual), postwhiten, then L2
    normalization; the per-token weights are the L2 norms of the tokens
    before projection.  Arrays may be numpy or tensors; they meet the
    tokens on the tokens' device in f32."""

    prewhiten: Optional[tuple] = None
    projector: Sequence[tuple] = ()
    residual: bool = False
    postwhiten: Optional[tuple] = None
    codebook: Optional[np.ndarray] = None    # (words, D') ASMK centroids
    alpha: float = 3.0                       # ASMK selectivity exponent
    similarity_threshold: float = 0.0

    @staticmethod
    def _affine(x, wb):
        W, b = (torch.as_tensor(a, dtype=torch.float32, device=x.device)
                for a in wb)
        return x @ W + b

    def project(self, tokens: torch.Tensor):
        """tokens (..., N, D) → (projected (..., N, D'), weights (..., N))."""
        x = tokens.float()
        w = torch.linalg.vector_norm(x, dim=-1)
        if self.prewhiten is not None:
            x = self._affine(x, self.prewhiten)
        if self.projector:
            h = x
            for i, wb in enumerate(self.projector):
                h = self._affine(h, wb)
                if i + 1 < len(self.projector):
                    h = F.gelu(h)
            x = x + h if (self.residual and h.shape == x.shape) else h
        if self.postwhiten is not None:
            x = self._affine(x, self.postwhiten)
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                            min=1e-8)
        return x, w

    def assign_and_binarize(self, tokens: torch.Tensor):
        """Top-1 codebook words and binarized residuals (ASMK*): tokens
        (V, N, D) → (words (V, N) int64, bits (V, N, D') ±1 int8, weights
        (V, N)).  The nearest centroid in L2 is the largest x·c − ‖c‖²/2."""
        if self.codebook is None:
            raise ValueError("no ASMK codebook loaded")
        x, w = self.project(tokens)
        C = torch.as_tensor(self.codebook, dtype=torch.float32,
                            device=x.device)
        Cn = C / torch.clamp(torch.linalg.vector_norm(C, dim=-1,
                                                      keepdim=True), min=1e-8)
        score = x @ C.T - 0.5 * (C * C).sum(-1)
        words = torch.argmax(score, dim=-1)
        bits = torch.where(x - Cn[words] >= 0, 1, -1).to(torch.int8)
        return words, bits, w


def asmk_similarity(head: RetrievalHead, tokens: torch.Tensor) -> np.ndarray:
    """(V, N, D) encoder tokens → (V, V) ASMK* similarity.  On the tokens'
    device: projection, assignment and binarization.  On the host: per
    view and word the sign of the summed bits, then over the words two
    views share σ_α(u) = sign(u)·|u|^α of their normalized binary dot
    products, summed and divided by the square roots of their word
    counts."""
    words, bits, _ = head.assign_and_binarize(tokens)
    words = words.cpu().numpy()
    bits = bits.cpu().numpy().astype(np.float32)
    V, N, D = bits.shape

    agg_words, agg_bits, norms = [], [], []
    for v in range(V):
        order = np.argsort(words[v], kind="stable")
        uniq, starts = np.unique(words[v][order], return_index=True)
        sums = np.add.reduceat(bits[v][order], starts, axis=0)
        agg_words.append(uniq)
        agg_bits.append(np.where(sums >= 0, 1.0, -1.0))
        norms.append(np.sqrt(len(uniq)))
    sim = np.zeros((V, V), np.float32)
    for a in range(V):
        wa, ba = agg_words[a], agg_bits[a]
        for b in range(a, V):
            common, ia, ib = np.intersect1d(wa, agg_words[b],
                                            assume_unique=True,
                                            return_indices=True)
            if len(common) == 0:
                continue
            u = (ba[ia] * agg_bits[b][ib]).sum(-1) / D
            u = np.where(np.abs(u) >= head.similarity_threshold, u, 0.0)
            s = float((np.sign(u) * np.abs(u) ** head.alpha).sum()
                      / (norms[a] * norms[b]))
            sim[a, b] = sim[b, a] = s
    return sim
