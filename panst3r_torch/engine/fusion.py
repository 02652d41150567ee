"""Multi-view-consistent panoptic fusion (counterpart of
panst3r_tpu/engine/fusion.py).

- ``panoptic_fusion`` (standard fusion; ``panoptic_fusion_v1`` its v1
  thresholds): per scene, sigmoid masks upsampled (bilinear, as
  ``jax.image.resize``) in bf16, a prob-weighted argmax over queries
  jointly across all views, and a per-query area/overlap test iterated
  ``niters`` times; segment ids follow query order.
- ``panoptic_fusion_multi_ar``: the same over views of different shapes
  (each upsampled to its own shape, zero-padded to the largest, fused
  jointly, cropped back).
- ``qubo_fusion``: query-subset selection as a QUBO (``qubo_weights``),
  solved by simulated annealing with parallel restarts
  (``solve_qubo_sa``), then an argmax instance map.

Sharded fusion waits for a later slice.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from panst3r_torch.ops.image import resize, resize_bilinear_hw


def _class_scores(mask_cls, label_mode, cls_threshold, temperature):
    if label_mode == "sigmoid":
        probs = torch.sigmoid(mask_cls.float())
        scores, labels = probs.max(-1)
        keep = scores > cls_threshold
        if temperature is not None:
            soft = torch.softmax(probs / temperature, dim=-1)
            scores, labels = soft.max(-1)
    else:
        soft = torch.softmax(mask_cls.float(), dim=-1)
        scores, labels = soft.max(-1)
        ncls = mask_cls.shape[-1] - 1
        keep = (labels != ncls) & (scores > cls_threshold)
    return scores, labels, keep


def _fusion_scores(mask_cls, mask_pred, true_shape, label_mode, cls_threshold,
                   temperature):
    B, V, Q = mask_pred.shape[:3]
    H, W = true_shape
    masks = torch.sigmoid(mask_pred.float()).to(torch.bfloat16)
    masks = resize(masks, (B, V, Q, H, W), "bilinear")
    scores, labels, keep = _class_scores(mask_cls, label_mode, cls_threshold,
                                         temperature)
    return masks, scores, labels, keep


def _fusion_iters(masks, scores, keep, labels, mask_threshold,
                  overlap_threshold, niters, void_confidence):
    """Iterated argmax fusion; returns (pan (B, V, H, W) int32, conf,
    seg_ids (B, Q), labels, selected (B, Q))."""
    pm = masks.permute(0, 2, 1, 3, 4)                   # (B, Q, V, H, W)
    prob_masks = pm * scores.to(pm.dtype)[:, :, None, None, None]
    orig_area = (pm >= 0.5).sum((2, 3, 4))              # (B, Q)
    alive = keep
    winner = pm_win = selected = pix_assigned = None
    neg_inf = torch.tensor(float("-inf"), dtype=pm.dtype, device=pm.device)
    for _ in range(niters):
        neg = torch.where(alive[:, :, None, None, None], prob_masks, neg_inf)
        winner = neg.argmax(dim=1)                      # (B, V, H, W)
        pm_win = torch.gather(pm, 1, winner[:, None])[:, 0]
        alive_win = torch.gather(alive, 1, winner.flatten(1)).view_as(winner)
        win_valid = (pm_win >= mask_threshold) & alive_win
        mask_area = torch.zeros_like(orig_area).scatter_add_(
            1, winner.flatten(1), win_valid.flatten(1).to(orig_area.dtype))
        selected = (alive & (mask_area > 0) & (orig_area > 0)
                    & (mask_area / orig_area.clamp(min=1)
                       >= overlap_threshold))
        alive = selected
        pix_assigned = win_valid
    seg_ids = torch.cumsum(selected.int(), dim=1) * selected
    sel_at_winner = torch.gather(selected, 1,
                                 winner.flatten(1)).view_as(winner)
    assigned = pix_assigned & sel_at_winner
    seg_at_winner = torch.gather(seg_ids, 1, winner.flatten(1)).view_as(winner)
    pan = torch.where(assigned, seg_at_winner, 0).to(torch.int32)
    conf = torch.where(assigned, pm_win.float(),
                       torch.tensor(void_confidence, device=pm.device))
    return pan, conf, seg_ids, labels, selected


def _fusion_full(mask_cls, mask_pred, true_shape, label_mode, cls_threshold,
                 temperature, mask_threshold, overlap_threshold, niters,
                 void_confidence):
    masks, scores, labels, keep = _fusion_scores(
        mask_cls, mask_pred, true_shape, label_mode, cls_threshold,
        temperature)
    return _fusion_iters(masks, scores, keep, labels, mask_threshold,
                         overlap_threshold, niters, void_confidence)


def _fusion_presigmoid(mask_cls, masks, label_mode, cls_threshold,
                       temperature, mask_threshold, overlap_threshold,
                       niters, void_confidence):
    """Fusion over pre-sigmoided, pre-padded masks (B, V, Q, H, W): the
    mixed-aspect-ratio path, where per-view upsampling and zero padding
    happened upstream."""
    scores, labels, keep = _class_scores(mask_cls, label_mode, cls_threshold,
                                         temperature)
    return _fusion_iters(masks, scores, keep, labels, mask_threshold,
                         overlap_threshold, niters, void_confidence)


def panoptic_fusion_multi_ar(mask_cls, mask_pred_views: Sequence,
                             true_shapes: Sequence[tuple[int, int]],
                             label_mode: str = "sigmoid",
                             cls_threshold: float = 0.1, temperature=None,
                             mask_threshold: float = 0.25,
                             overlap_threshold: float = 0.5, niters: int = 2,
                             void_confidence: float = 0.1,
                             with_conf: bool = True) -> list[dict]:
    """Mixed-aspect-ratio scene fusion: per view, sigmoid → bilinear
    upsample to that view's true shape → zero-pad to the largest shape;
    fuse jointly (padding never reaches ``mask_threshold``, so padded
    pixels stay void and count no area); crop each view's maps back.

    mask_cls (Q, ncls) logits; mask_pred_views: per-view (Q, h_i, w_i)
    logits; true_shapes: per-view (H_i, W_i).  One scene; the work runs
    on mask_cls's device."""
    mask_cls = torch.as_tensor(mask_cls)
    dev = mask_cls.device
    Hm = max(h for h, _ in true_shapes)
    Wm = max(w for _, w in true_shapes)
    padded = []
    for m, (h, w) in zip(mask_pred_views, true_shapes):
        pm = torch.sigmoid(torch.as_tensor(m, device=dev).float()) \
            .to(torch.bfloat16)
        pm = resize_bilinear_hw(pm, h, w)
        padded.append(F.pad(pm, (0, Wm - w, 0, Hm - h)))
    masks = torch.stack(padded)[None]                   # (1, V, Q, Hm, Wm)
    pan, conf, seg_ids, seg_cls, seg_valid = _fusion_presigmoid(
        mask_cls[None], masks, label_mode, cls_threshold, temperature,
        mask_threshold, overlap_threshold, niters, void_confidence)
    pan_h = pan[0].cpu().numpy().astype(np.uint16).astype(np.int32)
    conf_h = conf[0].to(torch.float16).cpu().numpy().astype(np.float32)
    ids, cls, valid = (seg_ids[0].cpu().numpy(), seg_cls[0].cpu().numpy(),
                       seg_valid[0].cpu().numpy())
    infos = [{"id": int(ids[q]), "query_id": int(q),
              "category_id": int(cls[q])}
             for q in range(ids.shape[0]) if valid[q]]
    return [{
        "pan": [pan_h[i, :h, :w] for i, (h, w) in enumerate(true_shapes)],
        "segments_info": infos,
        "conf": ([conf_h[i, :h, :w] for i, (h, w) in enumerate(true_shapes)]
                 if with_conf else None),
    }]


def panoptic_fusion(mask_cls, mask_pred, true_shape: tuple[int, int],
                    label_mode: str = "sigmoid", cls_threshold: float = 0.1,
                    temperature=None, mask_threshold: float = 0.25,
                    overlap_threshold: float = 0.5, niters: int = 2,
                    void_confidence: float = 0.1, with_conf: bool = True):
    """mask_cls (B, Q, ncls) logits; mask_pred (B, V, Q, h, w) logits.

    Returns per-scene dicts {'pan': (V, H, W) int32 segment ids,
    'segments_info': [{'id', 'query_id', 'category_id'}, ...], 'conf'}."""
    pan, conf, seg_ids, seg_cls, seg_valid = _fusion_full(
        mask_cls, mask_pred, tuple(true_shape), label_mode, cls_threshold,
        temperature, mask_threshold, overlap_threshold, niters,
        void_confidence)
    # host transfers: ids fit uint16, confidence travels as f16
    pan_host = pan.to(torch.int32).cpu().numpy().astype(np.uint16) \
        .astype(np.int32)
    conf_host = (conf.to(torch.float16).cpu().numpy().astype(np.float32)
                 if with_conf else None)
    seg_ids_h = seg_ids.cpu().numpy()
    seg_cls_h = seg_cls.cpu().numpy()
    seg_valid_h = seg_valid.cpu().numpy()
    results = []
    for b in range(mask_cls.shape[0]):
        ids, cls, valid = seg_ids_h[b], seg_cls_h[b], seg_valid_h[b]
        infos = [{"id": int(ids[q]), "query_id": int(q),
                  "category_id": int(cls[q])}
                 for q in range(ids.shape[0]) if valid[q]]
        results.append({"pan": pan_host[b], "segments_info": infos,
                        "conf": conf_host[b] if with_conf else None})
    return results


def panoptic_fusion_v1(mask_cls, mask_pred, true_shape, **kw):
    """v1 fusion: one iteration, mask and overlap thresholds 0.5 / 0.8."""
    kw.setdefault("mask_threshold", 0.5)
    kw.setdefault("overlap_threshold", 0.8)
    return panoptic_fusion(mask_cls, mask_pred, true_shape, niters=1, **kw)


# ---------------------------------------------------------------- QUBO ----

def qubo_weights(masks, cls_probs=None, penalty: float = 1.0,
                 min_cls_prob: float = 0.0, cutoff: float = 0.0,
                 prob_weighted: bool = False) -> torch.Tensor:
    """Weight matrix for query-subset selection.

    masks (Q, V, H, W) sigmoid masks; cls_probs (Q, ncls) or None.  The
    diagonal holds each mask's area, the off-diagonal -(1 + penalty) times
    the pairwise min-overlap / 2 (zero at or below ``cutoff``), all over
    pixels × views; the result is negated.  With ``prob_weighted`` masks
    scale by their largest class prob; queries whose class probs never
    reach ``min_cls_prob`` are zeroed."""
    Q, V, H, W = masks.shape
    if cls_probs is not None:
        if prob_weighted:
            masks = masks * cls_probs.max(-1).values[:, None, None, None]
        bad = (cls_probs < min_cls_prob).all(-1)
        masks = torch.where(bad[:, None, None, None], 0.0, masks)
    flat = masks.reshape(Q, -1)
    # pairwise min-overlap one query row at a time (the (Q, Q, P)
    # broadcast would not fit at full resolution)
    overlap = torch.stack([torch.minimum(row[None], flat).sum(-1)
                           for row in flat])
    overlap = torch.where(overlap > cutoff, overlap, 0.0)
    w_mat = -(1.0 + penalty) * overlap / 2.0
    w_mat.diagonal().copy_(flat.sum(-1))
    return -(w_mat / (H * W) / V)


def solve_qubo_sa(W, seed: int = 0, num_iters: int = 10000, T0: float = 0.5,
                  T_end: float = 1e-4, lambda_reg: float = 1e-3,
                  num_restarts: int = 20):
    """Simulated annealing with ``num_restarts`` restarts in parallel.

    Minimizes x^T W x + λ·mean(x) over x ∈ {0,1}^N with geometric cooling;
    each step flips one random bit per restart and scores it by the exact
    incremental energy (O(N)).  The random draws (initial bits, flipped
    bits, acceptance uniforms) come from a CPU ``torch.Generator`` seeded
    by ``seed``, so a seed gives the same draws on every device.  The
    steps are sequential and tiny (N·restarts values), so they run on the
    host, where a step costs a few microseconds rather than a dozen kernel
    launches.  Returns (best x as a bool (N,) tensor, its energy), on W's
    device."""
    N, R, dev = W.shape[0], num_restarts, W.device
    Wh = W.detach().float().cpu().numpy()
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(R, N, generator=g) < 0.5).numpy().astype(np.float32)
    js = torch.randint(0, N, (num_iters, R), generator=g).numpy()
    us = torch.rand(num_iters, R, generator=g).numpy()
    cooling = (T_end / T0) ** (1.0 / num_iters)
    temps = (T0 * cooling ** np.arange(num_iters)).astype(np.float32)
    e = ((x @ Wh) * x).sum(-1) + np.float32(lambda_reg) * x.mean(-1)
    best_x, best_e = x.copy(), e.copy()
    rows = np.arange(R)
    diag = np.diagonal(Wh)
    for it in range(num_iters):
        j = js[it]
        s = 1.0 - 2.0 * x[rows, j]
        delta = 2.0 * s * np.einsum("rn,rn->r", Wh[j], x) + diag[j] \
            + np.float32(lambda_reg) * s / N
        with np.errstate(over="ignore"):
            accept = (delta < 0) | (us[it] < np.exp(-delta / temps[it]))
        x[rows, j] += np.where(accept, s, 0.0).astype(np.float32)
        e = np.where(accept, e + delta, e).astype(np.float32)
        better = e < best_e
        best_x[better] = x[better]
        best_e[better] = e[better]
    best = int(np.argmin(best_e))
    return (torch.from_numpy(best_x[best] > 0.5).to(dev),
            torch.tensor(best_e[best], device=dev))


def qubo_fusion(mask_cls, mask_pred, true_shape: tuple[int, int],
                label_mode: str = "sigmoid", temperature=None,
                prob_threshold: float = 0.01, num_restarts: int = 20,
                seed: int = 0) -> list[dict]:
    """QUBO-based fusion.  mask_cls (B, Q, ncls) logits; mask_pred (B, V,
    Q, h, w) logits.  Per scene: the subset of queries that
    ``solve_qubo_sa`` selects, each pixel to the selected query of the
    highest mask probability, and a segment kept where its class prob
    times its mean mask confidence reaches ``prob_threshold``."""
    B, V, Q = mask_pred.shape[:3]
    H, W = true_shape
    masks_all = resize(torch.sigmoid(mask_pred.float()), (B, V, Q, H, W),
                       "bilinear")
    if label_mode == "sigmoid":
        probs_all = torch.sigmoid(mask_cls.float())
        if temperature is not None:
            # as the reference: with a temperature, sigmoid is applied a
            # second time before the softmax
            probs_all = torch.softmax(torch.sigmoid(probs_all) / temperature,
                                      dim=-1)
    else:
        probs_all = torch.softmax(mask_cls.float(), dim=-1)[..., :-1]

    results = []
    for b in range(B):
        masks = masks_all[b].transpose(0, 1)                   # (Q, V, H, W)
        probs = probs_all[b]
        sol, _ = solve_qubo_sa(qubo_weights(masks, cls_probs=probs),
                               seed=seed + b, num_restarts=num_restarts)
        sel_idx = torch.nonzero(sol)[:, 0]
        if sel_idx.numel() == 0:
            results.append({"pan": np.zeros((V, H, W), np.int32),
                            "segments_info": [],
                            "conf": np.zeros((V, H, W), np.float32)})
            continue
        conf_t, inst_t = masks[sel_idx].max(0)                 # (V, H, W)
        conf, inst = conf_t.cpu().numpy(), inst_t.cpu().numpy()
        cls_p_t, cls_ids_t = probs[sel_idx].max(-1)
        cls_p, cls_ids = cls_p_t.cpu().numpy(), cls_ids_t.cpu().numpy()
        sel = sel_idx.cpu().numpy()

        pan = np.zeros(inst.shape, np.int32)
        infos = []
        new_id = 1
        for si in np.unique(inst):
            region = inst == si
            mask_conf = float(conf[region].mean())
            if cls_p[si] * mask_conf < prob_threshold:
                continue
            pan[region] = new_id
            infos.append({"id": new_id, "query_id": int(sel[si]),
                          "class_prob": float(cls_p[si]),
                          "mask_conf": mask_conf,
                          "category_id": int(cls_ids[si]),
                          "area": int(region.sum())})
            new_id += 1
        results.append({"pan": pan, "segments_info": infos, "conf": conf})
    return results
