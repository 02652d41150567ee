"""Multi-view-consistent panoptic fusion (counterpart of the standard fusion
of panst3r_tpu/engine/fusion.py: ``_class_scores``, ``_fusion_scores``,
``_fusion_iters``, ``_fusion_full`` and ``panoptic_fusion``).

Per scene: sigmoid masks upsampled (bilinear, as ``jax.image.resize``) in
bf16, a prob-weighted argmax over queries jointly across all views, and a
per-query area/overlap test iterated ``niters`` times; segment ids follow
query order.  QUBO, multi-aspect-ratio and sharded fusion wait for a later
slice.
"""
from __future__ import annotations

import numpy as np
import torch

from panst3r_torch.ops.image import resize


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
