"""Panoptic Quality (PQ) evaluation (counterpart of
panst3r_tpu/engine/eval.py; numpy only).

panopticapi-style PQ over multi-view scenes: a segment is the union of its
pixels across all V views of a scene (direct multi-view prediction), IoU
is computed over the scene's pixels jointly, and a prediction matches a
ground-truth segment iff IoU > 0.5 (which makes the match unique).

PQ = Σ_TP IoU / (|TP| + |FP|/2 + |FN|/2),  SQ = Σ IoU/|TP|,  RQ = F1.

Matching follows panopticapi's ``pq_compute_single_core``:
- ground-truth segments with ``iscrowd=1`` never match and are not FN;
- an unmatched prediction is ignored (not FP) when more than half of its
  area lies on VOID plus the same-category crowd segment; panopticapi
  keeps ONE crowd segment per category (a dict overwrite), and so does
  this module;
- PQ/SQ/RQ are per-class means over the classes present in the ground
  truth or the predictions (``pq_average``); the Things/Stuff splits
  average over those category subsets.

Also the trajectory metric of the SLAM app: ``ate_rmse`` after a Umeyama
alignment.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

VOID = 0


@dataclasses.dataclass
class PQStat:
    iou_sum: float = 0.0
    tp: int = 0
    fp: int = 0
    fn: int = 0

    def __iadd__(self, other):
        self.iou_sum += other.iou_sum
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        return self

    @property
    def pq(self) -> float:
        denom = self.tp + 0.5 * self.fp + 0.5 * self.fn
        return self.iou_sum / denom if denom else 0.0

    @property
    def sq(self) -> float:
        return self.iou_sum / self.tp if self.tp else 0.0

    @property
    def rq(self) -> float:
        denom = self.tp + 0.5 * self.fp + 0.5 * self.fn
        return self.tp / denom if denom else 0.0


def scene_pq(pred_pan: np.ndarray, pred_segments: list[dict],
             gt_pan: np.ndarray, gt_segments: list[dict],
             per_class: dict[int, PQStat] | None = None) -> PQStat:
    """pred_pan / gt_pan: (V, H, W) segment-id maps (0 = void);
    ``*_segments``: [{'id', 'category_id'[, 'iscrowd']}].  Adds into
    ``per_class`` in place and returns the scene's total."""
    if per_class is None:
        per_class = defaultdict(PQStat)

    pred_cat = {s["id"]: s["category_id"] for s in pred_segments}
    gt_cat = {s["id"]: s["category_id"] for s in gt_segments}
    gt_crowd = {s["id"] for s in gt_segments if s.get("iscrowd", 0)}

    pred_flat = pred_pan.reshape(-1).astype(np.int64)
    gt_flat = gt_pan.reshape(-1).astype(np.int64)

    # the joint histogram of (gt id, pred id)
    base = pred_flat.max() + 2
    vals, counts = np.unique(gt_flat * base + pred_flat, return_counts=True)
    inter = {(int(v // base), int(v % base)): int(c)
             for v, c in zip(vals, counts)}

    gt_area = defaultdict(int)
    pred_area = defaultdict(int)
    for (g, p), c in inter.items():
        gt_area[g] += c
        pred_area[p] += c

    matched_gt, matched_pred = set(), set()
    for (g, p), c in inter.items():
        if g == VOID or p == VOID:
            continue
        if g not in gt_cat or p not in pred_cat:
            continue
        if g in gt_crowd:
            continue
        if gt_cat[g] != pred_cat[p]:
            continue
        # predicted pixels on void ground truth do not count in the union
        union = gt_area[g] + pred_area[p] - c - inter.get((VOID, p), 0)
        iou = c / union if union else 0.0
        if iou > 0.5:
            cat = gt_cat[g]
            per_class[cat].iou_sum += iou
            per_class[cat].tp += 1
            matched_gt.add(g)
            matched_pred.add(p)

    # false negatives; crowd segments are never FN, and the last crowd
    # segment of a category is the one the FP rule below reads
    crowd_by_cat: dict[int, int] = {}
    for s in gt_segments:
        g, cat = s["id"], s["category_id"]
        if g in matched_gt or gt_area.get(g, 0) == 0:
            continue
        if g in gt_crowd:
            crowd_by_cat[cat] = g
            continue
        per_class[cat].fn += 1

    for p, cat in pred_cat.items():
        if p in matched_pred:
            continue
        ignored = inter.get((VOID, p), 0)
        if cat in crowd_by_cat:
            ignored += inter.get((crowd_by_cat[cat], p), 0)
        area = pred_area.get(p, 0)
        if area == 0 or ignored / area > 0.5:
            continue
        per_class[cat].fp += 1

    total = PQStat()
    for st in per_class.values():
        total += st
    return total


def _pq_average(per_class: dict[int, PQStat],
                cats: set[int] | None = None) -> dict:
    """panopticapi's ``pq_average``: per-class means over the classes with
    tp + fp + fn > 0 (only those in ``cats`` when given)."""
    sel = [st for c, st in per_class.items()
           if (cats is None or c in cats) and st.tp + st.fp + st.fn > 0]
    n = len(sel)
    if not n:
        return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}
    return {"pq": sum(st.pq for st in sel) / n,
            "sq": sum(st.sq for st in sel) / n,
            "rq": sum(st.rq for st in sel) / n, "n": n}


def summarize(per_class: dict[int, PQStat],
              things: set[int] | None = None) -> dict:
    """PQ / SQ / RQ (percent) by panopticapi's averaging and the
    aggregate PQ; with ``things`` (the thing category ids) also the
    Things / Stuff splits."""
    total = PQStat()
    for st in per_class.values():
        total += st
    avg = _pq_average(per_class)
    out = {"PQ": 100.0 * avg["pq"], "SQ": 100.0 * avg["sq"],
           "RQ": 100.0 * avg["rq"], "PQ_agg": 100.0 * total.pq,
           "num_classes": avg["n"]}
    if things is not None:
        th = _pq_average(per_class, things)
        stf = _pq_average(per_class, set(per_class) - set(things))
        out.update({"PQ_th": 100.0 * th["pq"], "SQ_th": 100.0 * th["sq"],
                    "RQ_th": 100.0 * th["rq"], "N_th": th["n"],
                    "PQ_st": 100.0 * stf["pq"], "SQ_st": 100.0 * stf["sq"],
                    "RQ_st": 100.0 * stf["rq"], "N_st": stf["n"]})
    return out


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """The similarity (s, R, t) minimizing ‖s·R·src + t − dst‖²."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (sc ** 2).sum() / len(src)
    s = float((D * np.diag(S)).sum() / var) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(pred_poses: np.ndarray, gt_poses: np.ndarray,
             align: bool = True, with_scale: bool = True) -> float:
    """Absolute trajectory error: the RMSE of the camera centres of
    (N, 4, 4) cam2world poses, after a Umeyama alignment when ``align``."""
    p = pred_poses[:, :3, 3]
    g = gt_poses[:, :3, 3]
    if align:
        s, R, t = umeyama_alignment(p, g, with_scale)
        p = (s * (R @ p.T)).T + t
    return float(np.sqrt(((p - g) ** 2).sum(-1).mean()))


def gt_segments_from_maps(inst_ids: np.ndarray, cls_ids: np.ndarray,
                          class_set: list[str], classes: list[str],
                          crowd_inst_ids=None):
    """(gt_pan, gt_segments) from a dataset's instance and class maps;
    ``class_set`` names the dataset's local class ids, ``classes`` the
    evaluation's vocabulary.  ``crowd_inst_ids``: instance ids annotated
    as crowd (``iscrowd=1``, for scene_pq's crowd rules)."""
    class2id = {c: i for i, c in enumerate(classes)}
    crowd = set(int(i) for i in crowd_inst_ids) \
        if crowd_inst_ids is not None else set()
    segments = []
    for iid in np.unique(inst_ids):
        if iid == 0:
            continue
        local = int(cls_ids[inst_ids == iid][0])
        segments.append({"id": int(iid),
                         "category_id": class2id[class_set[local]],
                         "iscrowd": int(int(iid) in crowd)})
    return inst_ids.astype(np.int64), segments
