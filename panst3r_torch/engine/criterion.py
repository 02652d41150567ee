"""Panoptic set-prediction criterion: Hungarian matcher and DETR losses
(counterpart of panst3r_tpu/engine/criterion.py).

- ``match``: class cost −softmax prob plus sigmoid-CE and dice mask costs
  over every view jointly, with one point set per view shared by all masks
  (``matcher_sampling`` "grid": a bilinear point-evaluation at a ~num_points
  grid; "random": uniform points), solved on the device by the auction
  (``ops/lap.py``); invalid target columns carry a large constant and do
  not bid.
- ``set_criterion``: sigmoid-focal or masked-softmax label loss with the
  per-dataset class mask; mask CE + dice on a jittered ~num_points grid
  ("grid") or on PointRend uncertainty points ("random"); ``num_masks``
  the number of valid targets; every deep-supervision level re-matched.
  The levels' assignments are solved in one batched auction, as the JAX
  package's ``vmap`` over levels does.
- ``panoptic_loss``: the weighted total.

Targets are padded to ``max_instances`` per sample: labels (B, T), masks
(B, T, V, H, W), valid (B, T), output_mask (B, ncls).

Random draws come from an explicit ``torch.Generator``, or are passed in
through ``draws``: per level, the matcher's points (B, V, P, 2) ("random"
matcher) and the mask loss's grid jitter (2,) ("grid") or its PointRend
uniform draws ("random").  ``jax_draws`` in the tests makes them with the
JAX package's key splits.  The matching runs without a graph: the
assignment is an integer.

Data parallelism (``group``: the mesh's ``data`` axis, every rank holding
an equal slice of the global batch): the loss of each rank is its share
of the global-batch loss, so the shares sum to it — ``num_masks`` and the
softmax label loss's weight sum are global sums, and the random draws are
this rank's rows of the global batch's draws from the same generator.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from panst3r_torch.core import config as cfg
from panst3r_torch.core.mesh import all_reduce, group_index, group_size
from panst3r_torch.ops.image import resize, scale_and_translate_linear
from panst3r_torch.ops.lap import auction_lap
from panst3r_torch.ops.sampling import (point_sample, point_sample_shared,
                                        uncertain_point_coords)

_BIG = 1e6


class Targets(NamedTuple):
    labels: torch.Tensor       # (B, T) int, global class ids
    masks: torch.Tensor        # (B, T, V, H, W) float binary
    valid: torch.Tensor        # (B, T) bool
    output_mask: torch.Tensor  # (B, ncls) bool — classes of this dataset


@cfg.register
@dataclasses.dataclass(frozen=True)
class PanopticLossConfig:
    class_weight: float = 1.0
    mask_weight: float = 20.0
    dice_weight: float = 1.0
    no_obj_weight: float = 0.1
    num_points: int = 12288
    oversample_ratio: float = 1.0
    importance_sample_ratio: float = 1.0
    label_mode: str = "sigmoid"
    deep_supervision: bool = True
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    matcher_sampling: str = "grid"
    loss_sampling: str = "grid"


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _batch_sigmoid_ce(inputs, targets):
    """(..., N, P) logits × (..., M, P) binary → (..., N, M)."""
    P = inputs.shape[-1]
    tt = targets.transpose(-1, -2)
    return (softplus(-inputs) @ tt + softplus(inputs) @ (1 - tt)) / P


def _batch_dice(inputs, targets):
    """(..., N, P) logits × (..., M, P) binary → (..., N, M)."""
    probs = torch.sigmoid(inputs)
    num = 2 * (probs @ targets.transpose(-1, -2))
    den = probs.sum(-1)[..., :, None] + targets.sum(-1)[..., None, :]
    return 1 - (num + 1) / (den + 1)


def _grid_shape(num_points: int, H: int, W: int):
    """The ~num_points quadrature grid at the masks' aspect."""
    gh = max(1, int(round((num_points * H / W) ** 0.5)))
    return gh, max(1, num_points // gh)


def _grid_points(m, grid):
    """(B, K, V, h, w) masks at the grid matcher's (gh, gw) quadrature
    points of every view, bilinear without antialias: (B, K, V·gh·gw)."""
    gh, gw = grid
    r = resize(m, (*m.shape[:3], gh, gw), "bilinear", antialias=False)
    return r.reshape(m.shape[0], m.shape[1], -1)


@torch.no_grad()
def match_costs(pred_logits, pred_masks, targets: Targets,
                c: PanopticLossConfig, points=None, tgt_pts=None):
    """Matching costs (B, Q, T) with invalid columns at a large constant,
    the span of the real costs (B,), and the column validity (B, T).
    pred_masks (B, V, Q, h, w); ``points`` (B, V, P, 2) for the random
    matcher; ``tgt_pts``: the grid matcher's target samples when the
    caller has them (``set_criterion`` samples them once for every level,
    as the JAX vmap over the levels does)."""
    B, Q = pred_logits.shape[:2]
    V = pred_masks.shape[1]
    T = targets.labels.shape[1]
    prob = torch.softmax(pred_logits.float(), -1)                # (B, Q, n)
    safe = torch.clamp(targets.labels, min=0).long()
    cost_class = -torch.gather(prob, 2, safe[:, None, :].expand(B, Q, T))
    masks_q = pred_masks.float().transpose(1, 2)             # (B, Q, V, h, w)
    masks_t = targets.masks.float()                          # (B, T, V, H, W)
    if c.matcher_sampling == "grid":
        grid = _grid_shape(c.num_points, *masks_t.shape[-2:])

        def sample(m):
            return _grid_points(m, grid)
    else:
        def sample(m):
            return torch.stack([torch.stack([
                point_sample_shared(m[b, :, v], points[b, v])
                for v in range(V)], 1) for b in range(B)]).reshape(
                    B, m.shape[1], -1)

    out_pts = sample(masks_q)
    if tgt_pts is None:
        tgt_pts = sample(masks_t)
    cost = (c.mask_weight * _batch_sigmoid_ce(out_pts, tgt_pts)
            + c.class_weight * cost_class
            + c.dice_weight * _batch_dice(out_pts, tgt_pts))
    valid = targets.valid[:, None, :]
    span = torch.where(valid, cost.abs(), 0.0).amax(dim=(1, 2))
    return torch.where(valid, cost, _BIG), span, targets.valid


def match(pred_logits, pred_masks, targets: Targets, c: PanopticLossConfig,
          points=None):
    """query_for_target (B, T): one auction per item."""
    cost, span, valid = match_costs(pred_logits, pred_masks, targets, c,
                                    points)
    return auction_lap(cost, span=span, col_valid=valid)


def _onehot_at(B, Q, n, assign, values):
    """(B, Q, n) zeros with ``values`` (B, T, n) added at rows ``assign``."""
    out = torch.zeros((B, Q, n), dtype=values.dtype, device=values.device)
    b_idx = torch.arange(B, device=assign.device)[:, None].expand_as(assign)
    return out.index_put((b_idx, assign), values, accumulate=True)


def _loss_labels_sigmoid(pred_logits, targets: Targets, assign, num_masks,
                         c: PanopticLossConfig):
    """Sigmoid focal label loss with the dataset class mask."""
    B, Q, ncls = pred_logits.shape
    logits = pred_logits.float()
    cls = F.one_hot(targets.labels.long(), ncls).float() \
        * targets.valid[..., None]
    onehot = torch.clamp(_onehot_at(B, Q, ncls, assign, cls), 0.0, 1.0)
    prob = torch.sigmoid(logits)
    ce = softplus(-logits) * onehot + softplus(logits) * (1 - onehot)
    p_t = prob * onehot + (1 - prob) * (1 - onehot)
    loss = ce * (1 - p_t) ** c.focal_gamma
    alpha_t = c.focal_alpha * onehot + (1 - c.focal_alpha) * (1 - onehot)
    loss = alpha_t * loss
    loss = loss * targets.output_mask[:, None]
    return loss.mean(1).sum() / num_masks * Q


def _loss_labels_softmax(pred_logits, targets: Targets, assign, num_masks,
                         c: PanopticLossConfig, group=None):
    """Masked-softmax CE label loss; the last class is no-object."""
    B, Q, nclsp1 = pred_logits.shape
    ncls = nclsp1 - 1
    logits = pred_logits.float()
    tgt = torch.where(targets.valid, targets.labels.long(), ncls)
    target_classes = torch.full((B, Q), ncls, dtype=torch.long,
                                device=logits.device)
    b_idx = torch.arange(B, device=assign.device)[:, None].expand_as(assign)
    target_classes = target_classes.index_put((b_idx, assign), tgt)
    om = torch.cat([targets.output_mask,
                    torch.ones((B, 1), dtype=torch.bool,
                               device=logits.device)], -1)
    masked = torch.where(om[:, None], logits, float("-inf"))
    logp = torch.log_softmax(masked, -1)
    nll = -torch.gather(logp, 2, target_classes[..., None])[..., 0]
    w = torch.where(target_classes == ncls, c.no_obj_weight, 1.0)
    return (nll * w).sum() / all_reduce(w.sum(), group)


def replicate_pad1(m: torch.Tensor) -> torch.Tensor:
    """(N, h, w) → (N, h + 2, w + 2), the edge rows and columns repeated
    (``F.pad(mode="replicate")``'s values).  Built by concatenation, so
    that its backward adds each border pixel's copies in autograd's fixed
    order: on the card ``F.pad``'s replicate backward adds them with
    atomics, which made the train step's gradients differ run to run."""
    m = torch.cat([m[:, :1], m, m[:, -1:]], 1)
    return torch.cat([m[:, :, :1], m, m[:, :, -1:]], 2)


def _loss_masks(pred_masks, targets: Targets, assign, num_masks,
                c: PanopticLossConfig, draw):
    """Mask CE + dice per (target, view) row.  ``draw``: the grid jitter
    (2,) ("grid") or the PointRend (candidates, extra) uniform draws
    ("random"): a level of ``draw_levels``."""
    B, V, Q = pred_masks.shape[:3]
    T = assign.shape[1]
    b_idx = torch.arange(B, device=assign.device)[:, None].expand(B, T)
    src = pred_masks.transpose(1, 2)[b_idx, assign]       # (B, T, V, h, w)
    src = src.reshape(B * T * V, *src.shape[3:]).float()
    tgt = targets.masks.reshape(B * T * V, *targets.masks.shape[3:]).float()
    dev = src.device

    if c.loss_sampling == "grid":
        gh, gw = _grid_shape(c.num_points, *tgt.shape[-2:])
        jit = draw.to(device=dev, dtype=torch.float32)

        def q(m):
            # 1-px edge-replicate pad: the jitter moves boundary taps up to
            # half a cell outside the map, where the resampling zero-fills
            h, w = m.shape[-2:]
            scale = torch.tensor([gh / h, gw / w], dtype=torch.float32,
                                 device=dev)
            m = replicate_pad1(m)
            return scale_and_translate_linear(
                m, (m.shape[0], gh, gw), (1, 2), scale, jit - scale) \
                .reshape(-1, gh * gw)

        point_logits = q(src)
        with torch.no_grad():
            point_labels = q(tgt)
    else:
        with torch.no_grad():
            coords = uncertain_point_coords(
                src.detach(), c.num_points, c.oversample_ratio,
                c.importance_sample_ratio, draws=draw)
            point_labels = point_sample(tgt, coords)
        point_logits = point_sample(src, coords)

    vmask = targets.valid.reshape(-1).repeat_interleave(V).float()
    ce = softplus(-point_logits) * point_labels \
        + softplus(point_logits) * (1 - point_labels)
    loss_mask = (ce.mean(1) * vmask).sum() / num_masks / V
    probs = torch.sigmoid(point_logits)
    num = 2 * (probs * point_labels).sum(-1)
    den = probs.sum(-1) + point_labels.sum(-1)
    dice = 1 - (num + 1) / (den + 1)
    loss_dice = (dice * vmask).sum() / num_masks / V
    return loss_mask, loss_dice


def _levels(outputs: dict):
    aux = outputs.get("aux_outputs", [])
    return [(outputs["pred_logits"], outputs["pred_masks"])] + [
        (a["pred_logits"], a["pred_masks"]) for a in aux]


def draw_levels(levels, targets: Targets, c: PanopticLossConfig,
                generator, group=None) -> list:
    """Every level's draws from ``generator``: per level a dict with
    "match" (the random matcher's points (B, V, P, 2)) and "mask" (the
    mask loss's grid jitter (2,), or ``uncertain_point_coords``' two
    uniform draws over the (B, T, V) rows), in the order the criterion
    uses them (the matcher's points of every level, then each level's
    mask draw).  Under a data ``group`` of n ranks each draw is that of
    the global batch of n·B items, cut to this rank's rows: every rank
    draws the same numbers from the same generator."""
    n, r = group_size(group), group_index(group)
    B, V = levels[0][1].shape[:2]
    T = targets.labels.shape[1]
    dev = targets.masks.device

    def rows(shape, per_item):
        full = torch.rand((n * shape[0], *shape[1:]), generator=generator,
                          device=dev)
        return full[r * per_item * B:(r + 1) * per_item * B]

    draws = [{} for _ in levels]
    if c.matcher_sampling != "grid":
        for d in draws:
            d["match"] = rows((B, V, c.num_points, 2), 1)
    for d in draws:
        if c.loss_sampling == "grid":
            d["mask"] = torch.rand((2,), generator=generator,
                                   device=dev) - 0.5
        else:
            n_unc = int(c.importance_sample_ratio * c.num_points)
            d["mask"] = (
                rows((B * T * V, int(c.num_points * c.oversample_ratio), 2),
                     T * V),
                rows((B * T * V, c.num_points - n_unc, 2), T * V))
    return draws


def set_criterion(outputs: dict, targets: Targets, c: PanopticLossConfig,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[list] = None, details: bool = False,
                  group=None):
    """Losses over the final and aux outputs.  ``draws``: per level a dict
    with "match" (the random matcher's points) and "mask" (the mask
    loss's draw), else drawn from ``generator``.  ``group``: the data
    axis this rank's batch is a slice of (the losses are then this rank's
    shares).  Returns the loss dict and, with ``details``, also the
    assignments (L, B, T)."""
    num_masks = torch.clamp(
        all_reduce(targets.valid.sum().float(), group), min=1.0)
    label_loss = _loss_labels_sigmoid
    if c.label_mode != "sigmoid":
        def label_loss(*args):
            return _loss_labels_softmax(*args, group=group)
    levels = _levels(outputs)
    if draws is None:
        draws = draw_levels(levels, targets, c, generator, group)
    tgt_pts = None
    if c.matcher_sampling == "grid":    # the same targets at every level
        tgt_pts = _grid_points(targets.masks.float(), _grid_shape(
            c.num_points, *targets.masks.shape[-2:]))
    costs = [match_costs(lg, m, targets, c, d.get("match"), tgt_pts)
             for (lg, m), d in zip(levels, draws)]
    assign = auction_lap(torch.stack([x[0] for x in costs]),
                         span=torch.stack([x[1] for x in costs]),
                         col_valid=torch.stack([x[2] for x in costs]))
    names = ["loss_ce", "loss_mask", "loss_dice"]
    losses = {}
    for i, ((logits, masks), d) in enumerate(zip(levels, draws)):
        l_ce = label_loss(logits, targets, assign[i], num_masks, c)
        l_mask, l_dice = _loss_masks(masks, targets, assign[i], num_masks, c,
                                     d["mask"])
        suffix = "" if i == 0 else f"_{i - 1}"
        for name, val in zip(names, (l_ce, l_mask, l_dice)):
            losses[name + suffix] = val
    return (losses, assign) if details else losses


def panoptic_loss(outputs: dict, targets: Targets,
                  c: PanopticLossConfig = PanopticLossConfig(),
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[list] = None, group=None):
    """Weighted total and the details dict (every loss, the total as
    ``panoptic_loss`` and the assignments as ``assign`` (L, B, T)).  With
    a data ``group`` these are this rank's shares of the global-batch
    losses (their sum over the group)."""
    losses, assign = set_criterion(outputs, targets, c, generator, draws,
                                   details=True, group=group)
    weights = {"loss_ce": c.class_weight, "loss_mask": c.mask_weight,
               "loss_dice": c.dice_weight}
    total = torch.zeros((), device=targets.masks.device)
    for k, v in losses.items():
        base = k.rsplit("_", 1)[0] if k.split("_")[-1].isdigit() else k
        total = total + weights[base] * v
    out = dict(losses)
    out["panoptic_loss"] = total
    out["assign"] = assign
    return total, out
