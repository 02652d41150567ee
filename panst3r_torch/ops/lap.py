"""Linear assignment on the device: the Jacobi auction (counterpart of
panst3r_tpu/ops/lap.py ``auction_lap`` and ``assignment_cost``).

Every unassigned column (bidder) bids for its best row (object) at once;
each object goes to its highest bidder; ε = span·2e-3/(C+1) bounds the
optimality gap by C·ε ≈ 0.2% of the cost span; columns marked invalid do
not bid and, like any column left unassigned at the iteration cap, are
placed on the cheapest free row by a greedy completion.

``auction_lap`` solves a batch of problems at once, as the JAX package's
``vmap`` over deep-supervision levels and batch items does.  Under
``vmap`` the ``while_loop`` runs until every member is done, and a member
that is done keeps its state; here too a finished member is not updated
again, so the host tests the loop condition only every ``check_every``
iterations (one device sync each) with the same result.  Ties break as in
JAX: ``lax.top_k`` and ``argmax`` take the lowest index, and a contested
object goes to the highest bidder index.

``exact_lap`` is the exact solver on the host (``native/lap.cpp``, built at
first use; scipy's ``linear_sum_assignment`` where no compiler is there),
for evaluation and for measuring the auction's gap.
"""
from __future__ import annotations

import numpy as np
import torch


def _best_two(values: torch.Tensor):
    """(top value, its index, second value) along the last dim, ties to
    the lower index (``lax.top_k(values, 2)``)."""
    v0, i0 = values.max(dim=-1)
    rest = values.scatter(-1, i0[..., None], float("-inf"))
    v1 = rest.max(dim=-1).values
    return v0, i0, v1


def auction_lap(cost: torch.Tensor, max_iters: int = 5000, span=None,
                col_valid=None, check_every: int = 8) -> torch.Tensor:
    """Min-cost assignment of columns to distinct rows.

    cost: (R, C) or (..., R, C) with R >= C; span: the cost scale that sets
    ε (per problem; default the max |cost|) — callers that pad invalid
    columns with a large sentinel pass the span of the real costs;
    col_valid: (..., C) bool, False for padding columns.  Returns
    row_for_col (..., C) int64."""
    *lead, R, C = cost.shape
    if R < C:
        raise ValueError("auction_lap expects tall cost matrices (R >= C)")
    dev = cost.device
    benefit = -cost.float().reshape(-1, R, C).transpose(1, 2)   # (N, C, R)
    N = benefit.shape[0]
    if span is None:
        span = benefit.abs().amax(dim=(1, 2))
    span = torch.as_tensor(span, dtype=torch.float32, device=dev)
    span = torch.clamp(span.reshape(-1).expand(N), min=1e-6)
    # divide by a tensor: CUDA divides by a host scalar through its
    # reciprocal, and one ulp of ε can change an auction
    eps = (span * 2e-3 / torch.full((), C + 1.0, device=dev))[:, None]
    if col_valid is None:
        col_valid = torch.ones((N, C), dtype=torch.bool, device=dev)
    col_valid = col_valid.reshape(N, C)

    prices = torch.zeros((N, R), dtype=torch.float32, device=dev)
    assign = torch.full((N, C), -1, dtype=torch.long, device=dev)
    owner = torch.full((N, R), -1, dtype=torch.long, device=dev)
    it = torch.zeros((N,), dtype=torch.long, device=dev)
    bidders = torch.arange(C, device=dev).expand(N, C)
    objects = torch.arange(R, device=dev).expand(N, R)

    def active():
        return ((assign < 0) & col_valid).any(dim=1) & (it < max_iters)

    done = False
    while not done:
        for _ in range(check_every):
            act = active()
            unassigned = (assign < 0) & col_valid
            values = benefit - prices[:, None, :]
            top0, best, top1 = _best_two(values)
            bid = torch.gather(prices, 1, best) + top0 - top1 + eps
            bid_u = torch.where(unassigned, bid, float("-inf"))
            obj_bids = torch.full((N, R), float("-inf"), device=dev) \
                .scatter_reduce(1, best, bid_u, "amax")
            ids = torch.where(
                (torch.gather(obj_bids, 1, best) == bid_u) & unassigned,
                bidders, -1)
            winner = torch.full((N, R), -1, dtype=torch.long, device=dev) \
                .scatter_reduce(1, best, ids, "amax")
            contested = winner >= 0
            # previous owners of contested objects lose them
            lost = torch.zeros((N, C + 1), dtype=torch.bool, device=dev) \
                .scatter(1, torch.where(owner >= 0, owner, C), contested)[:, :C]
            new_assign = torch.where(lost, -1, assign)
            new_assign = torch.cat(
                [new_assign, new_assign.new_zeros((N, 1))], 1).scatter(
                1, torch.where(contested, winner, C), objects)[:, :C]
            a = act[:, None]
            assign = torch.where(a, new_assign, assign)
            owner = torch.where(a & contested, winner, owner)
            prices = torch.where(a & contested, obj_bids, prices)
            it = it + act.long()
        done = not bool(active().any())

    # Greedy completion: each round gives the first unassigned column of
    # every member its cheapest free row; rounds = the most unassigned.
    # A member with none left rewrites its own values.
    rows = torch.arange(N, device=dev)
    for _ in range(int((assign < 0).sum(dim=1).max())):
        left = assign < 0
        has = left.any(dim=1)
        t = torch.argmax(left.long(), dim=1)[:, None]
        masked = torch.where(owner < 0, benefit[rows, t[:, 0]], float("-inf"))
        r = torch.argmax(masked, dim=1)[:, None]
        assign.scatter_(1, t, torch.where(has[:, None], r, assign.gather(1, t)))
        owner.scatter_(1, r, torch.where(has[:, None], t, owner.gather(1, r)))
    return assign.reshape(*lead, C)


def assignment_cost(cost: torch.Tensor, row_for_col: torch.Tensor):
    """Total cost of an assignment (one problem)."""
    C = cost.shape[1]
    return cost[row_for_col, torch.arange(C, device=cost.device)].sum()


def exact_lap(cost) -> tuple[np.ndarray, np.ndarray]:
    """Exact min-cost assignment on the host: (row_ind, col_ind) int64,
    scipy's surface.  The native solver, or scipy's without a compiler."""
    from panst3r_torch.native import lap_jv

    res = lap_jv(np.asarray(cost))
    if res is not None:
        return res
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(np.asarray(cost))
    return rows.astype(np.int64), cols.astype(np.int64)
