"""Memory-sharded cross-attention over the mesh's ``mem`` axis
(counterpart of panst3r_tpu/ops/sharded_attention.py).

The decoder's KV banks may be split along their capacity over the ranks
of a ``mem`` group while the queries are replicated.  Two exact schedules:

- ``sharded_memory_attention``: each rank scores its KV shard, the row
  maxima are max-reduced, then the unnormalized outputs and the row sums
  are sum-reduced — one round of O(B·H·Nq·D) traffic, whatever the
  memory's length;
- ``ring_memory_attention``: the KV shards travel around the ring
  (``dist.batch_isend_irecv``) while each rank keeps flash-style running
  (max, sum, acc) for its queries.

Both are plain products, as the JAX versions are plain ``jnp`` einsums
(no Pallas call).  The decoder's render does not use them: it gathers the
bank and runs K2 over all of it (``models/decoder.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from panst3r_torch.core.mesh import Group, all_reduce, group_size

_NEG_INF = float(torch.finfo(torch.float32).min)


def _scores(q, k, valid):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    if valid is not None:
        s = s + torch.where(valid, 0.0, _NEG_INF)[:, None, None, :]
    return s


def sharded_memory_attention(group: Optional[Group], q: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor,
                             kv_valid: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """q (B, H, Nq, D) replicated over ``group``; k, v (B, H, M/n, D) this
    rank's slice of the keys; kv_valid (B, M/n) bool, its slice of the
    validity.  Returns (B, H, Nq, D) on every rank."""
    s = _scores(q, k, kv_valid)
    m = all_reduce(s.amax(-1, keepdim=True), group, dist.ReduceOp.MAX)
    safe_m = torch.where(m <= _NEG_INF / 2, 0.0, m)
    p = torch.exp(s - safe_m)
    p = torch.where(s <= _NEG_INF / 2, 0.0, p)
    o = all_reduce(torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
                   .float(), group)
    l = all_reduce(p.sum(-1, keepdim=True), group)
    return (o / torch.clamp(l, min=1e-20)).to(q.dtype)


def ring_memory_attention(group: Optional[Group], q: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          kv_valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The ring schedule of ``sharded_memory_attention`` (same arguments):
    n − 1 hops of the KV shards to the next rank, each hop's scores folded
    into running (max, sum, acc).  Moves the KV bytes instead of one
    reduction of the outputs: the better choice when the queries are many
    relative to a KV shard."""
    n = group_size(group)
    B, H, Nq, D = q.shape
    m_run = torch.full((B, H, Nq, 1), _NEG_INF, device=q.device)
    l_run = torch.zeros((B, H, Nq, 1), device=q.device)
    acc = torch.zeros((B, H, Nq, D), device=q.device)
    shard = [k.contiguous(), v.contiguous()]
    if kv_valid is not None:
        shard.append(kv_valid.to(torch.uint8).contiguous())
    for hop in range(n):
        valid = shard[2].bool() if kv_valid is not None else None
        s = _scores(q, shard[0], valid)
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        safe = torch.where(m_new <= _NEG_INF / 2, 0.0, m_new)
        p = torch.exp(s - safe)
        p = torch.where(s <= _NEG_INF / 2, 0.0, p)
        alpha = torch.exp(m_run - safe)
        alpha = torch.where(m_run <= _NEG_INF / 2, 0.0, alpha)
        l_run = alpha * l_run + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(shard[1].dtype), shard[1]).float()
        m_run = m_new
        if hop < n - 1:
            shard = _ring_shift(shard, group)
    return (acc / torch.clamp(l_run, min=1e-20)).to(q.dtype)


def _ring_shift(tensors: list, group: Group) -> list:
    """Each tensor sent to the next rank of the group, the previous rank's
    received in its place."""
    nxt = group.ranks[(group.index + 1) % group.size]
    prv = group.ranks[(group.index - 1) % group.size]
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group=group.pg) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group=group.pg) for t in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out
