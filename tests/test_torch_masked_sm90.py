"""The arithmetic of the bf16 K3 on the Hopper engine
(csrc/masked_attn_sm90.cu) that can be checked without a card, in f32: its
split plan, its pre-pass's list of live key blocks (``live_blocks``)
against the port's and the JAX package's ``plan_blocks``, and its
split-then-merge softmax (``masked_mha_split_ref``) against the port's
plain version and the Pallas kernel in interpret mode.  The CUDA kernel is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import masked_attention as t_ma
from panst3r_tpu.ops.pallas import masked_attention as j_ma


def _t(a):
    return torch.from_numpy(np.array(a))


def _blocked(rng, B, Nq, Nk):
    """Object-like spans with a little salt, as the mask transformer's late
    layers give: dead key blocks, a query block's worth of fully blocked
    rows in the last batch, and a fully blocked row inside a live block."""
    blocked = np.ones((B, Nq, Nk), bool)
    for b in range(B):
        starts = rng.integers(0, max(1, Nk - 200), 4)
        for qi in range(Nq):
            s = starts[qi % 4]
            blocked[b, qi, s:s + 60 + 40 * (qi % 4)] = False
    blocked &= rng.random((B, Nq, Nk)) > 0.003
    blocked[:, Nq // 2] = True
    if B > 1:
        blocked[-1, :64] = True
    return blocked


@pytest.mark.parametrize("live", [0, 1, 7, 8, 9, 48, 192])
def test_split_plan_covers_live_list_in_fixed_runs(live):
    plan = t_ma.split_plan(live)
    assert len(plan) == max(1, math.ceil(live / t_ma.SPLIT_TILES))
    assert plan[0][0] == 0 and plan[-1][1] == live
    for (a, z), (a2, _) in zip(plan, plan[1:]):
        assert z == a2 and z - a == t_ma.SPLIT_TILES
    assert all(0 <= z - a <= t_ma.SPLIT_TILES for a, z in plan)
    # the grid's depth covers a query block of any live count
    assert t_ma.max_splits(max(live, 1) * t_ma.BLOCK_K) >= len(plan)


def test_split_plan_depends_on_the_batch_alone(rng):
    """A (batch, query block)'s live list, and so its splits, are the same
    in the full call and in its own batch slice, whatever the other
    batches hold: they come from that batch's mask rows and Nk only."""
    B, Nq, Nk = 3, 130, 1400
    blocked = _blocked(rng, B, Nq, Nk)
    blocked[1, :, 300:] = True                   # few live blocks
    full = t_ma.live_blocks(_t(blocked))
    for b in range(B):
        own = t_ma.live_blocks(_t(blocked[b:b + 1]))
        assert own == [full[b]]
        other = blocked.copy()
        other[(b + 1) % B] = ~other[(b + 1) % B]
        assert t_ma.live_blocks(_t(other))[b] == full[b]
        assert [t_ma.split_plan(len(x)) for x in own[0]] \
            == [t_ma.split_plan(len(x)) for x in full[b]]
    assert full[2][0] == []                       # a block with no live key
    assert max(len(x) for x in full[0]) > t_ma.SPLIT_TILES


@pytest.mark.parametrize("B,Nq,Nk", [(1, 200, 3072), (2, 130, 700),
                                     (2, 1, 100), (2, 64, 64)])
def test_prepass_list_matches_plan_blocks(rng, B, Nq, Nk):
    """The pre-pass's list is the first ``count`` entries of the port's
    ``plan_blocks`` and of the JAX ``plan_blocks`` (the Pallas kernel's
    visit plan) at 64 x 64 blocks, ragged edges blocked."""
    blocked = _blocked(rng, B, Nq, Nk)
    nqp, nkp = -(-Nq // 64) * 64, -(-Nk // 64) * 64
    lists = t_ma.live_blocks(_t(blocked))
    kv_idx, count = t_ma.plan_blocks(_t(blocked), 64, 64, nqp, nkp)
    _, j_idx, j_count = j_ma.plan_blocks(jnp.asarray(blocked), 64, 64, nqp,
                                         nkp)
    j_idx, j_count = np.asarray(j_idx), np.asarray(j_count)
    for b in range(B):
        for a in range(nqp // 64):
            n = int(count[b, a])
            assert lists[b][a] == kv_idx[b, a, :n].tolist()
            assert n == int(j_count[b, a])
            assert lists[b][a] == j_idx[b, a, :n].tolist()


@pytest.mark.parametrize("split_tiles", [t_ma.SPLIT_TILES, 3, 1])
def test_split_merge_matches_plain_and_pallas(rng, split_tiles):
    """The bf16 kernel's split-then-merge arithmetic (log2 units, p
    rounded to v's dtype, splits merged in order) against the one-pass
    plain version and the Pallas kernel in interpret mode, at a ragged
    shape (Nq = 130, Nk = 1400) with dead blocks and fully blocked rows,
    which give 0.  1e-5: in f32 the rounding of p is exact, and the merge
    re-weights each split's sums by exp2(m_s - max m); both differ from
    one softmax pass by f32 rounding of outputs of size ~1 (about 1e-7),
    and 1e-5 leaves room for exp2 against exp and other summation
    orders."""
    B, H, Nq, Nk, D = 2, 2, 130, 1400, 96
    q = rng.standard_normal((B, H, Nq, D)).astype(np.float32) * 0.4
    k = rng.standard_normal((B, H, Nk, D)).astype(np.float32) * 0.4
    v = rng.standard_normal((B, H, Nk, D)).astype(np.float32)
    blocked = _blocked(rng, B, Nq, Nk)
    got = t_ma.masked_mha_split_ref(_t(q), _t(k), _t(v), _t(blocked),
                                    split_tiles=split_tiles).numpy()
    plain = t_ma.masked_mha_ref(_t(q), _t(k), _t(v), _t(blocked)).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(j_ma.pallas_masked_mha(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(blocked)))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[:, :, Nq // 2], 0.0)
    np.testing.assert_array_equal(got[-1, :, :64], 0.0)
    lists = t_ma.live_blocks(_t(blocked))
    assert max(len(t_ma.split_plan(len(x), split_tiles))
               for x in lists[0]) > 1
