"""The arithmetic of the Hopper engine's bf16 K1/K2 (csrc/attn_sm90.cuh,
csrc/tower_cross_sm90.cu) that can be checked without a card, in f32: K2's
split plan, its pre-pass (rotation, padded log2 bias, live-tile list) and
its split-then-merge softmax, against the port's plain version and the JAX
package (its RoPE, its jnp reference and the Pallas kernel's tile skip in
interpret mode).  The CUDA kernels are held against the plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import tower_attention as t_ta
from panst3r_tpu.ops.pallas import tower_attention as j_ta
from panst3r_tpu.ops.rope import apply_rope_tables, rope2d_tables

NEG = float(np.finfo(np.float32).min)
SCALE = 64 ** -0.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _tabs(rng, B, N):
    pos = jnp.asarray(rng.integers(0, 32, (B, N, 2)), jnp.int32)
    return rope2d_tables(pos, 64)


def _bias(rng, B, Nk):
    """Per batch: live keys with dead tiles inside, a soft span and -inf
    keys; one whole tile at -inf; batch 1 with no live key at all."""
    valid = rng.random((B, Nk)) > 0.2
    valid[:, 300:900] = False                 # whole dead tiles
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    bias[:, 10:40] = -0.7
    bias[:, -3:] = -np.inf
    bias[:, 1024:1152] = -np.inf              # a tile of -inf keys
    if B > 1:
        bias[1] = NEG
    return bias


@pytest.mark.parametrize("live", [0, 1, 15, 16, 17, 96, 102])
def test_split_plan_covers_live_tiles_in_fixed_runs(live):
    plan = t_ta.split_plan(live)
    assert len(plan) == max(1, math.ceil(live / t_ta.SPLIT_TILES))
    assert plan[0][0] == 0 and plan[-1][1] == live
    for (a, z), (a2, _) in zip(plan, plan[1:]):
        assert z == a2 and z - a == t_ta.SPLIT_TILES
    assert all(0 <= z - a <= t_ta.SPLIT_TILES for a, z in plan)
    # the grid's depth covers any batch of Nk keys
    Nk = max(live, 1) * t_ta.BLOCK_K
    assert t_ta.max_splits(Nk) >= len(plan)


def test_split_plan_depends_on_the_batch_alone(rng):
    """A batch's live tiles, and so its splits, are the same in the full
    call, in its own batch slice and in every chunk of query rows: they
    come from its key bias and Nk only."""
    B, Nq, Nk, C = 3, 50, 2950, 128
    q = torch.from_numpy(rng.standard_normal((B, Nq, C)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Nk, C)).astype(np.float32))
    bias = torch.from_numpy(_bias(rng, B, Nk))
    bias[2, 2000:] = NEG
    _, _, bl, tiles = t_ta.cross_prepass_ref(q, k, kv_bias=bias)
    assert [len(t) for t in tiles] == [19, 0, 11]    # 24 tiles, 5 dead
    for b in range(B):
        _, _, bl_b, tiles_b = t_ta.cross_prepass_ref(
            q[b:b + 1], k[b:b + 1], kv_bias=bias[b:b + 1])
        assert tiles_b == [tiles[b]]
        assert torch.equal(bl_b, bl[b:b + 1])
        for a, n in ((0, 7), (7, 43), (49, 1)):
            _, _, _, tiles_c = t_ta.cross_prepass_ref(
                q[b:b + 1, a:a + n], k[b:b + 1], kv_bias=bias[b:b + 1])
            assert tiles_c == [tiles[b]]
        assert t_ta.split_plan(len(tiles_b[0])) \
            == t_ta.split_plan(len(tiles[b]))
    # the CTA size is the only thing B and Nq choose, and it changes no
    # row's arithmetic
    assert t_ta.cta_warpgroups(1, 12, 768, 7) == 2
    assert t_ta.cta_warpgroups(1, 12, 64, 1) == 1


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("split_tiles", [t_ta.SPLIT_TILES, 4, 1])
def test_split_merge_matches_plain_and_jax(rng, rope, split_tiles):
    """K2's split-then-merge arithmetic (p rounded to v's dtype, merged in
    split order) against the single-pass plain version and JAX's jnp
    reference, with live, dead and -inf tiles and a batch with no live key.
    1e-5: in f32 the rounding of p is exact, and the merge re-weights each
    split's sums by exp2(m_s - max m); both differ from one softmax pass by
    f32 rounding of outputs of size ~1 (about 1e-7), and 1e-5 leaves room
    for exp2 against exp and other summation orders."""
    B, Nq, Nk, C = 3, 40, 3000, 128          # 24 key tiles, 4 dead
    q = rng.standard_normal((B, Nq, C)).astype(np.float32) * 0.7
    k = rng.standard_normal((B, Nk, C)).astype(np.float32) * 0.7
    v = rng.standard_normal((B, Nk, C)).astype(np.float32)
    bias = _bias(rng, B, Nk)
    qtab = _tabs(rng, B, Nq) if rope else None
    ktab = _tabs(rng, B, Nk) if rope else None
    conv = (lambda t: None if t is None else tuple(map(_t, t)))
    got = t_ta.tower_cross_split_ref(
        _t(q), _t(k), _t(v), conv(qtab), conv(ktab), _t(bias), SCALE,
        split_tiles=split_tiles).numpy()
    plain = t_ta.tower_cross_attention_ref(
        _t(q), _t(k), _t(v), conv(qtab), conv(ktab), _t(bias), SCALE).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[1], 0.0)   # no live key
    # the jnp reference averages a row with no live key uniformly (the
    # kernels write 0), so batch 1 is left out of that comparison
    ref = np.asarray(j_ta._cross_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), qtab, ktab,
                                     jnp.asarray(bias), SCALE))
    np.testing.assert_allclose(got[[0, 2]], ref[[0, 2]], atol=1e-5,
                               rtol=1e-5)
    live = [len(t) for t in t_ta.cross_prepass_ref(
        _t(q), _t(k), kv_bias=_t(bias))[3]]
    assert len(t_ta.split_plan(live[0], split_tiles)) > 1


def test_prepass_matches_jax_rope_and_tile_skip(rng):
    """The pre-pass's plain version: q~ = scale·rope(q) and k~ = rope(k)
    equal JAX's RoPE in f32; the padded bias is bias·log2(e), NEG where
    dead; and its live tiles are exactly the 128-key tiles the Pallas
    kernel computes.  That is probed in interpret mode with NaN keys:
    batch 0 puts NaN into every dead tile and must come out finite and
    right (the kernel skipped them); batch 1 + i puts NaN into the i-th
    live tile and must come out NaN (the kernel computed it)."""
    Nq, Nk, C = 8, 1100, 128                  # 9 tiles, the last ragged
    bias = np.zeros(Nk, np.float32)
    bias[128:256] = NEG                       # tile 1 dead
    bias[512:768] = -np.inf                   # tiles 4, 5 dead
    bias[300:310] = NEG                       # dead keys in a live tile
    bias[1000:] = -0.5
    q = rng.standard_normal((1, Nq, C)).astype(np.float32)
    k = rng.standard_normal((1, Nk, C)).astype(np.float32)
    v = rng.standard_normal((1, Nk, C)).astype(np.float32)
    qtab, ktab = _tabs(rng, 1, Nq), _tabs(rng, 1, Nk)

    qs, ks, bl, tiles = t_ta.cross_prepass_ref(
        _t(q), _t(k), tuple(map(_t, qtab)), tuple(map(_t, ktab)),
        _t(bias[None]), SCALE)
    split = (lambda x: x.reshape(1, -1, C // 64, 64).transpose(0, 2, 1, 3))
    merge = (lambda x: x.transpose(0, 2, 1, 3).reshape(1, -1, C))
    jq = merge(np.asarray(apply_rope_tables(jnp.asarray(split(q)), *qtab)))
    jk = merge(np.asarray(apply_rope_tables(jnp.asarray(split(k)), *ktab)))
    np.testing.assert_allclose(qs.numpy(), SCALE * jq, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ks.numpy(), jk, atol=1e-6, rtol=1e-6)
    want_bl = np.full(9 * 128, NEG, np.float32)
    live_key = bias > NEG / 2
    want_bl[:Nk][live_key] = bias[live_key] * np.float32(math.log2(math.e))
    np.testing.assert_array_equal(bl.numpy()[0], want_bl)
    assert tiles == [[0, 2, 3, 6, 7, 8]]

    live = tiles[0]
    dead = [t for t in range(9) if t not in live]
    nb = 1 + len(live)
    kk = np.repeat(k, nb, 0)
    for t in dead:
        kk[0, t * 128:(t + 1) * 128] = np.nan
    for i, t in enumerate(live):
        kk[1 + i, t * 128:min((t + 1) * 128, Nk)] = np.nan
    rep = (lambda a: jnp.asarray(np.repeat(np.asarray(a), nb, 0)))
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(j_ta._cross_fwd(
            rep(q), jnp.asarray(kk), rep(v), tuple(map(rep, qtab)),
            tuple(map(rep, ktab)), rep(bias[None]), SCALE, block_k=128))
    clean = t_ta.tower_cross_attention_ref(
        _t(q), _t(k), _t(v), tuple(map(_t, qtab)), tuple(map(_t, ktab)),
        _t(bias[None]), SCALE).numpy()
    np.testing.assert_allclose(out[0], clean[0], atol=2e-5, rtol=2e-5)
    assert np.isnan(out[1:]).all(axis=(1, 2)).all()
