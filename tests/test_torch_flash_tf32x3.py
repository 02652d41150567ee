"""The arithmetic of the f32 K4 and K5 on the Hopper f32 engine
(csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu: pre-split K/V (and Q/dO)
planes, 3xTF32 products, per-step f32 adds, dkdv's fixed query splits
merged in order), checked without a card: the split emulations
``flash_mha_split_ref`` and ``flash_mha_bwd_split_ref`` with their
products put through ``ops/tf32x3.py::matmul_tf32x3`` against the JAX
package's Pallas forward ``_flash_fwd`` and backward ``flash_bwd`` in
interpret mode.  Limits: the f32 limit of chip_smoke.py, 1e-4 — on the
output absolute, on the LSE relative to 1 + its max |value|, on each
gradient relative to its max |value| (K5's rule).  The CUDA kernels are
held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import flash_attention as t_fa
from panst3r_torch.ops.tf32x3 import matmul_tf32x3
from panst3r_tpu.ops.pallas import flash_attention as j_fa
from panst3r_tpu.ops.pallas import flash_attention_bwd as j_bwd
from panst3r_tpu.ops.rope import rope2d_tables
from tests.torch_release import release_memory  # noqa: F401

NEG = float(np.finfo(np.float32).min)
QK_STD = 1.4          # chip_smoke.py's: logits with a std of about 2
F32_TOL = 1e-4        # chip_smoke.py's limit for the f32 kernels
B, H, NQ, NK = 2, 2, 130, 333
CASES = ("plain", "kv_valid", "dense_bias", "rope", "masked_rows")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _inputs(case: str, D: int, Nq=NQ, Nk=NK, b=B, h=H):
    """q, k, v, do, bias, kv_valid, rope tables (jnp) for one case."""
    rng = np.random.default_rng(CASES.index(case) * 10 + D)

    def rnd(*shape, s=1.0):
        return jnp.asarray(rng.standard_normal(shape) * s, jnp.float32)

    q, k, v = rnd(b, h, Nq, D, s=QK_STD), rnd(b, h, Nk, D, s=QK_STD), \
        rnd(b, h, Nk, D)
    do = rnd(b, h, Nq, D)
    bias = kv_valid = rope = None
    if case == "dense_bias":
        x = rng.standard_normal((b, h, Nq, Nk))
        bias = jnp.asarray(np.where(rng.random(x.shape) < 0.2, NEG, x),
                           jnp.float32)
    if case in ("kv_valid", "masked_rows"):
        valid = rng.random((b, Nk)) > 0.2
        valid[0, 64:200] = False          # dead key tiles
        if case == "masked_rows":
            valid[1] = False              # batch 1 sees no key at all
        kv_valid = jnp.asarray(valid)
    if case == "rope":
        pos = [jnp.asarray(rng.integers(0, 24, (b, n, 2)), jnp.int32)
               for n in (Nq, Nk)]
        rope = (*rope2d_tables(pos[0], D), *rope2d_tables(pos[1], D))
    return q, k, v, do, bias, kv_valid, rope


def _rope_t(rope):
    return None if rope is None else tuple(map(_t, rope))


def _grad_ok(got, want, name):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= F32_TOL * float(np.abs(want).max()), (name, err)


def test_dkv_splits_and_key_tiles():
    """The dkdv split count and the key pre-pass's plain version: biases
    in log2 units padded to whole 32-key tiles, dead and past-Nk keys at
    finfo.min, only tiles with a live key listed."""
    assert t_fa.dkv_splits(130, 64) == 1
    assert t_fa.dkv_splits(49152) == 49152 // 64 // t_fa.SPLIT_TILES
    assert t_fa.dkv_splits(4097, 8) == 9
    row = torch.zeros(2, 70)
    row[0, :32] = NEG                       # tile 0 of batch 0 dead
    row[1, 5] = -2.0
    row[1] = torch.where(torch.arange(70) >= 64, NEG, row[1])
    bl, tiles = t_fa.key_tiles_ref(row, 2, 70)
    assert bl.shape == (2, 96)
    assert tiles == [[1, 2], [0, 1]]
    assert (bl[:, 70:] == NEG).all() and (bl[0, :32] == NEG).all()
    assert bl[1, 5] == np.float32(-2.0 * 1.4426950408889634)
    _, tiles = t_fa.key_tiles_ref(None, 1, 64)
    assert tiles == [[0, 1]]


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("case", CASES)
def test_flash_fwd_tf32x3_matches_pallas(case, D):
    """The f32 K4's arithmetic against the Pallas forward in interpret
    mode at a ragged shape (Nq = 130, Nk = 333); a batch without a live
    key gives 0 and the LSE finfo.min."""
    q, k, v, _, bias, kv_valid, rope = _inputs(case, D)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = (np.asarray(a) for a in j_fa._flash_fwd(
            q, k, v, bias, kv_valid, scale, rope=rope, with_lse=True))
    got, lse = t_fa.flash_mha_split_ref(
        _t(q), _t(k), _t(v), _t(bias), _t(kv_valid), _rope_t(rope), scale,
        with_lse=True, matmul=matmul_tf32x3)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(
        lse.numpy(), want_lse, rtol=0,
        atol=F32_TOL * (1 + float(np.abs(want_lse[want_lse > NEG]).max())))
    if case == "masked_rows":
        np.testing.assert_array_equal(got[1].numpy(), 0.0)
        np.testing.assert_array_equal(lse[1].numpy(), NEG)


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_tf32x3_matches_pallas(case, D):
    """The f32 K5's arithmetic (splits of one query tile, so that 130
    queries take three merged in order) against the Pallas backward in
    interpret mode, from the same output and LSE; rows without a live key
    get a zero dq."""
    q, k, v, do, bias, kv_valid, rope = _inputs(case, D)
    scale = D ** -0.5
    o, lse = t_fa.flash_mha_ref(_t(q), _t(k), _t(v), _t(bias), _t(kv_valid),
                                _rope_t(rope), scale, with_lse=True)
    with pltpu.force_tpu_interpret_mode():
        want = j_bwd.flash_bwd(q, k, v, bias, kv_valid, rope,
                               jnp.asarray(o.numpy()),
                               jnp.asarray(lse.numpy()), do, scale)
    assert t_fa.dkv_splits(NQ, 1) == 3
    got = t_fa.flash_mha_bwd_split_ref(
        _t(q), _t(k), _t(v), o, lse, _t(do), _t(bias), _t(kv_valid),
        _rope_t(rope), scale, split_tiles=1, matmul=matmul_tf32x3)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _grad_ok(a, w, name)
    if case == "masked_rows":
        np.testing.assert_array_equal(got[0][1].numpy(), 0.0)


def test_flash_bwd_tf32x3_long_query_walk():
    """One (b, h) with a 4608-query walk (72 query tiles: two fixed splits
    at SPLIT_TILES = 64): dk and dv, each summed per 8-query step in f32
    within a split and merged in order, stay within the f32 limit of the
    f64 gradients; so does dq."""
    assert t_fa.dkv_splits(4608) == 2
    q, k, v, do, *_ = (_t(a) for a in _inputs("plain", 96, Nq=4608, Nk=96,
                                              b=1, h=1)[:4])
    o, lse = t_fa.flash_mha_ref(q, k, v, with_lse=True)
    got = t_fa.flash_mha_bwd_split_ref(q, k, v, o, lse, do,
                                       matmul=matmul_tf32x3)
    exact = t_fa.flash_mha_bwd_ref(q.double(), k.double(), v.double(),
                                   o.double(), lse, do.double())
    for name, a, w in zip(("dq", "dk", "dv"), got, exact):
        _grad_ok(a, w.numpy(), name)
