"""The arithmetic of the f32 Hopper engine (csrc/attn_f32_sm90.cuh: 3xTF32
tensor-core products) that can be checked without a card: the TF32
rounding of ``cvt.rna.tf32.f32`` (``ops/tf32x3.py::tf32_round``) against
JAX's ``reduce_precision``, the 3xTF32 product against f64, why one TF32
product is not enough at the f32 limit of 1e-4, and K2's and K3's
split-then-merge plain versions with their products put through the
3xTF32 emulation against the JAX package (K2's jnp reference, K3's Pallas
kernel in interpret mode).  The CUDA kernels are held against the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import masked_attention as t_ma
from panst3r_torch.ops import tower_attention as t_ta
from panst3r_torch.ops.tf32x3 import (matmul_tf32, matmul_tf32x3,
                                      split_tf32, tf32_round)
from panst3r_tpu.ops.pallas import masked_attention as j_ma
from panst3r_tpu.ops.pallas import tower_attention as j_ta
from panst3r_tpu.ops.rope import rope2d_tables
from tests.torch_release import release_memory  # noqa: F401

NEG = float(np.finfo(np.float32).min)
QK_STD = 1.4          # chip_smoke.py's: logits with a std of about 2
F32_TOL = 1e-4        # chip_smoke.py's limit for the f32 kernels


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _jax_tf32(x):
    """JAX's TF32 rounding: to nearest, ties to even."""
    return np.asarray(jax.lax.reduce_precision(
        jnp.asarray(x), exponent_bits=8, mantissa_bits=10))


# (input bits, tf32 bits with ties away from zero)
_CASES = [
    (0x3F801000, 0x3F802000),   # 1 + 2^-11: a tie, away (even: 1.0)
    (0xBF801000, 0xBF802000),   # its negative
    (0x3F803000, 0x3F804000),   # a tie where even and away agree
    (0x3F800FFF, 0x3F800000),   # just below a tie: down
    (0x3F801001, 0x3F802000),   # just above: up
    (0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000),   # -0
    (0x00000001, 0x00000000),   # the least subnormal: to 0
    (0x00001000, 0x00002000),   # a subnormal tie: away
    (0x80001001, 0x80002000),   # a negative subnormal: up in magnitude
    (0x007FF000, 0x00800000),   # the largest subnormals round to a normal
    (0x7F7FFFFF, 0x7F800000),   # the largest finite value: to inf
    (0x7F800000, 0x7F800000),   # inf
    (0xFF800000, 0xFF800000),   # -inf
]


def test_tf32_round_hand_made_cases_and_jax():
    """Ties go away from zero, as cvt.rna does; ±0, subnormals, overflow to
    inf and infinities as IEEE rounding gives them; NaN stays NaN.  JAX's
    reduce_precision (ties to even) agrees everywhere except at the ties
    whose kept last bit is even."""
    src = np.array([c[0] for c in _CASES], np.uint32).view(np.float32)
    got = _bits(tf32_round(_t(src)).numpy())
    np.testing.assert_array_equal(got, [c[1] for c in _CASES])
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()
    jx = _bits(_jax_tf32(src))
    tie = (src.view(np.uint32) & 0x1FFF) == 0x1000
    even = (src.view(np.uint32) & 0x2000) == 0
    np.testing.assert_array_equal(got[~(tie & even)], jx[~(tie & even)])
    assert (got[tie & even] != jx[tie & even]).all()


def test_tf32_round_agrees_with_jax_off_ties(rng):
    """Random values over the whole f32 range, subnormals included: equal
    to JAX's rounding bit for bit wherever the dropped bits are not
    exactly half a unit; low 13 bits always clear."""
    raw = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32)
    raw[:1000] &= 0x807FFFFF                   # subnormals
    raw[1000:2000] = (raw[1000:2000] & ~np.uint32(0x1FFF)) | 0x1000  # ties
    x = raw.view(np.float32)
    finite = np.isfinite(x)
    got = _bits(tf32_round(_t(x)).numpy())
    jx = _bits(_jax_tf32(x))
    tie = (raw & 0x1FFF) == 0x1000
    ok = finite & ~tie
    np.testing.assert_array_equal(got[ok], jx[ok])
    assert ((got[finite] & 0x1FFF) == 0).all()
    assert (tie & finite).sum() >= 900


def test_split_tf32_is_exact_to_2_pow_minus_22(rng):
    x = rng.standard_normal(10_000).astype(np.float32) * np.float32(
        10.0) ** rng.integers(-20, 20, 10_000)
    hi, lo = split_tf32(_t(x))
    for t in (hi, lo):
        assert ((_bits(t.numpy()) & 0x1FFF) == 0).all()
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x)
    assert (err <= 2.0 ** -22 * np.abs(x)).all()


@pytest.mark.parametrize("shape", [(16, 64, 64), (64, 96, 8), (3, 200, 40)])
def test_matmul_tf32x3_against_f64(rng, shape):
    """Each entry within 2^-20 Σ|a||b| of the f64 product, with operands
    spread over six decades."""
    m, k, n = shape
    a = rng.standard_normal((m, k)) * 10.0 ** rng.uniform(-3, 3, (m, k))
    b = rng.standard_normal((k, n)) * 10.0 ** rng.uniform(-3, 3, (k, n))
    a, b = a.astype(np.float32), b.astype(np.float32)
    got = matmul_tf32x3(_t(a), _t(b)).double().numpy()
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert (np.abs(got - exact) <= 2.0 ** -20 * scale).all()


def _masked_inputs(rng, B, H, Nq, Nk, D):
    q = (rng.standard_normal((B, H, Nq, D)) * QK_STD).astype(np.float32)
    k = (rng.standard_normal((B, H, Nk, D)) * QK_STD).astype(np.float32)
    v = rng.standard_normal((B, H, Nk, D)).astype(np.float32)
    blocked = np.ones((B, Nq, Nk), bool)
    for b in range(B):
        starts = rng.integers(0, max(1, Nk - 200), 4)
        for qi in range(Nq):
            s = starts[qi % 4]
            blocked[b, qi, s:s + 60 + 40 * (qi % 4)] = False
    blocked &= rng.random((B, Nq, Nk)) > 0.003
    blocked[:, Nq // 2] = True                 # a fully blocked row
    if B > 1:
        blocked[-1, :64] = True                # a dead query block
    return q, k, v, blocked


def test_one_tf32_product_misses_the_f32_limit(rng):
    """At attention-like inputs (logits with a std of about 2) one TF32
    product per matmul moves K3's output by more than 1e-4 from f64, the
    3xTF32 split stays far inside: the reason for three terms."""
    q, k, v, blocked = _masked_inputs(rng, 1, 2, 64, 640, 96)
    exact = t_ma.masked_mha_ref(*(_t(x).double() for x in (q, k, v)),
                                _t(blocked)).numpy()
    err = {}
    for name, mm in (("tf32", matmul_tf32), ("tf32x3", matmul_tf32x3)):
        got = t_ma.masked_mha_split_ref(_t(q), _t(k), _t(v), _t(blocked),
                                        matmul=mm).numpy()
        err[name] = float(np.abs(got - exact).max())
    assert err["tf32"] > F32_TOL, err
    assert err["tf32x3"] < F32_TOL / 10, err


@pytest.mark.parametrize("rope", [True, False])
def test_k2_tf32x3_split_merge_matches_jax(rng, rope):
    """K2's f32 arithmetic (pre-pass, 3xTF32 products, splits merged in
    order) against JAX's jnp reference within the f32 limit, at C = 128
    (two d=64 heads) with RoPE, live, dead and -inf tiles, a soft-biased
    span and a batch with no live key (0: the jnp reference averages such
    a row uniformly, so it is left out of that comparison)."""
    B, Nq, Nk, C = 3, 40, 3000, 128          # 24 key tiles, several dead
    q = (rng.standard_normal((B, Nq, C)) * QK_STD).astype(np.float32)
    k = (rng.standard_normal((B, Nk, C)) * QK_STD).astype(np.float32)
    v = rng.standard_normal((B, Nk, C)).astype(np.float32)
    valid = rng.random((B, Nk)) > 0.2
    valid[:, 300:900] = False
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    bias[:, 10:40] = -0.7
    bias[:, -3:] = -np.inf
    bias[:, 1024:1152] = -np.inf
    bias[1] = NEG
    tabs = None
    if rope:
        tabs = [rope2d_tables(jnp.asarray(rng.integers(0, 32, (B, n, 2)),
                                          jnp.int32), 64) for n in (Nq, Nk)]
    conv = (lambda t: None if t is None else tuple(map(_t, t)))
    got = t_ta.tower_cross_split_ref(
        _t(q), _t(k), _t(v), conv(tabs and tabs[0]), conv(tabs and tabs[1]),
        _t(bias), 64 ** -0.5, split_tiles=4, matmul=matmul_tf32x3).numpy()
    ref = np.asarray(j_ta._cross_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        tabs and tabs[0], tabs and tabs[1], jnp.asarray(bias), 64 ** -0.5))
    np.testing.assert_allclose(got[[0, 2]], ref[[0, 2]], atol=F32_TOL, rtol=0)
    np.testing.assert_array_equal(got[1], 0.0)


def test_k3_tf32x3_split_merge_matches_pallas(rng):
    """K3's f32 arithmetic (3xTF32 products, runs of live blocks merged in
    order) against the Pallas kernel in interpret mode within the f32
    limit, at a ragged shape (Nq = 130, Nk = 1400, d = 96) with dead
    blocks, a fully blocked row and a dead query block, which give 0."""
    B, H, Nq, Nk, D = 2, 2, 130, 1400, 96
    q, k, v, blocked = _masked_inputs(rng, B, H, Nq, Nk, D)
    got = t_ma.masked_mha_split_ref(_t(q), _t(k), _t(v), _t(blocked),
                                    split_tiles=3,
                                    matmul=matmul_tf32x3).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(j_ma.pallas_masked_mha(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(blocked)))
    np.testing.assert_allclose(got, pallas, atol=F32_TOL, rtol=0)
    np.testing.assert_array_equal(got[:, :, Nq // 2], 0.0)
    np.testing.assert_array_equal(got[-1, :, :64], 0.0)
