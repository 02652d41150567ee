"""K5's plain version (``flash_mha_bwd_ref``, the CPU path of
``flash_mha_bwd``) against the JAX package's Pallas backward ``flash_bwd``
in interpret mode, and the K4 autograd function on the CPU against
``jax.vjp`` of the jnp attention, f32, at head dims 64 and 96.

Shapes are ragged (Nq = 130, Nk = 200: neither a multiple of the Pallas
blocks nor of the CUDA tiles).  Limits: 1e-5 abs + 1e-5 rel — f32 rounding
of 200-term sums; the Pallas kernels work from the same LSE and formulas.
The CUDA kernels are held against this plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import flash_attention as t_fa
from panst3r_tpu.ops import attention as j_attn
from panst3r_tpu.ops.pallas import flash_attention_bwd as j_bwd
from panst3r_tpu.ops.rope import apply_rope_tables, rope2d_tables

NEG = float(np.finfo(np.float32).min)
B, H, NQ, NK = 1, 2, 130, 200
TOL = dict(atol=1e-5, rtol=1e-5)
CASES = ("plain", "bias", "kv_valid", "rope")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _inputs(case: str, D: int):
    """q, k, v, do, bias, kv_valid, rope tables (jnp) for one case."""
    rng = np.random.default_rng(CASES.index(case) * 100 + D)

    def rnd(*shape, s=1.0):
        return jnp.asarray(rng.standard_normal(shape) * s, jnp.float32)

    # logits at a std of about 2 (peaked, as in trained attention)
    q, k, v = rnd(B, H, NQ, D, s=1.4), rnd(B, H, NK, D, s=1.4), \
        rnd(B, H, NK, D)
    do = rnd(B, H, NQ, D)
    bias = kv_valid = rope = None
    if case == "bias":                 # dense, head-shared, with masked keys
        b = rng.standard_normal((B, 1, NQ, NK))
        bias = jnp.asarray(np.where(rng.random(b.shape) < 0.3, NEG, b),
                           jnp.float32)
    if case == "kv_valid":
        valid = rng.random((B, NK)) > 0.2
        valid[:, 64:150] = False       # dead key tiles
        kv_valid = jnp.asarray(valid)
    if case == "rope":
        pos = [jnp.asarray(rng.integers(0, 24, (B, n, 2)), jnp.int32)
               for n in (NQ, NK)]
        rope = (*rope2d_tables(pos[0], D), *rope2d_tables(pos[1], D))
    return q, k, v, do, bias, kv_valid, rope


def _rope_t(rope):
    return None if rope is None else tuple(map(_t, rope))


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_ref_matches_pallas(case, D):
    q, k, v, do, bias, kv_valid, rope = _inputs(case, D)
    scale = D ** -0.5
    # the forward's output and LSE (K4's plain version, held against the
    # Pallas forward in tests/test_torch_flash.py) feed both backwards
    o, lse = (np.asarray(a) for a in t_fa.flash_mha_ref(
        _t(q), _t(k), _t(v), _t(bias), _t(kv_valid), _rope_t(rope), scale,
        with_lse=True))
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(g) for g in j_bwd.flash_bwd(
            q, k, v, bias, kv_valid, rope, jnp.asarray(o), jnp.asarray(lse),
            do, scale)]
    n0 = t_fa.flash_mha_bwd.launches
    got = t_fa.flash_mha_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(do),
                             bias=_t(bias), kv_valid=_t(kv_valid),
                             rope=_rope_t(rope), scale=scale)
    assert t_fa.flash_mha_bwd.launches == n0      # the CPU runs no kernel
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("case", CASES)
def test_flash_mha_autograd_matches_jax_vjp(case, D):
    """Gradients through ``flash_mha`` (K4 forward with the LSE, K5
    backward: plain versions on the CPU) against ``jax.vjp`` of the jnp
    attention, which the JAX package's default backward differentiates
    (flash_attention.py:443-454)."""
    q, k, v, do, bias, kv_valid, rope = _inputs(case, D)

    def ref(q, k, v):
        if rope is not None:
            q = apply_rope_tables(q, rope[0], rope[1])
            k = apply_rope_tables(k, rope[2], rope[3])
        mask = None if kv_valid is None else kv_valid[:, None, None, :]
        return j_attn.dot_product_attention(q, k, v, bias=bias, mask=mask)

    want_out, vjp = jax.vjp(ref, q, k, v)
    want = [np.asarray(g) for g in vjp(do)]
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = t_fa.flash_mha(tq, tk, tv, bias=_t(bias), kv_valid=_t(kv_valid),
                         rope=_rope_t(rope))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    out.backward(_t(do))
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), w, err_msg=name, **TOL)


def test_flash_mha_keeps_lse_only_for_gradients():
    """Without a gradient (no_grad, or inputs that need none) the forward
    computes no LSE for the backward; with ``with_lse`` the LSE is returned
    and has no gradient."""
    q, k, v, *_ = (_t(a) for a in _inputs("plain", 64)[:3])
    out = t_fa.flash_mha(q, k, v)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert t_fa.flash_mha(qg, k, v).grad_fn is None
    out, lse = t_fa.flash_mha(qg, k, v, with_lse=True)
    assert out.grad_fn is not None and not lse.requires_grad


def test_flash_mha_bwd_refuses_other_head_dims():
    """Off the CPU K5 takes D = 64 and 96 only (meta tensors stand in for
    the card here)."""
    q = torch.empty(1, 2, 300, 32, device="meta")
    lse = torch.empty(1, 2, 300, device="meta")
    with pytest.raises(NotImplementedError, match="K4/K5"):
        t_fa.flash_mha_bwd(q, q, q, q, lse, q)
