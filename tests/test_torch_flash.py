"""K4's plain version (the CPU path of ``flash_mha``) against the JAX
package's Pallas flash kernel ``_flash_fwd`` in interpret mode and against
the jnp formula, f32, at head dims 64 and 96 (the kernel's instantiations).

Every case has ragged shapes (Nq = 130, Nk = 200: neither a multiple of the
Pallas blocks nor of the CUDA tiles).  Limits: 2e-5 abs + 2e-5 rel on the
output and the LSE — f32 rounding of a 200-term sum, where the Pallas
kernel works in the exp2 domain and the plain version in natural log.
The CUDA kernel is held against this plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import attention as t_attn
from panst3r_torch.ops import flash_attention as t_fa
from panst3r_tpu.ops import attention as j_attn
from panst3r_tpu.ops.pallas import flash_attention as j_fa
from panst3r_tpu.ops.rope import apply_rope_tables, rope2d_tables
from tests.torch_release import release_memory  # noqa: F401

NEG = float(np.finfo(np.float32).min)
B, H, NQ, NK = 2, 2, 130, 200
TOL = dict(atol=2e-5, rtol=2e-5)
CASES = ("plain", "dense_bias", "head_shared_bias", "kv_valid", "key_bias",
         "bias_and_kv_valid", "rope", "masked_rows")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _inputs(case: str, D: int):
    """q, k, v, bias, kv_valid, rope tables (jnp) for one case."""
    rng = np.random.default_rng(CASES.index(case) * 1000 + D)

    def rnd(*shape, s=1.0):
        return jnp.asarray(rng.standard_normal(shape) * s, jnp.float32)

    # logits at a std of about 2 (peaked, as in trained attention)
    q, k, v = rnd(B, H, NQ, D, s=1.4), rnd(B, H, NK, D, s=1.4), \
        rnd(B, H, NK, D)
    bias = kv_valid = rope = None
    if case in ("dense_bias", "bias_and_kv_valid"):
        b = rng.standard_normal((B, H, NQ, NK))
        bias = jnp.asarray(np.where(rng.random(b.shape) < 0.2, NEG, b),
                           jnp.float32)
    if case == "head_shared_bias":        # the dense mask-transformer form
        bias = jnp.asarray(np.where(rng.random((B, 1, NQ, NK)) < 0.5, NEG,
                                    0.0), jnp.float32)
    if case in ("kv_valid", "bias_and_kv_valid", "masked_rows"):
        valid = rng.random((B, NK)) > 0.2
        valid[0, 64:150] = False          # dead key tiles
        if case == "masked_rows":
            valid[1] = False              # batch 1 sees no key at all
        kv_valid = jnp.asarray(valid)
    if case == "key_bias":
        kb = rng.standard_normal((B, 1, 1, NK))
        kb[:, ..., 20:90] = NEG
        bias = jnp.asarray(kb, jnp.float32)
    if case == "rope":
        pos = [jnp.asarray(rng.integers(0, 24, (B, n, 2)), jnp.int32)
               for n in (NQ, NK)]
        rope = (*rope2d_tables(pos[0], D), *rope2d_tables(pos[1], D))
    return q, k, v, bias, kv_valid, rope


def _jnp_formula(q, k, v, bias, kv_valid, rope, scale):
    """Plain jnp attention and the natural-log LSE of its logits."""
    if rope is not None:
        q = apply_rope_tables(q, rope[0], rope[1])
        k = apply_rope_tables(k, rope[2], rope[3])
    mask = None if kv_valid is None else kv_valid[:, None, None, :]
    out = j_attn.dot_product_attention(q, k, v, bias=bias, mask=mask,
                                       scale=scale)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    if mask is not None:
        s = jnp.where(mask, s, NEG)
    return np.asarray(out), np.asarray(jax.nn.logsumexp(s, axis=-1))


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("case", CASES)
def test_flash_ref_matches_pallas_and_formula(case, D):
    q, k, v, bias, kv_valid, rope = _inputs(case, D)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        pallas, pallas_lse = (np.asarray(a) for a in j_fa._flash_fwd(
            q, k, v, bias, kv_valid, scale, rope=rope, with_lse=True))
    got, got_lse = t_fa.flash_mha(
        _t(q), _t(k), _t(v), bias=_t(bias), kv_valid=_t(kv_valid),
        rope=None if rope is None else tuple(map(_t, rope)), with_lse=True)
    got, got_lse = got.numpy(), got_lse.numpy()
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got_lse, pallas_lse, **TOL)

    want, want_lse = _jnp_formula(q, k, v, bias, kv_valid, rope, scale)
    live = np.ones(B, bool)
    if case == "masked_rows":
        # no live key: the kernels write 0 and the finfo.min LSE sentinel;
        # the jnp formula averages uniformly
        live[1] = False
        np.testing.assert_array_equal(pallas[1], 0.0)
        np.testing.assert_array_equal(got[1], 0.0)
        np.testing.assert_array_equal(pallas_lse[1], NEG)
        np.testing.assert_array_equal(got_lse[1], NEG)
    np.testing.assert_allclose(got[live], want[live], **TOL)
    np.testing.assert_allclose(got_lse[live], want_lse[live], **TOL)


@pytest.mark.parametrize("D", [64, 96])
def test_routing_reaches_k4_like_the_jax_wrappers(D):
    """ops/attention: the non-tiny flash and RoPE-table paths run K4 (its
    plain version here) and agree with the JAX entry points on the CPU; a
    tiny shape keeps the plain formula."""
    q, k, v, _, _, rope = _inputs("rope", D)
    j_tabs = ((rope[0], rope[1]), (rope[2], rope[3]))
    t_tabs = tuple(tuple(map(_t, tab)) for tab in j_tabs)
    want = j_attn.flash_attention_rope2d_tables(q, k, v, *j_tabs)
    got = t_attn.flash_attention_rope2d_tables(_t(q), _t(k), _t(v), *t_tabs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    n0 = t_fa.flash_mha.launches
    want = j_attn.flash_attention(q, k, v)
    got = t_attn.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tiny = t_attn.flash_attention(_t(q[:, :, :100]), _t(k), _t(v))
    np.testing.assert_allclose(
        tiny.numpy(), np.asarray(j_attn.flash_attention(q[:, :, :100], k, v)),
        **TOL)
    assert t_fa.flash_mha.launches == n0      # the CPU path launches nothing


def test_dense_mask_path_matches_jax(monkeypatch):
    """PANST3R_DISABLE_SPARSE_MASK=1: the masked attention takes the dense
    path (K4 with a head-shared finfo.min bias); the JAX package runs the
    jnp formula there."""
    monkeypatch.setenv("PANST3R_DISABLE_SPARSE_MASK", "1")
    rng = np.random.default_rng(5)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 2, n, 96)) * 0.5,
                           jnp.float32) for n in (40, 300, 300))
    blocked = rng.random((1, 40, 300)) < 0.6
    blocked[:, :, 0] = False
    want = j_attn.masked_attention(q, k, v, jnp.asarray(blocked))
    got = t_attn.masked_attention(_t(q), _t(k), _t(v), _t(blocked))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_mha_refuses_other_head_dims(monkeypatch):
    """Off the CPU (meta tensors stand in for the card here) K4 refuses
    half floats at any head dim, and a head dim above 128 no longer
    raises: it goes to the wide-head engine at D rounded up to 64 (its
    launch replaced by a recorder), never to the D <= 128 engines."""
    for D in (64, 160):
        q = torch.empty(1, 2, 300, D, dtype=torch.float16, device="meta")
        with pytest.raises(TypeError):
            t_fa.flash_mha(q, q, q)
    seen = []

    def wide(q, *a):
        seen.append(q.shape[-1])
        return q, None

    def narrow(*a):
        raise AssertionError("a head dim above 128 reached K4's engines")

    monkeypatch.setattr(t_fa, "_flash_wide_fwd_launch", wide)
    monkeypatch.setattr(t_fa, "_flash_fwd_launch", narrow)
    for D in (160, 256):
        q = torch.empty(1, 2, 300, D, device="meta")
        assert t_fa.flash_mha(q, q, q).shape == q.shape
    assert seen == [192, 256]
