"""panst3r_torch ops against their panst3r_tpu twins on the CPU (f32).

Inputs come from numpy (seeded) and go through both the JAX function and
its port; tolerances are stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from panst3r_torch.ops import attention as t_attn
from panst3r_torch.ops import gelu as t_gelu
from panst3r_torch.ops import image as t_image
from panst3r_torch.ops import rope as t_rope
from panst3r_tpu.models.blocks import gelu_exact as j_gelu_exact
from panst3r_tpu.ops import attention as j_attn
from panst3r_tpu.ops import image as j_image
from panst3r_tpu.ops import rope as j_rope
from tests.torch_release import release_memory  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rope_tables_and_apply(rng):
    pos = rng.integers(0, 40, (2, 11, 2)).astype(np.int32)
    jc, js = j_rope.rope2d_tables(jnp.asarray(pos), 64)
    tc, ts = t_rope.rope2d_tables(_t(pos), 64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    x = rng.standard_normal((2, 3, 11, 64)).astype(np.float32)
    want = j_rope.apply_rope_tables(jnp.asarray(x), jc, js)
    got = t_rope.apply_rope_tables(_t(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the kernels' f32 form agrees in f32, and equals the positions form
    got32 = t_rope.apply_rope_tables_f32(_t(x), tc, ts)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want), atol=1e-5)
    want2 = j_rope.apply_rope_2d(jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want2), atol=1e-5)
    np.testing.assert_array_equal(
        t_rope._rotate_half_2d(_t(x)).numpy(),
        np.asarray(j_rope._rotate_half_2d(jnp.asarray(x))))
    np.testing.assert_array_equal(
        t_rope.patch_grid_positions(3, 5).numpy(),
        np.asarray(j_rope.patch_grid_positions(3, 5)))


@pytest.mark.parametrize("kind", ["plain", "bias", "mask"])
def test_dot_product_attention(rng, kind):
    q = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if kind == "bias":
        b = rng.standard_normal((2, 1, 7, 9)).astype(np.float32)
        kw_j["bias"], kw_t["bias"] = jnp.asarray(b), _t(b)
    if kind == "mask":
        m = rng.random((2, 1, 7, 9)) > 0.3
        m[..., 0] = True
        kw_j["mask"], kw_t["mask"] = jnp.asarray(m), _t(m)
    want = j_attn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **kw_j)
    got = t_attn.dot_product_attention(_t(q), _t(k), _t(v), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_memory_mask_bias(rng):
    valid = rng.random((2, 13)) > 0.5
    want = j_attn.memory_mask_bias(jnp.asarray(valid))
    got = t_attn.memory_mask_bias(_t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min().item() == float(np.finfo(np.float32).min)


def test_gelu_policy(rng, monkeypatch):
    x = (rng.standard_normal(4096) * 4).astype(np.float32)
    # f32: exact erf on both sides
    np.testing.assert_allclose(
        t_gelu.gelu_exact(_t(x)).numpy(),
        np.asarray(j_gelu_exact(jnp.asarray(x))), atol=1e-6)
    xb = jnp.asarray(x, jnp.bfloat16)
    tb = _t(x).to(torch.bfloat16)

    def as_f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    # bf16 default: the tanh form on both sides.  XLA rounds between the
    # ops of the formula, torch once, so the two agree within 2 bf16 ulps.
    monkeypatch.delenv("PANST3R_EXACT_GELU", raising=False)
    got = t_gelu.gelu_exact(tb).float().numpy()
    np.testing.assert_array_equal(
        got, F.gelu(tb, approximate="tanh").float().numpy())
    np.testing.assert_allclose(got, as_f32(j_gelu_exact(xb)), rtol=1.6e-2,
                               atol=4e-3)
    # PANST3R_EXACT_GELU=1: exact erf (JAX fast_gelu is bit-identical to it)
    monkeypatch.setenv("PANST3R_EXACT_GELU", "1")
    got = t_gelu.gelu_exact(tb).float().numpy()
    np.testing.assert_array_equal(got, F.gelu(tb).float().numpy())
    np.testing.assert_allclose(got, as_f32(j_gelu_exact(xb)), rtol=8e-3,
                               atol=1e-6)


@pytest.mark.parametrize("shape_in,shape_out,method", [
    ((1, 37, 37, 5), (1, 24, 32, 5), "bicubic"),   # DINO pos-embed
    ((2, 3, 48, 64, 4), (2, 3, 6, 8, 4), "bilinear"),  # 8x down, antialias
    ((1, 2, 3, 16, 24), (1, 2, 3, 32, 48), "bilinear"),  # fusion upsample
])
def test_resize_matches_jax_image_resize(rng, shape_in, shape_out, method):
    x = rng.standard_normal(shape_in).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), shape_out, method=method)
    got = t_image.resize(_t(x), shape_out, method)
    # same f32 weights; the contraction order differs (einsum vs matmul)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_resize_bilinear_torch_exact(rng):
    x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    want = j_image.resize_bilinear(jnp.asarray(x), 28, 42)
    got = t_image.resize_bilinear(_t(x), 28, 42)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    ref = F.interpolate(_t(x).permute(0, 3, 1, 2), size=(28, 42),
                        mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_image_cast(rng, kind):
    from panst3r_tpu.engine.inference import _image_cast

    img = rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8)
    if kind == "float":
        img = (img / 127.5 - 1.0).astype(np.float32)
    for amp in (False, True):
        want = np.asarray(jnp.asarray(_image_cast(jnp.asarray(img), amp),
                                      jnp.float32))
        got = t_image.image_cast(_t(img), amp).float().numpy()
        # bf16 (amp): the two frameworks round the same values; f32 exact
        np.testing.assert_allclose(got, want, atol=1e-6 if not amp else 8e-3)


def test_image_cast_uint8_is_bit_exact():
    """Every uint8 value normalizes to exactly the JAX package's value, in
    f32 and under amp: the v2 head's Fourier features multiply a one-ulp
    difference by up to e^10 (tests/test_torch_cuda.py holds the card to
    the same values)."""
    from panst3r_tpu.engine.inference import _image_cast

    img = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    for amp in (False, True):
        want = np.asarray(jnp.asarray(_image_cast(jnp.asarray(img), amp),
                                      jnp.float32))
        got = t_image.image_cast(_t(img), amp).float().numpy()
        np.testing.assert_array_equal(got, want)
