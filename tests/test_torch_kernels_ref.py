"""Plain versions of K1-K3 (the CPU path of the kernel wrappers) against the
JAX Pallas kernels in interpret mode and against the JAX references, f32.

The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py (no CUDA kernel has an interpret mode).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import masked_attention as t_ma
from panst3r_torch.ops import tower_attention as t_ta
from panst3r_tpu.ops.attention import dot_product_attention
from panst3r_tpu.ops.pallas import masked_attention as j_ma
from panst3r_tpu.ops.pallas import tower_attention as j_ta
from panst3r_tpu.ops.rope import rope2d_tables
from tests.torch_release import release_memory  # noqa: F401

NEG = float(np.finfo(np.float32).min)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tabs(rng, B, N):
    pos = jnp.asarray(rng.integers(0, 32, (B, N, 2)), jnp.int32)
    return rope2d_tables(pos, 64)


@pytest.mark.parametrize("N,rope,cls", [(128, False, False),
                                        (200, True, False),
                                        (200, False, True),
                                        (128, True, True)])
def test_tower_self_ref_matches_pallas(rng, N, rope, cls):
    B, C = 2, 128
    scale = 64 ** -0.5
    qkv = jnp.asarray(rng.standard_normal((B, N, 3 * C)) * 0.5, jnp.float32)
    tabs = _tabs(rng, B, N) if rope else None
    ckv = None
    if cls:
        ckv = (jnp.asarray(rng.standard_normal((B, 1, C)) * 0.5, jnp.float32),
               jnp.asarray(rng.standard_normal((B, 1, C)), jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(j_ta._tower_fwd(qkv, tabs, ckv, scale))
    ref = np.asarray(j_ta._tower_ref(qkv, tabs, ckv, scale))
    got = t_ta.tower_self_attention(
        _t(qkv), C // 64, tabs=None if tabs is None else tuple(map(_t, tabs)),
        cls_kv=None if ckv is None else tuple(map(_t, ckv))).numpy()
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("Nq,Nk,rope", [(128, 200, True), (200, 640, False)])
def test_tower_cross_ref_matches_pallas(rng, Nq, Nk, rope):
    B, C = 2, 128
    scale = 64 ** -0.5
    q = jnp.asarray(rng.standard_normal((B, Nq, C)) * 0.5, jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, Nk, C)) * 0.5, jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, Nk, C)), jnp.float32)
    valid = rng.random((B, Nk)) > 0.3
    valid[0, : Nk // 2] = False         # dead key tiles in batch 0
    bias = jnp.asarray(np.where(valid, 0.0, NEG), jnp.float32)
    qtab = _tabs(rng, B, Nq) if rope else None
    ktab = _tabs(rng, B, Nk) if rope else None
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(j_ta._cross_fwd(q, k, v, qtab, ktab, bias, scale))
    ref = np.asarray(j_ta._cross_ref(q, k, v, qtab, ktab, bias, scale))
    conv = (lambda t: None if t is None else tuple(map(_t, t)))
    got = t_ta.tower_cross_attention(_t(q), _t(k), _t(v), conv(qtab),
                                     conv(ktab), _t(bias), scale).numpy()
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_tower_cross_fully_masked_rows_are_zero(rng):
    """A batch element with no valid key: the Pallas kernel writes 0 (the
    jnp reference averages uniformly); the plain version follows the
    kernel."""
    B, Nq, Nk, C = 2, 128, 256, 128
    q = jnp.asarray(rng.standard_normal((B, Nq, C)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, Nk, C)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, Nk, C)), jnp.float32)
    valid = np.ones((B, Nk), bool)
    valid[1] = False
    bias = jnp.asarray(np.where(valid, 0.0, NEG), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(j_ta._cross_fwd(q, k, v, None, None, bias,
                                            64 ** -0.5))
    got = t_ta.tower_cross_attention(_t(q), _t(k), _t(v),
                                     kv_bias=_t(bias)).numpy()
    np.testing.assert_array_equal(pallas[1], 0.0)
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got[0], pallas[0], atol=2e-5, rtol=2e-5)


def _blocked(rng, B, Nq, Nk):
    blocked = np.ones((B, Nq, Nk), bool)
    for b in range(B):
        spans = np.sort(rng.integers(0, Nk, 8)).reshape(-1, 2)
        for qi in range(Nq):
            s, e = spans[qi % 4]
            blocked[b, qi, s:e + 1] = False
    blocked &= rng.random((B, Nq, Nk)) > 0.05
    blocked[..., 0] = False
    return blocked


def test_masked_mha_ref_matches_pallas(rng):
    B, H, Nq, Nk, D = 1, 2, 24, 512, 96
    q = jnp.asarray(rng.standard_normal((B, H, Nq, D)) * 0.5, jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, H, Nk, D)) * 0.5, jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, H, Nk, D)), jnp.float32)
    blocked = _blocked(rng, B, Nq, Nk)
    blocked[:, 5] = True                     # one fully blocked row
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(j_ma.pallas_masked_mha(q, k, v,
                                                   jnp.asarray(blocked)))
    got = t_ma.masked_mha(_t(q), _t(k), _t(v), _t(blocked)).numpy()
    np.testing.assert_array_equal(pallas[:, :, 5], 0.0)
    np.testing.assert_array_equal(got[:, :, 5], 0.0)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    live = np.ones(Nq, bool)
    live[5] = False
    dense = np.asarray(dot_product_attention(
        q, k, v, mask=~jnp.asarray(blocked)[:, None]))
    np.testing.assert_allclose(got[:, :, live], dense[:, :, live],
                               atol=2e-5, rtol=2e-5)


def test_masked_mha_refuses_other_head_dims(monkeypatch):
    """Off the CPU (meta tensors stand in for the card here) K3 refuses
    half floats, and a head dim above 128 no longer raises: it goes to the
    wide-head engine at D rounded up to 64 (its launch replaced by a
    recorder), never to K3's engine for 96 and 128."""
    blocked = torch.empty(1, 8, 8, dtype=torch.bool, device="meta")
    q = torch.empty(1, 2, 8, 160, dtype=torch.float16, device="meta")
    with pytest.raises(TypeError):
        t_ma.masked_mha(q, q, q, blocked)
    seen = []

    def wide(q, *a):
        seen.append(q.shape[-1])
        return q

    def narrow(*a):
        raise AssertionError("a head dim above 128 reached K3's engine")

    monkeypatch.setattr(t_ma, "_masked_wide_launch", wide)
    monkeypatch.setattr(t_ma, "_masked_mha_launch", narrow)
    for D in (160, 256):
        q = torch.empty(1, 2, 8, D, device="meta")
        assert t_ma.masked_mha(q, q, q, blocked).shape == q.shape
    assert seen == [192, 256]


def test_plan_blocks_matches_jax(rng):
    blocked = _blocked(rng, 2, 70, 300)
    blocked[1, :, 128:] = True
    _, *want = j_ma.plan_blocks(jnp.asarray(blocked), 64, 64, 128, 320)
    got = t_ma.plan_blocks(_t(blocked), 64, 64, 128, 320)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gates_match_jax():
    for args in ((768, 1024, 16), (768, 768, 12), (2048, 1024, 16),
                 (768, 1024, 8), (768, 832, 13)):
        assert t_ta.supports_tower_attention(*args) == \
            j_ta.supports_tower_attention(*args)
    for args in ((1536, 4608, 768, 12), (16, 16, 768, 12),
                 (3072, 3072, 768, 12), (64, 64, 128, 2)):
        assert t_ta.supports_tower_cross(*args) == \
            j_ta.supports_tower_cross(*args)


def test_no_cuda_and_no_device_raises(monkeypatch):
    """Entry points default to the card; without one they raise instead of
    running on the CPU."""
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.core.device import resolve_device
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.models.presets import tiny_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tiny_config())
    model = build_model(tiny_config(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model, Bucket(32, 48))
    assert resolve_device("cpu").type == "cpu"
