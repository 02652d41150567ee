"""K2-int8 (panst3r_torch/ops/tower_attention.py::tower_cross_int8) on the
CPU: its plain version ``tower_cross_int8_ref`` against the Pallas
``_cross_fwd(..., kv_int8=True)`` in interpret mode (f32, within 2e-5 as
the K2 parity tests), and the int8 gate against the JAX package's.  The
CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import panst3r_tpu.ops.pallas.tower_attention as jta
from panst3r_torch.ops import tower_attention as ta
from panst3r_tpu.ops.rope import rope2d_tables as j_tables

NEG = float(np.finfo(np.float32).min)
SCALE = 64 ** -0.5


def _inputs(seed, B, Nq, Nk, C, bias):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Nq, C)) * 1.4).astype(np.float32)
    k = (rng.standard_normal((B, Nk, C)) * 1.4).astype(np.float32)
    v = rng.standard_normal((B, Nk, C)).astype(np.float32)
    if B == 2:
        k[1] *= 3.0                  # the per-tensor scale spans the batch
    tabs = [tuple(np.asarray(t) for t in j_tables(
        jnp.asarray(rng.integers(0, 32, (B, n, 2)), jnp.int32), 64))
        for n in (Nq, Nk)]
    kb = None
    if bias != "none":
        kb = np.zeros((B, Nk), np.float32)
        if bias in ("dead", "all"):
            kb[:, 64:260] = NEG                  # dead key tiles
        if bias in ("inf", "all"):
            kb[:, -37:] = -np.inf                # -inf keys, ragged tail
        if bias in ("soft", "all"):
            kb[:, 5:40] = -0.7                   # a soft-biased span
    return q, k, v, tabs[0], tabs[1], kb


def _pallas(q, k, v, qtab, ktab, kb, kv_int8):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jta._cross_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            tuple(map(jnp.asarray, qtab)), tuple(map(jnp.asarray, ktab)),
            None if kb is None else jnp.asarray(kb), SCALE,
            kv_int8=kv_int8))


def _t(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(map(_t, x))
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("B,Nq,Nk,C,bias", [
    (1, 256, 384, 128, "none"),          # no bias
    (1, 200, 333, 256, "all"),           # dead tiles, -inf keys, soft span;
                                         # Nq and Nk not tile multiples
    (2, 130, 300, 128, "soft"),          # B=2: one k scale for the batch
    (1, 64, 700, 128, "inf"),
])
def test_int8_ref_matches_pallas(monkeypatch, B, Nq, Nk, C, bias):
    """The plain int8 version equals the Pallas int8 branch within 2e-5,
    and differs from the f32 K2 (the int8 path ran)."""
    monkeypatch.setattr(jta, "_INT8_MIN_NQ", 0)
    q, k, v, qtab, ktab, kb = _inputs(Nq + Nk, B, Nq, Nk, C, bias)
    want = _pallas(q, k, v, qtab, ktab, kb, kv_int8=True)
    got = ta.tower_cross_int8_ref(_t(q), _t(k), _t(v), _t(qtab), _t(ktab),
                                  _t(kb)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    k2 = ta.tower_cross_attention_ref(_t(q), _t(k), _t(v), _t(qtab),
                                      _t(ktab), _t(kb)).numpy()
    assert np.abs(got - k2).max() > 1e-3


def test_int8_prepare_scales():
    """The per-tensor key scale and the pre-scaled q tables: k8 spans
    [-127, 127] with one scale for all of the batch, the q tables carry
    scale·log2(e)·sk, and ``int8_log2_bias`` gives the key bias times
    log2(e)."""
    q, k, v, qtab, ktab, kb = _inputs(3, 2, 64, 200, 128, "soft")
    k8, (qcos, qsin) = ta.int8_prepare(_t(k), _t(qtab), _t(ktab), SCALE)
    kbs = ta.int8_log2_bias(_t(kb))
    assert k8.dtype == torch.int8 and k8.shape == k.shape
    assert int(k8.abs().max()) == 127
    assert int(k8[0].abs().max()) < 127        # batch 1 sets the scale
    sk = (torch.as_tensor(qcos) / _t(qtab)[0]).flatten()
    sk = sk[torch.isfinite(sk)]
    assert torch.allclose(sk, sk[0].expand_as(sk), rtol=1e-6)
    np.testing.assert_array_equal(kbs.numpy(),
                                  kb * np.float32(np.log2(np.e)))


def test_int8_gate_matches_jax(monkeypatch):
    """``int8_gate`` opens exactly where the JAX package's gate does: the
    wrapper's ``kv_int8 and qtab is not None`` with the env var read at
    call time (tower_attention.py:642-646), then ``Nq >= _INT8_MIN_NQ``
    (:472)."""
    assert ta._INT8_MIN_NQ == jta._INT8_MIN_NQ == 16384
    seen = []
    monkeypatch.setattr(jta, "_tower_cross",
                        lambda *a: seen.append(a[7]) or a[0])
    tab = (jnp.zeros((1, 4, 64)), jnp.zeros((1, 4, 64)))
    x = jnp.zeros((1, 4, 128))
    for env in (None, "0", "1"):
        if env is None:
            monkeypatch.delenv("PANST3R_KV_INT8", raising=False)
        else:
            monkeypatch.setenv("PANST3R_KV_INT8", env)
        for kv_int8 in (None, False, True):
            for qtab in (None, tab):
                for Nq in (768, 16383, 16384, 38400):
                    seen.clear()
                    jta.tower_cross_attention(x, x, x, qtab, qtab,
                                              kv_int8=kv_int8)
                    jax_gate = seen[0] and Nq >= jta._INT8_MIN_NQ
                    assert ta.int8_gate(Nq, qtab, kv_int8) == jax_gate, (
                        env, kv_int8, qtab is None, Nq)


def test_cpu_wrapper_follows_the_jnp_formula(monkeypatch):
    """On a CPU tensor ``tower_cross_attention`` ignores int8, as the JAX
    package's CPU path does (its jnp formula): the same bits as K2's plain
    version, and no int8 launch counted."""
    monkeypatch.setattr(ta, "_INT8_MIN_NQ", 0)
    q, k, v, qtab, ktab, kb = _inputs(5, 1, 96, 200, 128, "dead")
    args = (_t(q), _t(k), _t(v), _t(qtab), _t(ktab), _t(kb))
    n0 = ta.tower_cross_int8.launches
    got = ta.tower_cross_attention(*args, kv_int8=True)
    assert torch.equal(got, ta.tower_cross_attention_ref(*args))
    assert not torch.equal(got, ta.tower_cross_int8_ref(*args))
    assert ta.tower_cross_int8.launches == n0


def test_int8_bf16_ref_rounds_p_to_v_dtype():
    """In bf16 the plain int8 version rounds p to bf16 before both sums:
    it stays within bf16 rounding of the f32 run on the same inputs."""
    q, k, v, qtab, ktab, kb = _inputs(7, 1, 100, 300, 128, "all")
    bf = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    out = ta.tower_cross_int8_ref(*bf, _t(qtab), _t(ktab), _t(kb))
    f32 = ta.tower_cross_int8_ref(*(a.float() for a in bf), _t(qtab),
                                  _t(ktab), _t(kb))
    assert out.dtype == torch.bfloat16
    err = (out.float() - f32).abs().max().item()
    assert 0 < err < 0.05, err
