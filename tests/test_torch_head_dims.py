"""Head dims the kernels are not built for: K3, K4 and K5 pad D with zero
lanes to their next instantiation (``ops/flash_attention.py``:
``kernel_head_dim``, ``pad_head_dim``, ``pad_rope``), as the Pallas kernels
pad D to their lane width.

The wrappers' padding code runs here with the launch replaced by the
plain version at the padded head dim (what the kernel computes there, as
the card's checks hold it), so pad -> plain version -> slice is held
against the plain version at the true D, at D = 8, 12, 16, 80 and 128,
with RoPE tables padded per quarter; and at one shape each (2 x 2 x 130 x
333, f32) against the Pallas kernels in interpret mode (``_flash_fwd``
with its LSE, ``flash_bwd``, ``pallas_masked_mha``).  Limits: rtol 1e-5,
atol 2e-5 (f32 rounding of a 333-term sum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import flash_attention as t_fa
from panst3r_torch.ops import masked_attention as t_ma
from panst3r_torch.ops.rope import rope2d_tables
from panst3r_tpu.ops.pallas import flash_attention as j_fa
from panst3r_tpu.ops.pallas import flash_attention_bwd as j_bwd
from panst3r_tpu.ops.pallas import masked_attention as j_ma
from tests.torch_release import release_memory  # noqa: F401

TOL = dict(rtol=1e-5, atol=2e-5)
DIMS = (8, 12, 16, 80, 128)
B, H, NQ, NK = 2, 2, 130, 333


def _inputs(D: int, seed: int):
    """q, k, v, do (numpy f32), RoPE tables and a key validity with dead
    tiles (torch)."""
    rng = np.random.default_rng(seed * 1000 + D)
    q, k = (rng.standard_normal((B, H, n, D)).astype(np.float32) * 1.4
            for n in (NQ, NK))
    v = rng.standard_normal((B, H, NK, D)).astype(np.float32)
    do = rng.standard_normal((B, H, NQ, D)).astype(np.float32)
    pos = [torch.from_numpy(rng.integers(0, 24, (B, n, 2)).astype(np.int32))
           for n in (NQ, NK)]
    rope = (*rope2d_tables(pos[0], D), *rope2d_tables(pos[1], D))
    valid = rng.random((B, NK)) > 0.2
    valid[0, 64:150] = False
    return q, k, v, do, rope, torch.from_numpy(valid)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def plain_launches(monkeypatch):
    """The kernel launches replaced by the plain versions at the padded
    head dim, which must be an instantiated one."""
    def fwd(q, k, v, bias, kv_valid, rope, scale, with_lse):
        assert q.shape[-1] in t_fa.HEAD_DIMS
        out, lse = t_fa.flash_mha_ref(q, k, v, bias, kv_valid, rope, scale,
                                      with_lse=True)
        return out, (lse if with_lse else None)

    def bwd(q, k, v, o, lse, do, bias, kv_valid, rope, scale):
        assert q.shape[-1] in t_fa.HEAD_DIMS and o.shape == q.shape
        return t_fa.flash_mha_bwd_ref(q, k, v, o, lse, do, bias, kv_valid,
                                      rope, scale)

    def masked(q, k, v, blocked, scale):
        assert q.shape[-1] in t_ma.HEAD_DIMS
        return t_ma.masked_mha_ref(q, k, v, blocked, scale)

    monkeypatch.setattr(t_fa, "_flash_fwd_launch", fwd)
    monkeypatch.setattr(t_fa, "_flash_bwd_launch", bwd)
    monkeypatch.setattr(t_ma, "_masked_mha_launch", masked)


def _blocked(rng, Nq, Nk):
    blocked = np.ones((B, Nq, Nk), bool)
    for b in range(B):
        spans = np.sort(rng.integers(0, Nk, 8)).reshape(-1, 2)
        for qi in range(Nq):
            s, e = spans[qi % 4]
            blocked[b, qi, s:e + 1] = False
    blocked &= rng.random((B, Nq, Nk)) > 0.05
    blocked[:, 7] = True                     # one fully blocked row
    return blocked


def test_padding_layout():
    """Quarter padding keeps each RoPE quarter's lanes together, the
    tables rotate nothing on the pad lanes, and the inverse restores x."""
    x = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)
    y = t_fa.pad_head_dim(x, 64, quarters=True)
    assert y.shape == (2, 64)
    for qd in range(4):
        np.testing.assert_array_equal(y[:, 16 * qd:16 * qd + 3],
                                      x[:, 3 * qd:3 * qd + 3])
        assert (y[:, 16 * qd + 3:16 * (qd + 1)] == 0).all()
    np.testing.assert_array_equal(t_fa.unpad_head_dim(y, 12, True), x)
    np.testing.assert_array_equal(
        t_fa.unpad_head_dim(t_fa.pad_head_dim(x, 96), 12), x)
    tabs = [torch.rand(1, 5, 12) for _ in range(4)]
    pc, ps, _, _ = t_fa.pad_rope(tabs, 64)
    pad = t_fa.pad_head_dim(torch.zeros(1, 5, 12), 64, True,
                            1.0) != t_fa.pad_head_dim(torch.zeros(1, 5, 12),
                                                      64, True)
    assert (pc[pad] == 1).all() and (ps[pad] == 0).all()
    assert [t_fa.kernel_head_dim(d) for d in (8, 64, 65, 96, 97, 128)] == \
        [64, 64, 96, 96, 128, 128]
    assert t_ma.kernel_head_dim(8, t_ma.HEAD_DIMS) == 96
    # above 128: the wide-head engine, at D rounded up to 64
    assert [t_fa.kernel_head_dim(d) for d in (129, 256)] == [192, 256]


@pytest.mark.parametrize("D", DIMS)
def test_padded_plain_matches_unpadded(plain_launches, D):
    """K4 (with and without tables, with key validity, with the LSE), K5
    and K3 through the wrappers' padding against their plain versions at
    the true D."""
    q, k, v, do, rope, valid = _inputs(D, 0)
    q, k, v, do = map(_t, (q, k, v, do))
    for tabs, kv in ((None, None), (rope, valid)):
        out, lse = t_fa._flash_fwd_kernel(q, k, v, None, kv, tabs, None,
                                          True)
        want, want_lse = t_fa.flash_mha_ref(q, k, v, None, kv, tabs,
                                            with_lse=True)
        np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **TOL)
        got = t_fa._flash_bwd_kernel(q, k, v, want, want_lse, do, None, kv,
                                     tabs, None)
        wants = t_fa.flash_mha_bwd_ref(q, k, v, want, want_lse, do, None, kv,
                                       tabs)
        for name, g, w in zip(("dq", "dk", "dv"), got, wants):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                       **TOL)
    blocked = torch.from_numpy(_blocked(np.random.default_rng(D), NQ, NK))
    got = t_ma._masked_mha_kernel(q, k, v, blocked, None)
    np.testing.assert_allclose(got.numpy(),
                               t_ma.masked_mha_ref(q, k, v, blocked).numpy(),
                               **TOL)


def test_padded_k4_k5_match_pallas(plain_launches):
    """K4 with its LSE and K5 at D = 16 with RoPE tables and key validity,
    padded to 64, against the Pallas ``_flash_fwd`` and ``flash_bwd`` in
    interpret mode (which pad D to their lane width themselves)."""
    D = 16
    q, k, v, do, rope, valid = _inputs(D, 1)
    scale = D ** -0.5
    jrope = tuple(jnp.asarray(t.numpy()) for t in rope)
    jvalid = jnp.asarray(valid.numpy())
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = j_fa._flash_fwd(q, k, v, None, jvalid, scale,
                                         rope=jrope, with_lse=True)
        want_bwd = j_bwd.flash_bwd(q, k, v, None, jvalid, jrope, want,
                                   want_lse, do, scale)
    out, lse = t_fa._flash_fwd_kernel(_t(q), _t(k), _t(v), None, valid, rope,
                                      None, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    got = t_fa._flash_bwd_kernel(_t(q), _t(k), _t(v), _t(want),
                                 _t(want_lse), _t(do), None, valid, rope,
                                 None)
    for name, g, w in zip(("dq", "dk", "dv"), got, want_bwd):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_padded_k3_matches_pallas(plain_launches):
    """K3 at the tiny presets' mask-transformer head dim (D = 8, padded to
    96) against ``pallas_masked_mha`` in interpret mode."""
    D = 8
    q, k, v, *_ = _inputs(D, 2)
    blocked = _blocked(np.random.default_rng(2), NQ, NK)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_ma.pallas_masked_mha(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(blocked)))
    got = t_ma._masked_mha_kernel(_t(q), _t(k), _t(v), _t(blocked), None)
    np.testing.assert_array_equal(got[:, :, 7].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
