"""Head dims above 128: K3, K4 and K5 on the wide-head engine
(``csrc/flash_wide_sm90.cu``), which takes q, k and v padded with zero
lanes to a multiple of 64 (``ops/flash_attention.py``: ``kernel_head_dim``,
``pad_head_dim``, ``pad_rope``), as the Pallas kernels pad D to their lane
width.

The wrappers' padding and routing run here with the wide launches
replaced by the plain versions at the padded head dim (what the kernel
computes there, as the card's checks hold it): pad -> plain version ->
slice against the plain version at the true D, at D = 136, 192, 200 and
256, with RoPE tables padded per quarter; at one shape (2 x 2 x 130 x 333,
f32, D = 200) against the Pallas kernels in interpret mode (``_flash_fwd``
with its LSE, ``flash_bwd``, ``pallas_masked_mha``).  Limits: rtol 1e-5,
atol 2e-5 (f32 rounding of a 333-term sum).  Then a tiny v2 model whose
InputMixer, LoftUp and mask transformer each have one head of D > 128
(136, 192 and 200) against the JAX package: the training forward
(tests/test_torch_v2.py's limits) and one train step's loss and head
gradients (tests/test_torch_train.py's).  Its LoftUp has one Fourier
frequency (e^-2): with the preset's range up to e^10 one f32 rounding of a
coordinate moves a phase by ~3e-3 (tests/test_torch_v2.py), and f32 head
gradients then differ from JAX's by up to 45x the train test's limit on
the shipped tiny_v2 as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.engine import criterion as t_crit
from panst3r_torch.engine import train as t_train
from panst3r_torch.models import input_mixer as t_mixer
from panst3r_torch.models import presets as t_presets
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.upscalers import loftup as t_loftup
from panst3r_torch.ops import flash_attention as t_fa
from panst3r_torch.ops import masked_attention as t_ma
from panst3r_tpu.engine import criterion as j_crit
from panst3r_tpu.engine import train as j_train
from panst3r_tpu.models import input_mixer as j_mixer
from panst3r_tpu.models import presets as j_presets
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.upscalers import loftup as j_loftup
from panst3r_tpu.ops.pallas import flash_attention as j_fa
from panst3r_tpu.ops.pallas import flash_attention_bwd as j_bwd
from panst3r_tpu.ops.pallas import masked_attention as j_ma
from tests.test_torch_criterion import jax_draws
from tests.test_torch_head_dims import _blocked, _inputs, _t
from tests.test_torch_models import random_params
from tests.test_torch_train import (GRID, T, V, _batch, _flat, _jbatch,
                                    _to_torch_layout, _torch_name)
from tests.test_torch_v2 import _port
from tests.torch_release import release_memory  # noqa: F401

TOL = dict(rtol=1e-5, atol=2e-5)
WIDE_DIMS = (136, 192, 200, 256)


@pytest.fixture
def plain_wide(monkeypatch):
    """The wide-head launches replaced by the plain versions at the padded
    head dim, which must be a multiple of 64 above 128; returns the head
    dims each launch saw."""
    seen = {"fwd": [], "bwd": [], "masked": []}

    def padded(what, D):
        assert D % 64 == 0 and D > 128, (what, D)
        seen[what].append(D)

    def fwd(q, k, v, bias, kv_valid, rope, scale, with_lse):
        padded("fwd", q.shape[-1])
        out, lse = t_fa.flash_mha_ref(q, k, v, bias, kv_valid, rope, scale,
                                      with_lse=True)
        return out, (lse if with_lse else None)

    def bwd(q, k, v, o, lse, do, bias, kv_valid, rope, scale):
        padded("bwd", q.shape[-1])
        assert o.shape == q.shape == do.shape
        return t_fa.flash_mha_bwd_ref(q, k, v, o, lse, do, bias, kv_valid,
                                      rope, scale)

    def masked(q, k, v, blocked, scale):
        padded("masked", q.shape[-1])
        return t_ma.masked_mha_ref(q, k, v, blocked, scale)

    def refuse(*a, **kw):
        raise AssertionError("a D > 128 reached a D <= 128 engine")

    monkeypatch.setattr(t_fa, "_flash_wide_fwd_launch", fwd)
    monkeypatch.setattr(t_fa, "_flash_wide_bwd_launch", bwd)
    monkeypatch.setattr(t_ma, "_masked_wide_launch", masked)
    for mod, name in ((t_fa, "_flash_fwd_launch"),
                      (t_fa, "_flash_bwd_launch"),
                      (t_ma, "_masked_mha_launch")):
        monkeypatch.setattr(mod, name, refuse)
    return seen


def test_wide_head_dims():
    """Above 128 the kernel head dim is D rounded up to 64 (K3 too), the
    wide engine takes it; at most 128 nothing changes."""
    assert [t_fa.kernel_head_dim(d) for d in (129, 136, 192, 200, 256, 384,
                                              500)] == \
        [192, 192, 192, 256, 256, 384, 512]
    assert [t_ma.kernel_head_dim(d, t_ma.HEAD_DIMS) for d in (8, 128, 136,
                                                              256)] == \
        [96, 128, 192, 256]
    assert [t_fa.is_wide(t_fa.kernel_head_dim(d)) for d in (8, 128, 129)] \
        == [False, False, True]
    x = torch.arange(2 * 136, dtype=torch.float32).reshape(2, 136)
    y = t_fa.pad_head_dim(x, 192, quarters=True)
    for qd in range(4):                     # 34 lanes of each quarter of 48
        np.testing.assert_array_equal(y[:, 48 * qd:48 * qd + 34],
                                      x[:, 34 * qd:34 * (qd + 1)])
        assert (y[:, 48 * qd + 34:48 * (qd + 1)] == 0).all()
    np.testing.assert_array_equal(t_fa.unpad_head_dim(y, 136, True), x)


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_wide_padded_plain_matches_unpadded(plain_wide, D):
    """K4 (with and without tables and key validity, with the LSE), K5 and
    K3 through the wrappers' padding and routing against their plain
    versions at the true D; every launch at round_up(D, 64)."""
    q, k, v, do, rope, valid = _inputs(D, 0)
    q, k, v, do = map(_t, (q, k, v, do))
    P = t_fa.kernel_head_dim(D)
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
    blocked = torch.from_numpy(_blocked(np.random.default_rng(D), 130, 333))
    got = t_ma._masked_mha_kernel(q, k, v, blocked, None)
    np.testing.assert_allclose(got.numpy(),
                               t_ma.masked_mha_ref(q, k, v, blocked).numpy(),
                               **TOL)
    assert plain_wide == {"fwd": [P, P], "bwd": [P, P], "masked": [P]}


def test_wide_k4_k5_k3_match_pallas(plain_wide):
    """D = 200 (padded to 256): K4 with its LSE and K5 with RoPE tables and
    key validity, and K3, against the Pallas ``_flash_fwd``,
    ``flash_bwd`` and ``pallas_masked_mha`` in interpret mode."""
    D = 200
    q, k, v, do, rope, valid = _inputs(D, 1)
    scale = D ** -0.5
    jrope = tuple(jnp.asarray(t.numpy()) for t in rope)
    jvalid = jnp.asarray(valid.numpy())
    blocked = _blocked(np.random.default_rng(3), 130, 333)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = j_fa._flash_fwd(q, k, v, None, jvalid, scale,
                                         rope=jrope, with_lse=True)
        want_bwd = j_bwd.flash_bwd(q, k, v, None, jvalid, jrope, want,
                                   want_lse, do, scale)
        want_masked = np.asarray(j_ma.pallas_masked_mha(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(blocked)))
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
    got = t_ma._masked_mha_kernel(_t(q), _t(k), _t(v), _t(blocked), None)
    np.testing.assert_array_equal(got[:, :, 7].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), want_masked, **TOL)
    assert plain_wide == {"fwd": [256], "bwd": [256], "masked": [256]}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
def test_wide_plan_covers_every_head_dim(dtype, masked):
    """``wide_plan`` at every P multiple of 64 from 192 to 1024 (and on to
    4096: no P is refused): its slices cover the P output lanes once, a
    CTA fits 232,448 bytes of shared memory, O stays within 128 registers
    a thread (bf16: a warpgroup's 64 x 256 lanes) or 64 (f32: a warp's 16
    x 128), and S is formed at most ceil(P / 256) times per row tile and
    key tile (once per CTA); bf16 keeps Q resident up to 1024."""
    bf16 = dtype == torch.bfloat16
    for P in range(192, 4097, 64):
        plan = t_fa.wide_plan(P, dtype, masked)
        cover = np.zeros(P, np.int64)
        for z, w, lane0, n in plan.slices():
            assert z < plan.groups and w < plan.per_cta and n > 0
            cover[lane0:lane0 + n] += 1
        assert (cover == 1).all(), P
        assert plan.nb * plan.box == P
        assert plan.smem <= 232448 and 2 <= plan.stages <= 16, P
        # O's rows x the slice's lanes over the threads that hold them
        assert plan.o_registers == plan.nbw * plan.box // 2
        assert plan.o_registers <= (128 if bf16 else 64), P
        assert plan.recompute <= -(-P // 256), P
        assert plan.warps * 32 <= (256 if bf16 else 512)
        # S formed once per CTA: the CTAs along the lanes
        assert plan.recompute == plan.groups
        if bf16:
            assert plan.rows == 64 and plan.per_cta <= 2 and plan.nbw >= 3
            if P <= 1024:
                assert plan.qres
        else:
            assert not plan.qres and plan.per_cta == 4 and plan.nbw >= 2
    # split-KV runs of 8 key tiles past 16, fixed by Nk alone
    for Nk, splits in ((1, 1), (768, 1), (1024, 1), (1025, 3), (3072, 6),
                       (3840, 8)):
        assert t_fa.wide_plan(384, dtype, masked, Nk).splits == splits, Nk
    for bad in (128, 200, 64):
        with pytest.raises(ValueError):
            t_fa.wide_plan(bad, dtype, masked)


# one head each: the mixer at D = 136 (RoPE tables, padded per quarter to
# 192), LoftUp at 192, the mask transformer at 200 (padded to 256)
WIDE_MIXER, WIDE_LOFTUP, WIDE_MASK = 136, 192, 200
LOSS = dict(num_points=32)


def wide_tiny_v2(presets, mixer, loftup):
    """``tiny_v2_config`` of ``presets`` with one head of D > 128 in the
    InputMixer, LoftUp and the mask transformer (the transformer's
    ``fpn_dims`` and ``mask_dim`` follow the mixer's and LoftUp's
    widths)."""
    cfg = presets.tiny_v2_config()
    pan = cfg.panoptic
    return dataclasses.replace(cfg, panoptic=dataclasses.replace(
        pan,
        input_mixer=mixer.InputMixerConfig(hidden_dim=WIDE_MIXER,
                                           num_heads=1, num_layers=1),
        upscaler=loftup.LoftUpUpscalerConfig(dim=WIDE_LOFTUP, n_freqs=1,
                                             num_heads=1, num_layers=1),
        mask_transformer=dataclasses.replace(
            pan.mask_transformer, hidden_dim=WIDE_MASK, num_heads=1,
            fpn_dims=(WIDE_MIXER,), mask_dim=WIDE_LOFTUP)))


@pytest.fixture(scope="module")
def wide_models():
    jm = JPanSt3R(wide_tiny_v2(j_presets, j_mixer, j_loftup))
    batch, cls = _batch(2)
    params = random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["images"]),
        jnp.asarray(batch["portrait"]), jnp.asarray(cls), GRID)))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tcfg = wide_tiny_v2(t_presets, t_mixer, t_loftup)
    return jm, params, tcfg, batch, cls


@torch.no_grad()
def test_wide_tiny_v2_forward_matches_jax(wide_models):
    """The training forward with a head of D > 128 in each of the three
    modules: pointmaps and every supervision level (tests/test_torch_v2.py's
    limits)."""
    jm, params, tcfg, batch, cls = wide_models
    tm = _port(lambda: TPanSt3R(tcfg), params)
    args = (batch["images"], batch["portrait"], cls)
    want, want_pm = jax.jit(lambda p, *a: jm.apply(p, *a, GRID))(
        params, *map(jnp.asarray, args))
    got, got_pm = tm(*map(_t, args), GRID)
    np.testing.assert_allclose(got_pm.numpy(), np.asarray(want_pm),
                               atol=2e-4)
    levels = [(got, want)] + list(zip(got["aux_outputs"],
                                      want["aux_outputs"]))
    for g, w in levels:
        np.testing.assert_allclose(g["pred_logits"].numpy(),
                                   np.asarray(w["pred_logits"]), atol=2e-3)
        np.testing.assert_allclose(g["pred_masks"].numpy(),
                                   np.asarray(w["pred_masks"]), atol=1e-2,
                                   rtol=1e-2)


def test_wide_tiny_v2_train_step_matches_jax(wide_models):
    """One train step with a head of D > 128 in each of the three modules
    against ``make_train_step``: the loss and every head gradient
    (tests/test_torch_train.py's limits)."""
    jm, params, tcfg, batch, cls = wide_models
    tm = _port(lambda: TPanSt3R(tcfg), params)
    kw = dict(lr=1e-3, accum_iter=1, epochs=2, warmup_epochs=0)
    jcfg = j_train.TrainConfig(**kw, loss=j_crit.PanopticLossConfig(**LOSS))
    cfg = t_train.TrainConfig(**kw, loss=t_crit.PanopticLossConfig(**LOSS))
    key = jax.random.PRNGKey(4)
    tmask = j_train.trainable_mask(params)
    tx, _ = j_train.build_optimizer(jcfg, 1, 4, trainable_mask=tmask)
    stash = optax.GradientTransformation(      # keeps the gradients it gets
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, _, p=None: (g, g))
    tx = optax.chain(stash, tx)
    jstep = j_train.make_train_step(jm, tx, jcfg.loss, GRID, donate=False,
                                    train_mask=tmask)
    state, jl, _ = jstep(j_train.TrainState.create(params, tx),
                         _jbatch(batch), jnp.asarray(cls), key)
    jgrads = _flat(state.opt_state[0])

    mask = t_train.trainable_mask(tm)
    grads = {}

    class Keep(t_train.Optimizer):
        def step(self):
            grads.update({n: p.grad.detach().clone()
                          for n, p in self.params.items()})
            return super().step()

    opt = Keep({n: p for n, p in tm.named_parameters() if mask[n]}, cfg, 1,
               4)
    step = t_train.make_train_step(tm, opt, cfg.loss, GRID)
    # the final level and one per decoder layer but the last (deep
    # supervision), as tests/test_torch_train.py draws them
    levels = 1 + tcfg.panoptic.mask_transformer.dec_layers
    loss, _ = step(t_train.batch_to(batch, "cpu"), _t(cls),
                   draws=jax_draws(key, cfg.loss, levels, 2 * T * V))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    name_of = {tuple(n.split(".")): n for n, _ in tm.named_parameters()}
    want = {_torch_name(p, name_of): _to_torch_layout(p, g)
            for p, g in jgrads.items() if p[0] == "panoptic_decoder"}
    assert set(want) == set(grads) and len(grads) > 10
    for n, jg in want.items():
        g = grads[n].numpy()
        if n.endswith("k_proj.bias"):
            # the softmax ignores a shift shared by all keys: the true
            # gradient is 0 and both sides hold rounding, held against the
            # layer's key-weight gradient (a single head of 200 lanes sums
            # more of it than the tiny preset's heads of 8)
            scale = float(np.abs(want[n[:-4] + "weight"]).max())
            assert max(np.abs(g).max(), np.abs(jg).max()) <= 1e-4 * scale, n
            continue
        np.testing.assert_allclose(g, jg, atol=1e-4 * float(np.abs(jg).max())
                                   + 1e-6, err_msg=n)
