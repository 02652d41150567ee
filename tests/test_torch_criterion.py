"""The port's training criterion against the JAX package's on the CPU, f32:
point sampling, the auction LAP, the jax.image resamplings the losses use,
the matcher, the label and mask losses and ``panoptic_loss`` with deep
supervision (values and gradients).  Random draws are made with the JAX
package's own key splits and passed to the port (``jax_draws``).

Limits: assignments equal; losses 1e-5 relative (f32 sums in another
order); gradients 1e-5 of their leaf's max |value|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch.engine import criterion as t_crit
from panst3r_torch.ops import image as t_image
from panst3r_torch.ops import lap as t_lap
from panst3r_torch.ops import sampling as t_samp
from panst3r_tpu.engine import criterion as j_crit
from panst3r_tpu.ops import lap as j_lap
from panst3r_tpu.ops import sampling as j_samp
from tests.torch_release import release_memory  # noqa: F401

B, Q, NCLS, V, T = 2, 8, 5, 2, 4
HM, WM, H, W = 16, 24, 32, 48
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(key, c, n_levels: int, n_rows: int):
    """The draws the JAX criterion makes from ``key`` (criterion.py:301,
    :291, :159 and :235; sampling.py:100-110), per level, in the form the
    port's ``set_criterion(draws=...)`` takes."""
    out = []
    for k in jax.random.split(key, n_levels):
        k_match, k_pts = jax.random.split(k)
        d = {}
        if c.matcher_sampling != "grid":
            d["match"] = _t(np.stack([
                np.asarray(jax.random.uniform(kb, (V, c.num_points, 2)))
                for kb in jax.random.split(k_match, B)]))
        if c.loss_sampling == "grid":
            d["mask"] = _t(jax.random.uniform(k_pts, (2,)) - 0.5)
        else:
            k1, k2 = jax.random.split(k_pts)
            ns = int(c.num_points * c.oversample_ratio)
            nr = c.num_points - int(c.importance_sample_ratio * c.num_points)
            d["mask"] = (_t(jax.random.uniform(k1, (n_rows, ns, 2))),
                         _t(jax.random.uniform(k2, (n_rows, nr, 2))))
        out.append(d)
    return out


def _outputs(seed: int, levels: int = 1):
    rng = np.random.default_rng(seed)
    outs = [(rng.standard_normal((B, Q, NCLS)).astype(np.float32) * 2,
             rng.standard_normal((B, V, Q, HM, WM)).astype(np.float32) * 3)
            for _ in range(levels)]
    masks = (rng.random((B, T, V, H, W)) < 0.3).astype(np.float32)
    labels = rng.integers(0, NCLS, (B, T)).astype(np.int32)
    valid = np.array([[True, True, True, False], [True, False, True, False]])
    omask = rng.random((B, NCLS)) < 0.8
    return outs, (labels, masks, valid, omask)


def _targets(tg, lib):
    if lib == "jax":
        return j_crit.Targets(*(jnp.asarray(a) for a in tg))
    return t_crit.Targets(*(_t(a) for a in tg))


def _as_outputs(outs, lib):
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    (lg, m), *aux = outs
    d = {"pred_logits": conv(lg), "pred_masks": conv(m)}
    if aux:
        d["aux_outputs"] = [{"pred_logits": conv(a), "pred_masks": conv(b)}
                            for a, b in aux]
    return d


# ---------------------------------------------------------------- sampling

def test_point_sample_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 2, 7, 9)).astype(np.float32)
    # points beyond [0, 1] exercise the zero padding
    pts = (rng.random((3, 40, 2)) * 1.2 - 0.1).astype(np.float32)
    np.testing.assert_allclose(
        t_samp.point_sample(_t(feats), _t(pts)).numpy(),
        np.asarray(j_samp.point_sample(jnp.asarray(feats), jnp.asarray(pts))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t_samp.point_sample(_t(feats[:, 0]), _t(pts)).numpy(),
        np.asarray(j_samp.point_sample(jnp.asarray(feats[:, 0]),
                                       jnp.asarray(pts))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t_samp.point_sample_shared(_t(feats[:, 0]), _t(pts[0])).numpy(),
        np.asarray(j_samp.point_sample_shared(jnp.asarray(feats[:, 0]),
                                              jnp.asarray(pts[0]))),
        rtol=1e-6, atol=1e-6)


def test_uncertain_point_coords_with_jax_draws():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 12, 16)).astype(np.float32) * 3
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_samp.uncertain_point_coords(
        key, jnp.asarray(logits), 20, 3.0, 0.75))
    k1, k2 = jax.random.split(key)
    draws = (_t(jax.random.uniform(k1, (4, 60, 2))),
             _t(jax.random.uniform(k2, (4, 5, 2))))
    got = t_samp.uncertain_point_coords(_t(logits), 20, 3.0, 0.75,
                                        draws=draws)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_indices_breaks_ties_low():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    want = np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 3)[1])
    assert t_samp.top_k_indices(x, 3).tolist() == want.tolist() == [[1, 2, 4]]


# --------------------------------------------------------------------- LAP

def _lap_problem(rng, R, C, ties):
    cost = rng.standard_normal((R, C)).astype(np.float32)
    if ties:
        cost = np.round(cost, 1)
    valid = rng.random(C) > 0.3
    span = np.float32(np.abs(np.where(valid[None], cost, 0)).max())
    return cost, np.where(valid[None], cost, 1e6).astype(np.float32), \
        valid, span


@pytest.mark.parametrize("ties", [False, True])
def test_auction_lap_matches_jax(ties):
    """Random and tied costs, without and with col_valid and span."""
    rng = np.random.default_rng(int(ties))
    for R, C in ((9, 9), (24, 10), (24, 10), (24, 10)):
        cost, padded, valid, span = _lap_problem(rng, R, C, ties)
        want = np.asarray(j_lap.auction_lap(jnp.asarray(cost)))
        got = t_lap.auction_lap(_t(cost))
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(j_lap.auction_lap(jnp.asarray(padded), span=span,
                                            col_valid=jnp.asarray(valid)))
        got = t_lap.auction_lap(_t(padded), span=float(span),
                                col_valid=_t(valid))
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(set(got.tolist())) == C
        np.testing.assert_allclose(
            float(t_lap.assignment_cost(_t(cost), got)),
            float(j_lap.assignment_cost(jnp.asarray(cost),
                                        jnp.asarray(want))), rtol=1e-6)


def test_auction_lap_batched_equals_vmap():
    """One batched call over (levels, items), as ``set_criterion`` makes
    it, against ``jax.vmap``: finished members stay frozen while the others
    iterate, whatever ``check_every``."""
    rng = np.random.default_rng(7)
    L, R, C = 6, 30, 12
    probs = [_lap_problem(rng, R, C, ties=i % 2 == 0) for i in range(L)]
    padded = np.stack([p[1] for p in probs])
    valid = np.stack([p[2] for p in probs])
    spans = np.stack([p[3] for p in probs])
    want = np.asarray(jax.vmap(
        lambda c, s, v: j_lap.auction_lap(c, span=s, col_valid=v))(
        jnp.asarray(padded), jnp.asarray(spans), jnp.asarray(valid)))
    for every in (1, 8, 64):
        got = t_lap.auction_lap(_t(padded).reshape(2, 3, R, C),
                                span=_t(spans), col_valid=_t(valid)
                                .reshape(2, 3, C), check_every=every)
        np.testing.assert_array_equal(got.reshape(L, C).numpy(), want)


# ----------------------------------------------------------------- images

def test_resize_without_antialias_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2, HM, WM)).astype(np.float32)
    for shape in ((3, 2, 5, 6), (3, 2, 8, 12), (3, 2, 40, 30)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), shape, "bilinear",
                                           antialias=False))
        got = t_image.resize(_t(x), shape, "bilinear", antialias=False)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("jit", [(0.0, 0.0), (0.37, -0.41), (-0.5, 0.25)])
def test_scale_and_translate_matches_jax(jit):
    """The mask loss's form: an edge-padded map, scale = grid / map size,
    translation = jitter − scale."""
    rng = np.random.default_rng(3)
    m = rng.standard_normal((4, HM + 2, WM + 2)).astype(np.float32)
    gh, gw = 5, 6
    scale = jnp.array([gh / HM, gw / WM])
    tr = jnp.asarray(jit, jnp.float32) - scale
    want = np.asarray(jax.image.scale_and_translate(
        jnp.asarray(m), (4, gh, gw), (1, 2), scale, tr, method="linear",
        antialias=False))
    got = t_image.scale_and_translate_linear(_t(m), (4, gh, gw), (1, 2),
                                             _t(scale), _t(tr))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- losses

def _cfg(matcher="grid", loss="grid", **kw):
    kw = dict(num_points=32, matcher_sampling=matcher, loss_sampling=loss,
              **kw)
    return j_crit.PanopticLossConfig(**kw), t_crit.PanopticLossConfig(**kw)


@pytest.mark.parametrize("mode", ["grid", "random"])
def test_match_matches_jax(mode):
    jc, tc = _cfg(matcher=mode)
    outs, tg = _outputs(4)
    (lg, m), = outs
    key = jax.random.PRNGKey(5)
    want = np.asarray(j_crit.match(key, jnp.asarray(lg), jnp.asarray(m),
                                   _targets(tg, "jax"), jc))
    points = None
    if mode == "random":          # the points JAX draws from ``key``
        points = _t(np.stack([np.asarray(jax.random.uniform(
            kb, (V, tc.num_points, 2))) for kb in jax.random.split(key, B)]))
    got = t_crit.match(_t(lg), _t(m), _targets(tg, "torch"), tc, points)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("label_mode", ["sigmoid", "softmax"])
def test_label_losses_match_jax(label_mode):
    jc, tc = _cfg(label_mode=label_mode)
    outs, tg = _outputs(6)
    lg, _ = outs[0]
    if label_mode == "softmax":
        lg = np.concatenate([lg, lg[..., :1]], -1)
    assign = np.array([[3, 0, 5, 1], [2, 7, 4, 6]])
    num_masks = 4.0
    jf = (j_crit._loss_labels_sigmoid if label_mode == "sigmoid"
          else j_crit._loss_labels_softmax)
    tf = (t_crit._loss_labels_sigmoid if label_mode == "sigmoid"
          else t_crit._loss_labels_softmax)
    want, jgrad = jax.value_and_grad(lambda x: jf(
        x, _targets(tg, "jax"), jnp.asarray(assign), num_masks, jc))(
        jnp.asarray(lg))
    x = _t(lg).requires_grad_()
    got = tf(x, _targets(tg, "torch"), _t(assign), num_masks, tc)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               atol=RTOL * float(np.abs(jgrad).max()))


@pytest.mark.parametrize("mode", ["grid", "random"])
def test_mask_losses_match_jax(mode):
    jc, tc = _cfg(loss=mode, oversample_ratio=3.0,
                  importance_sample_ratio=0.75)
    outs, tg = _outputs(8)
    _, m = outs[0]
    assign = np.array([[3, 0, 5, 1], [2, 7, 4, 6]])
    key = jax.random.PRNGKey(9)
    f = jax.jit(lambda x: j_crit._loss_masks(key, x, _targets(tg, "jax"),
                                             jnp.asarray(assign), 3.0, jc))
    wm, wd = f(jnp.asarray(m))
    jgrad = jax.grad(lambda x: sum(f(x)))(jnp.asarray(m))
    # the draw JAX makes from this key inside _loss_masks
    if mode == "grid":
        draw = _t(jax.random.uniform(key, (2,)) - 0.5)
    else:
        k1, k2 = jax.random.split(key)
        n = B * T * V
        draw = (_t(jax.random.uniform(k1, (n, 96, 2))),
                _t(jax.random.uniform(k2, (n, 8, 2))))
    x = _t(m).requires_grad_()
    gm, gd = t_crit._loss_masks(x, _targets(tg, "torch"), _t(assign), 3.0,
                                tc, draw=draw)
    (gm + gd).backward()
    np.testing.assert_allclose(float(gm.detach()), float(wm), rtol=RTOL)
    np.testing.assert_allclose(float(gd.detach()), float(wd), rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               atol=RTOL * float(np.abs(jgrad).max()))


@pytest.mark.parametrize("matcher,loss", [("grid", "grid"),
                                          ("random", "random")])
def test_panoptic_loss_deep_supervision_matches_jax(matcher, loss):
    """Final + two aux levels: every loss, the total, the per-level
    assignments and the gradients in the predictions."""
    jc, tc = _cfg(matcher=matcher, loss=loss)
    outs, tg = _outputs(10, levels=3)
    key = jax.random.PRNGKey(11)

    def jloss(leaves):
        total, details = j_crit.panoptic_loss(
            key, _as_outputs(list(zip(leaves[::2], leaves[1::2])), "jax"),
            _targets(tg, "jax"), jc)
        return total, details

    jleaves = [jnp.asarray(a) for pair in outs for a in pair]
    (want, wdet), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jleaves)
    tleaves = [_t(a).requires_grad_() for pair in outs for a in pair]
    draws = jax_draws(key, tc, 3, B * T * V)
    got, det = t_crit.panoptic_loss(
        _as_outputs(list(zip(tleaves[::2], tleaves[1::2])), "torch"),
        _targets(tg, "torch"), tc, draws=draws)
    got.backward()
    assert set(det) == set(wdet) | {"assign"}
    for k in wdet:
        np.testing.assert_allclose(float(det[k].detach()), float(wdet[k]),
                                   rtol=RTOL,
                                   err_msg=k)
    for lvl in range(3):
        logits, masks = (jnp.asarray(a) for a in outs[lvl])
        kl = jax.random.split(key, 3)[lvl]
        want_assign = np.asarray(j_crit.match(
            jax.random.split(kl)[0], logits, masks, _targets(tg, "jax"), jc))
        np.testing.assert_array_equal(det["assign"][lvl].numpy(),
                                      want_assign)
    for t, g in zip(tleaves, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g,
                                   atol=RTOL * float(np.abs(g).max()))


def test_loss_config_registered_with_every_field():
    from panst3r_torch.core import config as t_cfg

    jf = {f.name: f.default for f in dataclasses.fields(
        j_crit.PanopticLossConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(
        t_crit.PanopticLossConfig)}
    assert jf == tf
    c = t_crit.PanopticLossConfig(num_points=64, label_mode="softmax")
    assert t_cfg.from_dict(t_cfg.to_dict(c)) == c


def test_small_train_check_pins_one_assignment():
    """chip_smoke.py's card-vs-CPU train check: ``_pinned_auction`` records
    each auction's own assignment and hands back the pinned one, and
    ``eps_optimal`` holds an assignment to T·ε of scipy's optimum (it
    passes the auction's own and refuses one far from optimal)."""
    import chip_smoke

    criterion = t_crit
    g = torch.Generator().manual_seed(0)
    cost = torch.rand(3, 2, 10, 6, generator=g)
    valid = torch.ones(3, 2, 6, dtype=torch.bool)
    valid[1, 0, 4:] = False
    span = torch.rand(3, 2, generator=g) + 0.5
    real = criterion.auction_lap
    calls = []
    with chip_smoke._pinned_auction(calls):
        own = criterion.auction_lap(cost, span=span, col_valid=valid)
    assert criterion.auction_lap is real
    assert chip_smoke.eps_optimal(calls[0])["ok"]
    pin = torch.zeros_like(own)
    pinned = []
    with chip_smoke._pinned_auction(pinned, [pin]):
        got = criterion.auction_lap(cost, span=span, col_valid=valid)
    assert torch.equal(got, pin) and torch.equal(pinned[0]["assign"], own)
    far = dict(calls[0], assign=pin)
    assert not chip_smoke.eps_optimal(far)["ok"]


def test_replicate_pad1_matches_jnp_edge_pad():
    """The mask loss's border pad (built by concatenation so that its
    backward has no atomics on the card) gives ``jnp.pad(mode="edge")``'s
    values, and its gradient sums each border pixel's copies as JAX's
    does."""
    rng = np.random.default_rng(0)
    m = rng.standard_normal((3, 5, 7)).astype(np.float32)
    g = rng.standard_normal((3, 7, 9)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jnp.pad(x, ((0, 0), (1, 1), (1, 1)),
                                          mode="edge"), jnp.asarray(m))
    t = torch.tensor(m, requires_grad=True)
    got = t_crit.replicate_pad1(t)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.tensor(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(g)[0]),
                               rtol=1e-6, atol=1e-6)
