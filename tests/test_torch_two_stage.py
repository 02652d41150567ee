"""Two-stage query selection in panst3r_torch against panst3r_tpu (CPU,
f32): the two-stage mask transformer (``MaskTransformerConfig.two_stage``)
against the flax module on the same weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch.models import mask_transformer as tmt
from panst3r_torch.models.panst3r import build_model
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_tpu.models.mask_transformer import MaskTransformer as JMT
from panst3r_tpu.models.mask_transformer import \
    MaskTransformerConfig as JMTCfg
from tests.test_torch_models import _MT_KW, _apply, _init, _np, _port, _t
from tests.torch_release import release_memory  # noqa: F401

_TS_KW = dict(_MT_KW, two_stage=True)


@pytest.fixture(scope="module")
def two_stage():
    rng = np.random.default_rng(3)
    fpn = rng.standard_normal((2, 2, 4, 6, 64)).astype(np.float32)
    mf = rng.standard_normal((2, 2, 32, 48, 16)).astype(np.float32)
    cls = rng.standard_normal((5, 24)).astype(np.float32)
    portrait = np.array([[False, True], [True, False]])
    jm = JMT(JMTCfg(**_TS_KW))
    args = ([jnp.asarray(fpn)], jnp.asarray(mf), jnp.asarray(cls),
            jnp.asarray(portrait))
    params = _init(jm, *args)
    return jm, params, args, (fpn, mf, cls, portrait)


@torch.no_grad()
def test_two_stage_selection_matches_jax(two_stage):
    """The top ``num_queries`` tokens by largest class logit: the same
    indices as ``jax.lax.top_k``, highest first, and the gathered queries
    and position embeddings; no learned queries on either side."""
    jm, params, args, (fpn, mf, cls, portrait) = two_stage
    assert "query_feat" not in params["params"]
    tm = _port(tmt.MaskTransformer(tmt.MaskTransformerConfig(**_TS_KW)),
               params)
    names = dict(tm.named_parameters())
    assert "query_feat" not in names and "query_embed" not in names
    rng = np.random.default_rng(4)
    src = rng.standard_normal((2, 48, 64)).astype(np.float32)
    pos = rng.standard_normal((2, 48, 64)).astype(np.float32)
    k = _TS_KW["num_queries"]

    def jtop(m, f, c):
        return jax.lax.top_k(m._class_logits(m.decoder_norm(f), c).max(-1),
                             k)[1]

    want = np.asarray(_apply(jm, params, jnp.asarray(src), jnp.asarray(cls),
                             method=jtop))
    score = tm._class_logits(tm.decoder_norm(_t(src)), _t(cls)).amax(-1)
    np.testing.assert_array_equal(
        _np(tmt.select_queries(score, k)), want)
    jout, jqe = _apply(jm, params, [jnp.asarray(src)], [jnp.asarray(pos)],
                       jnp.asarray(cls),
                       method=lambda m, s, p, c: m._query_selection(s, p, c))
    out, qe = tm._query_selection([_t(src)], [_t(pos)], _t(cls))
    np.testing.assert_array_equal(_np(out), np.asarray(jout))
    np.testing.assert_array_equal(_np(qe), np.asarray(jqe))


def test_two_stage_decode_matches_jax(two_stage):
    """The two-stage decoder end to end (B = 2, deep supervision) at the
    tolerances of tests/test_torch_models.py; the first prediction's
    gradient reaches the features; a two-stage model builds with seeded
    weights."""
    jm, params, args, (fpn, mf, cls, portrait) = two_stage
    tm = _port(tmt.MaskTransformer(tmt.MaskTransformerConfig(**_TS_KW)),
               params)
    want = _apply(jm, params, *args)
    with torch.no_grad():
        got = tm([_t(fpn)], _t(mf), _t(cls), _t(portrait))
    np.testing.assert_allclose(_np(got["pred_logits"]),
                               np.asarray(want["pred_logits"]), atol=2e-3)
    np.testing.assert_allclose(_np(got["pred_masks"]),
                               np.asarray(want["pred_masks"]), atol=1e-2,
                               rtol=1e-2)
    for a, b in zip(got["aux_outputs"], want["aux_outputs"]):
        np.testing.assert_allclose(_np(a["pred_logits"]),
                                   np.asarray(b["pred_logits"]), atol=2e-3)

    # the first prediction's gradient reaches the features through the
    # selected tokens
    f = _t(fpn).requires_grad_(True)
    out = tm([f], _t(mf), _t(cls), _t(portrait))
    first = torch.autograd.grad(out["aux_outputs"][0]["pred_logits"].sum(),
                                f)[0]
    assert first.abs().sum() > 0

    cfg = t_tiny()
    cfg = dataclasses.replace(cfg, panoptic=dataclasses.replace(
        cfg.panoptic, mask_transformer=dataclasses.replace(
            cfg.panoptic.mask_transformer, two_stage=True)))
    model = build_model(cfg, device="cpu", seed=0)
    assert not hasattr(model.panoptic_decoder.mask_transformer, "query_feat")
