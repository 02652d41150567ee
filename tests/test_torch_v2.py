"""The v2 head of panst3r_torch against its flax twins on the CPU: the
cross-only block, the InputMixer and LoftUp in f64 on both sides, the v2
panoptic decoder in both label modes and a tiny_v2 engine run in f32, and
the dtypes of LoftUp's intermediates under amp.

Why f64 for the LoftUp modules: LoftUp's Fourier featurizer multiplies its
inputs by up to e^10 ≈ 2.2e4 before sin/cos, so one f32 rounding of a
coordinate moves a phase by ~3e-3; in f64 a mapping or layout fault still
shows as O(1).  The JAX attention keeps f32 logits even for f64 inputs
(``preferred_element_type``), hence limits of 1e-6 there.

Port modules are built on the meta device and filled by
``weights.load_jax_params``: no test here draws from torch's global RNG or
changes any other global state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch.core.bucketing import Bucket as TBucket
from panst3r_torch.engine.inference import InferenceEngine as TEngine
from panst3r_torch.models import blocks as t_blocks
from panst3r_torch.models.input_mixer import InputMixer as TMixer
from panst3r_torch.models.input_mixer import InputMixerConfig as TMixerCfg
from panst3r_torch.models.panoptic_decoder import PanopticDecoder as TPD
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.presets import tiny_v2_config as t_tiny_v2
from panst3r_torch.models.upscalers import LoftUpUpscaler as TLoftUp
from panst3r_torch.models.upscalers import LoftUpUpscalerConfig as TLoftCfg
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.core.bucketing import Bucket as JBucket
from panst3r_tpu.engine.inference import InferenceEngine as JEngine
from panst3r_tpu.models import blocks as j_blocks
from panst3r_tpu.models.input_mixer import InputMixer as JMixer
from panst3r_tpu.models.input_mixer import InputMixerConfig as JMixerCfg
from panst3r_tpu.models.panoptic_decoder import PanopticDecoder as JPD
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.presets import tiny_v2_config as j_tiny_v2
from panst3r_tpu.models.upscalers.loftup import LoftUpUpscaler as JLoftUp
from panst3r_tpu.models.upscalers.loftup import \
    LoftUpUpscalerConfig as JLoftCfg
from panst3r_tpu.ops.rope import patch_grid_positions
from tests.test_torch_models import random_params

F64_TOL = dict(rtol=1e-6, atol=1e-6)


def _port(ctor, params, dtype=torch.float32):
    """Build a port module on the meta device (no RNG draw) and fill it."""
    with torch.device("meta"):
        module = ctor()
    module = module.to_empty(device="cpu").to(dtype)
    return load_jax_params(module, params).eval()


def _init(module, *args, **kw):
    return random_params(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kw)))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@torch.no_grad()
@pytest.mark.parametrize("dim,heads,nq", [(16, 2, 300), (192, 2, 260)])
def test_crossonly_block_f64(dim, heads, nq):
    """K4's plain version at D = 8 and D = 96 (the LoftUp head dim)."""
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((2, nq, dim))
    y = rng.standard_normal((2, 40, dim))
    jm = j_blocks.CrossonlyDecoderBlock(heads, mlp_ratio=1.0)
    params = _f64(_init(jm, jnp.zeros((2, nq, dim)), jnp.zeros((2, 40, dim))))
    with jax.enable_x64():
        want, _ = jm.apply(params, jnp.asarray(x), jnp.asarray(y))
        want = np.asarray(want)
    tm = _port(lambda: t_blocks.CrossonlyDecoderBlock(dim, heads, 1.0),
               params, torch.float64)
    got, _ = tm(_t(x), _t(y))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


@torch.no_grad()
@pytest.mark.parametrize("hidden,heads,grid", [(128, 2, (8, 12)),
                                               (192, 2, (15, 20))])
def test_input_mixer_f64(hidden, heads, grid):
    """(128, 2): d=64 heads, the tower path (K1's plain version);
    (192, 2): d=96 over 300 tokens, the generic path (K4 with RoPE)."""
    rng = np.random.default_rng(hidden)
    n = grid[0] * grid[1]
    x = rng.standard_normal((2, n, 48))
    pos = np.broadcast_to(np.asarray(patch_grid_positions(*grid))[None],
                          (2, n, 2)).astype(np.int32)
    kw = dict(hidden_dim=hidden, num_heads=heads, num_layers=2)
    jm = JMixer(JMixerCfg(**kw))
    params = _f64(_init(jm, jnp.zeros((2, n, 48)), jnp.asarray(pos)))
    with jax.enable_x64():
        want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(pos)))
    tm = _port(lambda: TMixer(48, TMixerCfg(**kw)), params, torch.float64)
    got = tm(_t(x), _t(pos))
    # RoPE tables are f32 on both sides, as are the JAX logits
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@torch.no_grad()
@pytest.mark.parametrize("dim,heads,n_freqs,hw", [(16, 2, 20, (32, 48)),
                                                  (192, 2, 5, (48, 32))])
def test_loftup_f64(dim, heads, n_freqs, hw):
    """LoftUp with two views in one call (its min-max spans both)."""
    rng = np.random.default_rng(dim + n_freqs)
    H, W = hw
    gh, gw = H // 16, W // 16
    feats = rng.standard_normal((2, gh * gw, 24))
    img = rng.random((2, H, W, 3)) * 2 - 1
    kw = dict(dim=dim, num_heads=heads, n_freqs=n_freqs)
    jm = JLoftUp(JLoftCfg(**kw))
    params = _f64(_init(jm, jnp.zeros((2, gh * gw, 24)),
                        jnp.zeros((2, H, W, 3)), (gh, gw)))
    with jax.enable_x64():
        (jf,), jmask = jm.apply(params, jnp.asarray(feats), jnp.asarray(img),
                                (gh, gw))
        jf, jmask = np.asarray(jf), np.asarray(jmask)
    tm = _port(lambda: TLoftUp(24, TLoftCfg(**kw)), params, torch.float64)
    (tf,), tmask = tm(_t(feats), _t(img), (gh, gw))
    assert tmask.shape == (2, H // 2, W // 2, dim)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tmask.numpy(), jmask, **F64_TOL)


def _collect_dtypes(tree):
    """flax capture_intermediates → {module name: output dtypes}."""
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict) and "__call__" in sub:
            out[name] = [str(a.dtype) for a in
                         jax.tree_util.tree_leaves(sub["__call__"])]
    return out


@torch.no_grad()
def test_loftup_amp_dtypes_follow_flax_promotion():
    """Under amp (bf16 parameters, feats and images) flax promotes LoftUp's
    guidance branch to f32 from the Fourier features on; the port's
    intermediates and mask features carry the same dtypes."""
    H, W, gh, gw, C = 32, 48, 2, 3, 24
    kw = dict(dim=16, num_heads=2, n_freqs=4)
    jm = JLoftUp(JLoftCfg(**kw))
    params = _init(jm, jnp.zeros((2, gh * gw, C)), jnp.zeros((2, H, W, 3)),
                   (gh, gw))
    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                 params)
    feats = jnp.zeros((2, gh * gw, C), jnp.bfloat16)
    img = jnp.zeros((2, H, W, 3), jnp.bfloat16)
    (jf,), jmask = jax.eval_shape(lambda: jm.apply(p16, feats, img,
                                                   (gh, gw)))
    _, state = jax.eval_shape(lambda: jm.apply(
        p16, feats, img, (gh, gw), capture_intermediates=True,
        mutable=["intermediates"]))
    want = _collect_dtypes(state["intermediates"])
    want["mask_feats"], want["fpn0"] = [str(jmask.dtype)], [str(jf.dtype)]

    tm = _port(lambda: TLoftUp(C, TLoftCfg(**kw)), params, torch.bfloat16)
    got = {}

    def hook(name):
        def record(_, __, out):
            leaves = out if isinstance(out, (tuple, list)) else (out,)
            got[name] = [str(t.dtype).split(".")[-1] for t in leaves]
        return record

    handles = [m.register_forward_hook(hook(n))
               for n, m in tm.named_children()]
    rng = np.random.default_rng(0)
    (tf,), tmask = tm(_t(rng.standard_normal((2, gh * gw, C))).bfloat16(),
                      _t(rng.random((2, H, W, 3))).bfloat16(), (gh, gw))
    for h in handles:
        h.remove()
    got["mask_feats"], got["fpn0"] = [str(tmask.dtype).split(".")[-1]], \
        [str(tf.dtype).split(".")[-1]]
    assert want["fourier"] == want["conv1"] == want["mask_feats"] \
        == ["float32"]
    assert want["minmax"] == want["fpn0"] == ["bfloat16"]
    for name, dtypes in want.items():
        assert got[name] == dtypes, (name, got[name], dtypes)


def _v2_panoptic_cfg(label_mode):
    """tiny_v2's head in ``label_mode``, with the no-class token as wide as
    its class embeddings (24)."""
    kw = dict(label_mode=label_mode, text_embed_dim=24)
    return dataclasses.replace(j_tiny_v2().panoptic, **kw), \
        dataclasses.replace(t_tiny_v2().panoptic, **kw)


@torch.no_grad()
@pytest.mark.parametrize("label_mode", ["sigmoid", "softmax"])
def test_v2_panoptic_decoder(label_mode):
    """Mixer → LoftUp → mask transformer, then the memory-queries path;
    f32 (the Fourier phases differ by ~1e-3 between JAX's f32 coordinates
    and the port's, so the mask limits are those of the v1 head)."""
    rng = np.random.default_rng(3)
    V, gh, gw = 2, 2, 3
    feats = tuple(rng.standard_normal((1, V, gh * gw, d)).astype(np.float32)
                  for d in (64, 48, 32))
    images = (rng.random((1, V, 32, 48, 3)) * 2 - 1).astype(np.float32)
    pos = np.broadcast_to(np.asarray(patch_grid_positions(gh, gw)),
                          (1, V, gh * gw, 2)).astype(np.int32)
    portrait = np.zeros((1, V), bool)
    cls = rng.standard_normal((5, 24)).astype(np.float32)
    jcfg, tcfg = _v2_panoptic_cfg(label_mode)
    jm = JPD(jcfg)
    jargs = (tuple(map(jnp.asarray, feats)), jnp.asarray(images),
             jnp.asarray(pos), jnp.asarray(portrait), jnp.asarray(cls))
    params = _init(jm, *jargs, (gh, gw))
    tm = _port(lambda: TPD(144, tcfg), params)
    targs = (tuple(map(_t, feats)), _t(images), _t(pos), _t(portrait),
             _t(cls), (gh, gw))
    want = jax.jit(lambda p, *a: jm.apply(p, *a, (gh, gw),
                                          deep_supervision=False))(
        params, *jargs)
    got = tm(*targs, deep_supervision=False)
    ncls = 6 if label_mode == "softmax" else 5
    assert got["pred_logits"].shape == (1, 16, ncls)
    np.testing.assert_allclose(got["pred_logits"].numpy(),
                               np.asarray(want["pred_logits"]), atol=2e-3)
    np.testing.assert_allclose(got["pred_masks"].numpy(),
                               np.asarray(want["pred_masks"]), atol=1e-2,
                               rtol=1e-2)
    mq = np.asarray(want["out_queries"])
    want = jax.jit(lambda p, q, *a: jm.apply(p, *a, (gh, gw),
                                             memory_queries=q))(
        params, jnp.asarray(mq), *jargs)
    got = tm(*targs, memory_queries=_t(mq))
    np.testing.assert_allclose(got["pred_logits"].numpy(),
                               np.asarray(want["pred_logits"]), atol=1e-4)
    np.testing.assert_allclose(got["pred_masks"].numpy(),
                               np.asarray(want["pred_masks"]), atol=1e-2,
                               rtol=1e-2)


H, W, V, K, NCLS = 32, 48, 5, 3, 5


def test_tiny_v2_engine_run_matches_jax_engine():
    """The whole v2 slice: uint8 views through InferenceEngine.run on both
    sides, same weights, f32; limits of tests/test_inference.py."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    portrait = np.zeros(V, bool)
    cls_emb = rng.standard_normal((NCLS, 24)).astype(np.float32)
    jmodel = JPanSt3R(j_tiny_v2())
    params = random_params(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)),
        jnp.zeros((1, 2), bool), jnp.asarray(cls_emb), (H // 16, W // 16))))
    jeng = JEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                   JBucket(H, W), num_keyframes=K, chunk=2, amp=False)
    teng = TEngine(_port(lambda: TPanSt3R(t_tiny_v2()), params),
                   TBucket(H, W), num_keyframes=K, chunk=2, amp=False,
                   device="cpu")
    want = jeng.run(images, portrait, cls_emb)
    got = teng.run(images, portrait, cls_emb)
    assert got["keyframes"] == want["keyframes"] == [0, 2, 4]
    np.testing.assert_allclose(got["pointmaps_raw"], want["pointmaps_raw"],
                               atol=2e-4)
    np.testing.assert_allclose(got["pred_logits"], want["pred_logits"],
                               atol=2e-3)
    np.testing.assert_allclose(got["pred_masks"], want["pred_masks"],
                               atol=1e-2, rtol=1e-2)
