"""panst3r_torch modules against their flax twins on the CPU (f32).

Each test initializes the flax module, carries its parameters into the
port with weights.load_jax_params, feeds both the same numpy inputs and
compares.  Widths use d=64 heads where the JAX package would route to a
tower kernel, so the port's K1/K2 plain versions are what runs here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch.models import blocks as t_blocks
from panst3r_torch.models import memory as t_mem
from panst3r_torch.models.decoder import MemoryDecoder as TDecoder
from panst3r_torch.models.decoder import MemoryDecoderConfig as TDecCfg
from panst3r_torch.models.dino import DinoEncoder as TDino
from panst3r_torch.models.dino import DinoEncoderConfig as TDinoCfg
from panst3r_torch.models.encoder import ViTEncoder as TEncoder
from panst3r_torch.models.encoder import ViTEncoderConfig as TEncCfg
from panst3r_torch.models.mask_transformer import MaskTransformer as TMT
from panst3r_torch.models.mask_transformer import \
    MaskTransformerConfig as TMTCfg
from panst3r_torch.models.panoptic_decoder import PanopticDecoder as TPD
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_torch.models.upscalers import PixelShuffleUpscaler as TPS
from panst3r_torch.ops.image import resize as t_resize
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.models import blocks as j_blocks
from panst3r_tpu.models import memory as j_mem
from panst3r_tpu.models.decoder import MemoryDecoder as JDecoder
from panst3r_tpu.models.decoder import MemoryDecoderConfig as JDecCfg
from panst3r_tpu.models.dino import DinoEncoder as JDino
from panst3r_tpu.models.dino import DinoEncoderConfig as JDinoCfg
from panst3r_tpu.models.encoder import ViTEncoder as JEncoder
from panst3r_tpu.models.encoder import ViTEncoderConfig as JEncCfg
from panst3r_tpu.models.mask_transformer import MaskTransformer as JMT
from panst3r_tpu.models.mask_transformer import \
    MaskTransformerConfig as JMTCfg
from panst3r_tpu.models.panoptic_decoder import PanopticDecoder as JPD
from panst3r_tpu.models.presets import tiny_config as j_tiny
from panst3r_tpu.models.upscalers import PixelShuffleUpscaler as JPS
from panst3r_tpu.ops.rope import patch_grid_positions, rope2d_tables

GH, GW = 8, 12                     # token grid: N = 96
N = GH * GW
NEG = float(np.finfo(np.float32).min)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


def random_params(shapes, seed: int = 7):
    """Random values for a flax parameter tree of shapes (numpy, seeded):
    non-zero biases and non-unit norm scales, so a mis-mapped bias or
    scale shows; kernels scaled by 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        shape = tuple(s.shape)
        if name == "kernel":
            fan_in = np.prod(shape[:-1]) if len(shape) == 4 else shape[-2]
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "cls_token", "pos_embed"):
            a = 0.05 * rng.standard_normal(shape)
        elif name in ("ls1", "ls2"):
            a = 0.2 + 0.05 * rng.standard_normal(shape)
        elif name == "cls_logit_scale":
            a = np.asarray(1.0 + 0.1 * rng.standard_normal())
        else:                       # query_feat, query_embed, level_embed
            a = rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _init(module, *args, **kw):
    return random_params(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kw)))


def _apply(module, params, *args, **kw):
    """module.apply under one jit; keyword arguments stay static."""
    return jax.jit(lambda p, *a: module.apply(p, *a, **kw))(params, *args)


def _port(module, params):
    return load_jax_params(module, params).eval()


def _pos(B):
    return np.broadcast_to(np.asarray(patch_grid_positions(GH, GW))[None],
                           (B, N, 2)).astype(np.int32)


def _tabs_pair(pos):
    j = rope2d_tables(jnp.asarray(pos), 64)
    return j, tuple(_t(a) for a in j)


@torch.no_grad()
def test_block_with_rope(rng):
    x = rng.standard_normal((2, N, 128)).astype(np.float32)
    jt, tt = _tabs_pair(_pos(2))
    jm = j_blocks.Block(num_heads=2)
    params = _init(jm, jnp.asarray(x), tabs=jt)
    want = _apply(jm, params, jnp.asarray(x), None, jt)
    got = _port(t_blocks.Block(128, 2), params)(_t(x), tabs=tt)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


@torch.no_grad()
def test_self_attention_generic_path(rng):
    """d=32 heads: not a tower shape, the JAX generic path (K4, its plain
    version on the CPU); off the CPU the port refuses it (K4 is built for
    head dims 64 and 96)."""
    x = rng.standard_normal((1, 300, 128)).astype(np.float32)
    pos = rng.integers(0, 20, (1, 300, 2)).astype(np.int32)
    jt = rope2d_tables(jnp.asarray(pos), 32)
    jm = j_blocks.SelfAttention(num_heads=4)
    params = _init(jm, jnp.asarray(x), tabs=jt)
    want = _apply(jm, params, jnp.asarray(x), None, None, jt)
    tm = _port(t_blocks.SelfAttention(128, 4), params)
    got = tm(_t(x), tabs=tuple(_t(a) for a in jt))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    with pytest.raises(NotImplementedError, match="K4"):
        tm.to("meta")(torch.empty(1, 300, 128, device="meta"))


@torch.no_grad()
def test_cross_attention_rope_and_validity_bias(rng):
    x = rng.standard_normal((1, 2 * N, 128)).astype(np.float32)
    kv = rng.standard_normal((1, 5 * N, 128)).astype(np.float32)
    valid = np.ones((1, 5 * N), bool)
    valid[:, 2 * N:3 * N] = False
    bias = np.where(valid, 0.0, NEG).astype(np.float32)[:, None, None]
    qpos = rng.integers(0, 20, (1, 2 * N, 2)).astype(np.int32)
    kpos = rng.integers(0, 20, (1, 5 * N, 2)).astype(np.int32)
    jq, tq = _tabs_pair(qpos)
    jk, tk = _tabs_pair(kpos)
    jm = j_blocks.CrossAttention(num_heads=2)
    params = _init(jm, jnp.asarray(x), jnp.asarray(kv), jnp.asarray(kv),
                   bias=jnp.asarray(bias), qtab=jq, ktab=jk)
    want = _apply(jm, params, jnp.asarray(x), jnp.asarray(kv),
                  jnp.asarray(kv), None, None, jnp.asarray(bias), None, jq, jk)
    got = _port(t_blocks.CrossAttention(128, 2), params)(
        _t(x), _t(kv), _t(kv), bias=_t(bias), qtab=tq, ktab=tk)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@torch.no_grad()
def test_decoder_block_with_positions(rng):
    x = rng.standard_normal((1, N, 128)).astype(np.float32)
    mem = rng.standard_normal((1, 3 * N, 128)).astype(np.float32)
    xpos = _pos(1)
    mpos = rng.integers(0, 20, (1, 3 * N, 2)).astype(np.int32)
    valid = np.ones((1, 3 * N), bool)
    valid[:, 2 * N:] = False
    bias = np.where(valid, 0.0, NEG).astype(np.float32)[:, None, None]
    jargs = (jnp.asarray(x), jnp.asarray(xpos), jnp.asarray(mem),
             jnp.asarray(mpos), jnp.asarray(bias))
    jm = j_blocks.DecoderBlock(num_heads=2)
    params = _init(jm, *jargs)
    want = _apply(jm, params, *jargs)
    got = _port(t_blocks.DecoderBlock(128, 2), params)(
        _t(x), _t(xpos), _t(mem), _t(mpos), _t(bias))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


@torch.no_grad()
def test_encoder(rng):
    img = rng.standard_normal((2, GH * 16, GW * 16, 3)).astype(np.float32)
    jm = JEncoder(JEncCfg(embed_dim=128, depth=2, num_heads=2))
    params = _init(jm, jnp.asarray(img))
    jx, jpos = _apply(jm, params, jnp.asarray(img))
    tx, tpos = _port(TEncoder(TEncCfg(embed_dim=128, depth=2, num_heads=2)),
                     params)(_t(img))
    np.testing.assert_array_equal(_np(tpos), np.asarray(jpos))
    np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=1e-4)


@torch.no_grad()
def test_dino_split_cls(rng):
    img = rng.standard_normal((2, GH * 16, GW * 16, 3)).astype(np.float32)
    kw = dict(embed_dim=128, depth=2, num_heads=2, pos_grid=5,
              layerscale_init=0.1)
    jm = JDino(JDinoCfg(**kw))
    params = _init(jm, jnp.asarray(img))
    want = _apply(jm, params, jnp.asarray(img))
    got = _port(TDino(TDinoCfg(**kw)), params)(_t(img))
    assert got.shape == (2, N, 128)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


@torch.no_grad()
def test_decoder_update_and_render_on_partial_memory(rng):
    kw = dict(enc_dim=64, dim=128, depth=2, num_heads=2)
    jm = JDecoder(JDecCfg(**kw))
    tm = TDecoder(TDecCfg(**kw))
    V, K = 3, 3
    x = rng.standard_normal((1, V, N, 64)).astype(np.float32)
    pos = _pos(V)[None]
    jmem = j_mem.init_memory(2, 1, K * N, 128)
    params = _init(jm, jnp.asarray(x[:, :2]), jnp.asarray(pos[:, :2]), jmem,
                   render=False, grid=(GH, GW))
    _port(tm, params)
    # update with 2 views: memory ends 2/3 full
    jmem, jpm, jf = _apply(jm, params, jnp.asarray(x[:, :2]),
                           jnp.asarray(pos[:, :2]), jmem, render=False,
                           grid=(GH, GW))
    tmem = t_mem.init_memory(2, 1, K * N, 128)
    tmem, tpm, tf = tm(_t(x[:, :2]), _t(pos[:, :2]), tmem, render=False,
                       grid=(GH, GW))
    assert tmem.count == int(jmem.count) == 2 * N
    np.testing.assert_array_equal(_np(tmem.valid), np.asarray(jmem.valid))
    np.testing.assert_allclose(_np(tmem.y), np.asarray(jmem.y), atol=1e-4)
    np.testing.assert_allclose(_np(tpm), np.asarray(jpm), atol=2e-4)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=1e-4)
    # render all 3 views against the partly filled memory
    _, jpm, jf = _apply(jm, params, jnp.asarray(x), jnp.asarray(pos), jmem,
                        render=True, grid=(GH, GW))
    _, tpm, tf = tm(_t(x), _t(pos), tmem, render=True, grid=(GH, GW))
    np.testing.assert_allclose(_np(tpm), np.asarray(jpm), atol=2e-4)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=1e-4)


@torch.no_grad()
def test_pixel_shuffle_upscaler(rng):
    cfg = j_tiny().panoptic.upscaler
    feats = rng.standard_normal((2, 6, 64)).astype(np.float32)
    jm = JPS(cfg)
    params = _init(jm, jnp.asarray(feats), None, (2, 3))
    (jf16,), jf2 = _apply(jm, params, jnp.asarray(feats), None, grid=(2, 3))
    (tf16,), tf2 = _port(TPS(64, t_tiny().panoptic.upscaler), params)(
        _t(feats), (2, 3))
    np.testing.assert_allclose(_np(tf16), np.asarray(jf16), atol=1e-5)
    np.testing.assert_allclose(_np(tf2), np.asarray(jf2), atol=1e-5)


_MT_KW = dict(hidden_dim=64, ff_dim=64, mask_dim=16, num_queries=10,
              num_heads=2, dec_layers=2, lang_dim=24, fpn_dims=(64,))


@pytest.fixture(scope="module")
def mt_setup():
    rng = np.random.default_rng(1)
    fpn = rng.standard_normal((1, 2, 4, 6, 64)).astype(np.float32)
    mf = rng.standard_normal((1, 2, 32, 48, 16)).astype(np.float32)
    cls = rng.standard_normal((5, 24)).astype(np.float32)
    portrait = np.array([[False, True]])
    jm = JMT(JMTCfg(**_MT_KW))
    args = ([jnp.asarray(fpn)], jnp.asarray(mf), jnp.asarray(cls),
            jnp.asarray(portrait))
    params = _init(jm, *args)
    tm = _port(TMT(TMTCfg(**_MT_KW)), params)
    return jm, params, tm, args, (fpn, mf, cls, portrait)


@torch.no_grad()
def test_mask_transformer_layer_with_jax_blocked(mt_setup):
    """Prediction heads (class logits, masks, blocked bits) and the masked
    cross-attention layer fed the JAX blocked mask."""
    jm, params, tm, args, (fpn, mf, cls, _) = mt_setup
    out0 = np.asarray(params["params"]["query_feat"])[None]
    jc, jmask, jblk = _apply(jm, params, jnp.asarray(out0), jnp.asarray(mf),
                             jnp.asarray(cls), attn_grids=(4, 6),
                             method=JMT.prediction_heads)
    af = t_resize(_t(mf), (1, 2, 4, 6, 16), "bilinear")
    tc, tmask, tblk = tm.prediction_heads(_t(out0), _t(mf), _t(cls),
                                          attn_feats=af)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(_np(tmask), np.asarray(jmask), atol=1e-4)
    np.testing.assert_array_equal(_np(tblk), np.asarray(jblk))

    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 10, 64)).astype(np.float32)
    kv = rng.standard_normal((1, 48, 64)).astype(np.float32)

    def layer0(m, q, k, v, b):
        return m.cross_attn_layers[0](q, k, v, blocked=b)

    want = _apply(jm, params, jnp.asarray(q), jnp.asarray(kv),
                  jnp.asarray(kv), jblk, method=layer0)
    got = tm.cross_attn_0(_t(q), _t(kv), _t(kv), blocked=_t(jblk))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@torch.no_grad()
def test_mask_transformer_end_to_end(mt_setup):
    jm, params, tm, args, (fpn, mf, cls, portrait) = mt_setup
    want = _apply(jm, params, *args)
    got = tm([_t(fpn)], _t(mf), _t(cls), _t(portrait))
    np.testing.assert_allclose(_np(got["pred_logits"]),
                               np.asarray(want["pred_logits"]), atol=2e-3)
    np.testing.assert_allclose(_np(got["pred_masks"]),
                               np.asarray(want["pred_masks"]), atol=1e-2,
                               rtol=1e-2)
    for a, b in zip(got["aux_outputs"], want["aux_outputs"]):
        np.testing.assert_allclose(_np(a["pred_masks"]),
                                   np.asarray(b["pred_masks"]), atol=1e-2,
                                   rtol=1e-2)


@torch.no_grad()
def test_panoptic_decoder_with_memory_queries(rng):
    V = 2
    feats = tuple(rng.standard_normal((1, V, 6, d)).astype(np.float32)
                  for d in (64, 48, 32))
    images = np.zeros((1, V, 32, 48, 3), np.float32)
    pos = np.zeros((1, V, 6, 2), np.int32)
    portrait = np.zeros((1, V), bool)
    cls = rng.standard_normal((5, 24)).astype(np.float32)
    jm = JPD(j_tiny().panoptic)
    jargs = (tuple(map(jnp.asarray, feats)), jnp.asarray(images),
             jnp.asarray(pos), jnp.asarray(portrait), jnp.asarray(cls),
             (2, 3))
    params = _init(jm, *jargs)
    tm = _port(TPD(144, t_tiny().panoptic), params)
    targs = (tuple(map(_t, feats)), _t(images), _t(pos), _t(portrait),
             _t(cls), (2, 3))
    want = _apply(jm, params, *jargs[:5], grid=(2, 3),
                  deep_supervision=False)
    got = tm(*targs, deep_supervision=False)
    np.testing.assert_allclose(_np(got["pred_logits"]),
                               np.asarray(want["pred_logits"]), atol=2e-3)
    np.testing.assert_allclose(_np(got["pred_masks"]),
                               np.asarray(want["pred_masks"]), atol=1e-2,
                               rtol=1e-2)
    mq = np.asarray(want["out_queries"])
    want = _apply(jm, params, *jargs[:5], grid=(2, 3),
                  memory_queries=jnp.asarray(mq))
    got = tm(*targs, memory_queries=_t(mq))
    np.testing.assert_allclose(_np(got["pred_logits"]),
                               np.asarray(want["pred_logits"]), atol=1e-4)
    np.testing.assert_allclose(_np(got["pred_masks"]),
                               np.asarray(want["pred_masks"]), atol=1e-4)
