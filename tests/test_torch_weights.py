"""weights.load_jax_params: every flax leaf maps onto one port parameter and
every port parameter is filled, for the tiny configs (real arrays) and for
the v1 and v2 configs' shapes (jax.eval_shape on one side, the meta device
on the other, so no full-size array is made)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.presets import panst3r_v1_config as t_v1
from panst3r_torch.models.presets import panst3r_v2_config as t_v2
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_torch.models.presets import tiny_v2_config as t_tiny_v2
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.presets import panst3r_v1_config as j_v1
from panst3r_tpu.models.presets import panst3r_v2_config as j_v2
from panst3r_tpu.models.presets import tiny_config as j_tiny
from panst3r_tpu.models.presets import tiny_v2_config as j_tiny_v2
from tests.test_torch_models import random_params
from tests.torch_release import release_memory  # noqa: F401

H, W, NCLS = 32, 48, 5




@pytest.fixture(scope="module")
def tiny_tree():
    model = JPanSt3R(j_tiny())
    return random_params(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)),
        jnp.zeros((1, 2), bool), jnp.zeros((NCLS, 24)), (H // 16, W // 16))))


def test_tiny_tree_fills_every_parameter(tiny_tree):
    model = TPanSt3R(t_tiny())
    load_jax_params(model, tiny_tree)
    p = tiny_tree["params"]
    enc = p["must3r_encoder"]
    np.testing.assert_array_equal(
        model.must3r_encoder.blocks[1].attn.qkv.weight.detach().numpy(),
        enc["blocks"]["block"]["attn"]["qkv"]["kernel"][1].T)
    np.testing.assert_array_equal(
        model.must3r_encoder.patch_embed.weight.detach().numpy(),
        enc["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.must3r_decoder.layers[0].norm_y.weight.detach().numpy(),
        p["must3r_decoder"]["layers"]["norm_y"]["scale"][0])
    mt = p["panoptic_decoder"]["mask_transformer"]
    assert model.panoptic_decoder.mask_transformer.cls_logit_scale.item() \
        == float(mt["cls_logit_scale"])
    np.testing.assert_array_equal(
        model.dino_encoder.blocks[0].ls1.detach().numpy(),
        p["dino_encoder"]["blocks"]["block"]["ls1"][0])


def test_unmapped_or_missing_leaves_raise(tiny_tree):
    model = TPanSt3R(t_tiny())
    extra = jax.tree_util.tree_map(lambda a: a, tiny_tree)
    extra["params"]["must3r_encoder"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(model, extra)
    missing = jax.tree_util.tree_map(lambda a: a, tiny_tree)
    del missing["params"]["must3r_decoder"]["head"]
    with pytest.raises(KeyError, match="must3r_decoder.head"):
        load_jax_params(model, missing)


def test_v1_shapes_map_one_to_one():
    model = JPanSt3R(j_v1())
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 384, 512, 3)),
        jnp.zeros((1, 2), bool), jnp.zeros((NCLS, 768)), (24, 32)))
    zero = np.zeros((), np.float32)
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(zero, s.shape),
                                  shapes)
    with torch.device("meta"):
        model = TPanSt3R(t_v1())
    load_jax_params(model, tree, copy=False)
    n_flax = sum(int(np.prod(s.shape))
                 for s in jax.tree_util.tree_leaves(shapes))
    assert n_flax == sum(p.numel() for p in model.parameters())


def test_tiny_v2_tree_fills_every_parameter():
    """The v2 head's leaves: GroupNorm scale/bias, the raw Fourier
    ``biases``, convolutions, the mixer's blocks (softmax label mode for
    ``nocls_token``)."""
    import dataclasses

    jcfg, tcfg = j_tiny_v2(), t_tiny_v2()
    kw = dict(label_mode="softmax", text_embed_dim=24)
    jcfg = dataclasses.replace(
        jcfg, panoptic=dataclasses.replace(jcfg.panoptic, **kw))
    tcfg = dataclasses.replace(
        tcfg, panoptic=dataclasses.replace(tcfg.panoptic, **kw))
    jmodel = JPanSt3R(jcfg)
    tree = random_params(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)),
        jnp.zeros((1, 2), bool), jnp.zeros((NCLS, 24)), (H // 16, W // 16))))
    with torch.device("meta"):
        model = TPanSt3R(tcfg)
    model = load_jax_params(model.to_empty(device="cpu"), tree)
    p = tree["params"]["panoptic_decoder"]
    pd = model.panoptic_decoder
    up = p["upscaler"]
    np.testing.assert_array_equal(pd.upscaler.fourier.biases.detach().numpy(),
                                  up["fourier"]["biases"])
    np.testing.assert_array_equal(pd.upscaler.gn1.weight.detach().numpy(),
                                  up["gn1"]["scale"])
    np.testing.assert_array_equal(
        pd.upscaler.conv1.weight.detach().numpy(),
        up["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        pd.upscaler.ca_block_0.cross_attn.projq.weight.detach().numpy(),
        up["ca_block_0"]["cross_attn"]["projq"]["kernel"].T)
    np.testing.assert_array_equal(
        pd.input_mixer.mixer_blk_0.attn.qkv.weight.detach().numpy(),
        p["input_mixer"]["mixer_blk_0"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(pd.nocls_token.detach().numpy(),
                                  p["nocls_token"])


def test_v2_shapes_map_one_to_one():
    model = JPanSt3R(j_v2())
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 384, 512, 3)),
        jnp.zeros((1, 2), bool), jnp.zeros((NCLS, 768)), (24, 32)))
    zero = np.zeros((), np.float32)
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(zero, s.shape),
                                  shapes)
    with torch.device("meta"):
        model = TPanSt3R(t_v2())
    load_jax_params(model, tree, copy=False)
    n_flax = sum(int(np.prod(s.shape))
                 for s in jax.tree_util.tree_leaves(shapes))
    assert n_flax == sum(p.numel() for p in model.parameters())


def test_config_registry_round_trip():
    from panst3r_torch.core import config as cfglib

    cfg = t_v1(init_num_views=3)
    d = cfglib.to_dict(cfg)
    assert d["_type_"] == "PanSt3RConfig"
    assert d["panoptic"]["mask_transformer"]["fpn_dims"] == [768]
    assert cfglib.from_dict(d) == cfg
    with pytest.raises(ValueError, match="unknown fields"):
        cfglib.from_dict({**d, "stray": 1})
