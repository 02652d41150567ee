"""weights.load_jax_params: every flax leaf maps onto one port parameter and
every port parameter is filled, for the tiny config (real arrays) and for
the v1 config's shapes (jax.eval_shape on one side, the meta device on the
other, so no full-size array is made)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.presets import panst3r_v1_config as t_v1
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.presets import panst3r_v1_config as j_v1
from panst3r_tpu.models.presets import tiny_config as j_tiny
from tests.test_torch_models import random_params

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


def test_config_registry_round_trip():
    from panst3r_torch.core import config as cfglib

    cfg = t_v1(init_num_views=3)
    d = cfglib.to_dict(cfg)
    assert d["_type_"] == "PanSt3RConfig"
    assert d["panoptic"]["mask_transformer"]["fpn_dims"] == [768]
    assert cfglib.from_dict(d) == cfg
    with pytest.raises(ValueError, match="unknown fields"):
        cfglib.from_dict({**d, "stray": 1})
