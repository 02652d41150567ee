"""The port's mesh and tensor-parallel rules against panst3r_tpu's, on the
CPU without spawning ranks: ``MeshSpec.resolve``, ``tp_spec`` over every
parameter of the tiny and v1 models against the JAX rule over the flax
tree, ``apply_tp``'s refusals, and the packed ``qkv`` split by heads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from panst3r_torch.core import mesh as tmesh
from panst3r_torch.core import tp as ttp
from panst3r_torch.models import presets as t_presets
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.weights import _convert
from panst3r_tpu.core import mesh as jmesh
from panst3r_tpu.core.tp import tp_spec as j_tp_spec
from panst3r_tpu.models import presets as j_presets
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from tests.torch_release import release_memory  # noqa: F401

RESOLVE_CASES = [((-1, 2, 1), 8), ((8, 1, 1), 8), ((2, 2, -1), 8),
                 ((3, 2, 1), 8), ((2, 1, 1), 1), ((-1, 2, 1), 1),
                 ((1, 1, 2), 1), ((-1, -1, 1), 4)]


@pytest.mark.parametrize("axes,n", RESOLVE_CASES)
def test_mesh_spec_resolve_matches_jax(axes, n):
    """The cases of tests/test_sharding.py and the train app's one-process
    refusals: the same sizes, or the same ValueError."""
    def run(spec):
        try:
            return spec.resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tmesh.MeshSpec(*axes)) == run(jmesh.MeshSpec(*axes))


def test_build_mesh_one_process_and_padding():
    m = tmesh.build_mesh()
    assert m.shape == (1, 1, 1) and m.coords == (0, 0, 0)
    assert all(m.group(a) is None for a in tmesh.AXES)
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.build_mesh(tmesh.MeshSpec(data=2))
    for n, k in ((5, 2), (8, 4), (1, 3), (9, 4)):
        assert tmesh.pad_to_multiple(n, k) == jmesh.pad_to_multiple(n, k)
    x = torch.arange(12).reshape(3, 4)
    assert tmesh.local_slice(x, 1, None) is x


def _jax_shapes(jconfig):
    model = JPanSt3R(jconfig)
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 48, 3)),
        jnp.zeros((1, 2), bool), jnp.zeros((5, jconfig.panoptic
                                            .mask_transformer.lang_dim)),
        (2, 3)))["params"]


def _jax_specs(shapes, model_size):
    """{port parameter name: sharded torch dim or None} from JAX's rule
    over the flax tree of shapes (the layer axis of scanned stacks
    dropped, flax (…, in, out) read as torch (out, in, …))."""
    specs = jax.tree_util.tree_map_with_path(
        lambda p, l: j_tp_spec(p, l, model_size), shapes)
    flat_specs = {
        tuple(str(k.key) for k in p): s
        for p, s in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))}
    out = {}
    for p, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        path = tuple(str(k.key) for k in p)
        spec = tuple(flat_specs[path]) + (None,) * (
            len(leaf.shape) - len(flat_specs[path]))
        dims = [i for i, ax in enumerate(spec) if ax is not None]
        nd = len(leaf.shape)
        zeros = np.broadcast_to(np.zeros((), np.int8), leaf.shape)
        for name, _ in _convert(path, zeros):
            if not dims:
                out[name] = None
            else:   # flax's last dim is torch's 0, the one before its 1
                out[name] = {nd - 1: 0, nd - 2: 1}[dims[0]]
    return out


@pytest.mark.parametrize("preset", ["tiny", "v1"])
def test_tp_spec_matches_jax(preset):
    jcfg = {"tiny": j_presets.tiny_config,
            "v1": j_presets.panst3r_v1_config}[preset]()
    tcfg = {"tiny": t_presets.tiny_config,
            "v1": t_presets.panst3r_v1_config}[preset]()
    with torch.device("meta"):
        model = TPanSt3R(tcfg)
    params = dict(model.named_parameters())
    shapes = _jax_shapes(jcfg)
    for n in (2, 4):
        want = _jax_specs(shapes, n)
        assert set(want) == set(params)
        got = {k: ttp.sharded_dim(k, p.shape, n) for k, p in params.items()}
        assert got == want, [k for k in got if got[k] != want[k]][:5]
        assert any(v is not None for v in got.values())


def _fake_group(n, index=0):
    return tmesh.Group(None, tuple(range(n)), index)


def test_apply_tp_refuses_a_half_split_block():
    """At model=3 the tiny preset's qkv (192 rows) would split and its
    proj (64 inputs) not: apply_tp names them; at model=8 the DINO's 2
    heads would split."""
    with torch.device("meta"):
        model = TPanSt3R(t_presets.tiny_config())
    with pytest.raises(ValueError, match="qkv"):
        ttp.apply_tp(model, _fake_group(3))
    with torch.device("meta"):
        model = TPanSt3R(t_presets.tiny_config())
    with pytest.raises(ValueError, match="heads over 8"):
        ttp.apply_tp(model, _fake_group(8))


def test_qkv_split_by_heads():
    """A rank's packed qkv rows are its heads' q, k and v rows; the shards
    put back per q/k/v give the full matrix, and a row-parallel weight
    splits its input columns."""
    C, n = 8, 2
    full = torch.arange(3 * C * C, dtype=torch.float32).reshape(3 * C, C)
    shards = [ttp.shard_param("a.qkv.weight", full, _fake_group(n, r))
              for r in range(n)]
    for r, s in enumerate(shards):
        want = torch.cat([full[j * C + r * C // n:j * C + (r + 1) * C // n]
                          for j in range(3)])
        assert torch.equal(s, want)
    proj = torch.arange(C * C, dtype=torch.float32).reshape(C, C)
    assert torch.equal(ttp.shard_param("a.proj.weight", proj,
                                       _fake_group(n, 1)), proj[:, C // n:])
    bias = torch.arange(C, dtype=torch.float32)
    assert torch.equal(ttp.shard_param("a.proj.bias", bias,
                                       _fake_group(n, 1)), bias)
