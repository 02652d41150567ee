"""The JAX ladder's flagship rungs in the port (``core/dryrun.py``:
``flagship_step_worker``, ``flagship_serve_worker``) at the tiny preset
on eight gloo ranks (CPU), in one spawn with the tiny step, over the
(data 2, mem 2, model 2) mesh of ``mesh_axes(8)``.

The flagship step's loss is the same on every rank and within 1e-6
relative of the port's one-process step on the same batch (the data-,
memory- and tensor-parallel sums only reassociate, as
tests/test_torch_tp_dp.py's step).  The sharded serve wire (memory bank
over ``mem``, tensor parallelism over ``model``) against the JAX
package's one-device ``serve_device`` wire on the same weights, under
JAX's limits (pan agreement > 0.99, conf atol 0.05,
``__graft_entry__.py:300-302``); ``fusion_sharded`` bit-equal to the
unsharded fusion on every rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from panst3r_torch.core import dryrun
from panst3r_torch.models.panst3r import build_model
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_torch.weights import dump_jax_params
from panst3r_tpu.core.bucketing import Bucket as JBucket
from panst3r_tpu.engine.inference import InferenceEngine as JEngine
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.presets import tiny_config as j_tiny
from tests.torch_release import release_memory  # noqa: F401

RANKS = 8


@pytest.fixture(scope="module")
def ranks():
    return dryrun.dryrun_multichip(RANKS, flagship=True, config=t_tiny(),
                                   timeout=300)


def test_flagship_mesh_and_losses(ranks):
    """Every rank on the (2, 2, 2) mesh, each coordinate once; the tiny
    and the flagship step's losses finite and equal on every rank."""
    assert [r["flagship_step"]["mesh"] for r in ranks] == [(2, 2, 2)] * 8
    assert sorted(r["flagship_step"]["coords"] for r in ranks) == [
        (d, m, t) for d in range(2) for m in range(2) for t in range(2)]
    for losses in ([r["loss"] for r in ranks],
                   [r["flagship_step"]["loss"] for r in ranks]):
        assert np.isfinite(losses).all() and len(set(losses)) == 1


def test_flagship_step_matches_one_process(ranks):
    """The sharded step's loss against the port's one-process step on the
    whole batch."""
    f = dryrun.FLAGSHIP_STEP
    cfg = t_tiny()
    (H, W), B = f["hw"], f["B"]
    batch = dryrun.tiny_batch(B, f["V"], 0, (H, W), f["ncls"],
                              cfg.panoptic.mask_transformer.lang_dim,
                              valid=(True, True, True, False))
    model = build_model(cfg, device="cpu", seed=0).train()
    loss, _, _ = dryrun.train_micro_step(
        model, dryrun.batch_rows(batch, slice(None), "cpu"),
        (H // 16, W // 16), "cpu", lr=f["lr"], num_points=f["num_points"])
    got = ranks[0]["flagship_step"]["loss"]
    assert abs(got - loss) <= 1e-6 * abs(loss), (got, loss)


def test_sharded_serve_matches_jax_wire(ranks):
    """The mem-sharded, tensor-parallel wire of every rank against the JAX
    package's one-device ``serve_device`` on the same weights and scene,
    decoded by the JAX engine: pan agreement > 0.99, conf within 0.05."""
    f = dryrun.FLAGSHIP_SERVE
    (H, W), V = f["hw"], f["V"]
    cfg = t_tiny()
    images, portrait, _ = dryrun.flagship_scene(
        cfg.panoptic.mask_transformer.lang_dim)
    cls = ranks[0]["sharded_serve"]["cls_emb"]
    model = build_model(cfg, device="cpu", seed=0)
    params = {"params": jax.tree_util.tree_map(jnp.asarray,
                                               dump_jax_params(model))}
    jeng = JEngine(JPanSt3R(j_tiny()), params, JBucket(H, W),
                   num_keyframes=f["K"], chunk=f["chunk"], amp=False)
    want = jeng.unpack_wire(np.asarray(jeng.serve_device(images, portrait,
                                                         cls)), V)
    assert want["selected"].sum() >= 1              # segments to compare
    for r, rank in enumerate(ranks):
        serve = rank["sharded_serve"]
        assert serve["ok"], r
        got = jeng.unpack_wire(serve["wire"], V)
        agree = float((got["pan"] == want["pan"]).mean())
        assert agree > dryrun.SERVE_PAN_AGREE, (r, agree)
        np.testing.assert_allclose(got["conf"], want["conf"],
                                   atol=dryrun.SERVE_CONF_ATOL,
                                   err_msg=f"rank {r}")


def test_fusion_sharded_bit_exact(ranks):
    """``fusion_sharded`` over ``mem`` against ``_fusion_full`` on the same
    rank at the rung's 200 queries x (H/2, W/2), with segments to
    compare."""
    for rank in ranks:
        serve = rank["sharded_serve"]
        assert serve["fusion_bit_equal"] and serve["fusion_segments"] > 0
