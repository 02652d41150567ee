"""The port's sharded functions on four gloo ranks (CPU) against
panst3r_tpu's on the virtual CPU mesh, with the same numpy inputs:
``sharded_memory_attention`` and ``ring_memory_attention`` over ``mem`` =
2 and 4 (rtol 2e-4 / atol 2e-5, as tests/test_sharding.py), the
view-sharded fusion over 2 ranks (bit for bit) and the
observation-sharded BA over 2 ranks (tests/test_ba.py's tolerances), and
the tiny train step of ``dryrun_multichip(4)``.  One spawn of four ranks
runs every port function (``core/dryrun.py::jobs_worker``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from panst3r_torch.core import distributed
from panst3r_torch.core import dryrun
from panst3r_tpu.core.mesh import MeshSpec, build_mesh
from panst3r_tpu.engine.ba import bundle_adjust_sharded as j_ba_sharded
from panst3r_tpu.engine.fusion import fusion_sharded as j_fusion_sharded
from panst3r_tpu.ops.sharded_attention import (ring_memory_attention,
                                               sharded_memory_attention)
from tests.test_ba import _synthetic

RANKS = 4
FUSION = dict(B=1, V=8, Q=12, h=16, w=24, H=32, W=48)


def _attention_cases():
    rng = np.random.default_rng(0)
    B, H, Nq, M, D = 2, 4, 16, 64, 32
    q = (rng.standard_normal((B, H, Nq, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, H, M, D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, H, M, D)).astype(np.float32)
    valid = np.broadcast_to(np.arange(M) < 40, (B, M)).copy()
    return [(q, k, v, None), (q, k, v, valid)]


def _fusion_inputs():
    f = FUSION
    return dryrun.fusion_inputs(1, f["B"], f["V"], f["Q"], f["h"], f["w"])


def _ba_inputs():
    (_, _, poses0, anchors0, ov, oa, xl, w) = _synthetic(
        np.random.default_rng(2), K=4, A=32, obs_per_view=64)
    pad = (-len(ov)) % 2 + 2          # zero-weight padding, kept even
    return (poses0.astype(np.float32), anchors0,
            np.concatenate([ov, np.zeros(pad, np.int32)]),
            np.concatenate([oa, np.zeros(pad, np.int32)]),
            np.concatenate([xl, np.zeros((pad, 3), np.float32)]),
            np.concatenate([w, np.zeros(pad, np.float32)]))


@pytest.fixture(scope="module")
def ranks():
    f = FUSION
    jobs = [(dryrun.attention_worker, (_attention_cases(),), {}),
            (dryrun.fusion_worker, (*_fusion_inputs(), (f["H"], f["W"]), {}),
             {}),
            (dryrun.ba_worker, _ba_inputs(), {"iters": 6})]
    return distributed.launch(dryrun.jobs_worker, RANKS, "gloo", "cpu", jobs,
                              threads=1)


@pytest.mark.parametrize("mem", [2, 4])
def test_memory_attention_matches_jax(ranks, mem):
    mesh = build_mesh(MeshSpec(data=1, mem=mem))
    for i, (q, k, v, valid) in enumerate(_attention_cases()):
        args = [jnp.asarray(a) for a in (q, k, v)]
        if valid is not None:
            args.append(jnp.asarray(valid))
        want = {"sharded": np.asarray(sharded_memory_attention(mesh, *args)),
                "ring": np.asarray(ring_memory_attention(mesh, *args))}
        for r in range(RANKS):
            got = ranks[r][0][i][mem]
            for name in ("sharded", "ring"):
                np.testing.assert_allclose(got[name], want[name], rtol=2e-4,
                                           atol=2e-5, err_msg=f"{name} {r}")


def test_fusion_sharded_matches_jax_bit_for_bit(ranks):
    f = FUSION
    mask_cls, mask_pred = _fusion_inputs()
    mesh = build_mesh(MeshSpec(data=1, mem=2))
    want = j_fusion_sharded(jnp.asarray(mask_cls), jnp.asarray(mask_pred),
                            (f["H"], f["W"]), mesh, axis="mem")
    names = ("pan", "conf", "seg_ids", "labels", "selected")
    assert np.asarray(want[4]).sum() >= 2          # segments to compare
    for r in range(RANKS):
        got = ranks[r][1]
        assert got["bit_equal"], r          # against the port's one rank
        for name, w in zip(names, want):
            np.testing.assert_array_equal(got[name], np.asarray(w),
                                          err_msg=f"{name} rank {r}")


def test_bundle_adjust_sharded_matches_jax(ranks):
    args = _ba_inputs()
    mesh = build_mesh(MeshSpec(data=2, mem=1))
    poses, _, costs = j_ba_sharded(*(jnp.asarray(a) for a in args), mesh,
                                   iters=6)
    poses, costs = np.asarray(poses), np.asarray(costs)
    for r in range(RANKS):
        got = ranks[r][2]
        for p, c in ((got["poses"], got["costs"]),
                     (got["poses_one"], got["costs_one"])):
            np.testing.assert_allclose(p, poses, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(c, costs, rtol=1e-3,
                                       atol=1e-8 * float(costs[0]))


def test_dryrun_multichip_four_ranks():
    """data 2 × mem 2: a finite loss, the same on every rank."""
    out = dryrun.dryrun_multichip(4)
    assert [r["mesh"] for r in out] == [(2, 2, 1)] * 4
    assert sorted(r["coords"] for r in out) == [
        (d, m, 0) for d in range(2) for m in range(2)]
    assert np.isfinite(out[0]["loss"])
