"""Tensor and data parallelism of the port on two gloo ranks (CPU).

Against panst3r_tpu: the tiny preset's forward under ``model`` = 2 against
JAX's single-device ``PanSt3R.apply`` on the same weights (rtol = atol =
2e-4, as tests/test_tp.py).  Against the port's own single-rank path
(held to JAX by the other tests): ``serve_device`` under ``model`` = 2
(raw head outputs within 2e-4; the decoded pan agreeing on more than 99%
of pixels and conf within 0.05, as tests/test_serve_sharded.py),
``serve_many_device`` over ``data`` = 2 (the wires byte-equal), the
memory split over ``mem`` = 2 (each rank holding half of the bank; the
render bit-equal), one data-parallel micro-step of the
tiny v2 preset (LoftUp's min-max over the global batch) against one
process on the concatenated batch (loss within 1e-6 relative, weights
within 1e-6), the same step of the tiny preset under ``model`` = 2 and
with random point sampling, and the train app over two ranks: one epoch with a single
checkpoint writer, then a resumed one.  One spawn of two ranks runs all of
it (``core/dryrun.py::jobs_worker``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from panst3r_torch.apps import train as tapp
from panst3r_torch.core import distributed, dryrun
from panst3r_torch.core.bucketing import Bucket as TBucket
from panst3r_torch.engine.criterion import PanopticLossConfig
from panst3r_torch.engine.inference import InferenceEngine as TEngine
from panst3r_torch.engine.train import TrainConfig
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.presets import tiny_config as t_tiny
from panst3r_torch.models.presets import tiny_v2_config as t_tiny_v2
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.models.presets import tiny_config as j_tiny
from tests.test_data import _make_scannetpp
from tests.test_torch_models import random_params
from tests.torch_release import release_memory  # noqa: F401

H, W, GRID, NCLS = 32, 48, (2, 3), 5
SERVE = dict(V=5, K=3, chunk=2, ncls=6)
RANDOM_SAMPLING = dict(matcher_sampling="random", loss_sampling="random",
                       oversample_ratio=3.0, importance_sample_ratio=0.75)


def _jax_params():
    model = JPanSt3R(j_tiny())
    return model, random_params(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)),
        jnp.zeros((1, 2), bool), jnp.zeros((NCLS, 24)), GRID)))


def _forward_inputs():
    rng = np.random.default_rng(0)
    return ((rng.standard_normal((2, 2, H, W, 3)) * 0.2).astype(np.float32),
            np.zeros((2, 2), bool),
            rng.standard_normal((NCLS, 24)).astype(np.float32))


def _scene():
    rng = np.random.default_rng(5)
    V = SERVE["V"]
    images = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    portrait = np.zeros(V, bool)
    portrait[1] = True
    return {"images": images, "portrait": portrait,
            "cls_emb": rng.standard_normal((SERVE["ncls"], 24))
            .astype(np.float32),
            "scenes": np.stack([images, images[::-1].copy()]),
            "portraits": np.stack([portrait, portrait[::-1].copy()])}


def _experiment(data_root, out_dir, epochs):
    return tapp.ExperimentConfig(
        model_preset="tiny", data_root=str(data_root),
        resolution=((48, 32),), num_views=2, aug_crop=4,
        train=TrainConfig(epochs=epochs, warmup_epochs=0, lr=1e-3,
                          batch_size=1, accum_iter=1, max_instances=8,
                          loss=PanopticLossConfig(num_points=32)),
        output_dir=str(out_dir), keep_freq=0, print_freq=1, logger="jsonl",
        text_encoder="random", loader_workers=0, loader_prefetch=0,
        mesh_data=2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jmodel, params = _jax_params()
    state = {k: v.numpy() for k, v in load_jax_params(
        TPanSt3R(t_tiny()), params).state_dict().items()}
    factory = dryrun.ModelFactory(t_tiny(), state)
    tmp = tmp_path_factory.mktemp("tp_dp")
    _make_scannetpp(str(tmp / "data"), n_views=6, hw=(32, 48))
    exp = _experiment(tmp / "data", tmp / "out", 2)
    jobs = [
        (dryrun.tp_forward_worker, (factory, *_forward_inputs(), GRID), {}),
        (dryrun.serve_worker, (factory, _scene(), TBucket(H, W),
                               SERVE["K"], SERVE["chunk"], False,
                               {"fusion_res": "hybrid"},
                               ("tp", "dp", "mem")), {}),
        (dryrun.dp_step_worker, (dryrun.ModelFactory(t_tiny_v2(), seed=0),
                                 dryrun.tiny_batch(2), GRID, 1e-3), {}),
        (dryrun.train_app_worker, (exp, 1), {}),
        (dryrun.dp_step_worker, (dryrun.ModelFactory(t_tiny(), seed=0),
                                 dryrun.tiny_batch(2), GRID, 1e-3),
         {"model_size": 2}),
        (dryrun.dp_step_worker, (dryrun.ModelFactory(t_tiny(), seed=0),
                                 dryrun.tiny_batch(2), GRID, 1e-3),
         {"loss_kw": RANDOM_SAMPLING}),
    ]
    ranks = distributed.launch(dryrun.jobs_worker, 2, "gloo", "cpu", jobs,
                               threads=1)
    return jmodel, params, factory, ranks


def test_tp_forward_matches_jax(setup):
    jmodel, params, _, ranks = setup
    images, portrait, cls_emb = _forward_inputs()
    ref, _ = jax.jit(jmodel.apply, static_argnums=(4,))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(images),
        jnp.asarray(portrait), jnp.asarray(cls_emb), GRID)
    for r in range(2):
        for k in ("pred_masks", "pred_logits"):
            np.testing.assert_allclose(ranks[r][0][k], np.asarray(ref[k]),
                                       rtol=2e-4, atol=2e-4, err_msg=k)


def test_tp_serve_matches_one_rank(setup):
    *_, factory, ranks = setup
    eng = TEngine(factory("cpu"), TBucket(H, W), num_keyframes=SERVE["K"],
                  chunk=SERVE["chunk"], amp=False, device="cpu")
    V = SERVE["V"]
    for r in range(2):
        tp = ranks[r][1]["tp"]
        for k, want in tp["raw_one"].items():
            np.testing.assert_allclose(tp["raw"][k], want, rtol=2e-4,
                                       atol=2e-4, err_msg=k)
        got, want = (eng.unpack_wire(w, V) for w in (tp["wire"],
                                                      tp["wire_one"]))
        assert (got["pan"] == want["pan"]).mean() > 0.99
        np.testing.assert_allclose(got["conf"], want["conf"], atol=0.05)
        assert tp["pan_agree"] == (got["pan"] == want["pan"]).mean()
        # the plain versions run on the CPU: no kernel launches
        assert not any(tp["launches"].values())


def test_dp_serve_many_and_mem_render_bit_equal(setup):
    ranks = setup[-1]
    for r in range(2):
        dp, mem = ranks[r][1]["dp"], ranks[r][1]["mem"]
        assert dp["wires"].shape[0] == 2
        np.testing.assert_array_equal(dp["wires"], dp["wires_one"])
        np.testing.assert_array_equal(mem["wire"], mem["wire_one"])
        assert dp["wires_equal"] and mem["wire_equal"] and mem["run_equal"]
        # each mem rank holds half of the bank, which gathers whole
        assert mem["bank_equal"]
        assert 2 * mem["bank_bytes"] == mem["bank_bytes_one_rank"]


def test_dp_train_step_matches_one_process(setup):
    """The same loss on both ranks; within 1e-6 relative of one process's
    on the whole batch; the summed gradients within 1e-5 of the largest;
    the updated weights within 1e-6 wherever the gradient stands above
    f32 noise (``core/dryrun.py::step_agreement``: where the true
    gradient is 0, Adam's first step moves a weight by ±lr whatever the
    noise, and ``grad_diff`` holds those gradients)."""
    _check_step(setup[-1], 2)


def test_dp_train_step_random_sampling_matches_one_process(setup):
    """The tiny preset's step with the random matcher points and PointRend
    mask points: each rank's draws are its rows of the global batch's."""
    _check_step(setup[-1], 5)


def test_tp_train_step_matches_one_process(setup):
    """The tiny preset's step under ``model`` = 2 (gradients through the
    Megatron collectives), the weights gathered whole, held as above."""
    _check_step(setup[-1], 4)


def _check_step(ranks, job):
    for r in range(2):
        got = ranks[r][job]
        assert got["loss"] == ranks[0][job]["loss"]
        np.testing.assert_allclose(got["loss"], got["loss_one"], rtol=1e-6)
        assert got["grad_diff"] <= 1e-5, got
        assert got["weight_diff"] <= 1e-6, got


def test_train_app_two_ranks_resumes(setup):
    ranks = setup[-1]
    app = [ranks[r][3] for r in range(2)]
    for a in app:
        assert a["start_epoch"] == [0, 1]
        assert np.isfinite(a["loss"]).all()
    assert app[0]["loss"] == app[1]["loss"]
    assert app[0]["saved"] == [["last", "final"], ["last", "final"]]
    assert app[1]["saved"] == [[], []]
