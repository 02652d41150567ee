"""The port's training engine against the JAX package's on the CPU, f32:
the schedule, the parameter masks, the optimizer against the optax chain
(clipping, masking, ``MultiSteps`` accumulation), the training forward of
the tiny presets, one train step (loss, assignments, gradients, updated
parameters), the dtypes under bf16-stored frozen towers, and the epoch
loop's ``sync_every`` and NaN abort.

Port modules are built on the meta device and filled by
``weights.load_jax_params``; random draws are JAX's, passed in.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from panst3r_torch.data.loader import collate_batch
from panst3r_torch.engine import criterion as t_crit
from panst3r_torch.engine import train as t_train
from panst3r_torch.models.panst3r import PanSt3R as TPanSt3R
from panst3r_torch.models.panst3r import build_model
from panst3r_torch.models import presets as t_presets
from panst3r_tpu.engine import criterion as j_crit
from panst3r_tpu.engine import train as j_train
from panst3r_tpu.models import presets as j_presets
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from tests.test_torch_criterion import jax_draws
from tests.test_torch_models import random_params
from tests.test_torch_v2 import _port
from tests.torch_release import release_memory  # noqa: F401

H, W, V, NCLS, T = 32, 48, 2, 5, 4
GRID = (H // 16, W // 16)
LOSS = dict(num_points=32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(B: int, seed: int = 0):
    """A collated batch from seeded per-view instance maps."""
    rng = np.random.default_rng(seed)
    classes = [f"c{i}" for i in range(NCLS)]
    samples = []
    for _ in range(B):
        views = []
        for _ in range(V):
            inst = np.zeros((H, W), np.int64)
            cls = np.zeros((H, W), np.int64)
            for i in range(1, 4):
                y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
                inst[y:y + 12, x:x + 16] = i
                cls[y:y + 12, x:x + 16] = (i * 2) % 4
            views.append({"img": rng.standard_normal((H, W, 3)) * 0.2,
                          "pan_inst_id": inst, "pan_cls_id": cls,
                          "class_set": ";".join(classes[:4])})
        samples.append(views)
    return collate_batch(samples, classes, T), \
        rng.standard_normal((NCLS, 24)).astype(np.float32)


def _models(preset: str, B: int):
    jm = JPanSt3R(getattr(j_presets, f"{preset}_config")())
    batch, cls = _batch(B)
    params = random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["images"]),
        jnp.asarray(batch["portrait"]), jnp.asarray(cls), GRID)))
    tm = _port(lambda: TPanSt3R(getattr(t_presets, f"{preset}_config")()),
               params)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tm, batch, cls


def _jbatch(batch):
    return {"images": jnp.asarray(batch["images"]),
            "portrait": jnp.asarray(batch["portrait"]),
            "targets": j_crit.Targets(*map(jnp.asarray, batch["targets"]))}


def _flat(tree):
    """flax tree → {key path without the top ``params``: numpy array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = tuple(p.key for p in path)
        out[keys[1:] if keys[0] == "params" else keys] = np.asarray(leaf)
    return out


def test_cosine_lr_and_masks_match_jax():
    cfg = dict(epochs=10, warmup_epochs=2, lr=1e-3, min_lr=1e-5)
    js = j_train.cosine_lr(j_train.TrainConfig(**cfg), 1, 10)
    ts = t_train.cosine_lr(t_train.TrainConfig(**cfg), 1, 10)
    for step in (0, 5, 19, 20, 21, 57, 99, 150):
        # JAX evaluates the schedule in f32, the port in f64
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=3e-6)
    c = t_train.TrainConfig(lr=None, blr=1.5e-4, batch_size=2, accum_iter=2)
    assert c.effective_lr(4) == j_train.TrainConfig(
        lr=None, blr=1.5e-4, batch_size=2, accum_iter=2).effective_lr(4)
    jf = {f.name: f.default for f in dataclasses.fields(j_train.TrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(t_train.TrainConfig)}
    assert set(jf) == set(tf) and jf["loss"] == j_crit.PanopticLossConfig()
    assert {k: v for k, v in jf.items() if k != "loss"} == \
        {k: v for k, v in tf.items() if k != "loss"}

    # the masks on a model's parameters
    tm = build_model(t_presets.tiny_config(), device="cpu")
    tmask = t_train.trainable_mask(tm)
    assert all(v == n.startswith("panoptic_decoder.")
               for n, v in tmask.items())
    decay = t_train._decay_mask(dict(tm.named_parameters()))
    assert all(v == (p.ndim > 1) for (n, p), v in
               zip(tm.named_parameters(), decay.values()))
    t_train.cast_frozen_params(tm)
    assert all((p.dtype == torch.float32) == tmask[n]
               for n, p in tm.named_parameters())


@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_matches_optax_chain(clip):
    """Three updates over six micro-steps (accum_iter 2): warmup and cosine
    learning rates, decay on ndim > 1 only, clipping by the trainable
    leaves' global norm, frozen leaves untouched."""
    rng = np.random.default_rng(3)
    shapes = {("panoptic_decoder", "w"): (4, 3),
              ("panoptic_decoder", "b"): (3,),
              ("panoptic_decoder", "inner", "k"): (2, 2, 3),
              ("must3r_encoder", "w"): (3, 3)}

    def tree(vals):
        out = {}
        for path, v in vals.items():
            d = out
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = v
        return out

    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    cfg = dict(lr=1e-2, epochs=3, warmup_epochs=1, accum_iter=2,
               clip_grad=clip, weight_decay=0.05)
    params = tree({k: jnp.asarray(v) for k, v in init.items()})
    mask = j_train.trainable_mask(params)
    tx, _ = j_train.build_optimizer(j_train.TrainConfig(**cfg), 1, 8,
                                    trainable_mask=mask)
    state = tx.init(params)
    tparams = {".".join(k): torch.nn.Parameter(_t(v)) for k, v in
               init.items() if k[0] == "panoptic_decoder"}
    opt = t_train.Optimizer(tparams, t_train.TrainConfig(**cfg), 1, 8)
    for step in range(6):
        g = {k: rng.standard_normal(s).astype(np.float32) * (step + 1)
             for k, s in shapes.items()}
        updates, state = tx.update(tree({k: jnp.asarray(v)
                                         for k, v in g.items()}),
                                   state, params)
        params = jax.tree_util.tree_map(
            lambda m, p, u: optax.apply_updates(p, u) if m else p,
            mask, params, updates)
        for n, p in tparams.items():
            p.grad = _t(g[tuple(n.split("."))])
        assert opt.step() == (step % 2 == 1)
        flat = _flat(params)
        for n, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       flat[tuple(n.split("."))],
                                       rtol=1e-6, atol=1e-7, err_msg=n)
    np.testing.assert_array_equal(flat[("must3r_encoder", "w")],
                                  init[("must3r_encoder", "w")])


@torch.no_grad()
@pytest.mark.parametrize("preset", ["tiny", "tiny_v2"])
def test_training_forward_matches_jax(preset):
    """``PanSt3R.forward`` against ``PanSt3R.__call__``: pointmaps and every
    deep-supervision level (limits of tests/test_torch_v2.py: LoftUp's
    Fourier phases differ by ~1e-3 in f32)."""
    jm, params, tm, batch, cls = _models(preset, 2)
    args = (batch["images"], batch["portrait"], cls)
    want, want_pm = jax.jit(lambda p, *a: jm.apply(p, *a, GRID))(
        params, *map(jnp.asarray, args))
    got, got_pm = tm(*map(_t, args), GRID)
    np.testing.assert_allclose(got_pm.numpy(), np.asarray(want_pm),
                               atol=2e-4)
    levels = [(got, want)] + list(zip(got["aux_outputs"],
                                      want["aux_outputs"]))
    assert len(levels) == 3
    for g, w in levels:
        np.testing.assert_allclose(g["pred_logits"].numpy(),
                                   np.asarray(w["pred_logits"]), atol=2e-3)
        np.testing.assert_allclose(g["pred_masks"].numpy(),
                                   np.asarray(w["pred_masks"]), atol=1e-2,
                                   rtol=1e-2)


def test_train_step_matches_jax():
    """One step of the tiny preset against ``make_train_step`` with
    ``train_mask``: loss, per-level assignments, every trainable gradient,
    the updated parameters where the JAX gradient exceeds 1e-6 (Adam's
    first step divides g by |g|: smaller gradients say nothing), and the
    frozen parameters bit-identical."""
    jm, params, tm, batch, cls = _models("tiny", 2)
    jcfg = j_train.TrainConfig(lr=1e-3, accum_iter=1, epochs=2,
                               warmup_epochs=0,
                               loss=j_crit.PanopticLossConfig(**LOSS))
    tcfg = t_train.TrainConfig(lr=1e-3, accum_iter=1, epochs=2,
                               warmup_epochs=0,
                               loss=t_crit.PanopticLossConfig(**LOSS))
    key = jax.random.PRNGKey(4)
    jb = _jbatch(batch)
    jcls = jnp.asarray(cls)

    tmask = j_train.trainable_mask(params)
    tx, _ = j_train.build_optimizer(jcfg, 1, 4, trainable_mask=tmask)
    # a first link that keeps the gradients it is handed in its state
    stash = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, _, p=None: (g, g))
    tx = optax.chain(stash, tx)
    jstep = j_train.make_train_step(jm, tx, jcfg.loss, GRID, donate=False,
                                    train_mask=tmask)
    state, jl, jdet = jstep(j_train.TrainState.create(params, tx), jb, jcls,
                            key)
    jgrads = _flat(state.opt_state[0])
    jnew = _flat(state.params)
    panout = jax.jit(lambda p: jm.apply(p, jb["images"], jb["portrait"],
                                        jcls, GRID)[0])(params)
    levels = [(panout["pred_logits"], panout["pred_masks"])] + [
        (a["pred_logits"], a["pred_masks"]) for a in panout["aux_outputs"]]
    match = jax.jit(j_crit.match, static_argnums=4)
    jassign = [np.asarray(match(jax.random.split(k)[0], lg, m, jb["targets"],
                                jcfg.loss))
               for k, (lg, m) in zip(jax.random.split(key, len(levels)),
                                     levels)]

    mask = t_train.trainable_mask(tm)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = chip_smoke._recording(t_train.Optimizer)(
        {n: p for n, p in tm.named_parameters() if mask[n]}, tcfg, 1, 4)
    step = t_train.make_train_step(tm, opt, tcfg.loss, GRID)
    tb = t_train.batch_to(batch, "cpu")
    loss, det = step(tb, _t(cls), draws=jax_draws(
        key, tcfg.loss, len(levels), 2 * T * V))

    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in jdet:
        np.testing.assert_allclose(float(det[k]), float(jdet[k]), rtol=1e-4,
                                   err_msg=k)
    for lvl, want in enumerate(jassign):
        np.testing.assert_array_equal(det["assign"][lvl].numpy(), want)
    now = dict(tm.named_parameters())
    for n, p in now.items():
        if not mask[n]:
            assert torch.equal(p, before[n]), n
    name_of = {tuple(n.split(".")): n for n in before}
    changed = 0
    for path, jg in jgrads.items():
        if path[0] != "panoptic_decoder":
            continue
        n = _torch_name(path, name_of)
        new = now[n].detach()
        g = opt.grads[n].numpy()
        jg = _to_torch_layout(path, jg)
        # + 1e-6: a leaf whose true gradient is 0 (a key projection's bias:
        # the softmax ignores a shift shared by all keys) holds rounding
        np.testing.assert_allclose(g, jg, atol=1e-4 * float(np.abs(jg).max())
                                   + 1e-6, err_msg=n)
        big = np.abs(jg) > 1e-6
        jn = _to_torch_layout(path, jnew[path])
        # 1e-3 of the learning rate: a gradient near 1e-6 carries ~1e-7 of
        # rounding, which moves g / (|g| + 1e-8) by ~1e-3
        np.testing.assert_allclose(new.numpy()[big], jn[big], rtol=1e-5,
                                   atol=1e-3 * tcfg.lr, err_msg=n)
        changed += int(big.any())
    assert changed > 10


def _torch_name(path, name_of):
    """The port's parameter name of a flax leaf path (Dense ``kernel`` →
    ``weight``, norm ``scale`` → ``weight``)."""
    leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
    return name_of[tuple(path[:-1]) + (leaf,)]


def _to_torch_layout(path, a):
    """A flax leaf in the port's layout (Dense kernels transposed, conv
    kernels HWIO → OIHW)."""
    if path[-1] == "kernel":
        return a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
    return a


@pytest.mark.parametrize("preset", ["tiny", "tiny_v2"])
def test_frozen_bf16_towers_compute_like_flax(preset):
    """With the frozen towers stored in bf16 (``cast_frozen_params``) and
    f32 images, flax computes every stage in f32; the port's stage outputs
    carry the dtypes of the flax modules' outputs."""
    jm, params, tm, batch, cls = _models(preset, 1)
    jp = j_train.cast_frozen_params(params)
    args = (jnp.asarray(batch["images"]), jnp.asarray(batch["portrait"]),
            jnp.asarray(cls))
    _, state = jax.eval_shape(lambda: jm.apply(
        jp, *args, GRID, capture_intermediates=True,
        mutable=["intermediates"]))
    inter = state["intermediates"]
    names = ("dino_encoder", "must3r_encoder", "must3r_decoder",
             "panoptic_decoder")
    want = {n: sorted({str(a.dtype) for a in jax.tree_util.tree_leaves(
        inter[n]["__call__"]) if jnp.issubdtype(a.dtype, jnp.floating)})
        for n in names}
    t_train.cast_frozen_params(tm)
    got = {}

    def record(name):
        def hook(_, __, out):
            leaves = [t for t in jax.tree_util.tree_leaves(
                out, is_leaf=lambda x: isinstance(x, torch.Tensor))
                if isinstance(t, torch.Tensor) and t.is_floating_point()]
            got.setdefault(name, set()).update(
                str(t.dtype).split(".")[-1] for t in leaves)
        return hook

    for n in names:
        getattr(tm, n).register_forward_hook(record(n))
    with torch.no_grad():
        tm(*map(_t, (batch["images"], batch["portrait"], cls)), GRID)
    assert all(w == ["float32"] for w in want.values())
    for n in names:
        assert sorted(got[n]) == want[n], n


def test_train_one_epoch_sync_every_and_nan_abort():
    """Fetching the loss every 3 steps gives the same losses and
    parameters as every step; a NaN loss still raises."""
    _, params, _, batch, cls = _models("tiny", 1)
    tcfg = t_train.TrainConfig(lr=1e-3, accum_iter=1, epochs=2,
                               warmup_epochs=0,
                               loss=t_crit.PanopticLossConfig(**LOSS))

    def run(sync_every, nan=False):
        tm = _port(lambda: TPanSt3R(t_presets.tiny_config()), params)
        mask = t_train.trainable_mask(tm)
        opt = t_train.Optimizer({n: p for n, p in tm.named_parameters()
                                 if mask[n]}, tcfg, 1, 4)
        step = t_train.make_train_step(tm, opt, tcfg.loss, GRID)

        def nan_step(*a):
            loss, det = step(*a)
            return loss * float("nan"), det

        state, stats = t_train.train_one_epoch(
            opt, nan_step if nan else step, [batch] * 4, _t(cls), epoch=0,
            seed=0, device="cpu", sync_every=sync_every)
        assert state is opt and opt.micro_steps == 4
        return stats, [p.detach().clone() for p in tm.parameters()]

    s1, p1 = run(1)
    s3, p3 = run(3)
    assert s1 == s3 and np.isfinite(s1["loss"])
    assert all(torch.equal(a, b) for a, b in zip(p1, p3))
    with pytest.raises(FloatingPointError):
        run(4, nan=True)


def test_freeze_flags_select_the_trained_stages():
    """With the encoder and the decoder unfrozen, the backward reaches them
    (the memory banks take tokens that carry a gradient out of place);
    DINO, frozen in every config, gets none."""
    import dataclasses as dc

    _, params, _, batch, cls = _models("tiny", 1)
    cfg = dc.replace(t_presets.tiny_config(), freeze_encoder=False,
                     freeze_decoder=False)
    tm = _port(lambda: TPanSt3R(cfg), params)
    out, _ = tm(*map(_t, (batch["images"], batch["portrait"], cls)), GRID)
    (out["pred_logits"].sum() + out["pred_masks"].sum()).backward()
    grads = dict.fromkeys((n.split(".")[0] for n, _ in
                           tm.named_parameters()), 0.0)
    for n, p in tm.named_parameters():
        top = n.split(".")[0]
        grads[top] = max(grads[top], 0.0 if p.grad is None
                         else float(p.grad.abs().max()))
    assert grads["must3r_encoder"] > 0 and grads["must3r_decoder"] > 0
    assert grads["panoptic_decoder"] > 0 and grads["dino_encoder"] == 0


def test_amp_step_runs_in_bf16_and_restores_precision():
    """amp='bf16': the bf16-stored towers compute in bf16, the f32 head
    promotes back, the loss is finite, the f32 matmul precision is
    restored after the step, and the stage times come in order."""
    _, params, tm, batch, cls = _models("tiny_v2", 1)
    t_train.cast_frozen_params(tm)
    tcfg = t_train.TrainConfig(accum_iter=1, warmup_epochs=0,
                               loss=t_crit.PanopticLossConfig(**LOSS))
    mask = t_train.trainable_mask(tm)
    opt = t_train.Optimizer({n: p for n, p in tm.named_parameters()
                             if mask[n]}, tcfg, 1, 4)
    step = t_train.make_train_step(tm, opt, tcfg.loss, GRID, amp="bf16")
    seen = {}

    def record(name):
        def hook(_, __, out):
            seen[name] = (out[0] if isinstance(out, tuple)
                          else out["pred_logits"]).dtype
        return hook

    for name in ("must3r_encoder", "panoptic_decoder"):
        getattr(tm, name).register_forward_hook(record(name))
    before = torch.get_float32_matmul_precision()
    stages = {}
    loss, _ = step(t_train.batch_to(batch, "cpu"), _t(cls),
                   stage_times=stages)
    assert torch.isfinite(loss)
    assert list(stages) == ["frozen_forward", "head_forward", "criterion",
                            "backward", "optimizer"]
    assert seen == {"must3r_encoder": torch.bfloat16,
                    "panoptic_decoder": torch.float32}
    assert torch.get_float32_matmul_precision() == before
