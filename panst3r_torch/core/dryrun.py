"""Multi-rank rehearsals of the port (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` spawns ``n`` ranks (gloo on the CPU, NCCL on the
cards) and runs one tiny-preset train step over the (data, mem, model)
mesh the JAX ladder picks for ``n`` devices: the memory bank's render
sharded over ``mem``, tensor parallelism over ``model``, the batch over
``data``.  It asserts a finite loss, equal on every rank.  With
``flagship=True`` the same spawn runs the ladder's two flagship rungs
(``__graft_entry__.py``'s ``_dryrun_flagship_step`` and
``_dryrun_sharded_serve``) on the same mesh: ``flagship_step_worker``, one
v1 train step at 256x512 (B=2, V=3), and ``flagship_serve_worker``, the
mem-sharded and tensor-parallel ``serve_device`` wire against the one-rank
wire and ``fusion_sharded`` against the unsharded fusion at the flagship's
mask dims.  Each takes the config as an argument (``panst3r_v1_config``
on the card, ``tiny_config`` in the CPU tests).

The other functions here are rank workers (``core/distributed.py::launch``
re-imports this module in each spawned rank): the parity checks that the
tests and ``chip_smoke.py`` run, each comparing a sharded path with the
same work on one rank of the same process.  Every worker returns host
values (numpy, floats, dicts).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from panst3r_torch.core import distributed
from panst3r_torch.core.mesh import (DATA_AXIS, MEM_AXIS, MODEL_AXIS,
                                     MeshSpec, all_gather_cat, build_mesh,
                                     local_slice)

TINY_HW, TINY_GRID = (32, 48), (2, 3)
NCLS, T = 5, 4
# the flagship rungs (__graft_entry__.py:183-320): the train step's bucket,
# batch, classes and sampled points; the serve rung's bucket, views,
# keyframes, render chunk, classes and fusion queries; JAX's limits on the
# sharded wire against the one-rank wire (pan agreement, conf atol)
FLAGSHIP_STEP = dict(hw=(256, 512), B=2, V=3, ncls=32, num_points=512,
                     lr=1e-3)
FLAGSHIP_SERVE = dict(hw=(128, 256), V=6, K=4, chunk=2, ncls=16, queries=200)
# queries of the serve rung that pass fusion's class threshold
# (``segment_classes``): with the scene's random class table random weights
# leave every pixel void, and the wires would compare nothing
FLAGSHIP_LIVE = 4
SERVE_PAN_AGREE, SERVE_CONF_ATOL = 0.99, 0.05


def mesh_axes(n: int) -> tuple[int, int, int]:
    """The JAX ladder's (data, mem, model) for ``n`` devices: all three
    axes at a multiple of 8, data × mem at a multiple of 4, else data."""
    mem, model = (2, 2) if n % 8 == 0 else (2, 1) if n % 4 == 0 else (1, 1)
    return n // (mem * model), mem, model


def tiny_batch(B: int, V: int = 3, seed: int = 0, hw=TINY_HW,
               ncls: int = NCLS, lang_dim: int = 24,
               valid=(True, True, False, False)) -> dict:
    """A seeded numpy batch of the JAX dryrun's layout (B, V) at ``hw``
    with its class table (ncls, lang_dim); ``valid``: which of the T
    targets count (the flagship step's are ``[T, T, T, F]``)."""
    from panst3r_torch.engine.criterion import Targets

    rng = np.random.default_rng(seed)
    H, W = hw
    return {
        "images": (rng.standard_normal((B, V, H, W, 3)) * 0.2)
        .astype(np.float32),
        "portrait": np.zeros((B, V), bool),
        "targets": Targets(
            labels=rng.integers(0, ncls, (B, T)).astype(np.int32),
            masks=(rng.random((B, T, V, H, W)) < 0.3).astype(np.float32),
            valid=np.tile(list(valid), (B, 1)),
            output_mask=np.ones((B, ncls), bool)),
        "cls_emb": rng.standard_normal((ncls, lang_dim)).astype(np.float32),
    }


def batch_rows(batch: dict, rows: slice, device) -> dict:
    """``batch``'s rows as tensors on ``device`` (the class table whole)."""
    from panst3r_torch.engine.criterion import Targets

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a[rows]), device=device)

    return {"images": t(batch["images"]), "portrait": t(batch["portrait"]),
            "targets": Targets(*(t(a) for a in batch["targets"])),
            "cls_emb": torch.as_tensor(batch["cls_emb"], device=device)}


def train_micro_step(model, batch: dict, grid, device, data_group=None,
                     lr: float = 1e-3, num_points: int = 32, seed: int = 0,
                     trainable=("panoptic_decoder",), loss_kw=None):
    """One micro-step of ``model`` on ``batch`` (this rank's rows, tensors
    on ``device``; ``loss_kw``: more ``PanopticLossConfig`` fields):
    returns (loss, {name: gradient the optimizer got}, {name: updated
    trainable parameter})."""
    from panst3r_torch.engine.criterion import PanopticLossConfig
    from panst3r_torch.engine.train import (Optimizer, TrainConfig,
                                            make_train_step, trainable_mask)
    from panst3r_torch.core import rng

    class Recording(Optimizer):
        def step(self):
            self.grads = {n: p.grad.detach().clone()
                          for n, p in self.params.items()}
            return super().step()

    tcfg = TrainConfig(lr=lr, accum_iter=1, warmup_epochs=0, epochs=2,
                       loss=PanopticLossConfig(num_points=num_points,
                                               **(loss_kw or {})))
    mask = trainable_mask(model, trainable)
    opt = Recording({n: p for n, p in model.named_parameters() if mask[n]},
                    tcfg, 1, 4, tp_group=getattr(model, "tp_group", None),
                    tp_split=getattr(model, "tp_split", ()))
    step = make_train_step(model, opt, tcfg.loss, grid,
                           data_group=data_group)
    gen = rng.generator(seed, 0, 0, device=device)
    loss, details = step(batch, batch["cls_emb"], gen)
    return (float(loss), opt.grads,
            {n: p.detach() for n, p in opt.params.items()})


def _tiny_step(device, n: int):
    """Rank worker of ``dryrun_multichip``."""
    from panst3r_torch.core.tp import apply_tp
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.models.presets import tiny_config

    data, mem, model_size = mesh_axes(n)
    mesh = build_mesh(MeshSpec(data=data, mem=mem, model=model_size))
    B = data * 2
    batch = tiny_batch(B)
    d = mesh.index(DATA_AXIS)
    rows = slice(d * (B // data), (d + 1) * (B // data))
    model = build_model(tiny_config(), device=device, seed=0).train()
    apply_tp(model, mesh.group(MODEL_AXIS))
    model.mem_group = mesh.group(MEM_AXIS)
    loss, _, _ = train_micro_step(model, batch_rows(batch, rows, device),
                                  TINY_GRID, device,
                                  data_group=mesh.group(DATA_AXIS))
    return {"loss": loss, "mesh": mesh.shape, "coords": mesh.coords}


def dryrun_multichip(n: int, device="cpu", timeout: float = 120.0,
                     flagship: bool = False, config=None,
                     backend: str | None = None) -> list:
    """The tiny train step on ``n`` spawned ranks over ``mesh_axes(n)``;
    returns each rank's {"loss", "mesh", "coords"} and raises unless the
    loss is finite and the same on every rank.  With ``flagship`` the same
    spawn then runs ``flagship_step_worker`` and ``flagship_serve_worker``
    on ``config`` (default ``panst3r_v1_config()``), and each rank's result
    gains them under "flagship_step" and "sharded_serve"; it raises unless
    the flagship loss is finite and equal on every rank, the sharded wire
    keeps JAX's limits against the one-rank wire and ``fusion_sharded`` is
    bit-equal.  ``backend``: default ``distributed.default_backend``."""
    if config is None and flagship:
        from panst3r_torch.models.presets import panst3r_v1_config

        config = panst3r_v1_config()
    jobs = [(_tiny_step, (n,), {})]
    if flagship:
        jobs += [(flagship_step_worker, (config,), {}),
                 (flagship_serve_worker, (config,), {})]
    ranks = distributed.launch(
        jobs_worker, n, backend or distributed.default_backend(device),
        device, jobs, timeout=timeout, threads=1)
    out = [r[0] for r in ranks]
    losses = [r["loss"] for r in out]
    if not np.isfinite(losses).all() or len(set(losses)) != 1:
        raise AssertionError(f"dryrun_multichip({n}): losses {losses}")
    mesh = dict(zip(("data", "mem", "model"), out[0]["mesh"]))
    print(f"dryrun_multichip({n}): mesh={mesh} loss={losses[0]:.4f} ok",
          flush=True)
    if not flagship:
        return out
    for r, (_, step, serve) in zip(out, ranks):
        r["flagship_step"], r["sharded_serve"] = step, serve
    losses = [r["flagship_step"]["loss"] for r in out]
    if not np.isfinite(losses).all() or len(set(losses)) != 1:
        raise AssertionError(f"dryrun_flagship_step({n}): losses {losses}")
    bad = [(i, r["sharded_serve"]["pan_agree"],
            r["sharded_serve"]["conf_max_abs_diff"],
            r["sharded_serve"]["fusion_bit_equal"])
           for i, r in enumerate(out) if not r["sharded_serve"]["ok"]]
    if bad:
        raise AssertionError(f"dryrun_sharded_serve({n}): rank, pan "
                             f"agreement, conf diff, fusion exact: {bad}")
    s0 = out[0]["sharded_serve"]
    print(f"dryrun_flagship_step({n}): mesh={mesh} loss={losses[0]:.4f} ok "
          f"({out[0]['flagship_step']['job_seconds']:.0f}s)", flush=True)
    print(f"dryrun_sharded_serve({n}): mem-sharded KV + TP wire parity (pan "
          f"agree {s0['pan_agree']:.4f}) + fusion_sharded exact ok "
          f"({s0['job_seconds']:.0f}s)", flush=True)
    return out


def _flagship_mesh():
    world = distributed.process_count()
    data, mem, model = mesh_axes(world)
    return build_mesh(MeshSpec(data=data, mem=mem, model=model))


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def flagship_step_worker(device, config) -> dict:
    """Rank worker: one train micro-step of ``config`` (weights of seed 0)
    over the ``mesh_axes(world)`` mesh, the JAX ladder's
    ``_dryrun_flagship_step`` (``FLAGSHIP_STEP``): the batch's rows over
    ``data``, the memory bank over ``mem``, tensor parallelism over
    ``model``, the trainable mask ``engine/train.py`` gives (the panoptic
    head), Adam at ``lr``.  Returns the loss, the mesh, this rank's
    launches of the step (counted from 0 just before it), its seconds and
    its peak device bytes."""
    from panst3r_torch.core.tp import apply_tp
    from panst3r_torch.models.panst3r import build_model

    f = FLAGSHIP_STEP
    strict_f32(device)
    mesh = _flagship_mesh()
    data = mesh.shape[0]
    (H, W), B = f["hw"], f["B"]
    batch = tiny_batch(B, f["V"], 0, (H, W), f["ncls"],
                       config.panoptic.mask_transformer.lang_dim,
                       valid=(True, True, True, False))
    d = mesh.index(DATA_AXIS)
    rows = slice(d * (B // data), (d + 1) * (B // data))
    _peak_reset(device)
    model = build_model(config, device=device, seed=0).train()
    apply_tp(model, mesh.group(MODEL_AXIS))
    model.mem_group = mesh.group(MEM_AXIS)
    _reset_launches()
    (loss, _, _), secs = _timed(
        train_micro_step, model, batch_rows(batch, rows, device),
        (H // 16, W // 16), device, data_group=mesh.group(DATA_AXIS),
        lr=f["lr"], num_points=f["num_points"])
    launches = _launches()
    del model
    peak = _peak_reset(device)
    _free(device)
    return {"loss": loss, "mesh": mesh.shape, "coords": mesh.coords,
            "launches": launches, "seconds": secs, "peak_bytes": peak}


def flagship_scene(lang_dim: int):
    """The serve rung's seeded scene (``FLAGSHIP_SERVE``): uint8 views (V,
    H, W, 3), portrait flags and a class table (ncls, lang_dim), as the JAX
    rung draws them."""
    rng = np.random.default_rng(0)
    (H, W), V, ncls = (FLAGSHIP_SERVE[k] for k in ("hw", "V", "ncls"))
    return (rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8),
            np.zeros(V, bool),
            rng.standard_normal((ncls, lang_dim)).astype(np.float32))


def segment_classes(eng, images, portrait, ncls: int = 32,
                    alive: int = 4) -> np.ndarray:
    """(ncls, lang_dim) class embeddings under which only queries
    0..alive-1 pass the class threshold of fusion on this scene.  With
    random weights every query passes it with random class embeddings,
    the queries split the pixels, none passes the overlap test and every
    map is void; a few live queries give real segments, so the wire
    comparisons compare something.  The embeddings enter only the class
    logits, which are linear in them: one probe with the identity gives
    the logits' matrix, least squares the embeddings for logits of +4
    (query i, class i) and -8 elsewhere."""
    lang = eng.model.config.panoptic.mask_transformer.lang_dim
    probe = eng.run_fused(images, portrait, np.eye(lang, dtype=np.float32))
    probe = probe["pred_logits"].double().cpu().numpy()       # (Q, lang)
    target = np.tile(-8.0 - 0.5 * np.arange(ncls), (probe.shape[0], 1))
    for i in range(alive):
        target[i, i] = 4.0
    return np.linalg.lstsq(probe, target, rcond=None)[0].T.astype(np.float32)


def flagship_serve_worker(device, config) -> dict:
    """Rank worker: the JAX ladder's ``_dryrun_sharded_serve``
    (``FLAGSHIP_SERVE``).  ``config``'s model (weights of seed 0, f32)
    serves ``flagship_scene`` on this rank alone, its class table replaced
    by ``segment_classes`` with ``FLAGSHIP_LIVE`` live queries, then,
    tensor parallel over ``model`` (``apply_tp`` in place) with the memory
    bank over ``mem``, again; the decoded wires agree on more than
    ``SERVE_PAN_AGREE`` of the pixels with conf within ``SERVE_CONF_ATOL``
    (JAX's limits).  Then ``fusion_sharded`` over ``mem`` against
    ``_fusion_full`` on this rank at ``queries`` x (H/2, W/2), bit for
    bit.  Returns the sharded wire, the agreements, the launches of the
    sharded call and of the one-rank call, the seconds and the peak device
    bytes."""
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.core.tp import apply_tp
    from panst3r_torch.engine.inference import fetch_wire
    from panst3r_torch.models.panst3r import build_model

    f = FLAGSHIP_SERVE
    strict_f32(device)
    mesh = _flagship_mesh()
    (H, W), V = f["hw"], f["V"]
    images, portrait, _ = flagship_scene(
        config.panoptic.mask_transformer.lang_dim)
    _peak_reset(device)
    model = build_model(config, device=device, seed=0)
    bucket = Bucket(H, W)
    eng = _engine(model, bucket, device, False, f["K"], f["chunk"])
    cls = segment_classes(eng, images, portrait, f["ncls"], FLAGSHIP_LIVE)
    _reset_launches()
    ref, t_one = _timed(eng.serve_device, images, portrait, cls)
    launches_one = _launches()
    ref = fetch_wire(ref)
    eng = _engine(apply_tp(model, mesh.group(MODEL_AXIS)), bucket, device,
                  False, f["K"], f["chunk"])
    _reset_launches()
    wire, t_sharded = _timed(eng.serve_device, images, portrait, cls,
                             mem_group=mesh.group(MEM_AXIS))
    launches = _launches()
    wire = fetch_wire(wire)
    got, want = eng.unpack_wire(wire, V), eng.unpack_wire(ref, V)
    agree = float((got["pan"] == want["pan"]).mean())
    dconf = float(np.abs(got["conf"] - want["conf"]).max())
    del eng, model
    mask_cls, mask_pred = fusion_inputs(0, 1, V, f["queries"], H // 2,
                                        W // 2, ncls=f["ncls"] + 1, live=8)
    fusion = _fusion_check(device, mask_cls, mask_pred, (H, W),
                           mesh.group(MEM_AXIS), {})
    peak = _peak_reset(device)
    _free(device)
    return {"wire": wire, "wire_one": ref, "cls_emb": cls,
            "launches": launches, "launches_one_rank": launches_one,
            "pan_agree": agree, "conf_max_abs_diff": dconf,
            "n_segments": int(want["selected"].sum()),
            "fusion_bit_equal": fusion["bit_equal"],
            "fusion_segments": int(fusion["selected"].sum()),
            "ok": bool(agree > SERVE_PAN_AGREE and dconf <= SERVE_CONF_ATOL
                       and fusion["bit_equal"]),
            "seconds": t_sharded, "seconds_one_rank": t_one,
            "fusion_seconds": fusion["seconds"], "peak_bytes": peak}


# ------------------------------------------------------ parity workers ----

def _timed(fn, *args, **kw):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def jobs_worker(device, jobs: list) -> list:
    """Several workers in one spawn: ``jobs`` is a list of (worker, args,
    kwargs), run in order on every rank; returns their results.  A job
    that raises ends the spawn (``distributed.launch`` raises)."""
    out = []
    for fn, args, kw in jobs:
        t0 = time.perf_counter()
        res = fn(device, *args, **kw)
        if isinstance(res, dict):       # the job's wall seconds, set-up in
            res["job_seconds"] = time.perf_counter() - t0
        out.append(res)
    return out


def attention_worker(device, cases: list) -> list:
    """``sharded_memory_attention`` and ``ring_memory_attention`` over the
    whole world's ``mem`` axis and over ``mem`` = 2 slices of it: each case
    (q, k, v, valid-or-None) is split along the keys; returns per case
    {"mem": size: {"sharded", "ring"}} outputs."""
    from panst3r_torch.ops.sharded_attention import (ring_memory_attention,
                                                     sharded_memory_attention)

    world = distributed.process_count()
    meshes = {world: build_mesh(MeshSpec(data=1, mem=world))}
    if world > 2:
        meshes[2] = build_mesh(MeshSpec(data=world // 2, mem=2))
    out = []
    for q, k, v, valid in cases:
        res = {}
        for size, mesh in meshes.items():
            g = mesh.group(MEM_AXIS)
            args = [torch.as_tensor(q, device=device)] + [
                local_slice(torch.as_tensor(a, device=device), 2, g)
                for a in (k, v)]
            if valid is not None:
                args.append(local_slice(torch.as_tensor(valid, device=device),
                                        1, g))
            res[size] = {"sharded": sharded_memory_attention(g, *args),
                         "ring": ring_memory_attention(g, *args)}
        out.append(res)
    return out


def fusion_inputs(seed: int, B: int, V: int, Q: int, h: int, w: int,
                  ncls: int = 5, live: int = 4):
    """(mask_cls (B, Q, ncls), mask_pred (B, V, Q, h, w)) logits under
    which fusion selects segments: each view's pixels are split among
    ``live`` queries (the nearest of one random centre per query and
    view) at logit +6 ± noise, every other logit -6 ± noise.  (Random
    logits leave every query below the overlap test: all pixels void.)"""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cy = rng.uniform(0, h, (B, V, live, 1, 1))
    cx = rng.uniform(0, w, (B, V, live, 1, 1))
    owner = ((yy - cy) ** 2 + (xx - cx) ** 2).argmin(2)     # (B, V, h, w)
    pred = np.full((B, V, Q, h, w), -6.0) + rng.standard_normal(
        (B, V, Q, h, w))
    for q in range(live):
        pred[:, :, q] = np.where(owner == q, 6.0, -6.0) \
            + rng.standard_normal((B, V, h, w))
    cls = rng.standard_normal((B, Q, ncls)) * 2
    cls[:, :live, 0] = 4.0                 # the live queries pass the class
    return cls.astype(np.float32), pred.astype(np.float32)


def fusion_worker(device, mask_cls, mask_pred, true_shape, kw: dict):
    """``fusion_sharded`` over a ``mem`` = 2 axis (the world split into
    data × 2) against ``_fusion_full`` on this rank: the gathered maps and
    the selection, and whether they are bit-equal."""
    world = distributed.process_count()
    g = build_mesh(MeshSpec(data=world // 2, mem=2)).group(MEM_AXIS)
    return _fusion_check(device, mask_cls, mask_pred, true_shape, g, kw)


def _fusion_check(device, mask_cls, mask_pred, true_shape, g, kw: dict):
    """``fusion_sharded`` over the group ``g`` against ``_fusion_full`` on
    this rank (``fusion_worker``'s result)."""
    from panst3r_torch.engine.fusion import _fusion_full, fusion_sharded

    cls = torch.as_tensor(mask_cls, device=device)
    pred = torch.as_tensor(mask_pred, device=device)
    args = (kw.get("label_mode", "sigmoid"), 0.1, None,
            kw.get("mask_threshold", 0.25), kw.get("overlap_threshold", 0.5),
            kw.get("niters", 2), 0.1)
    with torch.inference_mode():
        (pan, conf, ids, labels, sel), t_shard = _timed(
            fusion_sharded, cls, pred, true_shape, g, *args)
        pan, conf = (all_gather_cat(x, 1, g) for x in (pan, conf))
        ref, t_full = _timed(_fusion_full, cls, pred, true_shape, *args)
    got = (pan, conf, ids, labels, sel)
    return {"pan": pan, "conf": conf, "seg_ids": ids, "labels": labels,
            "selected": sel,
            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, ref)),
            "seconds": t_shard, "seconds_one_rank": t_full}


def ba_worker(device, poses, anchors, obs_view, obs_anchor, x_local, weights,
              iters: int = 8):
    """``bundle_adjust_sharded`` over a ``mem`` = 2 axis against
    ``bundle_adjust`` on this rank."""
    from panst3r_torch.engine.ba import bundle_adjust, bundle_adjust_sharded

    world = distributed.process_count()
    g = build_mesh(MeshSpec(data=world // 2, mem=2)).group(MEM_AXIS)
    args = (poses, anchors, obs_view, obs_anchor, x_local, weights)
    (p, a, c), t_shard = _timed(bundle_adjust_sharded, *args, g, iters=iters,
                                device=device)
    (p1, a1, c1), t_one = _timed(bundle_adjust, *args, iters=iters,
                                 device=device)
    return {"poses": p, "anchors": a, "costs": c, "poses_one": p1,
            "anchors_one": a1, "costs_one": c1, "seconds": t_shard,
            "seconds_one_rank": t_one}


def _engine(model, bucket, device, amp, K, chunk):
    from panst3r_torch.engine.inference import InferenceEngine

    return InferenceEngine(model, bucket, num_keyframes=K, chunk=chunk,
                           amp=amp, device=device)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper (its ``launches`` counter), by kernel name."""
    from panst3r_torch.ops.flash_attention import flash_mha, flash_mha_bwd
    from panst3r_torch.ops.masked_attention import masked_mha
    from panst3r_torch.ops.packed_attention import packed_mha
    from panst3r_torch.ops.tower_attention import (tower_cross_attention,
                                                   tower_cross_int8,
                                                   tower_self_attention)

    return {"tower_self": tower_self_attention,
            "tower_cross": tower_cross_attention,
            "tower_cross_int8": tower_cross_int8,
            "masked_attn": masked_mha, "flash_fwd": flash_mha,
            "flash_bwd": flash_mha_bwd, "packed_flash": packed_mha}


def _launches():
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def _reset_launches():
    for fn in kernel_wrappers().values():
        for name in ("launches", "launches_f32", "launches_wide",
                     "launches_wide_f32"):
            if hasattr(fn, name):
                setattr(fn, name, 0)


class ModelFactory:
    """A picklable recipe for the same model on every rank: ``config``'s
    PanSt3R with ``state`` (parameter name → numpy array) or with the
    random weights of ``seed`` (``models/panst3r.py::build_model``)."""

    def __init__(self, config, state: dict | None = None, seed: int = 0):
        self.config, self.state, self.seed = config, state, seed

    def __call__(self, device):
        from panst3r_torch.models.panst3r import PanSt3R, build_model

        if self.state is None:
            return build_model(self.config, device=device, seed=self.seed)
        with torch.device("meta"):
            model = PanSt3R(self.config)
        model = model.to_empty(device=device)
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in self.state.items()})
        return model.eval()


def strict_f32(device):
    """No TF32 in this rank's f32 products and convolutions (a sharded
    run and its one-rank reference then round alike)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def serve_worker(device, make_model, scene: dict, bucket, K: int,
                 chunk: int, amp: bool, serve_kw: dict, checks: tuple,
                 raw: bool = True):
    """The serving paths over 2-rank meshes, each against the same call on
    this rank alone (one model, ``make_model(device)``, the same weights on
    every rank).  ``checks`` names what to run:

    - "tp": ``serve_device`` under ``model`` = 2 (``apply_tp`` on a second
      copy) — its wire and the decoded agreement with the one-rank wire,
      the raw ``run_fused`` outputs' largest differences (and, with
      ``raw``, the outputs), and the launches of the TP call (counted from
      0 just before it);
    - "dp": ``serve_many_device`` of ``scene["scenes"]`` over ``data`` = 2;
    - "mem": ``serve_device`` and ``run_device`` with the render over
      ``mem`` = 2.

    Returns {check: {...}} with the wires, the outputs and the seconds."""
    from panst3r_torch.core.tp import apply_tp
    from panst3r_torch.engine.inference import fetch_wire

    out = {}
    model = make_model(device)
    eng = _engine(model, bucket, device, amp, K, chunk)
    images, portrait, cls = (scene["images"], scene["portrait"],
                             scene["cls_emb"])
    if "tp" in checks or "mem" in checks:
        eng.serve_device(images, portrait, cls, **serve_kw)      # warm
        ref, t_ref = _timed(eng.serve_device, images, portrait, cls,
                            **serve_kw)
        ref = fetch_wire(ref)
    if "tp" in checks:
        g = build_mesh(MeshSpec(data=-1, model=2)).group(MODEL_AXIS)
        tp_eng = _engine(apply_tp(make_model(device), g), bucket, device,
                         amp, K, chunk)
        with torch.inference_mode():
            raw_ref = eng.run_fused(images, portrait, cls)
            raw = tp_eng.run_fused(images, portrait, cls)
        tp_eng.serve_device(images, portrait, cls, **serve_kw)  # warm
        _reset_launches()
        wire, t_tp = _timed(tp_eng.serve_device, images, portrait, cls,
                            **serve_kw)
        launches = _launches()
        keys = ("pointmaps_raw", "pred_logits", "pred_masks")
        wire = fetch_wire(wire)
        V = len(images)
        got, want = eng.unpack_wire(wire, V), eng.unpack_wire(ref, V)
        same = got["pan"] == want["pan"]
        dconf = np.abs(got["conf"] - want["conf"])
        out["tp"] = {
            "wire": wire, "wire_one": ref, "launches": launches,
            "pan_agree": float(same.mean()),
            "conf_max_abs_diff": float(dconf.max()),
            # where both runs give a pixel the same segment
            "conf_max_abs_diff_agreeing": float(dconf[same].max()),
            "n_segments": int(want["selected"].sum()),
            "raw_max_abs_diff": {k: float((raw[k].float()
                                           - raw_ref[k].float()).abs().max())
                                 for k in keys},
            "raw_max_abs": {k: float(raw_ref[k].float().abs().max())
                            for k in keys},
            "seconds": t_tp, "seconds_one_rank": t_ref}
        if raw:
            out["tp"]["raw"] = {k: raw[k] for k in keys}
            out["tp"]["raw_one"] = {k: raw_ref[k] for k in keys}
        del tp_eng
    if "dp" in checks:
        g = build_mesh(MeshSpec(data=2, mem=-1)).group(DATA_AXIS)
        scenes, ports = scene["scenes"], scene["portraits"]
        for group in (None, g):                                  # warm
            eng.serve_many_device(scenes, ports, cls, data_group=group,
                                  **serve_kw)
        one, t_one = _timed(eng.serve_many_device, scenes, ports, cls,
                            **serve_kw)
        many, t_dp = _timed(eng.serve_many_device, scenes, ports, cls,
                            data_group=g, **serve_kw)
        many, one = fetch_wire(many), fetch_wire(one)
        out["dp"] = {"wires": many, "wires_one": one,
                     "wires_equal": bool(np.array_equal(many, one)),
                     "seconds": t_dp, "seconds_one_rank": t_one}
    if "mem" in checks:
        g = build_mesh(MeshSpec(data=-1, mem=2)).group(MEM_AXIS)
        eng.serve_device(images, portrait, cls, mem_group=g, **serve_kw)
        _peak_reset(device)
        eng.serve_device(images, portrait, cls, **serve_kw)
        peak_one = _peak_reset(device)
        wire, t_mem = _timed(eng.serve_device, images, portrait, cls,
                             mem_group=g, **serve_kw)
        peak = _peak_reset(device)
        run_one = eng.run_device(images, portrait, cls)
        run_mem = eng.run_device(images, portrait, cls, mem_group=g)
        wire = fetch_wire(wire)
        out["mem"] = {"wire": wire, "wire_one": ref,
                      "wire_equal": bool(np.array_equal(wire, ref)),
                      "run_equal": all(torch.equal(run_one[k], run_mem[k])
                                       for k in ("pointmaps_raw",
                                                 "pred_logits",
                                                 "pred_masks")),
                      **_bank_split(eng, images, K, g),
                      "peak_bytes": peak, "peak_bytes_one_rank": peak_one,
                      "seconds": t_mem, "seconds_one_rank": t_ref}
    return out


def _peak_reset(device):
    """The card's peak allocated bytes in this process since the last
    call (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return int(peak)


@torch.inference_mode()
def _bank_split(eng, images, K: int, group) -> dict:
    """The memory of ``images``' linspace keyframes built split over
    ``group`` and whole on this rank: the bytes each holds, and whether
    the split banks, gathered, equal the whole ones bit for bit."""
    from panst3r_torch.engine.retrieval import select_keyframes_linspace

    x, pos = eng.encode_batch(torch.as_tensor(images, device=eng.device))
    kf = select_keyframes_linspace(len(images), K)
    with eng._mem_sharded(group):
        split = eng.build_memory(x[kf], pos[kf])
    one = eng.build_memory(x[kf], pos[kf])
    pairs = [(split.pos, one.pos), (split.valid, one.valid)] + list(
        zip(split.y, one.y))
    return {"bank_bytes": sum(a.nbytes for a in (split.y, split.pos,
                                                 split.valid)),
            "bank_bytes_one_rank": sum(a.nbytes for a in (one.y, one.pos,
                                                          one.valid)),
            "bank_equal": all(torch.equal(split.whole(a), b)
                              for a, b in pairs)}


def dp_step_worker(device, make_model, batch: dict, grid, lr: float,
                   trainable=("panoptic_decoder",), model_size: int = 1,
                   loss_kw=None):
    """One data-parallel micro-step over ``data`` = world / ``model_size``
    (tensor parallelism over ``model_size`` when > 1) on this rank's rows
    of ``batch``, and one micro-step of a fresh model on the whole batch
    on this rank: both losses and both sets of updated weights (the TP
    model's gathered whole).  ``loss_kw``: more loss settings (say,
    random point sampling)."""
    from panst3r_torch.core.tp import apply_tp, gather_state

    world = distributed.process_count()
    data = world // model_size
    mesh = build_mesh(MeshSpec(data=data, model=model_size))
    B = batch["images"].shape[0]
    d = mesh.index(DATA_AXIS)
    rows = slice(d * (B // data), (d + 1) * (B // data))
    model = apply_tp(make_model(device).train(), mesh.group(MODEL_AXIS))
    (loss, grads, params), t_dp = _timed(
        train_micro_step, model, batch_rows(batch, rows, device), grid,
        device, data_group=mesh.group(DATA_AXIS), lr=lr,
        trainable=trainable, loss_kw=loss_kw)
    grads, params = gather_state(model, grads), gather_state(model, params)
    ref = make_model(device).train()
    (loss1, grads1, params1), t_one = _timed(
        train_micro_step, ref, batch_rows(batch, slice(None), device), grid,
        device, lr=lr, trainable=trainable, loss_kw=loss_kw)
    return {"loss": loss, "loss_one": loss1, "seconds": t_dp,
            "seconds_one_rank": t_one,
            **step_agreement(grads, params, grads1, params1)}


def step_agreement(grads, params, grads1, params1) -> dict:
    """How far a sharded step's gradients and updated weights are from one
    process's: ``grad_diff`` the largest gradient difference over the
    largest one-process gradient; ``weight_diff`` the largest weight
    difference where the one-process gradient stands above the f32 noise
    of its sum (1e-8 of the largest gradient), ``weight_diff_noise``
    elsewhere, a reading: Adam's first update is g / (|g| + 1e-8), about
    ±lr for any g well above 1e-8, so a gradient whose true value is 0 (a
    key bias under softmax) moves its weight by ±lr whatever its noise
    (``grad_diff`` holds those gradients)."""
    gmax = max(float(g.abs().max()) for g in grads1.values())
    grad_diff = w_sig = w_noise = 0.0
    for k, g1 in grads1.items():
        grad_diff = max(grad_diff, float((grads[k] - g1).abs().max()))
        d = (params[k].float() - params1[k].float()).abs()
        sig = g1.abs() >= 1e-8 * gmax
        if sig.any():
            w_sig = max(w_sig, float(d[sig].max()))
        if (~sig).any():
            w_noise = max(w_noise, float(d[~sig].max()))
    return {"grad_diff": grad_diff / gmax, "weight_diff": w_sig,
            "weight_diff_noise": w_noise}


def tp_forward_worker(device, make_model, images, portrait, cls_emb, grid):
    """The training forward (``PanSt3R.forward``, no gradients) under
    ``model`` = 2: the panoptic head's outputs."""
    from panst3r_torch.core.tp import apply_tp

    g = build_mesh(MeshSpec(data=-1, model=2)).group(MODEL_AXIS)
    model = apply_tp(make_model(device), g)
    with torch.no_grad():
        panout, _ = model(*(torch.as_tensor(a, device=device)
                            for a in (images, portrait, cls_emb)), grid)
    return {k: panout[k] for k in ("pred_masks", "pred_logits")}


def train_app_worker(device, exp, first_epochs: int):
    """``apps/train.py::train`` for ``first_epochs`` epochs, then again to
    ``exp``'s epochs (a resume from ``last``): each run's start epoch,
    last loss and the checkpoints this rank wrote."""
    from panst3r_torch.apps import train as app

    runs = [app.train(dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, epochs=first_epochs)), device), app.train(exp, device)]
    return {"start_epoch": [r["start_epoch"] for r in runs],
            "loss": [r["stats"]["loss"] for r in runs],
            "saved": [r["saved"] for r in runs]}


def nccl_worker(device, make_model, batch: dict, grid, lr: float):
    """The production backend's code path on one rank: a ``Group`` of the
    whole world (one rank) runs the helpers' collectives for real — one
    ``all_reduce``, one ``all_gather_cat`` and a data-parallel micro-step
    — against the same step with no group."""
    import torch.distributed as dist

    from panst3r_torch.core.mesh import Group, all_reduce

    world = dist.get_world_size()
    g = Group(dist.group.WORLD, tuple(range(world)), dist.get_rank())
    x = torch.arange(4, dtype=torch.float32, device=device)
    summed = all_reduce(x.clone(), g)
    gathered = all_gather_cat(x, 0, g)
    rows = batch_rows(batch, slice(None), device)
    (loss, grads, params), t_g = _timed(train_micro_step,
                                        make_model(device).train(), rows,
                                        grid, device, data_group=g, lr=lr)
    (loss1, grads1, params1), t_one = _timed(
        train_micro_step, make_model(device).train(), rows, grid, device,
        lr=lr)
    return {"backend": dist.get_backend(), "world": world,
            "all_reduce_ok": bool(torch.equal(summed, x * world)),
            "all_gather_ok": bool(torch.equal(gathered, x.repeat(world))),
            "loss": loss, "loss_one": loss1, "seconds": t_g,
            "seconds_one_rank": t_one,
            "bit_equal": all(torch.equal(params[k], params1[k])
                             for k in params1),
            **step_agreement(grads, params, grads1, params1)}
