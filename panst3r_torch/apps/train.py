"""Training app (counterpart of panst3r_tpu/apps/train.py): a YAML
experiment config → datasets, model, one train step per resolution bucket,
the class vocabulary, the freeze policy, the optimizer, auto-resume from
``<output_dir>/last``, epochs with ``last`` and ``keep_freq`` checkpoints,
``log.txt`` and the weights-only ``final`` checkpoint.

    python -m panst3r_torch.apps.train --config configs/train_v2.yaml \
        [--output-dir out] [--epochs N] [--data-root dir] [--device cpu]

``main`` parses the arguments, reads the YAML and writes
``config.yaml`` (PyYAML is imported there only); ``train(exp)`` does the
rest, on the card unless ``device="cpu"``.  The experiment files of the
JAX package load unchanged: the XLA-only fields (``precompile``,
``compilation_cache``) are kept and not read.  The port trains on one
card: a mesh over more than one device (``mesh_*``) and the in-training
evaluation (``eval_every``) raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from panst3r_torch.apps.common import preset_config
from panst3r_torch.core import config as cfglib
from panst3r_torch.core.checkpoint import (latest_checkpoint, load_checkpoint,
                                           load_optimizer_state,
                                           save_checkpoint)
from panst3r_torch.core.device import resolve_device
from panst3r_torch.core.logging import build_logger
from panst3r_torch.data.loader import epoch_batches, prefetch
from panst3r_torch.data.scannetpp import ScanNetppPanoptic
from panst3r_torch.engine.train import (Optimizer, TrainConfig,
                                        cast_frozen_params, make_train_step,
                                        train_one_epoch, trainable_mask)
from panst3r_torch.models import panst3r as panst3r_model
from panst3r_torch.models.text_encoder import TextEncoder, TextEncoderConfig


@cfglib.register
@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """One term of the training mix, the declarative form of the
    reference's ``N @ Dataset(...) + M @ Dataset(...)`` strings:
    ``ds_size`` > 0 resamples it to that many tuples per epoch (``N @ A``),
    ``repeat`` > 1 repeats it (``N * A``); unset overrides take the
    experiment's values.  ``num_views`` stays experiment-wide: every
    sample of a batch has the same view count."""
    type: str = "scannetpp"
    root: str = ""
    ds_size: int = 0
    repeat: int = 1
    aug_crop: int = -1                     # -1: the experiment's aug_crop
    transform: str | None = None


@cfglib.register
@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model_preset: str = "v1"               # v1 | v2 | tiny | tiny_v2
    data_root: str = ""
    # the dataset mix; empty: one ScanNetppPanoptic at data_root
    datasets: tuple = ()
    resolution: tuple = ((512, 384),)      # (W, H) buckets, W >= H
    num_views: int = 5
    aug_crop: int = 16
    # the reference recipe: photometric augmentation and a random memory
    # core size per sample
    transform: str | None = None           # None | "ColorJitter"
    min_memory_num_views: int | None = None
    max_memory_num_views: int | None = None
    train: TrainConfig = TrainConfig()
    output_dir: str = "./out"
    keep_freq: int = 10
    print_freq: int = 20
    # fetch the loss every N steps (engine/train.py::train_one_epoch)
    sync_every: int = 1
    logger: str = "tensorboard"
    # the JAX package's device mesh; the port runs on one card, so each
    # axis must ask for at most one device (-1: all there are, i.e. one)
    mesh_data: int = -1
    mesh_mem: int = 1
    mesh_model: int = 1
    # host data pipeline: sample workers ("process": spawned processes;
    # "thread": a pool in this process) and batches prefetched
    loader_workers: int = 4
    loader_workers_mode: str = "process"
    loader_prefetch: int = 2
    text_encoder: str = "siglip"           # siglip | siglip2 | clip | random
    # PQ evaluation during training (waits for the eval slice)
    eval_every: int = 0
    eval_scenes: int = 8
    eval_keyframes: int = 4
    # XLA-only (the JAX package's compile cache and AOT precompile): kept
    # so that its files load, not read here
    precompile: bool = True
    compilation_cache: str | None = ".jax_cache"


def build_model(preset: str, device=None, seed: int = 0):
    """The preset's PanSt3R (``apps/common.py::preset_config``) with random
    weights drawn from ``seed``."""
    return panst3r_model.build_model(preset_config(preset), device=device,
                                     seed=seed)


DATASET_TYPES = {"scannetpp": ScanNetppPanoptic}


def build_datasets(exp: ExperimentConfig):
    """The experiment's dataset mix as one algebra dataset: each spec
    becomes ``repeat * (ds_size @ Dataset(...))`` and the terms
    concatenate; each sample keeps its dataset's vocabulary (its
    ``class_set``, the criterion's ``output_mask``)."""
    specs = [DatasetSpec(**s) if isinstance(s, dict) else s
             for s in exp.datasets]
    if not specs:
        specs = [DatasetSpec(root=exp.data_root)]
    terms = []
    for spec in specs:
        cls = DATASET_TYPES[spec.type]
        ds = cls(spec.root or exp.data_root,
                 resolution=list(exp.resolution),
                 num_views=exp.num_views,
                 aug_crop=exp.aug_crop if spec.aug_crop < 0 else spec.aug_crop,
                 transform=spec.transform or exp.transform,
                 min_memory_num_views=exp.min_memory_num_views,
                 max_memory_num_views=exp.max_memory_num_views)
        if spec.ds_size:
            ds = spec.ds_size @ ds
        if spec.repeat > 1:
            ds = spec.repeat * ds
        terms.append(ds)
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def class_embeddings(text_encoder: str, classes: list[str],
                     lang_dim: int) -> np.ndarray:
    """The (len(classes), lang_dim) f32 class table: the text tower's
    embeddings when ``text_encoder`` names one whose width is
    ``lang_dim`` and it runs; else (``"random"``, another width, or a tower
    that fails) random unit vectors from ``default_rng(0)``."""
    if text_encoder != "random":
        text = TextEncoder(TextEncoderConfig(model_name=text_encoder))
        if text.embed_dim == lang_dim:
            try:
                text.set_vocab(classes)
                return np.asarray(text(classes), np.float32)
            except Exception as e:
                print(f"WARN: text tower unavailable ({e}); "
                      "using random embeddings")
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((len(classes), lang_dim))
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return emb.astype(np.float32)


def _check_supported(exp: ExperimentConfig) -> None:
    if max(exp.mesh_data, exp.mesh_mem, exp.mesh_model) > 1:
        raise NotImplementedError(
            "the port trains on one card: a mesh over more devices "
            f"(mesh_data={exp.mesh_data}, mesh_mem={exp.mesh_mem}, "
            f"mesh_model={exp.mesh_model}) waits for the multi-GPU port "
            "(ROADMAP queue 1 item 10)")
    if exp.eval_every > 0:
        raise NotImplementedError(
            "eval_every > 0: the PQ evaluation waits for the eval port "
            "(ROADMAP queue 1 item 9)")


def train(exp: ExperimentConfig, device=None) -> dict:
    """Run the experiment (resuming from ``<output_dir>/last`` when it
    exists).  Returns {"start_epoch", "stats": the last epoch's}."""
    _check_supported(exp)
    dev = resolve_device(device)
    out_dir = Path(exp.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"device: {dev}")

    dataset = build_datasets(exp)
    classes = sorted(set(dataset.classes))

    model = build_model(exp.model_preset, device=dev, seed=exp.train.seed)
    model_cfg = model.config
    # one patch grid per resolution bucket, keyed by the batch's (H, W)
    grids = {(h, w): (h // 16, w // 16) for (w, h) in exp.resolution}

    # the class vocabulary → a fixed embedding table
    lang_dim = model_cfg.panoptic.mask_transformer.lang_dim
    cls_emb = class_embeddings(exp.text_encoder, classes, lang_dim)

    # freeze policy: the panoptic head trains, the towers unless unfrozen;
    # the frozen parameters are stored in bf16
    trainable = ["panoptic_decoder"]
    if not model_cfg.freeze_encoder:
        trainable.append("must3r_encoder")
    if not model_cfg.freeze_decoder:
        trainable.append("must3r_decoder")
    cast_frozen_params(model, tuple(trainable))
    mask = trainable_mask(model, tuple(trainable))

    world = 1
    steps_per_epoch = max(len(dataset) // (exp.train.batch_size * world), 1)
    opt = Optimizer({n: p for n, p in model.named_parameters() if mask[n]},
                    exp.train, world, steps_per_epoch)
    step_fns = {hw: make_train_step(model, opt, exp.train.loss, g,
                                    amp=exp.train.amp)
                for hw, g in grids.items()}

    start_epoch = 0
    last = latest_checkpoint(out_dir)
    if last:
        state, _, meta = load_checkpoint(out_dir, last)
        model.load_state_dict(state)
        opt_state = load_optimizer_state(out_dir, last)
        if opt_state is None:
            raise FileNotFoundError(f"{out_dir / last} holds no optimizer "
                                    "state to resume from")
        opt.load_state_dict(opt_state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        print(f"resumed from epoch {start_epoch}")

    log_writer = build_logger(exp.logger, out_dir)
    cls_t = torch.as_tensor(cls_emb, device=dev)

    print(f"Start training for {exp.train.epochs} epochs")
    t0 = time.time()
    stats: dict = {}
    for epoch in range(start_epoch, exp.train.epochs):
        batches = epoch_batches(dataset, exp.train.batch_size, classes,
                                exp.train.max_instances, epoch,
                                seed=exp.train.seed,
                                num_resolutions=len(exp.resolution),
                                workers=exp.loader_workers,
                                workers_mode=exp.loader_workers_mode)
        if exp.loader_prefetch > 0:
            batches = prefetch(batches, exp.loader_prefetch)
        opt, stats = train_one_epoch(
            opt, step_fns, batches, cls_t, epoch, exp.train.seed, dev,
            log_writer, exp.print_freq, steps_per_epoch,
            sync_every=exp.sync_every)

        meta = {"epoch": epoch, "stats": stats, "classes": classes,
                # serving pairs the trained weights with THIS table
                "cls_emb": cls_emb}
        save_checkpoint(out_dir, "last", model, model_cfg, meta,
                        optimizer=opt.state_dict())
        if exp.keep_freq and epoch % exp.keep_freq == 0:
            save_checkpoint(out_dir, str(epoch), model, model_cfg, meta,
                            optimizer=opt.state_dict())
        with (out_dir / "log.txt").open("a") as f:
            f.write(json.dumps({"epoch": epoch,
                                **{f"train_{k}": v
                                   for k, v in stats.items()}}) + "\n")

    print(f"Training time {time.time() - t0:.1f}s")
    log_writer.close()
    # the final checkpoint holds the weights only
    save_checkpoint(out_dir, "final", model, model_cfg,
                    {"epoch": exp.train.epochs, "classes": classes,
                     "cls_emb": cls_emb})
    return {"start_epoch": start_epoch, "stats": stats}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--output-dir", type=str, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--data-root", type=str, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="(always on: a run resumes from <output_dir>/last)")
    ap.add_argument("--device", type=str, default=None,
                    help="cpu to train on the CPU (default: the card)")
    args = ap.parse_args(argv)

    exp = (cfglib.load_yaml(args.config) if args.config
           else ExperimentConfig())
    if args.output_dir:
        exp = dataclasses.replace(exp, output_dir=args.output_dir)
    if args.data_root:
        exp = dataclasses.replace(exp, data_root=args.data_root)
    if args.epochs:
        exp = dataclasses.replace(
            exp, train=dataclasses.replace(exp.train, epochs=args.epochs))

    out_dir = Path(exp.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfglib.save_yaml(exp, out_dir / "config.yaml")
    return train(exp, device=args.device)


if __name__ == "__main__":
    main()
