"""Batches for training (counterpart of panst3r_tpu/data/loader.py).

``collate_batch`` turns view dicts into fixed-shape numpy batches
(portrait views transposed to landscape, targets padded to
``max_instances``); ``epoch_batches`` is the deterministic epoch iterator
(one permutation per epoch, rank sharding by slicing, one resolution drawn
per batch, an optional pool of thread or spawned process workers that
never changes the batches); ``prefetch`` runs an iterator in a thread a
few batches ahead.  ``engine/train.py::batch_to`` moves a batch to the
card.  Nothing here touches CUDA: process workers import numpy, cv2, PIL
and the dataset's modules only.
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from panst3r_torch.data.targets import prepare_targets


def canonicalize_views(views: Sequence[dict]) -> dict:
    """Stack one sample's views, portrait views transposed to landscape:
    images (V, H, W, 3), portrait (V,), pan_inst_id / pan_cls_id
    (V, H, W), class_set, crowd_inst_ids."""
    imgs, portraits, insts, clss = [], [], [], []
    for v in views:
        img, inst, cls = v["img"], v["pan_inst_id"], v["pan_cls_id"]
        portrait = img.shape[0] > img.shape[1]
        if portrait:
            img, inst, cls = (np.swapaxes(a, 0, 1) for a in (img, inst, cls))
        imgs.append(img)
        insts.append(inst)
        clss.append(cls)
        portraits.append(portrait)
    return {
        "images": np.stack(imgs),
        "portrait": np.asarray(portraits, bool),
        "pan_inst_id": np.stack(insts),
        "pan_cls_id": np.stack(clss),
        "class_set": views[0]["class_set"],
        "crowd_inst_ids": np.asarray(
            views[0].get("crowd_inst_ids", np.zeros(0, np.int64))),
    }


def collate_batch(samples: Sequence[Sequence[dict]], classes: list[str],
                  max_instances: int) -> dict:
    """samples: per-sample view lists of one resolution → {images (B, V,
    H, W, 3) f32, portrait (B, V), targets: Targets of numpy arrays}."""
    # imported here: the criterion imports torch, which process workers
    # (they only load samples) do not need
    from panst3r_torch.engine.criterion import Targets

    canon = [canonicalize_views(v) for v in samples]
    tgt = [prepare_targets(c["pan_inst_id"], c["pan_cls_id"],
                           c["class_set"].split(";"), classes, max_instances)
           for c in canon]
    targets = Targets(*(np.stack([t[k] for t in tgt]) for k in
                        ("labels", "masks", "valid", "output_mask")))
    return {"images": np.stack([c["images"] for c in canon])
            .astype(np.float32),
            "portrait": np.stack([c["portrait"] for c in canon]),
            "targets": targets}


# A process worker unpickles the dataset once, at pool start, then serves
# (idx, res) keys from it: the torch DataLoader's model without pickling
# the dataset per task.
_WORKER_DATASET = None


def _process_worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    try:                    # cv2 runs a thread pool per process: one
        import cv2          # thread each, or N workers oversubscribe
        cv2.setNumThreads(0)
    except ImportError:     # pragma: no cover
        pass


def _process_worker_get(key):
    return _WORKER_DATASET[key]


def epoch_batches(dataset, batch_size: int, classes: list[str],
                  max_instances: int, epoch: int, seed: int = 777,
                  rank: int = 0, world_size: int = 1,
                  num_resolutions: int = 1,
                  workers: int = 0,
                  workers_mode: str = "process") -> Iterator[dict]:
    """Collated batches of one epoch: the permutation of ``seed + epoch``,
    this rank's slice of it, and per batch one resolution index drawn from
    the same generator (every sample of a batch shares its bucket).

    ``workers`` > 0 loads the samples through a pool (torch DataLoader's
    ``num_workers``); the batches are the same for any number of workers.
    ``workers_mode="process"`` spawns worker processes (decoding and
    augmenting is numpy under the GIL, so threads do not scale); a parent
    with no importable main module (a REPL, ``-c``) falls back to threads.
    ``"thread"`` keeps the pool in this process.  Sample loads are kept
    ``max(2 * workers, 2 * batch_size)`` ahead across batch boundaries.
    """
    dataset.set_epoch(epoch)
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(len(dataset))
    order = order[rank::world_size]
    # every rank takes the same number of batches (its collectives pair up)
    n_batches = len(dataset) // world_size // batch_size
    batch_keys = []
    for b in range(n_batches):
        idxs = order[b * batch_size:(b + 1) * batch_size]
        res_idx = int(rng.integers(num_resolutions))
        batch_keys.append([(int(i), res_idx) for i in idxs])

    if workers <= 0:
        for keys in batch_keys:
            yield collate_batch([dataset[k] for k in keys], classes,
                                max_instances)
        return

    if workers_mode == "process":
        import multiprocessing as mp
        import os
        import sys

        # spawn re-imports __main__ in the child: a REPL, stdin or -c
        # parent has none and every worker would die at start
        main_mod = sys.modules.get("__main__")
        main_file = getattr(main_mod, "__file__", None)
        if main_file is not None and not os.path.exists(main_file):
            main_file = None
        if main_file is None and getattr(main_mod, "__spec__", None) is None:
            workers_mode = "thread"

    if workers_mode == "process":
        # spawn, not fork: the parent has threads (prefetch) and a CUDA
        # context, neither of which survives a fork
        pool = ProcessPoolExecutor(
            workers, mp_context=mp.get_context("spawn"),
            initializer=_process_worker_init, initargs=(dataset,))
        submit = lambda key: pool.submit(_process_worker_get, key)  # noqa: E731
    elif workers_mode == "thread":
        pool = ThreadPoolExecutor(workers)
        submit = lambda key: pool.submit(dataset.__getitem__, key)  # noqa: E731
    else:
        raise ValueError(f"workers_mode={workers_mode!r}")

    try:
        inflight = max(2 * workers, 2 * batch_size)
        pending: collections.deque = collections.deque()
        n_submitted = 0
        bi = 0
        while bi < len(batch_keys) or pending:
            while bi < len(batch_keys) and n_submitted < inflight:
                pending.append([submit(k) for k in batch_keys[bi]])
                n_submitted += len(batch_keys[bi])
                bi += 1
            futs = pending.popleft()
            samples = [f.result() for f in futs]
            n_submitted -= len(futs)
            yield collate_batch(samples, classes, max_instances)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def prefetch(batches: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Run ``batches`` in a background thread, up to ``depth`` batches
    ahead, so host loading overlaps the card's step.  An exception of the
    producer re-raises at the consumer."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    done = object()
    err = object()          # identity sentinels: no item equals them

    def producer():
        try:
            for item in batches:
                q.put(item)
            q.put(done)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            q.put((err, e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
            raise item[1]
        yield item
