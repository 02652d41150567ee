"""Dataset algebra and multi-view tuple sampling (counterpart of
panst3r_tpu/data/base.py): the reference's ``EasyDataset`` operators
(``A + B`` concatenates, ``N * A`` repeats, ``N @ A`` resamples to N
tuples per epoch) over map-style datasets, and the covisibility tuple
sampler.  ``data/loader.py`` batches and collates.
"""
from __future__ import annotations

import numpy as np


def _split_key(idx):
    """A loader key is an index or an ``(idx, res_idx)`` tuple (one
    resolution per batch, ``data/loader.py::epoch_batches``): the wrappers
    route on the index and pass the resolution through."""
    if isinstance(idx, tuple):
        return idx[0], idx[1:]
    return idx, ()


class EasyDataset:
    """Operator algebra: ``+`` concatenates, ``*`` repeats, ``@`` resizes."""

    def __add__(self, other):
        return CatDataset([self, other])

    def __rmul__(self, factor: int):
        return MulDataset(factor, self)

    def __rmatmul__(self, size: int):
        return ResizedDataset(size, self)

    def set_epoch(self, epoch: int):
        pass

    @property
    def classes(self):
        raise NotImplementedError


class CatDataset(EasyDataset):
    def __init__(self, datasets):
        self.datasets = []
        for d in datasets:  # flatten nested concatenations
            self.datasets.extend(d.datasets if isinstance(d, CatDataset)
                                 else [d])

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        idx, rest = _split_key(idx)
        for d in self.datasets:
            if idx < len(d):
                return d[(idx, *rest)] if rest else d[idx]
            idx -= len(d)
        raise IndexError(idx)

    def set_epoch(self, epoch):
        for d in self.datasets:
            d.set_epoch(epoch)

    @property
    def classes(self):
        """The union of the members' vocabularies, sorted."""
        out = set()
        for d in self.datasets:
            out.update(d.classes)
        return sorted(out)


class MulDataset(EasyDataset):
    def __init__(self, factor, dataset):
        self.factor = factor
        self.dataset = dataset

    def __len__(self):
        return self.factor * len(self.dataset)

    def __getitem__(self, idx):
        idx, rest = _split_key(idx)
        sub = idx // self.factor
        return self.dataset[(sub, *rest)] if rest else self.dataset[sub]

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)

    @property
    def classes(self):
        return self.dataset.classes

    @property
    def categories(self):
        return self.dataset.categories


class ResizedDataset(EasyDataset):
    """``N @ dataset``: N tuples per epoch, a fresh permutation per epoch."""

    def __init__(self, size, dataset):
        self.size = size
        self.dataset = dataset
        self._indices = None
        self.set_epoch(0)

    def __len__(self):
        return self.size

    def set_epoch(self, epoch):
        rng = np.random.default_rng(777 + epoch)
        n = len(self.dataset)
        reps = -(-self.size // n)
        idx = np.concatenate([rng.permutation(n) for _ in range(reps)])
        self._indices = idx[:self.size]
        self.dataset.set_epoch(epoch)

    def __getitem__(self, idx):
        idx, rest = _split_key(idx)
        sub = int(self._indices[idx])
        return self.dataset[(sub, *rest)] if rest else self.dataset[sub]

    @property
    def classes(self):
        return self.dataset.classes

    @property
    def categories(self):
        return self.dataset.categories


def select_tuple_from_pairs(get_pairs, get_view, num_views: int,
                            memory_num_views: int, rng: np.random.Generator,
                            idx1: int, idx2: int):
    """Grow a connected tuple of views from a seed pair over the
    covisibility graph (must3r's tuple maker).  The first
    ``memory_num_views`` views form a connected memory core, each covisible
    with the core so far; the rest are drawn from the core's neighbours
    only.  An exhausted neighbourhood repeats a selected view."""
    memory_num_views = max(2, min(memory_num_views, num_views))
    selected = [idx1, idx2]

    def grow(frontier_src):
        frontier = set()
        for s in frontier_src:
            frontier.update(get_pairs(s))
        frontier -= set(selected)
        if frontier:
            selected.append(int(rng.choice(sorted(frontier))))
        else:
            selected.append(int(rng.choice(selected)))

    while len(selected) < memory_num_views:
        grow(selected)
    mem_core = list(selected)
    while len(selected) < num_views:
        grow(mem_core)
    return [get_view(v, rng) for v in selected[:num_views]]
