"""Training engine: schedule, optimizer, train step and epoch loop
(counterpart of panst3r_tpu/engine/train.py).

- ``cosine_lr``: per-iteration warmup + cosine (croco adjust_learning_rate).
- ``Optimizer``: the JAX package's optax chain, in its order —
  clip by global norm (when ``clip_grad`` is set), Adam scaling (eps 1e-8),
  weight decay masked to parameters with ndim > 1, the learning-rate scale
  — over the trainable parameters only, inside ``MultiSteps``
  accumulation (the running mean of ``accum_iter`` micro-step gradients;
  the schedule counts updates).  ``torch.optim.AdamW`` folds the decay into
  the step differently, so it is not used.
- ``trainable_mask`` / ``cast_frozen_params``: the freeze policy (only the
  panoptic head trains by default; frozen towers stored in bf16).
- ``make_train_step``: forward, panoptic loss, backward, optimizer step;
  frozen parameters get no gradient and are never written.
- ``train_one_epoch``: the host loop with the NaN abort, fetching the loss
  every ``sync_every`` steps, one step function per resolution bucket,
  and the ``train/*`` log every ``print_freq`` steps.

The model's parameters are updated in place; the optimizer (its moments,
accumulator and counters, ``Optimizer.state_dict``) is the rest of the
training state, which ``apps/train.py`` checkpoints and resumes.

Data parallelism (``make_train_step(data_group=...)``, the mesh's
``data`` axis): each rank runs its slice of the global batch, its loss is
its share of the global-batch loss (``engine/criterion.py``), the
gradients are summed over the group before the optimizer, and the loss
and its details returned are the global ones, equal on every rank — the
update of one process on the whole batch.  A tensor-parallel model
(``core/tp.py``) trains the same way; ``Optimizer``'s gradient clipping
then sums the split parameters' squares over its ``tp_group``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from panst3r_torch.core import config as cfg
from panst3r_torch.core import rng
from panst3r_torch.core.device import tick
from panst3r_torch.core.mesh import all_reduce
from panst3r_torch.engine.criterion import (PanopticLossConfig, Targets,
                                            panoptic_loss)


@cfg.register
@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # reference configs/base.yaml:55-85 hyperparameters
    epochs: int = 200
    warmup_epochs: int = 5
    lr: Optional[float] = 1e-4
    blr: float = 1.5e-4          # base lr, scaled by eff_bs/256 if lr None
    min_lr: float = 1e-6
    weight_decay: float = 0.05
    betas: tuple = (0.9, 0.95)
    batch_size: int = 2
    accum_iter: int = 2
    clip_grad: Optional[float] = None
    seed: int = 777
    max_instances: int = 48
    # 'bf16': images enter in bf16 and f32 matrix products may run at bf16
    # precision; None keeps full f32
    amp: Optional[str] = None
    loss: PanopticLossConfig = PanopticLossConfig()

    def effective_lr(self, world_size: int) -> float:
        eff_bs = self.batch_size * self.accum_iter * world_size
        if self.lr is not None:
            return self.lr
        return self.blr * eff_bs / 256.0


def cosine_lr(config: TrainConfig, world_size: int, steps_per_epoch: int):
    """Per-iteration warmup + cosine schedule: step → learning rate."""
    peak = config.effective_lr(world_size)

    def schedule(step: int) -> float:
        epoch_f = step / steps_per_epoch
        if epoch_f < config.warmup_epochs:
            return peak * epoch_f / max(config.warmup_epochs, 1e-8)
        prog = (epoch_f - config.warmup_epochs) / max(
            config.epochs - config.warmup_epochs, 1e-8)
        return config.min_lr + (peak - config.min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * min(max(prog, 0.0), 1.0)))

    return schedule


def _decay_mask(params: dict) -> dict:
    """No weight decay on biases, norm scales or other 1-D parameters."""
    return {n: p.ndim > 1 for n, p in params.items()}


def trainable_mask(model: torch.nn.Module,
                   trainable_modules=("panoptic_decoder",)) -> dict:
    """{parameter name: True under a trainable module}."""
    mods = set(trainable_modules)
    return {n: bool(set(n.split(".")) & mods)
            for n, _ in model.named_parameters()}


@torch.no_grad()
def cast_frozen_params(model: torch.nn.Module,
                       trainable_modules=("panoptic_decoder",),
                       dtype=torch.bfloat16) -> torch.nn.Module:
    """Store the frozen parameters in ``dtype`` (halves their memory); the
    trainable ones stay f32 for the optimizer.  In place."""
    mask = trainable_mask(model, trainable_modules)
    for n, p in model.named_parameters():
        if not mask[n] and p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


class Optimizer:
    """The optax chain of the JAX package's ``build_optimizer`` over the
    trainable parameters ``params`` (name → f32 parameter), reading their
    ``.grad`` and updating them in place.  ``steps_per_epoch`` counts
    micro-steps; the schedule runs over updates."""

    def __init__(self, params: dict, config: TrainConfig, world_size: int,
                 steps_per_epoch: int, tp_group=None, tp_split=()):
        self.params = params
        # tensor parallelism: the names of the parameters split over
        # ``tp_group`` (their squares are summed over it for the clip)
        self.tp_group, self.tp_split = tp_group, set(tp_split)
        self.config = config
        self.k = max(config.accum_iter, 1)
        self.schedule = cosine_lr(config, world_size,
                                  max(steps_per_epoch // self.k, 1))
        self.decay = _decay_mask(params)
        zeros = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in params.items()}
        self.mu = dict(zeros)
        self.nu = {n: z.clone() for n, z in zeros.items()}
        self.acc = {n: z.clone() for n, z in zeros.items()}
        self.mini_step = 0
        self.updates = 0            # Adam's and the schedule's count

    @property
    def micro_steps(self) -> int:
        """Micro-steps taken (the JAX ``TrainState.step``)."""
        return self.updates * self.k + self.mini_step

    def log_schedule(self, micro_step: int) -> float:
        """The learning rate of the update that ``micro_step`` belongs to
        (the JAX ``build_optimizer``'s logging schedule)."""
        return self.schedule(micro_step // self.k)

    def state_dict(self) -> dict:
        """The moments, the accumulator (by parameter name) and the
        counters: with the parameters, all a resumed run needs."""
        return {"mu": dict(self.mu), "nu": dict(self.nu),
                "acc": dict(self.acc), "mini_step": self.mini_step,
                "updates": self.updates}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Install a ``state_dict`` (its tensors go to each parameter's
        device); raises on a parameter set or shape that differs."""
        for key in ("mu", "nu", "acc"):
            own = getattr(self, key)
            if set(state[key]) != set(own):
                raise KeyError(f"optimizer {key}: parameters differ: "
                               f"{sorted(set(state[key]) ^ set(own))[:5]}")
            for n, t in state[key].items():
                if tuple(t.shape) != tuple(own[n].shape):
                    raise ValueError(f"optimizer {key}.{n}: shape "
                                     f"{tuple(t.shape)}, expected "
                                     f"{tuple(own[n].shape)}")
                own[n] = t.to(device=own[n].device, dtype=torch.float32)
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])

    @torch.no_grad()
    def step(self) -> bool:
        """Accumulate the gradients; on every ``accum_iter``-th call apply
        one update.  Clears the gradients; returns whether it updated."""
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            den = torch.full((), self.mini_step + 1.0, device=g.device)
            self.acc[n] = self.acc[n] + (g.float() - self.acc[n]) / den
            p.grad = None
        self.mini_step = (self.mini_step + 1) % self.k
        if self.mini_step:
            return False
        self._update(self.acc)
        self.acc = {n: torch.zeros_like(a) for n, a in self.acc.items()}
        return True

    def _update(self, grads: dict) -> None:
        c = self.config
        b1, b2 = c.betas
        if c.clip_grad:
            sq = {n: (g * g).sum() for n, g in grads.items()}
            norm = sum(v for n, v in sq.items() if n not in self.tp_split)
            split = [v for n, v in sq.items() if n in self.tp_split]
            if split:
                norm = norm + all_reduce(torch.stack(split).sum(),
                                         self.tp_group)
            norm = torch.sqrt(norm)
            grads = {n: torch.where(norm < c.clip_grad, g,
                                    g / norm * c.clip_grad)
                     for n, g in grads.items()}
        self.updates += 1
        t = self.updates
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        lr = -self.schedule(t - 1)
        for n, p in self.params.items():
            g = grads[n]
            self.mu[n] = (1 - b1) * g + b1 * self.mu[n]
            self.nu[n] = (1 - b2) * (g * g) + b2 * self.nu[n]
            u = (self.mu[n] / bc1.to(g.device)) / (
                torch.sqrt(self.nu[n] / bc2.to(g.device)) + 1e-8)
            if self.decay[n]:
                u = u + c.weight_decay * p
            p.add_(lr * u)


@contextlib.contextmanager
def matmul_precision(amp: Optional[str]):
    """Under amp='bf16', f32 matrix products may run at bf16 precision
    (the JAX package's ``default_matmul_precision('bfloat16')``); the
    setting is restored on exit."""
    if amp != "bf16":
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def batch_to(batch: dict, device) -> dict:
    """A collated numpy batch (``data/loader.py::collate_batch``) as
    tensors on ``device``."""
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    tg = batch["targets"]
    return {"images": t(batch["images"]), "portrait": t(batch["portrait"]),
            "targets": Targets(*(t(a) for a in tg))}


def _sum_grads(params, group) -> None:
    """Every gradient summed over ``group``, in one flat buffer per dtype
    (one collective each)."""
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in ps]), group)
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad.copy_(g.view_as(p.grad))


def make_train_step(model: torch.nn.Module, optimizer: Optimizer,
                    loss_config: PanopticLossConfig, grid: tuple[int, int],
                    amp: Optional[str] = None, data_group=None):
    """step(batch, cls_embeddings, generator=None, draws=None,
    stage_times=None) → (loss, details): one micro-step on a batch of
    device tensors (images (B, V, H, W, 3) f32, portrait (B, V), targets).
    ``data_group``: the data axis the batch is this rank's slice of; the
    generator is the same on every rank (the global batch's draws are
    cut to this rank's rows) and the gradients, the loss and the scalar
    details are summed over the group.
    Only the optimizer's parameters get gradients.  amp='bf16' casts the
    images to bf16 (the frozen bf16 towers then compute in bf16, the f32
    head promotes back) and runs the forward, the loss and the backward
    under ``matmul_precision``.  ``stage_times``: a dict to receive the
    seconds of frozen_forward, head_forward, criterion, backward and
    optimizer (the device is synchronized at each boundary only when it is
    given)."""
    from panst3r_torch.models.upscalers.loftup import MinMaxScaler

    train = set(optimizer.params.values())
    for p in model.parameters():
        p.requires_grad_(p in train)
    device = next(model.parameters()).device
    for m in model.modules():
        if isinstance(m, MinMaxScaler):    # LoftUp's image extremes
            m.group = data_group

    def step(batch, cls_embeddings, generator=None, draws=None,
             stage_times=None):
        images = batch["images"]
        if amp == "bf16":
            images = images.to(torch.bfloat16)
        t = [tick(stage_times, None, 0.0, device)]
        hooks = []
        if stage_times is not None:
            head = model.panoptic_decoder
            for reg, name in ((head.register_forward_pre_hook,
                               "frozen_forward"),
                              (head.register_forward_hook, "head_forward")):
                hooks.append(reg(lambda *_, name=name: t.append(tick(
                    stage_times, name, t[-1], device)) and None))
        try:
            with matmul_precision(amp):
                panout, _ = model(images, batch["portrait"], cls_embeddings,
                                  grid)
                t.append(tick(stage_times, None, t[-1], device))
                total, details = panoptic_loss(panout, batch["targets"],
                                               loss_config, generator, draws,
                                               group=data_group)
                t.append(tick(stage_times, "criterion", t[-1], device))
                total.backward()
            if data_group is not None:
                _sum_grads(optimizer.params.values(), data_group)
            t.append(tick(stage_times, "backward", t[-1], device))
        finally:
            for h in hooks:
                h.remove()
        optimizer.step()
        tick(stage_times, "optimizer", t[-1], device)
        details = {k: (all_reduce(v.detach().clone(), data_group)
                       if v.ndim == 0 else v.detach())
                   for k, v in details.items()}
        return details["panoptic_loss"], details

    return step


def train_one_epoch(state: Optimizer, step_fn, data_iter, cls_embeddings,
                    epoch: int, seed: int, device, log_writer=None,
                    print_freq: int = 20, steps_per_epoch: int = 0,
                    sync_every: int = 1):
    """Host epoch loop.  ``state``: the optimizer the steps update;
    ``step_fn``: one step, or a dict of steps keyed by the batch's image
    (H, W), one per resolution bucket; ``data_iter`` yields collated numpy
    batches; each step draws from its own generator (``core/rng.py``).
    The loss is fetched every ``sync_every`` steps (each fetch waits for
    the card); a non-finite loss raises FloatingPointError, at most
    ``sync_every`` − 1 steps late.  Every ``print_freq`` steps
    ``log_writer`` gets ``train/loss`` (the mean since the last record),
    ``train/iter`` (the fractional epoch of ``steps_per_epoch``),
    ``train/lr`` (``Optimizer.log_schedule`` at the micro-step count) and
    each scalar loss of the last step.  Returns (state, {"loss": the
    epoch's mean loss})."""
    losses: list = []
    pending: list = []

    def drain():
        for dev_loss in pending:
            value = float(dev_loss)
            if not math.isfinite(value):
                raise FloatingPointError(f"Loss is {value}, stopping training")
            losses.append(value)
        pending.clear()

    for it, batch in enumerate(data_iter):
        fn = step_fn
        if isinstance(step_fn, dict):
            fn = step_fn[tuple(batch["images"].shape[2:4])]
        gen = rng.generator(seed, epoch, it, device=device)
        loss, details = fn(batch_to(batch, device), cls_embeddings, gen)
        pending.append(loss)
        if len(pending) >= max(sync_every, 1):
            drain()
        if log_writer is not None and (it + 1) % print_freq == 0:
            drain()
            epoch_f = epoch + it / max(steps_per_epoch, 1)
            vals = {"train/loss": float(np.mean(losses[-print_freq:])),
                    "train/iter": epoch_f,
                    "train/lr": state.log_schedule(state.micro_steps)}
            for k, v in details.items():
                if v.ndim == 0:         # not the assignments
                    vals[f"train/{k}"] = float(v)
            log_writer.log(vals, epoch_f)
    drain()
    return state, {"loss": float(np.mean(losses)) if losses else 0.0}
