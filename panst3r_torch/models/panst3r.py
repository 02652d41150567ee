"""The composite PanSt3R model (counterpart of panst3r_tpu/models/panst3r.py):
MUSt3R-style encoder and memory decoder, the DINO semantic encoder and the
panoptic head (v1 or v2), with the stage methods the inference engine
drives and the training forward (``forward``): DINO and the encoder, the
incremental memory build on the ``[2, 1, 1, …]`` schedule, the render
against the memory, then the panoptic head.  Frozen stages (the
``freeze_*`` fields; DINO is frozen in every shipped config) run without a
graph, the counterpart of the JAX package's ``stop_gradient``.

Dtypes follow flax's promotion: a layer computes in the wider of its
input's and its parameters' dtypes.  So with f32 images and frozen towers
stored in bf16 (``engine/train.py::cast_frozen_params``) the towers compute
in f32 with their layer parameters promoted at the call
(``promoted_params``), while raw bf16 parameters (DINO's position embedding
and cls token) meet the f32 activations through torch's own promotion, as
through jnp's.

``build_model`` makes the model on its device with seeded random weights
drawn like flax's initializers (lecun-normal dense/conv kernels, zero
biases, unit LayerNorm scales, the named raw parameters as in the JAX
modules).  The draws differ from JAX's bits: the tests load JAX weights
through ``weights.load_jax_params`` instead.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.core.device import resolve_device
from panst3r_torch.models.decoder import MemoryDecoder, MemoryDecoderConfig
from panst3r_torch.models.dino import DinoEncoder, DinoEncoderConfig
from panst3r_torch.models.encoder import ViTEncoder, ViTEncoderConfig
from panst3r_torch.models.panoptic_decoder import (PanopticDecoder,
                                                   PanopticDecoderConfig)
from panst3r_torch.models import memory as memlib
from panst3r_torch.models.upscalers.loftup import GroupNorm, promoted_params


@cfg.register
@dataclasses.dataclass(frozen=True)
class PanSt3RConfig:
    encoder: ViTEncoderConfig = ViTEncoderConfig()
    decoder: MemoryDecoderConfig = MemoryDecoderConfig()
    dino: DinoEncoderConfig = DinoEncoderConfig()
    panoptic: PanopticDecoderConfig = PanopticDecoderConfig()
    init_num_views: int = 2
    batch_num_views: int = 1
    # Freeze policy (reference train.py:219-222): DINO always frozen; the
    # MUSt3R encoder and decoder frozen unless fine-tuned.
    freeze_encoder: bool = True
    freeze_decoder: bool = True
    freeze_dino: bool = True

    def mem_batches(self, n_views: int) -> list[int]:
        """[2, 1, 1, ...] memory injection schedule."""
        batches = [min(self.init_num_views, n_views)]
        while sum(batches) < n_views:
            batches.append(min(self.batch_num_views, n_views - sum(batches)))
        return batches


class PanSt3R(nn.Module):
    def __init__(self, config: PanSt3RConfig = PanSt3RConfig()):
        super().__init__()
        c = self.config = config
        self.must3r_encoder = ViTEncoder(c.encoder)
        self.must3r_decoder = MemoryDecoder(c.decoder)
        self.dino_encoder = DinoEncoder(c.dino)
        self.panoptic_decoder = PanopticDecoder(
            c.encoder.embed_dim + c.decoder.dim + c.dino.embed_dim,
            c.panoptic)
        # the mesh's mem axis the training forward splits its memory
        # over (None: whole on this rank; ``models/memory.py``)
        self.mem_group = None

    # ---- stage methods ----

    def encode(self, images):
        """images (B, V, H, W, 3) → tokens (B, V, N, C), pos (B, V, N, 2)."""
        B, V = images.shape[:2]
        x, pos = self.must3r_encoder(images.reshape(B * V,
                                                    *images.shape[2:]))
        return x.reshape(B, V, *x.shape[1:]), pos.reshape(B, V, *pos.shape[1:])

    def encode_dino(self, images):
        B, V = images.shape[:2]
        out = self.dino_encoder(images.reshape(B * V, *images.shape[2:]))
        return out.reshape(B, V, *out.shape[1:])

    def decoder_update(self, x, pos, mem, grid):
        return self.must3r_decoder(x, pos, mem, render=False, grid=grid)

    def decoder_update_feedback(self, x, pos, mem, grid, feedback_feats):
        """A memory update of a refinement pass: the tokens gain the
        decoder's feedback MLP of ``feedback_feats``, the features a
        previous pass rendered for the same views."""
        return self.must3r_decoder(x, pos, mem, render=False, grid=grid,
                                   feedback_feats=feedback_feats)

    def decoder_render(self, x, pos, mem, grid):
        _, pointmaps, feats = self.must3r_decoder(x, pos, mem, render=True,
                                                  grid=grid)
        return pointmaps, feats

    def panoptic(self, in_feats, images, pos, portrait, cls_embeddings, grid,
                 memory_queries=None, deep_supervision=None,
                 per_scene=False):
        return self.panoptic_decoder(in_feats, images, pos, portrait,
                                     cls_embeddings, grid,
                                     memory_queries=memory_queries,
                                     deep_supervision=deep_supervision,
                                     per_scene=per_scene)

    # ---- training forward ----

    def forward(self, images, portrait, cls_embeddings, grid):
        """images (B, V, H, W, 3) landscape-canonical, dust3r-normalized;
        portrait (B, V) bool; cls_embeddings (num_classes, lang_dim); grid
        (H // 16, W // 16).  Returns (panout dict, pointmaps_raw
        (B, V, H, W, 7))."""
        c = self.config
        B, V = images.shape[:2]
        N = grid[0] * grid[1]
        flat = images.reshape(B * V, *images.shape[2:])

        def stage(module, frozen):
            params = promoted_params(module, images.dtype)
            grad = torch.is_grad_enabled() and not frozen

            def call(*args, **kwargs):
                with torch.set_grad_enabled(grad):
                    return torch.func.functional_call(module, params, args,
                                                      kwargs)
            return call

        x_dino = stage(self.dino_encoder, c.freeze_dino)(flat)
        x_dino = x_dino.reshape(B, V, *x_dino.shape[1:])
        x, pos = stage(self.must3r_encoder, c.freeze_encoder)(flat)
        x, pos = (t.reshape(B, V, *t.shape[1:]) for t in (x, pos))

        decoder = stage(self.must3r_decoder, c.freeze_decoder)
        mem = memlib.init_memory(c.decoder.depth, B, V * N, c.decoder.dim,
                                 dtype=x.dtype, device=x.device,
                                 group=self.mem_group)
        start = 0
        for nb in c.mem_batches(V):
            mem = decoder(x[:, start:start + nb], pos[:, start:start + nb],
                          mem, render=False, grid=grid)[0]
            start += nb
        _, pointmaps, y = decoder(x, pos, mem, render=True, grid=grid)

        # a head with wider parameters promotes its inputs (bf16 features
        # under amp meet the f32 head)
        head = next(self.panoptic_decoder.parameters()).dtype
        feats = tuple(f.to(torch.promote_types(f.dtype, head))
                      for f in (x, y, x_dino))
        panout = self.panoptic(feats, images, pos, portrait, cls_embeddings,
                               grid)
        return panout, pointmaps


_RAW_INIT = {
    # name: (kind, value) — flax initializers of the raw parameters
    "cls_token": ("const", 0.0),
    "pos_embed": ("normal", 0.02),
    "query_feat": ("normal", 1.0),
    "query_embed": ("normal", 1.0),
    "level_embed": ("normal", 1.0),
    "cls_logit_scale": ("const", 1.0),
    "biases": ("normal", 1.0),
    "nocls_token": ("normal", 1.0),
}


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init in the style of the flax initializers."""
    ls_init = {}
    for name, mod in model.named_modules():
        if isinstance(mod, DinoEncoder):
            ls_init[name] = mod.config.layerscale_init
    for name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.Linear, nn.Conv2d)) and pname == "weight":
                fan_in = p[0].numel()
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            elif isinstance(mod, (nn.LayerNorm, GroupNorm)) \
                    and pname == "weight":
                p.fill_(1.0)
            elif pname == "bias":
                p.zero_()
            elif pname in ("ls1", "ls2"):
                owner = max((k for k in ls_init if name.startswith(k)),
                            key=len)
                p.fill_(ls_init[owner])
            elif pname in _RAW_INIT:
                kind, val = _RAW_INIT[pname]
                if kind == "const":
                    p.fill_(val)
                else:
                    p.normal_(0.0, val, generator=generator)
            else:
                raise KeyError(f"no init rule for {name}.{pname}")
    return model


def build_model(config: PanSt3RConfig, device=None, seed: int = 0) -> PanSt3R:
    """PanSt3R on ``device`` (default: the card; raises when there is none)
    with random weights drawn from ``seed`` on that device."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = PanSt3R(config)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(model, gen).eval()
