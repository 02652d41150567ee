"""The composite PanSt3R model (counterpart of panst3r_tpu/models/panst3r.py):
MUSt3R-style encoder and memory decoder, the DINO semantic encoder and the
v1 panoptic head, with the stage methods the inference engine drives.  The
training forward and the freeze policy wait for the training slice.

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


@cfg.register
@dataclasses.dataclass(frozen=True)
class PanSt3RConfig:
    encoder: ViTEncoderConfig = ViTEncoderConfig()
    decoder: MemoryDecoderConfig = MemoryDecoderConfig()
    dino: DinoEncoderConfig = DinoEncoderConfig()
    panoptic: PanopticDecoderConfig = PanopticDecoderConfig()
    init_num_views: int = 2
    batch_num_views: int = 1

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

    def decoder_render(self, x, pos, mem, grid):
        _, pointmaps, feats = self.must3r_decoder(x, pos, mem, render=True,
                                                  grid=grid)
        return pointmaps, feats

    def panoptic(self, in_feats, portrait, cls_embeddings, grid,
                 memory_queries=None, deep_supervision=None):
        return self.panoptic_decoder(in_feats, portrait, cls_embeddings, grid,
                                     memory_queries=memory_queries,
                                     deep_supervision=deep_supervision)


_RAW_INIT = {
    # name: (kind, value) — flax initializers of the raw parameters
    "cls_token": ("const", 0.0),
    "pos_embed": ("normal", 0.02),
    "query_feat": ("normal", 1.0),
    "query_embed": ("normal", 1.0),
    "level_embed": ("normal", 1.0),
    "cls_logit_scale": ("const", 1.0),
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
            elif isinstance(mod, nn.LayerNorm) and pname == "weight":
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
