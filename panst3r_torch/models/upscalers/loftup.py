"""LoftUp upscaler of the v2 models (counterpart of
panst3r_tpu/models/upscalers/loftup.py): a Fourier-feature guidance branch
on the half-resolution image (min-max scaling, coordinate + RGB Fourier
features, GroupNorm / 3x3 conv stem) whose pixels query the sine-encoded
patch features through two cross-only blocks (K4: 4 heads of 96 at the v2
width).  Channels-last throughout; returns ``fpn=[patch feats]`` and the
stride-2 mask features.

Dtypes follow flax's promotion, which the JAX module relies on: the
featurizer's coordinates and frequencies are float32, so from the Fourier
features on every layer sees an f32 input, and under amp its bf16
parameters are promoted to f32 at the call (``call_promoted``; bf16 → f32
is exact).  Only ``minmax`` and the 1x1 ``patch_embed`` stay in the input
dtype.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.models.blocks import TORCH_LN_EPS, CrossonlyDecoderBlock
from panst3r_torch.ops.image import resize_bilinear


def promoted_params(module: nn.Module, dtype: torch.dtype) -> dict:
    """The parameters of ``module`` as flax computes with them when the
    input is ``dtype``: each layer (Linear, Conv2d, LayerNorm, GroupNorm)
    works in the wider of its input's and its parameters' dtypes, so its
    parameters are cast to that (exact); raw parameters keep their dtype,
    and torch promotes the ops that use them as jnp does."""
    out = {}
    for mname, mod in module.named_modules():
        layer = isinstance(mod, (nn.Linear, nn.Conv2d, nn.LayerNorm,
                                 GroupNorm))
        for pname, p in mod.named_parameters(recurse=False):
            if layer:
                p = p.to(torch.promote_types(p.dtype, dtype))
            out[f"{mname}.{pname}" if mname else pname] = p
    return out


def call_promoted(module: nn.Module, dtype: torch.dtype, *args, **kwargs):
    """``module(*args, **kwargs)`` with its parameters promoted for an input
    of ``dtype`` (``promoted_params``)."""
    params = promoted_params(module, dtype)
    if all(params[n] is p for n, p in module.named_parameters()):
        return module(*args, **kwargs)
    return torch.func.functional_call(module, params, args, kwargs)


def _linspace(start: float, stop: float, num: int, nd) -> np.ndarray:
    """``jnp.linspace`` (endpoint included) as JAX computes it,
    start·(1 − i/div) + stop·i/div, in numpy dtype ``nd``."""
    if num == 1:
        return np.asarray([start], nd)
    div = num - 1
    step = np.arange(div, dtype=nd) / nd(div)
    return np.concatenate([nd(start) * (nd(1) - step) + nd(stop) * step,
                           np.asarray([stop], nd)])


class MinMaxScaler(nn.Module):
    """Per-channel min-max scaling to [-0.5, 0.5] over batch, H and W: a
    view's output depends on the views that share its call, or with
    ``groups`` on those of its group (equal runs of the batch)."""

    def forward(self, x, groups: int = 1):
        g = x.reshape(groups, -1, *x.shape[1:])
        mn = g.amin(dim=(1, 2, 3), keepdim=True)
        mx = g.amax(dim=(1, 2, 3), keepdim=True)
        return ((g - mn) / torch.clamp(mx - mn, min=1e-4) - 0.5).reshape(
            x.shape)


class ImplicitFeaturizer(nn.Module):
    """Coordinate (+ colour) Fourier features with learned phase biases
    ``biases`` (2, dm, n_freqs): sin and cos of the features times
    e^linspace(-2, 10, n_freqs), then the colour itself."""

    def __init__(self, color_feats: bool, n_freqs: int, dm: int):
        super().__init__()
        self.color_feats = color_feats
        self.n_freqs = n_freqs
        self.biases = nn.Parameter(torch.empty(2, dm, n_freqs))

    def forward(self, image):
        B, H, W, _ = image.shape
        # Coordinates and frequencies are made on the host, so every device
        # sees the same values: the phases reach e^10 times them.
        dt = torch.promote_types(image.dtype, torch.float32)
        nd = np.float64 if dt == torch.float64 else np.float32
        dev = image.device
        yy, xx = torch.meshgrid(
            torch.as_tensor(_linspace(-1, 1, H, nd), device=dev),
            torch.as_tensor(_linspace(-1, 1, W, nd), device=dev),
            indexing="ij")
        feats = torch.stack([yy, xx], -1)[None].expand(B, H, W, 2)
        if self.color_feats:
            feats = torch.cat([feats, image.to(dt)], -1)
        dm = feats.shape[-1]
        freqs = torch.as_tensor(np.exp(_linspace(
            -2.0, 10.0, self.n_freqs, nd).astype(np.float64)).astype(nd),
            device=dev)
        f = feats[..., None, :] * freqs[:, None]          # (B, H, W, nf, dm)
        biases = self.biases.to(torch.promote_types(dt, self.biases.dtype))
        sin_f = (f + biases[0].T).reshape(B, H, W, self.n_freqs * dm)
        cos_f = (f + biases[1].T).reshape(B, H, W, self.n_freqs * dm)
        parts = [torch.sin(sin_f), torch.cos(cos_f)]
        if self.color_feats:
            parts.append(image.to(sin_f.dtype))
        return torch.cat(parts, -1)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on channels-last data: statistics over all
    non-batch axes of each group in at least f32, the variance as
    E[x²] − E[x]² (flax's fast variance)."""

    def __init__(self, num_groups: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        acc = torch.promote_types(x.dtype, torch.float32)
        g = x.to(acc).reshape(B, -1, G, C // G)
        mu = g.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(g.square().mean(dim=(1, 3), keepdim=True)
                          - mu.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(acc).reshape(G, -1)
        y = (g - mu) * mul + self.bias.to(acc).reshape(G, -1)
        out = torch.promote_types(x.dtype, self.weight.dtype)
        return y.reshape(x.shape).to(out)


class Conv1x1(nn.Conv2d):
    """A 1x1 convolution (a Conv2d's parameters) of channels-last input
    (..., C), computed as the matrix product it is: on the card cuDNN's
    filter gradient of the convolution adds in an order that changes run
    to run, the product's does not."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x):
        return F.linear(x, self.weight.reshape(self.out_channels, -1),
                        self.bias)


@cfg.register
@dataclasses.dataclass(frozen=True)
class LoftUpUpscalerConfig:
    dim: int = 384
    output_stride: int = 2
    patch_size: int = 16
    color_feats: bool = True
    n_freqs: int = 20
    num_heads: int = 4
    num_layers: int = 2

    @property
    def fpn_dim(self) -> tuple:
        return (768,)  # patch_embed keeps the input (mixer) dim

    @property
    def mask_dim(self) -> int:
        return self.dim


class LoftUpUpscaler(nn.Module):
    LR_PE_FREQS = 5

    def __init__(self, in_dim: int,
                 config: LoftUpUpscalerConfig = LoftUpUpscalerConfig()):
        super().__init__()
        c = self.config = config
        dm = 2 + (3 if c.color_feats else 0)
        guide_dim = 2 * c.n_freqs * dm + (3 if c.color_feats else 0)
        self.patch_embed = Conv1x1(in_dim, in_dim)
        self.minmax = MinMaxScaler()
        self.fourier = ImplicitFeaturizer(c.color_feats, c.n_freqs, dm)
        self.gn0 = GroupNorm(1, guide_dim)
        self.conv1 = nn.Conv2d(guide_dim, c.dim, 3, padding=1)
        self.gn1 = GroupNorm(8, c.dim)
        self.conv2 = nn.Conv2d(c.dim, c.dim, 3, padding=1)
        self.gn2 = GroupNorm(8, c.dim)
        self.lr_pe = ImplicitFeaturizer(False, self.LR_PE_FREQS, 2)
        self.lr_proj = nn.Linear(in_dim + 4 * self.LR_PE_FREQS, c.dim)
        self.lr_proj_norm = nn.LayerNorm(c.dim, eps=TORCH_LN_EPS)
        for i in range(c.num_layers):
            setattr(self, f"ca_block_{i}",
                    CrossonlyDecoderBlock(c.dim, c.num_heads, mlp_ratio=1.0))
        self.ca_norm = nn.LayerNorm(c.dim, eps=TORCH_LN_EPS)

    def forward(self, feats, images, grid, groups: int = 1):
        """feats (B, N, C) patch tokens; images (B, H, W, 3) guidance;
        grid (gh, gw); ``groups``: the image min-max spans each of that
        many equal runs of the batch (one scene each).  Returns ([patch
        feats (B, gh, gw, C)], mask feats (B, H/stride, W/stride, dim))."""
        c = self.config
        B, N, C = feats.shape
        gh, gw = grid
        lr = feats.reshape(B, gh, gw, C)
        patch_feats = self.patch_embed(lr)

        H, W = images.shape[1:3]
        hout, wout = H // c.output_stride, W // c.output_stride
        x = self.minmax(resize_bilinear(images, hout, wout), groups)
        x = self.fourier(x)
        dt = x.dtype
        x = call_promoted(self.gn0, dt, x)
        x = call_promoted(self.conv1, dt, x.permute(0, 3, 1, 2))
        x = F.relu(call_promoted(self.gn1, dt, x.permute(0, 2, 3, 1)))
        x = call_promoted(self.conv2, dt, x.permute(0, 3, 1, 2))
        x = F.relu(call_promoted(self.gn2, dt, x.permute(0, 2, 3, 1)))
        x = x.reshape(B, hout * wout, c.dim)

        lr_pe = self.lr_pe(lr)
        dt_lr = torch.promote_types(lr.dtype, lr_pe.dtype)
        lr_cat = torch.cat([lr.to(dt_lr), lr_pe.to(dt_lr)], -1).reshape(
            B, gh * gw, -1)
        lr_tokens = call_promoted(self.lr_proj_norm, dt_lr,
                                  call_promoted(self.lr_proj, dt_lr, lr_cat))

        for i in range(c.num_layers):
            x, _ = call_promoted(getattr(self, f"ca_block_{i}"), dt, x,
                                 lr_tokens)
        x = call_promoted(self.ca_norm, dt, x)
        return [patch_feats], x.reshape(B, hout, wout, c.dim)
