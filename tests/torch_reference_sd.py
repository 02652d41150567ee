"""A reference-named PanSt3R state_dict at a port config's widths, made
without JAX (``chip_smoke.py`` imports it on the card's machine).

The keys and shapes are those of ``tests/test_torch_demo.py::
reference_state_dict``, which builds them from the reference-named torch
transcriptions of ``tests/test_port_full.py`` (a JAX test module):
dust3r/croco naming for the MUSt3R encoder and decoder, HF
``Dinov2Model`` naming for DINOv2, the reference sources' naming for the
input mixer, LoftUp (two cross-attention blocks, as the reference module
has), the PixelShuffle MLPs and the mask transformer.
``tests/test_torch_checkpoint_tools.py`` holds the two equal at every
registered preset.  The values are drawn from a seed by the same rules:
weights scaled by 1/sqrt(fan-in), norm scales near 1, small biases.
"""
from __future__ import annotations

import numpy as np
import torch


def _linear(sd, name, n_in, n_out, bias=True):
    sd[f"{name}.weight"] = (n_out, n_in)
    if bias:
        sd[f"{name}.bias"] = (n_out,)


def _norm(sd, name, dim):
    sd[f"{name}.weight"] = sd[f"{name}.bias"] = (dim,)


def _mlp(sd, name, dim, hidden, out=None):
    _linear(sd, f"{name}.fc1", dim, hidden)
    _linear(sd, f"{name}.fc2", hidden, out or dim)


def _block(sd, name, dim):
    """croco ``Block``: norm1 / attn.qkv, attn.proj / norm2 / mlp."""
    _norm(sd, f"{name}.norm1", dim)
    _linear(sd, f"{name}.attn.qkv", dim, 3 * dim)
    _linear(sd, f"{name}.attn.proj", dim, dim)
    _norm(sd, f"{name}.norm2", dim)
    _mlp(sd, f"{name}.mlp", dim, 4 * dim)


def _cross_attn(sd, name, dim, qkv_bias=True):
    for n in ("projq", "projk", "projv"):
        _linear(sd, f"{name}.{n}", dim, dim, qkv_bias)
    _linear(sd, f"{name}.proj", dim, dim)


def _encoder(sd, p, dim, depth, patch=16):
    sd[f"{p}.patch_embed.proj.weight"] = (dim, 3, patch, patch)
    sd[f"{p}.patch_embed.proj.bias"] = (dim,)
    for i in range(depth):
        _block(sd, f"{p}.enc_blocks.{i}", dim)
    _norm(sd, f"{p}.enc_norm", dim)


def _decoder(sd, p, enc_dim, dim, depth, patch=16, ch=7):
    _linear(sd, f"{p}.decoder_embed", enc_dim, dim)
    _mlp(sd, f"{p}.feedback_mlp", dim, 2 * dim)
    for i in range(depth):
        b = f"{p}.dec_blocks.{i}"
        _norm(sd, f"{b}.norm1", dim)
        _linear(sd, f"{b}.attn.qkv", dim, 3 * dim)
        _linear(sd, f"{b}.attn.proj", dim, dim)
        _cross_attn(sd, f"{b}.cross_attn", dim)
        for n in ("norm2", "norm3"):
            _norm(sd, f"{b}.{n}", dim)
        _mlp(sd, f"{b}.mlp", dim, 4 * dim)
        _norm(sd, f"{b}.norm_y", dim)
    _norm(sd, f"{p}.dec_norm", dim)
    _linear(sd, f"{p}.head.proj", dim, patch * patch * ch)


def _dinov2(sd, p, dino):
    C, hid, k = dino.embed_dim, int(dino.embed_dim * dino.mlp_ratio), \
        dino.patch_size
    sd[f"{p}.embeddings.cls_token"] = (1, 1, C)
    sd[f"{p}.embeddings.mask_token"] = (1, C)
    sd[f"{p}.embeddings.position_embeddings"] = (1, dino.pos_grid ** 2 + 1, C)
    sd[f"{p}.embeddings.patch_embeddings.projection.weight"] = (C, 3, k, k)
    sd[f"{p}.embeddings.patch_embeddings.projection.bias"] = (C,)
    _norm(sd, f"{p}.layernorm", C)
    for i in range(dino.depth):
        L = f"{p}.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            _linear(sd, f"{L}.attention.attention.{n}", C, C)
        _linear(sd, f"{L}.attention.output.dense", C, C)
        _mlp(sd, f"{L}.mlp", C, hid)
        _norm(sd, f"{L}.norm1", C)
        _norm(sd, f"{L}.norm2", C)
        sd[f"{L}.layer_scale1.lambda1"] = sd[f"{L}.layer_scale2.lambda1"] = (C,)


def _loftup(sd, p, input_dim, dim, n_freqs, blocks=2):
    start = 5 * n_freqs * 2 + 3
    sd[f"{p}.patch_embed.weight"] = (input_dim, input_dim, 1, 1)
    sd[f"{p}.patch_embed.bias"] = (input_dim,)
    sd[f"{p}.lr_pe.biases"] = (2, 2, 5)
    _linear(sd, f"{p}.lr_input_proj.0", input_dim + 20, dim)
    _norm(sd, f"{p}.lr_input_proj.1", dim)
    sd[f"{p}.fourier_feat.1.biases"] = (2, 5, n_freqs)
    _norm(sd, f"{p}.first_conv.0", start)
    sd[f"{p}.first_conv.1.weight"] = (dim, start, 3, 3)
    sd[f"{p}.first_conv.1.bias"] = (dim,)
    _norm(sd, f"{p}.first_conv.2", dim)
    sd[f"{p}.first_conv.4.weight"] = (dim, dim, 3, 3)
    sd[f"{p}.first_conv.4.bias"] = (dim,)
    _norm(sd, f"{p}.first_conv.5", dim)
    for i in range(blocks):
        b = f"{p}.ca_transformer_blocks.{i}"
        _cross_attn(sd, f"{b}.cross_attn", dim, qkv_bias=False)
        for n in ("norm2", "norm3", "norm_y"):
            _norm(sd, f"{b}.{n}", dim)
        _mlp(sd, f"{b}.mlp", dim, dim)
    _norm(sd, f"{p}.ca_transformer_norm", dim)


def _mask_transformer(sd, p, mt):
    C, F = mt.hidden_dim, mt.ff_dim
    sd[f"{p}.query_feat.weight"] = sd[f"{p}.query_embed.weight"] = \
        (mt.num_queries, C)
    sd[f"{p}.level_embed.weight"] = (1, C)
    sd[f"{p}.cls_logit_scale"] = ()
    _norm(sd, f"{p}.decoder_norm", C)
    _linear(sd, f"{p}.lang_embed", C, mt.lang_dim)
    for i in range(3):
        _linear(sd, f"{p}.mask_embed.layers.{i}", C,
                mt.mask_dim if i == 2 else C)
    for i in range(mt.dec_layers):
        for mod, sub in ((f"cross_attn_layers.{i}", "multihead_attn"),
                         (f"self_attn_layers.{i}", "self_attn")):
            sd[f"{p}.{mod}.{sub}.in_proj_weight"] = (3 * C, C)
            sd[f"{p}.{mod}.{sub}.in_proj_bias"] = (3 * C,)
            _linear(sd, f"{p}.{mod}.{sub}.out_proj", C, C)
            _norm(sd, f"{p}.{mod}.norm", C)
        _linear(sd, f"{p}.ffn_layers.{i}.linear1", C, F)
        _linear(sd, f"{p}.ffn_layers.{i}.linear2", F, C)
        _norm(sd, f"{p}.ffn_layers.{i}.norm", C)


def reference_shapes(cfg) -> dict:
    """{key: shape} of a reference-named state_dict at ``cfg``'s widths."""
    from panst3r_torch.models.panst3r import PanSt3R

    enc, dec, dino, pan = cfg.encoder, cfg.decoder, cfg.dino, cfg.panoptic
    sd: dict = {}
    _encoder(sd, "must3r_encoder", enc.embed_dim, enc.depth)
    _decoder(sd, "must3r_decoder", enc.embed_dim, dec.dim, dec.depth)
    _dinov2(sd, "dino_encoder.dinov2", dino)
    in_dim = enc.embed_dim + dec.dim + dino.embed_dim
    p = "panoptic_decoder"
    if pan.input_mixer is not None:
        mix = pan.input_mixer
        _linear(sd, f"{p}.input_mixer.in_proj", in_dim, mix.hidden_dim)
        for i in range(mix.num_layers):
            _block(sd, f"{p}.input_mixer.mixer_blk.{i}", mix.hidden_dim)
        _norm(sd, f"{p}.input_mixer.mixer_norm", mix.hidden_dim)
        _loftup(sd, f"{p}.upscaler", mix.hidden_dim, pan.upscaler.dim,
                pan.upscaler.n_freqs)
    else:
        # the four MLPs at the widths of the port's module for this config
        with torch.device("meta"):
            up = PanSt3R(cfg).panoptic_decoder.upscaler
        for k, v in up.named_parameters():
            sd[f"{p}.upscaler.{k}"] = tuple(v.shape)
    _mask_transformer(sd, f"{p}.mask_transformer", pan.mask_transformer)
    return sd


@torch.no_grad()
def reference_state_dict(cfg, seed: int = 0, device="cpu") -> dict:
    """{key: f32 tensor on ``device``}: ``reference_shapes(cfg)`` filled
    from a torch generator seeded with ``seed`` (on ``device``: draws on
    the card are fast at full width)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, shape in sorted(reference_shapes(cfg).items()):
        a = torch.empty(shape, dtype=torch.float32, device=device)
        a.normal_(generator=gen)
        if len(shape) >= 2 and not k.endswith(
                ("embeddings", "_token", "position_embeddings")) \
                and "query_" not in k and "level_embed" not in k:
            a /= float(np.sqrt(np.prod(shape[1:])))
        elif k.endswith("weight") and len(shape) == 1:
            a.mul_(0.1).add_(1.0)
        elif k.endswith(("bias", "_token", "position_embeddings")):
            a.mul_(0.05)
        elif k.endswith("lambda1"):
            a.mul_(0.05).add_(0.2)
        elif k.endswith("cls_logit_scale"):
            a.mul_(0.1).add_(1.0)
        out[k] = a
    return out
