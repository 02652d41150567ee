"""Map a reference-shaped PanSt3R state_dict onto the port's modules.

The published PanSt3R weights are torch state_dicts named after the
reference modules: the mask transformer, upscalers and input mixer as in
the reference sources; DINOv2 in HF ``transformers`` naming
(``dino_encoder.dinov2.*``); the MUSt3R encoder and decoder in
dust3r/croco naming (``patch_embed.proj`` / ``enc_blocks.i`` /
``enc_norm``; ``decoder_embed`` / ``dec_blocks.i.*`` / ``dec_norm`` /
``head.proj``, with candidate names for drifted ones).  ``port_checkpoint``
maps it onto the flax-named parameter tree of panst3r_tpu (numpy only), and
``load_reference_state_dict`` fills a port model from that tree through
``weights.load_jax_params``.  Unmapped keys are reported, as
``ported_keys`` / ``total_keys`` / ``ignored`` / ``unmapped``.
``port_retrieval_checkpoint`` maps a must3r / PanSt3R retrieval checkpoint
onto ``engine/retrieval.py::RetrievalHead``'s fields.

RoPE layout: croco rotates within each y/x half of the head dim
(rotate-half per half), as ``ops/rope.py`` does, so q/k rows are taken as
they are.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from panst3r_torch.weights import load_jax_params


def t(x):
    """torch linear (out, in) → flax kernel (in, out)."""
    return np.asarray(x).T


def conv_hwio(x):
    """torch conv OIHW → flax HWIO."""
    return np.transpose(np.asarray(x), (2, 3, 1, 0))


def split_qkv(w, b):
    """torch MHA packed in_proj (3C, C) → separate q/k/v flax kernels."""
    w = np.asarray(w)
    b = np.asarray(b)
    C = w.shape[1]
    return [(t(w[i * C:(i + 1) * C]), b[i * C:(i + 1) * C])
            for i in range(3)]


class Port:
    """State-dict accessor that tracks consumed keys."""

    def __init__(self, sd: dict):
        self.sd = dict(sd)
        self.used: set = set()
        self.ignored: set = set()

    def __contains__(self, key):
        return key in self.sd

    def get(self, key):
        self.used.add(key)
        return self.sd[key]

    def first(self, *candidates):
        """First present candidate key (supports naming drift for modules
        whose source is not on disk)."""
        for c in candidates:
            if c in self.sd:
                return c
        raise KeyError(candidates)

    def ignore(self, *keys):
        self.ignored.update(k for k in keys if k in self.sd)

    def unmapped(self):
        return sorted(set(self.sd) - self.used - self.ignored)


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


def _ln(ctx, tree, path, prefix):
    _set(tree, path + ("scale",), ctx.get(prefix + ".weight"))
    _set(tree, path + ("bias",), ctx.get(prefix + ".bias"))


def _linear(ctx, tree, path, prefix):
    _set(tree, path + ("kernel",), t(ctx.get(prefix + ".weight")))
    if prefix + ".bias" in ctx:
        _set(tree, path + ("bias",), ctx.get(prefix + ".bias"))


def _conv(ctx, tree, path, prefix):
    _set(tree, path + ("kernel",), conv_hwio(ctx.get(prefix + ".weight")))
    if prefix + ".bias" in ctx:
        _set(tree, path + ("bias",), ctx.get(prefix + ".bias"))


def _groupnorm(ctx, tree, path, prefix):
    _set(tree, path + ("scale",), ctx.get(prefix + ".weight"))
    _set(tree, path + ("bias",), ctx.get(prefix + ".bias"))


def _mlp(ctx, tree, path, prefix):
    _linear(ctx, tree, path + ("fc1",), prefix + ".fc1")
    _linear(ctx, tree, path + ("fc2",), prefix + ".fc2")


def _cross_attn(ctx, tree, path, prefix):
    """croco CrossAttention: projq/projk/projv/proj Linears."""
    for name in ("projq", "projk", "projv", "proj"):
        _linear(ctx, tree, path + (name,), f"{prefix}.{name}")


def _stack_group(out: dict, fmt: str, depth: int, target_path: tuple):
    """Per-layer subtrees ``{fmt.format(i): subtree}`` → one stacked
    subtree at ``target_path`` — the ``nn.scan`` param layout (leaves
    gain a leading layer axis), matching models/{encoder,dino,decoder}."""
    subs = [out.pop(fmt.format(i)) for i in range(depth)]

    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return np.stack([np.asarray(t) for t in ts], axis=0)

    node = out
    for p in target_path[:-1]:
        node = node.setdefault(p, {})
    node[target_path[-1]] = stack(subs)


def _croco_block(ctx, tree, path, prefix):
    """croco `Block`: norm1/attn(qkv,proj)/norm2/mlp(fc1,fc2)."""
    _ln(ctx, tree, path + ("norm1",), f"{prefix}.norm1")
    _linear(ctx, tree, path + ("attn", "qkv"), f"{prefix}.attn.qkv")
    _linear(ctx, tree, path + ("attn", "proj"), f"{prefix}.attn.proj")
    _ln(ctx, tree, path + ("norm2",), f"{prefix}.norm2")
    _mlp(ctx, tree, path + ("mlp",), f"{prefix}.mlp")


# ---------------------------------------------------------------------------
# Per-module ports
# ---------------------------------------------------------------------------

def port_encoder(ctx: Port, depth: int = 24,
                 prefix: str = "must3r_encoder") -> dict:
    """Dust3rEncoder (croco ViT-L/16 + 2D RoPE).  dust3r naming:
    `patch_embed.proj`, `enc_blocks.i.*`, `enc_norm`; croco-generic
    `blocks.i` / `norm` accepted as fallback."""
    out: dict = {}
    pe = ctx.first(f"{prefix}.patch_embed.proj.weight")
    _set(out, ("patch_embed", "kernel"), conv_hwio(ctx.get(pe)))
    _set(out, ("patch_embed", "bias"),
         ctx.get(f"{prefix}.patch_embed.proj.bias"))
    blocks = "enc_blocks" if f"{prefix}.enc_blocks.0.norm1.weight" in ctx \
        else "blocks"
    for i in range(depth):
        _croco_block(ctx, out, (f"block_{i}",), f"{prefix}.{blocks}.{i}")
    _stack_group(out, "block_{}", depth, ("blocks", "block"))
    normp = ctx.first(f"{prefix}.enc_norm.weight", f"{prefix}.norm.weight")
    _ln(ctx, out, ("norm",), normp[:-len(".weight")])
    return out


def port_memory_decoder(ctx: Port, depth: int = 12,
                        prefix: str = "must3r_decoder") -> dict:
    """MUSt3R memory decoder (external; naming per module docstring).

    Our layout (models/decoder.py): decoder_embed, feedback_mlp(fc1,fc2),
    per-layer norm_y_i / norm1_i / self_attn_i(qkv,proj) / norm2_i /
    cross_attn_i(projq,projk,projv,proj) / norm3_i / mlp_i(fc1,fc2),
    final `norm`, pointmap `head` (Dense N→p*p*7)."""
    out: dict = {}
    _linear(ctx, out, ("decoder_embed",), f"{prefix}.decoder_embed")

    fb = None
    for cand in (f"{prefix}.feedback_mlp", f"{prefix}.feedback",
                 f"{prefix}.mem_feedback"):
        if f"{cand}.fc1.weight" in ctx:
            fb = cand
            break
    if fb is not None:
        _mlp(ctx, out, ("feedback_mlp",), fb)

    for i in range(depth):
        b = f"{prefix}.dec_blocks.{i}"
        _ln(ctx, out, (f"norm1_{i}",), f"{b}.norm1")
        _linear(ctx, out, (f"self_attn_{i}", "qkv"), f"{b}.attn.qkv")
        _linear(ctx, out, (f"self_attn_{i}", "proj"), f"{b}.attn.proj")
        _ln(ctx, out, (f"norm2_{i}",), f"{b}.norm2")
        _cross_attn(ctx, out, (f"cross_attn_{i}",), f"{b}.cross_attn")
        _ln(ctx, out, (f"norm3_{i}",), f"{b}.norm3")
        _mlp(ctx, out, (f"mlp_{i}",), f"{b}.mlp")
        _ln(ctx, out, (f"norm_y_{i}",), f"{b}.norm_y")
    for name in ("norm1", "self_attn", "norm2", "cross_attn", "norm3",
                 "mlp", "norm_y"):
        _stack_group(out, name + "_{}", depth, ("layers", name))

    normp = ctx.first(f"{prefix}.dec_norm.weight", f"{prefix}.norm.weight")
    _ln(ctx, out, ("norm",), normp[:-len(".weight")])

    headp = ctx.first(f"{prefix}.head.proj.weight",
                      f"{prefix}.head.weight",
                      f"{prefix}.downstream_head.proj.weight",
                      f"{prefix}.prediction_head.proj.weight")
    _linear(ctx, out, ("head",), headp[:-len(".weight")])
    return out


def port_dino(ctx: Port, depth: int = 24,
              prefix: str = "dino_encoder.dinov2") -> dict:
    """HF Dinov2Model → our DinoEncoder.

    HF naming (transformers modeling_dinov2): embeddings.{cls_token,
    mask_token,position_embeddings,patch_embeddings.projection},
    encoder.layer.i.{norm1,attention.attention.query|key|value,
    attention.output.dense,layer_scale1.lambda1,norm2,mlp.fc1|fc2,
    layer_scale2.lambda1}, layernorm.  mask_token is inference-unused and
    intentionally dropped."""
    out: dict = {}
    emb = f"{prefix}.embeddings"
    _set(out, ("cls_token",), ctx.get(f"{emb}.cls_token"))
    _set(out, ("pos_embed",), ctx.get(f"{emb}.position_embeddings"))
    _conv(ctx, out, ("patch_embed",), f"{emb}.patch_embeddings.projection")
    ctx.ignore(f"{emb}.mask_token")

    for i in range(depth):
        L = f"{prefix}.encoder.layer.{i}"
        blk = (f"block_{i}",)
        _ln(ctx, out, blk + ("norm1",), f"{L}.norm1")
        # separate q/k/v Linears → packed qkv Dense kernel (C, 3C)
        qw = t(ctx.get(f"{L}.attention.attention.query.weight"))
        kw = t(ctx.get(f"{L}.attention.attention.key.weight"))
        vw = t(ctx.get(f"{L}.attention.attention.value.weight"))
        _set(out, blk + ("attn", "qkv", "kernel"),
             np.concatenate([qw, kw, vw], axis=1))
        _set(out, blk + ("attn", "qkv", "bias"), np.concatenate([
            ctx.get(f"{L}.attention.attention.query.bias"),
            ctx.get(f"{L}.attention.attention.key.bias"),
            ctx.get(f"{L}.attention.attention.value.bias")]))
        _linear(ctx, out, blk + ("attn", "proj"),
                f"{L}.attention.output.dense")
        _set(out, blk + ("ls1",), ctx.get(f"{L}.layer_scale1.lambda1"))
        _ln(ctx, out, blk + ("norm2",), f"{L}.norm2")
        _mlp(ctx, out, blk + ("mlp",), f"{L}.mlp")
        _set(out, blk + ("ls2",), ctx.get(f"{L}.layer_scale2.lambda1"))
    _stack_group(out, "block_{}", depth, ("blocks", "block"))

    _ln(ctx, out, ("norm",), f"{prefix}.layernorm")
    return out


def _text_tower(ctx: Port, layers: int, prefix: str) -> dict:
    """The blocks shared by HF SigLIP and CLIP text models: embeddings,
    ``encoder.layers.i.{layer_norm1, self_attn.q|k|v|out_proj,
    layer_norm2, mlp.fc1|fc2}``, ``final_layer_norm``."""
    out: dict = {}
    _set(out, ("token_embedding",),
         ctx.get(f"{prefix}.embeddings.token_embedding.weight"))
    _set(out, ("position_embedding",),
         ctx.get(f"{prefix}.embeddings.position_embedding.weight"))
    for i in range(layers):
        L = f"{prefix}.encoder.layers.{i}"
        blk = (f"layer_{i}",)
        _ln(ctx, out, blk + ("layer_norm1",), f"{L}.layer_norm1")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(ctx, out, blk + (n,), f"{L}.self_attn.{n}")
        _ln(ctx, out, blk + ("layer_norm2",), f"{L}.layer_norm2")
        _linear(ctx, out, blk + ("fc1",), f"{L}.mlp.fc1")
        _linear(ctx, out, blk + ("fc2",), f"{L}.mlp.fc2")
    _ln(ctx, out, ("final_layer_norm",), f"{prefix}.final_layer_norm")
    return out


def port_siglip_text(ctx: Port, layers: int = 12,
                     prefix: str = "text_model") -> dict:
    """HF SiglipTextModel → ``models/siglip_text.py::SiglipTextTower``
    (the blocks, then the pooling ``head``)."""
    out = _text_tower(ctx, layers, prefix)
    _linear(ctx, out, ("head",), f"{prefix}.head")
    return out


def port_clip_text(ctx: Port, layers: int = 12,
                   prefix: str = "text_model") -> dict:
    """HF CLIPTextModel → ``models/clip_text.py::ClipTextTower`` (no
    pooling head: CLIP pools at the EOS position)."""
    ctx.ignore(f"{prefix}.embeddings.position_ids")
    return _text_tower(ctx, layers, prefix)


def port_input_mixer(ctx: Port, num_layers: int = 3,
                     prefix: str = "panoptic_decoder.input_mixer") -> dict:
    """The reference InputMixer (``in_proj``, ``mixer_blk.i``, ``mixer_norm``)."""
    out: dict = {}
    _linear(ctx, out, ("in_proj",), f"{prefix}.in_proj")
    for i in range(num_layers):
        _croco_block(ctx, out, (f"mixer_blk_{i}",), f"{prefix}.mixer_blk.{i}")
    _ln(ctx, out, ("mixer_norm",), f"{prefix}.mixer_norm")
    return out


def _implicit_biases(x):
    """The reference ImplicitFeaturizer stores biases as (2, dm, n_freqs)
    but *reshapes* (not transposes) each (dm, n_freqs) slab to (n_freqs,
    dm) at use time; the port's module transposes its (2, dm, n_freqs)
    parameter, so each slab is reshaped, then transposed."""
    x = np.asarray(x)
    two, dm, nf = x.shape
    return np.stack([x[i].reshape(nf, dm).T for i in range(two)])


def port_loftup(ctx: Port, num_layers: int = 2,
                prefix: str = "panoptic_decoder.upscaler") -> dict:
    """The reference LoftUpUpscaler."""
    out: dict = {}
    _conv(ctx, out, ("patch_embed",), f"{prefix}.patch_embed")
    _set(out, ("lr_pe", "biases"),
         _implicit_biases(ctx.get(f"{prefix}.lr_pe.biases")))
    _set(out, ("fourier", "biases"),
         _implicit_biases(ctx.get(f"{prefix}.fourier_feat.1.biases")))
    _linear(ctx, out, ("lr_proj",), f"{prefix}.lr_input_proj.0")
    _ln(ctx, out, ("lr_proj_norm",), f"{prefix}.lr_input_proj.1")
    # first_conv Sequential: 0 GN(1) / 1 Conv / 2 GN(8) / 4 Conv / 5 GN(8)
    _groupnorm(ctx, out, ("gn0",), f"{prefix}.first_conv.0")
    _conv(ctx, out, ("conv1",), f"{prefix}.first_conv.1")
    _groupnorm(ctx, out, ("gn1",), f"{prefix}.first_conv.2")
    _conv(ctx, out, ("conv2",), f"{prefix}.first_conv.4")
    _groupnorm(ctx, out, ("gn2",), f"{prefix}.first_conv.5")
    for i in range(num_layers):
        b = f"{prefix}.ca_transformer_blocks.{i}"
        blk = (f"ca_block_{i}",)
        _cross_attn(ctx, out, blk + ("cross_attn",), f"{b}.cross_attn")
        _ln(ctx, out, blk + ("norm2",), f"{b}.norm2")
        _ln(ctx, out, blk + ("norm3",), f"{b}.norm3")
        _mlp(ctx, out, blk + ("mlp",), f"{b}.mlp")
        _ln(ctx, out, blk + ("norm_y",), f"{b}.norm_y")
    _ln(ctx, out, ("ca_norm",), f"{prefix}.ca_transformer_norm")
    return out


def port_pixel_shuffle(ctx: Port,
                       prefix: str = "panoptic_decoder.upscaler") -> dict:
    """The reference PixelShuffleUpscaler (``proj_{8,4,2,16}`` MLPs)."""
    out: dict = {}
    for name in ("proj_8", "proj_4", "proj_2", "proj_16"):
        _mlp(ctx, out, (name,), f"{prefix}.{name}")
    return out


def port_mask_transformer(ctx: Port, dec_layers: int = 6,
                          prefix: str = "panoptic_decoder.mask_transformer"
                          ) -> dict:
    """The reference MaskTransformer (torch ``nn.MultiheadAttention``
    packed in-projections split into q/k/v)."""
    out: dict = {}

    def grab(name):
        return ctx.get(prefix + "." + name)

    _set(out, ("query_feat",), grab("query_feat.weight"))
    _set(out, ("query_embed",), grab("query_embed.weight"))
    _set(out, ("level_embed",), grab("level_embed.weight"))
    _set(out, ("cls_logit_scale",), grab("cls_logit_scale"))
    _set(out, ("decoder_norm", "scale"), grab("decoder_norm.weight"))
    _set(out, ("decoder_norm", "bias"), grab("decoder_norm.bias"))
    _set(out, ("lang_embed", "kernel"), t(grab("lang_embed.weight")))
    _set(out, ("lang_embed", "bias"), grab("lang_embed.bias"))
    for i in range(3):
        _set(out, ("mask_embed", f"fc{i}", "kernel"),
             t(grab(f"mask_embed.layers.{i}.weight")))
        _set(out, ("mask_embed", f"fc{i}", "bias"),
             grab(f"mask_embed.layers.{i}.bias"))

    for i in range(dec_layers):
        for ours, theirs in ((f"cross_attn_{i}",
                              f"cross_attn_layers.{i}.multihead_attn"),
                             (f"self_attn_{i}",
                              f"self_attn_layers.{i}.self_attn")):
            qkv = split_qkv(grab(f"{theirs}.in_proj_weight"),
                            grab(f"{theirs}.in_proj_bias"))
            for (k, b), name in zip(qkv, ("q_proj", "k_proj", "v_proj")):
                _set(out, (ours, name, "kernel"), k)
                _set(out, (ours, name, "bias"), b)
            _set(out, (ours, "out_proj", "kernel"),
                 t(grab(f"{theirs}.out_proj.weight")))
            _set(out, (ours, "out_proj", "bias"),
                 grab(f"{theirs}.out_proj.bias"))
        _set(out, (f"cross_norm_{i}", "scale"),
             grab(f"cross_attn_layers.{i}.norm.weight"))
        _set(out, (f"cross_norm_{i}", "bias"),
             grab(f"cross_attn_layers.{i}.norm.bias"))
        _set(out, (f"self_norm_{i}", "scale"),
             grab(f"self_attn_layers.{i}.norm.weight"))
        _set(out, (f"self_norm_{i}", "bias"),
             grab(f"self_attn_layers.{i}.norm.bias"))
        _set(out, (f"ffn_fc1_{i}", "kernel"),
             t(grab(f"ffn_layers.{i}.linear1.weight")))
        _set(out, (f"ffn_fc1_{i}", "bias"), grab(f"ffn_layers.{i}.linear1.bias"))
        _set(out, (f"ffn_fc2_{i}", "kernel"),
             t(grab(f"ffn_layers.{i}.linear2.weight")))
        _set(out, (f"ffn_fc2_{i}", "bias"), grab(f"ffn_layers.{i}.linear2.bias"))
        _set(out, (f"ffn_norm_{i}", "scale"), grab(f"ffn_layers.{i}.norm.weight"))
        _set(out, (f"ffn_norm_{i}", "bias"), grab(f"ffn_layers.{i}.norm.bias"))
    return out


# ---------------------------------------------------------------------------
# Full checkpoint
# ---------------------------------------------------------------------------

def _infer_depth(sd: dict, pattern: str) -> int:
    """Count layers by scanning `pattern.format(i)` key presence."""
    i = 0
    while pattern.format(i) in sd:
        i += 1
    return i


def port_checkpoint(sd: dict) -> tuple[dict, dict]:
    """Port a full reference PanSt3R state_dict (v1 or v2) of numpy arrays.

    Returns (flax-named parameter tree, report).  The goal is ZERO unmapped
    keys; anything left is listed in the report.  Depths are inferred from
    the state_dict.
    """
    ctx = Port(sd)
    sdk = ctx.sd
    dec_layers = _infer_depth(
        sdk, "panoptic_decoder.mask_transformer.ffn_layers.{}.norm.weight")
    blocks = "enc_blocks" if any(".enc_blocks." in k for k in sdk) else "blocks"
    depth_enc = _infer_depth(sdk, "must3r_encoder." + blocks
                             + ".{}.norm1.weight")
    depth_dec = _infer_depth(sdk, "must3r_decoder.dec_blocks.{}.norm1.weight")
    depth_dino = _infer_depth(sdk,
                              "dino_encoder.dinov2.encoder.layer.{}.norm1.weight")
    ported: dict = {"panoptic_decoder": {}}
    pd = ported["panoptic_decoder"]

    if "panoptic_decoder.mask_transformer.query_feat.weight" in ctx:
        pd["mask_transformer"] = port_mask_transformer(ctx, dec_layers)
    if "panoptic_decoder.upscaler.proj_8.fc1.weight" in ctx:
        pd["upscaler"] = port_pixel_shuffle(ctx)
    if "panoptic_decoder.upscaler.ca_transformer_norm.weight" in ctx:
        n_ca = _infer_depth(
            sdk, "panoptic_decoder.upscaler.ca_transformer_blocks.{}"
            ".norm2.weight")
        pd["upscaler"] = port_loftup(ctx, num_layers=n_ca)
    if "panoptic_decoder.input_mixer.in_proj.weight" in ctx:
        n_mix = _infer_depth(
            sdk, "panoptic_decoder.input_mixer.mixer_blk.{}.norm1.weight")
        pd["input_mixer"] = port_input_mixer(ctx, num_layers=n_mix)
    if "panoptic_decoder.nocls_token" in ctx:
        pd["nocls_token"] = np.asarray(ctx.get("panoptic_decoder.nocls_token"))

    def _require_depth(depth: int, pattern: str):
        # a module present with no layer found under the expected naming
        # (say ``decoder.blocks`` for ``dec_blocks``): name the pattern
        if depth == 0:
            raise KeyError((pattern.format(0),))

    if any(k.startswith("must3r_encoder.") for k in ctx.sd):
        _require_depth(depth_enc,
                       "must3r_encoder." + blocks + ".{}.norm1.weight")
        ported["must3r_encoder"] = port_encoder(ctx, depth_enc)
    if any(k.startswith("must3r_decoder.") for k in ctx.sd):
        _require_depth(depth_dec, "must3r_decoder.dec_blocks.{}.norm1.weight")
        ported["must3r_decoder"] = port_memory_decoder(ctx, depth_dec)
    if any(k.startswith("dino_encoder.") for k in ctx.sd):
        _require_depth(depth_dino,
                       "dino_encoder.dinov2.encoder.layer.{}.norm1.weight")
        ported["dino_encoder"] = port_dino(ctx, depth_dino)

    report = {"ported_keys": len(ctx.used), "total_keys": len(ctx.sd),
              "ignored": sorted(ctx.ignored), "unmapped": ctx.unmapped()}
    return ported, report


def load_reference_state_dict(model: nn.Module, sd: dict) -> dict:
    """Fill every parameter of a port ``PanSt3R`` from a reference-shaped
    state_dict (tensors or numpy arrays; a checkpoint's ``weights`` or
    ``model`` entry is taken when given the whole checkpoint).  Returns the
    report (``unmapped`` lists the keys nothing consumed); a port
    parameter the state_dict does not fill, or a shape mismatch, raises."""
    for key in ("weights", "model"):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
    sd = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
          for k, v in sd.items()}
    tree, report = port_checkpoint(sd)
    load_jax_params(model, tree)
    return report


def port_retrieval_checkpoint(ckpt: dict) -> dict:
    """A retrieval checkpoint → ``RetrievalHead(**out)`` keyword arguments
    (numpy arrays and scalars).  ``ckpt['model']``: the retrieval model's
    state_dict (the ``backbone.*`` keys are skipped): the ``prewhiten`` and
    ``postwhiten`` affines, the projector's Linears at ``projector.{i}``
    (activations hold no parameters, so the indices may be sparse);
    ``ckpt['args'].residual``; ``ckpt['asmk_codebook']``: the centroids;
    ``ckpt['asmk_params']``: ``alpha`` and ``similarity_threshold``
    (under ``similarity`` or at the top).  Any other model key raises."""
    def arr(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) \
            else np.asarray(v)

    args = ckpt.get("args")
    sd = {k: arr(v) for k, v in ckpt["model"].items()
          if not k.startswith("backbone")}
    out: dict = {}

    def affine(prefix):
        if f"{prefix}.weight" not in sd:
            return None
        W = t(sd.pop(f"{prefix}.weight"))
        b = sd.pop(f"{prefix}.bias", np.zeros(W.shape[1], np.float32))
        return (W, np.asarray(b))

    pw = affine("prewhiten")
    if pw is not None:
        out["prewhiten"] = pw
    idx = sorted({int(re.match(r"projector\.(\d+)\.", k).group(1))
                  for k in sd if k.startswith("projector.")})
    out["projector"] = tuple((t(sd.pop(f"projector.{i}.weight")),
                              sd.pop(f"projector.{i}.bias")) for i in idx)
    pw = affine("postwhiten")
    if pw is not None:
        out["postwhiten"] = pw
    if args is not None:
        out["residual"] = bool(getattr(args, "residual", False))
    if sd:
        raise ValueError(f"unmapped retrieval model keys: {sorted(sd)}")

    cb = ckpt.get("asmk_codebook")
    if cb is not None:
        cent = cb.get("centroids") if isinstance(cb, dict) else cb
        out["codebook"] = np.asarray(arr(cent), np.float32)
    params = ckpt.get("asmk_params") or {}
    sim = params.get("similarity", params) if isinstance(params, dict) \
        else {}
    out["alpha"] = float(sim.get("alpha", 3.0))
    out["similarity_threshold"] = float(sim.get("similarity_threshold", 0.0))
    return out
