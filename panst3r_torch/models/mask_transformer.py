"""Mask2Former-style multi-view query decoder (counterpart of
panst3r_tpu/models/mask_transformer.py), single resolution bucket.

200 learnable queries with a query PE; ``dec_layers`` rounds of [masked
cross-attention over the concatenated multi-view token axis (K3), query
self-attention (plain: 200 queries is the JAX package's tiny-shape jnp
branch), FFN], post-norm (LayerNorm eps 1e-5).  The attention mask comes
from the previous layer's mask prediction against token-grid-resized mask
features (``attn_feats``), sigmoid < 0.5 → blocked, with the fully-blocked
row → unblock fixup.  The mask products run in the wider of the two
dtypes, as jnp.einsum promotes: under amp the v2 head's LoftUp mask
features are f32 while the queries are bf16.  Two-stage query selection
waits for a later slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.models.blocks import merge_heads, split_heads
from panst3r_torch.ops.attention import flash_attention, masked_attention
from panst3r_torch.ops.image import resize

MT_LN_EPS = 1e-5


def sine_position_embedding(gh: int, gw: int, dim: int,
                            device=None) -> torch.Tensor:
    """Normalized 2D sine PE (gh*gw, 2*dim), y-features first, temperature
    10000."""
    temperature = 10000.0
    scale = 2 * math.pi
    eps = 1e-6
    f32 = torch.float32
    y = (torch.arange(gh, dtype=f32, device=device) + 1) / (gh + eps) * scale
    x = (torch.arange(gw, dtype=f32, device=device) + 1) / (gw + eps) * scale
    dim_t = temperature ** (2 * (torch.arange(dim, device=device) // 2)
                            .to(f32) / dim)

    def encode(v):
        ang = v[:, None] / dim_t
        return torch.stack([torch.sin(ang[:, 0::2]), torch.cos(ang[:, 1::2])],
                           dim=-1).reshape(v.shape[0], -1)

    pe_y = encode(y)[:, None].expand(gh, gw, dim)
    pe_x = encode(x)[None].expand(gh, gw, dim)
    return torch.cat([pe_y, pe_x], -1).reshape(gh * gw, 2 * dim)


def pe_with_portrait(gh: int, gw: int, dim: int,
                     portrait: torch.Tensor) -> torch.Tensor:
    """Per-view PE honoring the portrait flag; portrait (B, V) bool →
    (B, V, gh*gw, 2*dim)."""
    dev = portrait.device
    pe_land = sine_position_embedding(gh, gw, dim, dev)
    pe_port = sine_position_embedding(gw, gh, dim, dev).reshape(gw, gh, -1)
    pe_port = pe_port.transpose(0, 1).reshape(gh * gw, -1)
    return torch.where(portrait[..., None, None], pe_port[None, None],
                       pe_land[None, None])


class MHA(nn.Module):
    """torch-style multi-head attention (q/k/v proj + out proj)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, blocked=None):
        H = self.num_heads
        qh = split_heads(self.q_proj(q), H)
        kh = split_heads(self.k_proj(k), H)
        vh = split_heads(self.v_proj(v), H)
        if blocked is not None:
            out = masked_attention(qh, kh, vh, blocked)
        else:
            out = flash_attention(qh, kh, vh)
        return self.out_proj(merge_heads(out))


class QueryMLP(nn.Module):
    """3-layer ReLU MLP."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, hidden)
        self.fc1 = nn.Linear(hidden, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(F.relu(self.fc0(x)))))


@cfg.register
@dataclasses.dataclass(frozen=True)
class MaskTransformerConfig:
    hidden_dim: int = 768
    ff_dim: int = 2048
    mask_dim: int = 256
    num_queries: int = 200
    num_heads: int = 8
    dec_layers: int = 6
    lang_dim: int = 768
    fpn_dims: tuple = (768,)

    @property
    def num_feature_levels(self) -> int:
        return len(self.fpn_dims)


class MaskTransformer(nn.Module):
    def __init__(self, config: MaskTransformerConfig = MaskTransformerConfig()):
        super().__init__()
        c = self.config = config
        d = c.hidden_dim
        self.decoder_norm = nn.LayerNorm(d, eps=MT_LN_EPS)
        self.lang_embed = nn.Linear(d, c.lang_dim)
        self.cls_logit_scale = nn.Parameter(torch.empty(()))
        self.mask_embed = QueryMLP(d, d, c.mask_dim)
        self.level_embed = nn.Parameter(torch.empty(c.num_feature_levels, d))
        for i, fd in enumerate(c.fpn_dims):
            if fd != d:
                setattr(self, f"input_proj_{i}", nn.Conv2d(fd, d, 1))
        self.query_feat = nn.Parameter(torch.empty(c.num_queries, d))
        self.query_embed = nn.Parameter(torch.empty(c.num_queries, d))
        for i in range(c.dec_layers):
            setattr(self, f"cross_attn_{i}", MHA(d, c.num_heads))
            setattr(self, f"cross_norm_{i}", nn.LayerNorm(d, eps=MT_LN_EPS))
            setattr(self, f"self_attn_{i}", MHA(d, c.num_heads))
            setattr(self, f"self_norm_{i}", nn.LayerNorm(d, eps=MT_LN_EPS))
            setattr(self, f"ffn_fc1_{i}", nn.Linear(d, c.ff_dim))
            setattr(self, f"ffn_fc2_{i}", nn.Linear(c.ff_dim, d))
            setattr(self, f"ffn_norm_{i}", nn.LayerNorm(d, eps=MT_LN_EPS))

    def _class_logits(self, dec_out, cls_embeddings):
        lang = self.lang_embed(dec_out)
        lang = lang / (torch.linalg.vector_norm(lang, dim=-1, keepdim=True)
                       + 1e-7)
        return torch.exp(self.cls_logit_scale) * torch.einsum(
            "bqc,nc->bqn", lang, cls_embeddings)

    def prediction_heads(self, output, mask_feats, cls_embeddings,
                         attn_feats=None, need_mask: bool = True):
        """output (B, Q, C); mask_feats (B, V, Hm, Wm, mask_dim);
        attn_feats: token-grid mask features (B, V, gh, gw, mask_dim) or
        None.  Returns (class logits (B, Q, ncls), masks (B, V, Q, Hm, Wm)
        or None, blocked (B, Q, V*gh*gw) bool or None)."""
        dec_out = self.decoder_norm(output)
        outputs_class = self._class_logits(dec_out, cls_embeddings)
        mask_embed = self.mask_embed(dec_out)
        mask_embed = mask_embed.to(torch.promote_types(mask_embed.dtype,
                                                       mask_feats.dtype))
        outputs_mask = None
        if need_mask:
            outputs_mask = torch.einsum("bqc,bvhwc->bvqhw", mask_embed,
                                        mask_feats.to(mask_embed.dtype))
        blocked = None
        if attn_feats is not None:
            am = torch.einsum("bqc,bvhwc->bqvhw", mask_embed,
                              attn_feats.to(mask_embed.dtype))
            B, Q = am.shape[:2]
            blocked = (torch.sigmoid(am) < 0.5).reshape(B, Q, -1)
            all_blocked = blocked.all(dim=-1, keepdim=True)
            blocked = blocked & ~all_blocked
        return outputs_class, outputs_mask, blocked

    def decode_with_queries(self, memory_queries, mask_feats, cls_embeddings):
        """Non-keyframe fast path: prediction heads against frozen
        keyframe queries."""
        ocls, omask, _ = self.prediction_heads(memory_queries, mask_feats,
                                               cls_embeddings)
        return {"pred_logits": ocls, "pred_masks": omask,
                "out_queries": memory_queries}

    def forward(self, fpn_f, mask_feats, cls_embeddings, portrait,
                deep_supervision: bool = True):
        """fpn_f: per-level (B, V, gh, gw, C); mask_feats (B, V, Hm, Wm,
        mask_dim); portrait (B, V) bool."""
        c = self.config
        assert len(fpn_f) == c.num_feature_levels
        B, V, gh, gw, _ = fpn_f[0].shape
        attn_feats = resize(mask_feats, (*mask_feats.shape[:2], gh, gw,
                                         mask_feats.shape[-1]), "bilinear")
        src, pos = [], []
        for lvl, f in enumerate(fpn_f):
            proj = getattr(self, f"input_proj_{lvl}", None)
            if proj is not None:
                f = proj(f.reshape(B * V, gh, gw, -1).permute(0, 3, 1, 2)) \
                    .permute(0, 2, 3, 1).reshape(B, V, gh, gw, -1)
            src.append(f.reshape(B, V * gh * gw, c.hidden_dim)
                       + self.level_embed[lvl])
            pe = pe_with_portrait(gh, gw, c.hidden_dim // 2, portrait)
            pos.append(pe.reshape(B, V * gh * gw, c.hidden_dim).to(f.dtype))

        output = self.query_feat[None].expand(B, -1, -1)
        query_embed = self.query_embed[None].expand(B, -1, -1)
        ocls, omask, blocked = self.prediction_heads(
            output, mask_feats, cls_embeddings, attn_feats,
            need_mask=deep_supervision)
        pred_cls, pred_masks = [ocls], [omask]
        for i in range(c.dec_layers):
            lvl = i % c.num_feature_levels
            attn_out = getattr(self, f"cross_attn_{i}")(
                output + query_embed, src[lvl] + pos[lvl], src[lvl],
                blocked=blocked)
            output = getattr(self, f"cross_norm_{i}")(output + attn_out)
            qe = output + query_embed
            sa = getattr(self, f"self_attn_{i}")(qe, qe, output)
            output = getattr(self, f"self_norm_{i}")(output + sa)
            h = getattr(self, f"ffn_fc2_{i}")(
                F.relu(getattr(self, f"ffn_fc1_{i}")(output)))
            output = getattr(self, f"ffn_norm_{i}")(output + h)
            last = i == c.dec_layers - 1
            ocls, omask, blocked = self.prediction_heads(
                output, mask_feats, cls_embeddings,
                None if last else attn_feats,
                need_mask=deep_supervision or last)
            pred_cls.append(ocls)
            pred_masks.append(omask)
        out = {"pred_logits": pred_cls[-1], "pred_masks": pred_masks[-1],
               "out_queries": output}
        if deep_supervision:
            out["aux_outputs"] = [{"pred_logits": a, "pred_masks": b}
                                  for a, b in zip(pred_cls[:-1],
                                                  pred_masks[:-1])]
        return out
