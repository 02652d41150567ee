"""CLIP text tower (counterpart of panst3r_tpu/models/clip_text.py): HF
``CLIPTextTransformer`` semantics, the pooled output without the
projection (``openai/clip-vit-base-patch32``'s ``pooler_output``).

- token + learned position embeddings (context 77);
- pre-LN blocks with CAUSAL self-attention plus the padding mask,
  quick_gelu MLP (x * sigmoid(1.702 x)), LayerNorm eps 1e-5;
- final LayerNorm, pooling at the FIRST EOS position of each sequence.

The causal and pad biases are finfo.min each and are added in f32, so a
key both in the future and padded holds -inf, as in the JAX package.  The
attention is the plain ``ops/attention.py::dot_product_attention`` (the
JAX package calls its plain jnp attention here too): no kernel.

Tokenization: CLIP's lowercase byte-BPE with ``</w>`` word ends, read from
a checkpoint's local ``vocab.json`` and ``merges.txt``.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.models.siglip_text import tower_from_params
from panst3r_torch.ops.attention import NEG_INF, dot_product_attention


@cfg.register
@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    mlp_dim: int = 2048
    max_positions: int = 77
    eps: float = 1e-5               # HF clip layer_norm_eps
    eos_id: int = 49407


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class _ClipBlock(nn.Module):
    def __init__(self, c: ClipTextConfig):
        super().__init__()
        self.heads = c.heads
        self.layer_norm1 = nn.LayerNorm(c.width, eps=c.eps)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(c.width, c.width))
        self.layer_norm2 = nn.LayerNorm(c.width, eps=c.eps)
        self.fc1 = nn.Linear(c.width, c.mlp_dim)
        self.fc2 = nn.Linear(c.mlp_dim, c.width)

    def forward(self, x, bias):
        h = self.layer_norm1(x)
        B, N, C = h.shape

        def heads(t):
            return t.reshape(B, N, self.heads, C // self.heads).transpose(1, 2)

        att = dot_product_attention(heads(self.q_proj(h)),
                                    heads(self.k_proj(h)),
                                    heads(self.v_proj(h)), bias=bias)
        x = x + self.out_proj(att.transpose(1, 2).reshape(B, N, C))
        h = self.fc1(self.layer_norm2(x))
        return x + self.fc2(quick_gelu(h))


class ClipTextTower(nn.Module):
    def __init__(self, config: ClipTextConfig = ClipTextConfig()):
        super().__init__()
        c = self.config = config
        self.token_embedding = nn.Parameter(torch.empty(c.vocab_size,
                                                        c.width))
        self.position_embedding = nn.Parameter(torch.empty(c.max_positions,
                                                           c.width))
        for i in range(c.layers):
            setattr(self, f"layer_{i}", _ClipBlock(c))
        self.final_layer_norm = nn.LayerNorm(c.width, eps=c.eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        """input_ids (B, N) integer; attention_mask (B, N) 1/0.  Returns
        (pooled (B, width), last_hidden (B, N, width))."""
        c = self.config
        B, N = input_ids.shape
        dev = input_ids.device
        x = self.token_embedding[input_ids.long()] \
            + self.position_embedding[None, :N]
        bias = torch.triu(torch.full((N, N), NEG_INF, device=dev),
                          diagonal=1)[None, None]
        if attention_mask is not None:
            pad = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                              NEG_INF).to(torch.float32)
            bias = bias + pad           # finfo.min twice: -inf
        for i in range(c.layers):
            x = getattr(self, f"layer_{i}")(x, bias)
        x = self.final_layer_norm(x)
        # the first EOS of each sequence (argmax takes the first maximum)
        eos_pos = (input_ids == c.eos_id).int().argmax(dim=1)
        return x[torch.arange(B, device=dev), eos_pos], x


# --------------------------------------------------------------- tokenizer


def _bytes_to_unicode():
    """GPT-2/CLIP byte↔unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# CLIP's split pattern uses unicode categories (\p{L}, \p{N}), which only
# the `regex` module expresses; the ASCII pattern is for environments
# without it and splits non-ASCII words (e.g. "café") differently from HF.
try:
    import regex as _regex

    _PAT = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE)
except ImportError:  # pragma: no cover
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+",
        re.IGNORECASE)


class ClipTokenizer:
    """CLIP byte-BPE from local ``vocab.json`` + ``merges.txt``."""

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path, encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith("#version")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self._cache: dict[str, list[int]] = {}

    def _bpe(self, token: str) -> list[str]:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        return list(word)

    def encode(self, text: str) -> list[int]:
        text = re.sub(r"\s+", " ", text.lower()).strip()
        ids: list[int] = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            if token not in self._cache:
                self._cache[token] = [self.encoder[t]
                                      for t in self._bpe(token)]
            ids.extend(self._cache[token])
        return ids


def tokenize_clip(texts: Sequence[str], tok: ClipTokenizer,
                  max_len: int = 77) -> tuple[np.ndarray, np.ndarray]:
    """HF CLIPTokenizer(padding=True): BOS + BPE + EOS, the batch padded
    to its longest sequence with EOS (CLIP's pad is its EOS)."""
    seqs = [[tok.bos] + tok.encode(t)[: max_len - 2] + [tok.eos]
            for t in texts]
    longest = max(len(s) for s in seqs)
    ids = np.full((len(seqs), longest), tok.eos, np.int32)
    mask = np.zeros((len(seqs), longest), np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
        mask[i, :len(s)] = 1
    return ids, mask


class NativeClipTower:
    """``tower_fn`` for ``models/text_encoder.py::TextEncoder``: prompts →
    pooled embeddings (B, width) f32 numpy, through the CLIP tower on
    ``device`` (default: the card) and the host byte-BPE."""

    def __init__(self, params: dict, vocab_path: str, merges_path: str,
                 config: ClipTextConfig = ClipTextConfig(), device=None):
        self.model = tower_from_params(ClipTextTower, config, params, device)
        self.device = next(self.model.parameters()).device
        self.tok = ClipTokenizer(vocab_path, merges_path)

    @torch.no_grad()
    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        ids, mask = tokenize_clip(prompts, self.tok)
        pooled, _ = self.model(torch.as_tensor(ids, device=self.device),
                               torch.as_tensor(mask, device=self.device))
        return pooled.float().cpu().numpy()
