"""SigLIP / SigLIP2 text tower (counterpart of
panst3r_tpu/models/siglip_text.py): the HF ``SiglipTextTransformer``
semantics — pre-norm blocks with full (non-causal) attention, tanh-GELU
MLP, LayerNorm eps 1e-6, final LayerNorm, pooling at the LAST position of
the padded sequence, then a linear head.

The attention goes through ``ops/attention.py::flash_attention`` with a
(B, 1, 1, N) finfo.min bias on the pad keys: a bias is never the tiny
branch, so on the card every layer launches K4 (``flash_mha``), which
takes the bias as a per-key row.  The parameters carry the flax names
(``token_embedding``, ``layer_<i>.q_proj``, ...), so a tree from
``port_checkpoint.py::port_siglip_text`` loads through
``weights.py::load_jax_params``.

Tokenization runs on the host: ``tokenize_siglip`` (canonicalize, encode,
EOS, pad with EOS to 64) and ``tokenize_siglip2`` (the Gemma pipeline:
BOS, pad id 0) take any object with ``encode(str) -> list[int]``;
``load_tokenizer`` opens a sentencepiece ``.model`` or an HF
``tokenizer.json``, importing those packages inside the function.
"""
from __future__ import annotations

import dataclasses
import re
import string
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panst3r_torch.core import config as cfg
from panst3r_torch.core.device import resolve_device
from panst3r_torch.ops.attention import NEG_INF, flash_attention


@cfg.register
@dataclasses.dataclass(frozen=True)
class SiglipTextConfig:
    vocab_size: int = 32000
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_positions: int = 64
    eps: float = 1e-6               # HF siglip layer_norm_eps


class _TextBlock(nn.Module):
    def __init__(self, c: SiglipTextConfig):
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

        att = flash_attention(heads(self.q_proj(h)), heads(self.k_proj(h)),
                              heads(self.v_proj(h)), bias=bias)
        x = x + self.out_proj(att.transpose(1, 2).reshape(B, N, C))
        h = self.fc1(self.layer_norm2(x))
        # HF hidden_act=gelu_pytorch_tanh (not the port's GELU policy)
        return x + self.fc2(F.gelu(h, approximate="tanh"))


class SiglipTextTower(nn.Module):
    def __init__(self, config: SiglipTextConfig = SiglipTextConfig()):
        super().__init__()
        c = self.config = config
        self.token_embedding = nn.Parameter(torch.empty(c.vocab_size,
                                                        c.width))
        self.position_embedding = nn.Parameter(torch.empty(c.max_positions,
                                                           c.width))
        for i in range(c.layers):
            setattr(self, f"layer_{i}", _TextBlock(c))
        self.final_layer_norm = nn.LayerNorm(c.width, eps=c.eps)
        self.head = nn.Linear(c.width, c.width)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        """input_ids (B, N) integer (N = max_positions, padded);
        attention_mask (B, N) 1/0.  Returns (pooled (B, width),
        last_hidden (B, N, width))."""
        c = self.config
        N = input_ids.shape[1]
        x = self.token_embedding[input_ids.long()] \
            + self.position_embedding[None, :N]
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                               NEG_INF).to(torch.float32)
        for i in range(c.layers):
            x = getattr(self, f"layer_{i}")(x, bias)
        x = self.final_layer_norm(x)
        # HF pools the LAST position of the padded sequence
        return self.head(x[:, -1]), x


# SigLIP2 (google/siglip2-base-*): the same transformer with the
# multilingual Gemma tokenizer; only the vocabulary and tokenization differ.
SIGLIP2_CONFIG = SiglipTextConfig(vocab_size=256000)


def tokenize_siglip2(texts: Sequence[str], spm, max_len: int = 64,
                     bos_id: int = 2, pad_id: int = 0,
                     add_eos: bool = False):
    """Siglip2Processor's Gemma pipeline: [BOS] + pieces, truncated and
    padded to ``max_len`` with ``pad_id`` (EOS only with ``add_eos``).
    Returns (ids, attention_mask) int32."""
    ids_all, mask_all = [], []
    budget = max_len - 1 - int(add_eos)
    for t in texts:
        ids = [bos_id] + list(spm.encode(t))[:budget]
        if add_eos:
            ids.append(1)
        mask = [1] * len(ids) + [0] * (max_len - len(ids))
        ids_all.append(ids + [pad_id] * (max_len - len(ids)))
        mask_all.append(mask)
    return (np.asarray(ids_all, np.int32), np.asarray(mask_all, np.int32))


_PUNCT = re.compile(f"[{re.escape(string.punctuation)}]")


def canonicalize_text(text: str) -> str:
    """SigLIP canonicalization: strip punctuation, collapse whitespace."""
    text = _PUNCT.sub("", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def tokenize_siglip(texts: Sequence[str], spm, max_len: int = 64,
                    eos_id: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """SiglipTokenizer(padding='max_length', max_length=64): encode the
    canonicalized text, append EOS, pad with EOS (SigLIP's pad is its EOS).
    Returns (input_ids, attention_mask) (B, max_len) int32."""
    ids_all, mask_all = [], []
    for t in texts:
        ids = list(spm.encode(canonicalize_text(t)))[: max_len - 1]
        ids.append(eos_id)
        mask = [1] * len(ids) + [0] * (max_len - len(ids))
        ids_all.append(ids + [eos_id] * (max_len - len(ids)))
        mask_all.append(mask)
    return (np.asarray(ids_all, np.int32), np.asarray(mask_all, np.int32))


def load_tokenizer(path: str):
    """A host tokenizer with ``encode(str) -> list[int]``: an HF
    ``tokenizer.json`` (the ``tokenizers`` package) or a sentencepiece
    ``.model`` (the ``sentencepiece`` package)."""
    if path.endswith(".json"):
        from tokenizers import Tokenizer

        tok = Tokenizer.from_file(path)

        class _Wrap:
            def encode(self, text):
                return tok.encode(text, add_special_tokens=False).ids

        return _Wrap()
    import sentencepiece as sp

    return sp.SentencePieceProcessor(model_file=path)


def tower_from_params(module_cls, config, params: dict, device=None):
    """``module_cls(config)`` on ``device`` (default: the card), filled from
    the flax-named tree ``params``, in eval mode."""
    from panst3r_torch.weights import load_jax_params

    with torch.device("meta"):
        model = module_cls(config)
    model = model.to_empty(device=resolve_device(device))
    return load_jax_params(model, params).eval()


class NativeTextTower:
    """``tower_fn`` for ``models/text_encoder.py::TextEncoder``: prompts →
    pooled embeddings (B, width) f32 numpy, through the SigLIP tower on
    ``device`` (default: the card).  ``tokenizer``: a path (see
    ``load_tokenizer``) or any object with ``encode``."""

    def __init__(self, params: dict, tokenizer,
                 config: SiglipTextConfig = SiglipTextConfig(),
                 device=None):
        self.model = tower_from_params(SiglipTextTower, config, params,
                                       device)
        self.device = next(self.model.parameters()).device
        self.spm = (load_tokenizer(tokenizer) if isinstance(tokenizer, str)
                    else tokenizer)

    @torch.no_grad()
    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        ids, mask = tokenize_siglip(prompts, self.spm)
        pooled, _ = self.model(torch.as_tensor(ids, device=self.device),
                               torch.as_tensor(mask, device=self.device))
        return pooled.float().cpu().numpy()
