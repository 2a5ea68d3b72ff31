"""Bidirectional masked-LM encoder, RoBERTa / BERT / XLM style (counterpart
of chimera_st_tpu/models/masked_lm.py; fairseq ``models/masked_lm.py`` and
``models/roberta``): token embeddings plus sinusoidal positions, an
embedding LayerNorm, a post-norm ``TransformerEncoderLayer`` stack, and the
RoBERTa LM head (dense, activation, LayerNorm, the tied projection plus
``lm_head_bias``, logits in fp32). With ``sentence_class_num`` > 0 (the
``bert*`` presets) a next-sentence head projects the first token's state.

The positions are sinusoidal, as in the JAX model (fairseq's RoBERTa learns
them): neither package loads a released RoBERTa checkpoint (ROADMAP C).
Attention dropout is the model's ``dropout``, as in JAX, so each layer's
self-attention runs K1 in evaluation and the plain path in a training
micro-batch with dropout > 0.

Module names: ``embed_tokens``, ``emb_layer_norm``, ``layers.{i}``,
``lm_head_dense``, ``lm_head_layer_norm``, ``lm_head_bias`` and
``sentence_projection`` (the ``masked_lm`` table of ``convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.attention import dropout
from .embedding import Embed
from .layers import (LayerNorm, TransformerEncoderLayer, get_activation, linear,
                     positional_embedding_from_mask)
from .transformer_mt import _config


@dataclass(frozen=True)
class MaskedLMConfig:
    vocab_size: int = 8
    padding_idx: int = 1
    embed_dim: int = 768
    ffn_dim: int = 3072
    layers: int = 12
    heads: int = 12
    normalize_before: bool = False  # roberta / bert: post-norm
    activation: str = "gelu"
    dropout: float = 0.1
    max_positions: int = 512
    sentence_class_num: int = 0  # > 0: the next-sentence head


class MaskedLMModel(nn.Module):
    def __init__(self, cfg: MaskedLMConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        self.embed_tokens = Embed(c.vocab_size, c.embed_dim, padding_idx=c.padding_idx,
                                  device=device)
        self.emb_layer_norm = LayerNorm(c.embed_dim, device=device)
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(c.embed_dim, c.ffn_dim, c.heads, activation=c.activation,
                                    normalize_before=c.normalize_before, dropout=c.dropout,
                                    attention_dropout=c.dropout, device=device)
            for _ in range(c.layers)])
        self.lm_head_dense = linear(c.embed_dim, c.embed_dim, device=device)
        self.lm_head_layer_norm = LayerNorm(c.embed_dim, device=device)
        self.lm_head_bias = nn.Parameter(torch.zeros(c.vocab_size, device=device))
        if c.sentence_class_num > 0:
            self.sentence_projection = linear(c.embed_dim, c.sentence_class_num, device=device)
        self.act = get_activation(c.activation)

    def encode(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T] -> (final states [B, T, C], padding mask [B, T])."""
        c = self.cfg
        pad_mask = tokens == c.padding_idx
        x = self.embed_tokens(tokens)
        x = x + positional_embedding_from_mask(pad_mask, c.embed_dim, c.padding_idx).to(x.dtype)
        x = dropout(self.emb_layer_norm(x), c.dropout if self.training else 0.0, generator)
        for layer in self.layers:
            x = layer(x, encoder_padding_mask=pad_mask, generator=generator)
        return x, pad_mask

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The LM head over final states -> fp32 logits [B, T, V]."""
        h = self.lm_head_layer_norm(self.act(self.lm_head_dense(x)))
        return self.embed_tokens.attend(h) + self.lm_head_bias.float()

    def forward(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """[B, T] -> masked-LM logits [B, T, V] (fp32)."""
        return self.lm_logits(self.encode(tokens, generator)[0])

    def classify_sentence(self, tokens: torch.Tensor,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Next-sentence logits [B, C] (fp32) from the first token's state."""
        x, _ = self.encode(tokens, generator)
        return self.sentence_projection(x[:, 0]).float()

    def forward_with_sentence(self, tokens: torch.Tensor,
                              generator: Optional[torch.Generator] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One encoder pass -> (masked-LM logits [B, T, V], next-sentence
        logits [B, C]), both fp32."""
        x, _ = self.encode(tokens, generator)
        return self.lm_logits(x), self.sentence_projection(x[:, 0]).float()


def build_masked_lm(cfg_dict: Dict, device="cuda") -> MaskedLMModel:
    d = dict(cfg_dict)
    d.setdefault("vocab_size", d.pop("tgt_vocab_size", 8))
    return MaskedLMModel(_config(MaskedLMConfig, d), device=device)


# ---- presets (JAX masked_lm.py:125-246)

def _widths(embed: int, ffn: int, layers: int, heads: int, **extra):
    def preset(cfg: Dict) -> Dict:
        d = dict(cfg)
        for k, v in (("embed_dim", embed), ("ffn_dim", ffn), ("layers", layers),
                     ("heads", heads), *extra.items()):
            d.setdefault(k, v)
        return d
    return preset


roberta_base = _widths(768, 3072, 12, 12)
roberta_large = _widths(1024, 4096, 24, 16)
xlm = _widths(1280, 1280 * 4, 16, 16)
masked_lm_base = _widths(1024, 4096, 6, 8)
bert_base = _widths(768, 3072, 12, 12, activation="gelu", sentence_class_num=2)
xlm_base = _widths(1024, 4096, 6, 8, activation="gelu", sentence_class_num=0)


def bert_large(cfg: Dict) -> Dict:
    return bert_base(_widths(1024, 4096, 24, 16)(cfg))


# the model names: ``roberta`` is the masked-LM encoder under the hub;
# ``camembert`` and ``xlmr`` differ from it only by their released
# tokenizers
MODEL_BUILDERS = {name: build_masked_lm for name in ("masked_lm", "roberta", "camembert", "xlmr")}
# arch name -> (model name, preset)
ARCHITECTURES = {
    "roberta_base": ("masked_lm", roberta_base),
    "roberta_large": ("masked_lm", roberta_large),
    "roberta": ("roberta", roberta_base),
    "camembert": ("roberta", roberta_base),
    "xlmr": ("roberta", roberta_large),
    "xlm": ("roberta", xlm),
    "masked_lm": ("masked_lm", masked_lm_base),
    "bert_base": ("masked_lm", bert_base),
    "bert_large": ("masked_lm", bert_large),
    "xlm_base": ("masked_lm", xlm_base),
}
