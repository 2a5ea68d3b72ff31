"""LightConv / DynamicConv translation model (counterpart of
chimera_st_tpu/models/lightconv_mt.py; fairseq ``lightconv.py``): an
encoder of ``ConvAttentionLayer`` blocks, a decoder of causal conv blocks
with encoder-decoder attention and an FFN, sinusoidal positions, the
target table tied to the output by default.

The decoder's attention is cross-attention over the encoder states: it runs
the plain attention path (``MultiheadAttention`` with ``kv``), not K1 and
not K3 (the model has no incremental decoder, as in JAX).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.attention import dropout
from .conv_attention import ConvAttentionLayer
from .embedding import Embed
from .layers import LayerNorm, MultiheadAttention, linear, positional_embedding_from_mask
from .transformer_mt import _config, preset


@dataclass(frozen=True)
class LightConvMTConfig:
    src_vocab_size: int = 8
    tgt_vocab_size: int = 8
    padding_idx: int = 1
    embed_dim: int = 512
    ffn_dim: int = 2048
    encoder_layers: int = 7
    decoder_layers: int = 6
    heads: int = 8
    conv_type: str = "lightweight"  # or "dynamic"
    encoder_kernel_sizes: Tuple[int, ...] = (3, 7, 15, 31, 31, 31, 31)
    decoder_kernel_sizes: Tuple[int, ...] = (3, 7, 15, 31, 31, 31)
    dropout: float = 0.1
    share_decoder_input_output_embed: bool = True
    normalize_before: bool = True


class LightConvDecoderLayer(ConvAttentionLayer):
    """The causal conv block, then encoder attention, then the FFN."""

    def __init__(self, dim: int, ffn_dim: int, kernel_size: int, heads: int, conv_type: str,
                 dropout: float = 0.1, normalize_before: bool = True, device="cuda"):
        super().__init__(dim, ffn_dim, kernel_size, heads, conv_type=conv_type, causal=True,
                         dropout=dropout, normalize_before=normalize_before, device=device)
        self.encoder_attn_layer_norm = LayerNorm(dim, device=device)
        self.encoder_attn = MultiheadAttention(dim, heads, device=device)

    def forward(self, x: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.conv_block(x, None, generator)
        residual = x
        if self.normalize_before:
            x = self.encoder_attn_layer_norm(x)
        x = self.encoder_attn(x, kv=enc, key_padding_mask=enc_mask, generator=generator)
        x = residual + dropout(x, self._p(), generator)
        if not self.normalize_before:
            x = self.encoder_attn_layer_norm(x)
        return self.ffn_block(x, generator)


def _fit(ks, n: int) -> Tuple[int, ...]:
    ks = tuple(ks)
    return ks[:n] if len(ks) >= n else ks + (ks[-1],) * (n - len(ks))


class LightConvModel(nn.Module):
    def __init__(self, cfg: LightConvMTConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        self.embed_tokens = Embed(c.src_vocab_size, c.embed_dim, c.padding_idx, device=device)
        self.tgt_embed_tokens = Embed(c.tgt_vocab_size, c.embed_dim, c.padding_idx,
                                      device=device)
        self.enc = nn.ModuleList([
            ConvAttentionLayer(c.embed_dim, c.ffn_dim, c.encoder_kernel_sizes[i], c.heads,
                               conv_type=c.conv_type, causal=False, dropout=c.dropout,
                               normalize_before=c.normalize_before, device=device)
            for i in range(c.encoder_layers)])
        self.dec = nn.ModuleList([
            LightConvDecoderLayer(c.embed_dim, c.ffn_dim, c.decoder_kernel_sizes[i], c.heads,
                                  c.conv_type, dropout=c.dropout,
                                  normalize_before=c.normalize_before, device=device)
            for i in range(c.decoder_layers)])
        if c.normalize_before:  # the final norms (flax makes them only where they run)
            self.enc_norm = LayerNorm(c.embed_dim, device=device)
            self.dec_norm = LayerNorm(c.embed_dim, device=device)
        if not c.share_decoder_input_output_embed:
            self.output_projection = linear(c.embed_dim, c.tgt_vocab_size, bias=False,
                                            device=device)
        self.embed_scale = math.sqrt(c.embed_dim)

    def _embed(self, table: Embed, tokens: torch.Tensor, generator) -> torch.Tensor:
        c = self.cfg
        pad = tokens == c.padding_idx
        x = self.embed_scale * table(tokens)
        x = x + positional_embedding_from_mask(pad, c.embed_dim, c.padding_idx).to(x.dtype)
        return dropout(x, c.dropout if self.training else 0.0, generator)

    def encode_text(self, src_tokens: torch.Tensor, generator=None):
        """-> (encoder states [B, S, E], padding mask [B, S])."""
        pad = src_tokens == self.cfg.padding_idx
        x = self._embed(self.embed_tokens, src_tokens, generator)
        for layer in self.enc:
            x = layer(x, padding_mask=pad, generator=generator)
        if self.cfg.normalize_before:
            x = self.enc_norm(x)
        return x, pad

    def decode(self, prev_output_tokens, enc, enc_mask, generator=None) -> torch.Tensor:
        x = self._embed(self.tgt_embed_tokens, prev_output_tokens, generator)
        for layer in self.dec:
            x = layer(x, enc, enc_mask, generator)
        if self.cfg.normalize_before:
            x = self.dec_norm(x)
        if self.cfg.share_decoder_input_output_embed:
            return self.tgt_embed_tokens.attend(x)
        return self.output_projection(x).float()

    def forward(self, src_tokens, prev_output_tokens, generator=None) -> torch.Tensor:
        enc, enc_mask = self.encode_text(src_tokens, generator)
        return self.decode(prev_output_tokens, enc, enc_mask, generator)

    def forward_text_with_internal(self, src_tokens, prev_output_tokens, generator=None):
        """-> (logits [B, T, V] fp32, encoder states)."""
        enc, enc_mask = self.encode_text(src_tokens, generator)
        return self.decode(prev_output_tokens, enc, enc_mask, generator), enc


def build_lightconv(cfg_dict: Dict, device="cuda") -> LightConvModel:
    d = dict(cfg_dict)
    # per-layer kernel lists fitted to the layer counts
    d["encoder_kernel_sizes"] = _fit(d.get("encoder_kernel_sizes", (3, 7, 15, 31, 31, 31, 31)),
                                     d.get("encoder_layers", 7))
    d["decoder_kernel_sizes"] = _fit(d.get("decoder_kernel_sizes", (3, 7, 15, 31, 31, 31)),
                                     d.get("decoder_layers", 6))
    return LightConvModel(_config(LightConvMTConfig, d), device=device)


# ---- presets (JAX lightconv_mt.py:200-261)

lightconv_iwslt = preset(embed_dim=512, ffn_dim=1024, encoder_layers=7, decoder_layers=6,
                         heads=4, conv_type="lightweight")
lightconv_wmt_en_de_big = preset(embed_dim=1024, ffn_dim=4096, heads=16, dropout=0.3)


def dynamicconv_iwslt(cfg: Dict) -> Dict:
    return {**lightconv_iwslt(cfg), "conv_type": "dynamic"}


def _big_with_dropout(rate: float):
    def preset(cfg: Dict) -> Dict:
        return lightconv_wmt_en_de_big({"dropout": rate, **cfg})
    return preset


MODEL_BUILDERS = {"lightconv": build_lightconv}
ARCHITECTURES = {
    "lightconv": ("lightconv", dict),
    "lightconv_wmt_en_de": ("lightconv", dict),
    "lightconv_iwslt_de_en": ("lightconv", lightconv_iwslt),
    "dynamicconv_iwslt_de_en": ("lightconv", dynamicconv_iwslt),
    "lightconv_wmt_en_de_big": ("lightconv", lightconv_wmt_en_de_big),
    "lightconv_wmt_en_fr_big": ("lightconv", _big_with_dropout(0.1)),
    "lightconv_wmt_zh_en_big": ("lightconv", _big_with_dropout(0.2)),
}
