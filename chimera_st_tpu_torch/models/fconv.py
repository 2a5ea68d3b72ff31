"""Convolutional seq2seq and its language model (counterpart of
chimera_st_tpu/models/fconv.py; fairseq ``fconv.py`` / ``fconv_lm.py``,
"Convolutional Sequence to Sequence Learning"): GLU convolution stacks with
sqrt(0.5)-scaled residuals, multi-step attention in every decoder layer,
learned positions.

``GLUConv`` is, as in the JAX package, a dense layer over the K shifted
views of the input (K-major, channel-minor), without fairseq's weight
norm: its ``conv`` weight [2 C_out, K C_in] is that dense layer's. The port
runs it as one ``F.conv1d`` over the padded input with the same weight
seen as [2 C_out, C_in, K], which computes the same sum.

Module names follow the JAX modules (the ``fconv`` and ``fconv_lm``
tables of ``convert.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import NEG_INF, dropout
from .conv_attention import pad_for_views
from .embedding import Embed
from .layers import linear
from .transformer_mt import _config, preset

SQRT_HALF = math.sqrt(0.5)


@dataclass(frozen=True)
class FConvConfig:
    src_vocab_size: int = 8
    tgt_vocab_size: int = 8
    padding_idx: int = 1
    embed_dim: int = 512
    # (channels, kernel) per layer
    encoder_layers: Tuple[Tuple[int, int], ...] = ((512, 3),) * 20
    decoder_layers: Tuple[Tuple[int, int], ...] = ((512, 3),) * 20
    decoder_out_embed_dim: int = 256
    dropout: float = 0.1
    max_positions: int = 1024


class GLUConv(nn.Module):
    """Conv -> GLU over 2x channels (one layer of the fconv stack)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, causal: bool,
                 device="cuda"):
        super().__init__()
        self.in_channels, self.kernel_size, self.causal = in_channels, kernel_size, causal
        self.conv = linear(kernel_size * in_channels, 2 * out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        K, C = self.kernel_size, self.in_channels
        w = self.conv.weight.reshape(-1, K, C).transpose(1, 2)  # [2 C_out, C_in, K]
        xp = pad_for_views(x, K, self.causal).transpose(1, 2)
        y = F.conv1d(xp, w.to(x.dtype), self.conv.bias.to(x.dtype)).transpose(1, 2)
        return F.glu(y, dim=-1)


def learned_positions(tokens: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """fairseq's position ids: 1 + the count of real tokens so far past
    ``padding_idx``, a pad at ``padding_idx``."""
    nonpad = (tokens != padding_idx).long()
    return torch.cumsum(nonpad, dim=1) * nonpad + padding_idx


def _stack(layers, causal: bool, device) -> nn.ModuleList:
    chans = [layers[0][0]] + [ch for ch, _ in layers]
    return nn.ModuleList([GLUConv(chans[i], ch, k, causal, device=device)
                          for i, (ch, k) in enumerate(layers)])


def run_convs(x: torch.Tensor, convs, pad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The residual GLU stack: pads zeroed before each conv (encoder), the
    residual added and scaled where the width stays."""
    for conv in convs:
        residual = x
        if pad is not None:
            x = x.masked_fill(pad[:, :, None], 0.0)
        x = conv(x)
        if x.shape[-1] == residual.shape[-1]:
            x = (x + residual) * SQRT_HALF
    return x


def multistep_attention(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                        enc_pad: torch.Tensor) -> torch.Tensor:
    """fconv's attention: softmax(q . keys) over the real source positions
    (a pad's score -1e8), values averaged and scaled by sqrt(source
    length)."""
    scores = torch.einsum("btc,bsc->bts", q, keys).masked_fill(enc_pad[:, None, :], NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    ctx = torch.einsum("bts,bsc->btc", w, values)
    s = (~enc_pad).sum(dim=1, keepdim=True).to(ctx.dtype)
    return ctx * torch.sqrt(torch.clamp(s, min=1.0))[:, :, None]


class FConvModel(nn.Module):
    def __init__(self, cfg: FConvConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        n_pos = c.max_positions + c.padding_idx + 1
        self.src_embed = Embed(c.src_vocab_size, c.embed_dim, c.padding_idx, device=device)
        self.tgt_embed = Embed(c.tgt_vocab_size, c.embed_dim, c.padding_idx, device=device)
        self.src_pos = Embed(n_pos, c.embed_dim, c.padding_idx, device=device)
        self.tgt_pos = Embed(n_pos, c.embed_dim, c.padding_idx, device=device)
        self.enc_proj_in = linear(c.embed_dim, c.encoder_layers[0][0], device=device)
        self.enc_conv = _stack(c.encoder_layers, False, device)
        self.enc_proj_out = linear(c.encoder_layers[-1][0], c.embed_dim, device=device)
        self.dec_proj_in = linear(c.embed_dim, c.decoder_layers[0][0], device=device)
        self.dec_conv = _stack(c.decoder_layers, True, device)
        self.attn_q = nn.ModuleList([linear(ch, c.embed_dim, device=device)
                                     for ch, _ in c.decoder_layers])
        self.attn_o = nn.ModuleList([linear(c.embed_dim, ch, device=device)
                                     for ch, _ in c.decoder_layers])
        self.dec_proj_out = linear(c.decoder_layers[-1][0], c.decoder_out_embed_dim,
                                   device=device)
        self.out_proj = linear(c.decoder_out_embed_dim, c.tgt_vocab_size, device=device)

    def _p(self) -> float:
        return self.cfg.dropout if self.training else 0.0

    def encode_text(self, src_tokens: torch.Tensor, generator=None):
        """-> ((attention keys, values) [B, S, E], padding mask [B, S])."""
        c = self.cfg
        pad = src_tokens == c.padding_idx
        x = self.src_embed(src_tokens) + self.src_pos(learned_positions(src_tokens,
                                                                         c.padding_idx))
        x = dropout(x, self._p(), generator)
        input_embed = x
        x = self.enc_proj_out(run_convs(self.enc_proj_in(x), self.enc_conv, pad))
        return (x, (x + input_embed) * SQRT_HALF), pad

    def decode(self, prev_output_tokens, keys, values, enc_pad, generator=None):
        c = self.cfg
        y = self.tgt_embed(prev_output_tokens) + self.tgt_pos(
            learned_positions(prev_output_tokens, c.padding_idx))
        target_embed = y = dropout(y, self._p(), generator)
        y = self.dec_proj_in(y)
        for conv, attn_q, attn_o in zip(self.dec_conv, self.attn_q, self.attn_o):
            residual = y
            y = conv(y)
            q = (attn_q(y) + target_embed) * SQRT_HALF
            y = y + attn_o(multistep_attention(q, keys, values, enc_pad))
            if y.shape[-1] == residual.shape[-1]:
                y = (y + residual) * SQRT_HALF
        y = dropout(self.dec_proj_out(y), self._p(), generator)
        return self.out_proj(y).float()

    def forward(self, src_tokens, prev_output_tokens, generator=None) -> torch.Tensor:
        (keys, values), enc_pad = self.encode_text(src_tokens, generator)
        return self.decode(prev_output_tokens, keys, values, enc_pad, generator)

    def forward_text_with_internal(self, src_tokens, prev_output_tokens, generator=None):
        """-> (logits [B, T, V] fp32, the encoder's attention keys)."""
        (keys, values), enc_pad = self.encode_text(src_tokens, generator)
        return self.decode(prev_output_tokens, keys, values, enc_pad, generator), keys


@dataclass(frozen=True)
class FConvLMConfig:
    vocab_size: int = 8
    padding_idx: int = 1
    embed_dim: int = 128
    layers: Tuple[Tuple[int, int], ...] = ((1268, 4),) * 13
    out_embed_dim: int = 128
    dropout: float = 0.1
    max_positions: int = 1024


class FConvLM(nn.Module):
    """The fconv decoder stack without attention, as a language model."""

    def __init__(self, cfg: FConvLMConfig, device="cuda", output_layer: bool = True):
        super().__init__()
        self.cfg = c = cfg
        self.embed = Embed(c.vocab_size, c.embed_dim, c.padding_idx, device=device)
        self.pos = Embed(c.max_positions + c.padding_idx + 1, c.embed_dim, c.padding_idx,
                         device=device)
        self.proj_in = linear(c.embed_dim, c.layers[0][0], device=device)
        self.conv = _stack(c.layers, True, device)
        self.proj_out = linear(c.layers[-1][0], c.out_embed_dim, device=device)
        if output_layer:  # fconv_self_att's nested LM reads only its features
            self.out = linear(c.out_embed_dim, c.vocab_size, device=device)

    def _p(self) -> float:
        return self.cfg.dropout if self.training else 0.0

    def features(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        """Pre-vocabulary states [B, T, out_embed_dim] (what fconv_self_att's
        pretrained-LM gating reads)."""
        c = self.cfg
        x = self.embed(tokens) + self.pos(learned_positions(tokens, c.padding_idx))
        x = self.proj_in(dropout(x, self._p(), generator))
        return self.proj_out(run_convs(x, self.conv))

    def forward(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        """[B, T] -> logits [B, T, V] (fp32)."""
        x = dropout(self.features(tokens, generator), self._p(), generator)
        return self.out(x).float()


def _layers(d: Dict, *keys: str) -> Dict:
    for key in keys:
        if d.get(key):
            d[key] = tuple(tuple(x) for x in d[key])
    return d


def build_fconv(cfg_dict: Dict, device="cuda") -> FConvModel:
    return FConvModel(_config(FConvConfig, _layers(dict(cfg_dict), "encoder_layers",
                                                   "decoder_layers")), device=device)


def build_fconv_lm(cfg_dict: Dict, device="cuda") -> FConvLM:
    return FConvLM(_config(FConvLMConfig, _layers(dict(cfg_dict), "layers")), device=device)


# ---- presets (JAX fconv.py:193-321)


_WMT_EN_FR = ((512, 3),) * 6 + ((768, 3),) * 4 + ((1024, 3),) * 3 + ((2048, 1),) + ((4096, 1),)
_WMT_EN_DE = ((512, 3),) * 9 + ((1024, 3),) * 4 + ((2048, 1),) * 2
_DAUPHIN_GBW = ((512, 5),) + ((128, 1), (128, 5), (512, 1)) * 3 \
    + ((512, 1), (512, 5), (1024, 1)) * 3 + ((1024, 1), (1024, 5), (2048, 1)) * 6 \
    + ((1024, 1), (1024, 5), (4096, 1))
_DAUPHIN_WIKITEXT103 = ((850, 6),) * 3 + ((850, 1),) + ((850, 5),) * 4 + ((850, 1),) \
    + ((850, 4),) * 3 + ((1024, 4),) + ((2048, 4),)

MODEL_BUILDERS = {"fconv": build_fconv, "fconv_lm": build_fconv_lm}
ARCHITECTURES = {
    "fconv": ("fconv", preset()),
    "fconv_iwslt_de_en": ("fconv", preset(embed_dim=256, encoder_layers=((256, 3),) * 4,
                                           decoder_layers=((256, 3),) * 3,
                                           decoder_out_embed_dim=256)),
    "fconv_wmt_en_de": ("fconv", preset(embed_dim=768, encoder_layers=_WMT_EN_DE,
                                         decoder_layers=_WMT_EN_DE, decoder_out_embed_dim=512)),
    "fconv_wmt_en_ro": ("fconv", preset(decoder_out_embed_dim=512)),
    "fconv_wmt_en_fr": ("fconv", preset(embed_dim=768, encoder_layers=_WMT_EN_FR,
                                         decoder_layers=_WMT_EN_FR, decoder_out_embed_dim=512)),
    "fconv_lm": ("fconv_lm", preset()),
    "fconv_lm_dauphin_wikitext103": ("fconv_lm", preset(embed_dim=280,
                                                         layers=_DAUPHIN_WIKITEXT103,
                                                         out_embed_dim=280)),
    # the reference's 3-tuples carry a residual-skip distance; the JAX build
    # uses distance-1 residuals throughout, so the layers are (channels,
    # kernel) pairs
    "fconv_lm_dauphin_gbw": ("fconv_lm", preset(embed_dim=128, layers=_DAUPHIN_GBW)),
}
