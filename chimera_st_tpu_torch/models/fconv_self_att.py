"""Convolutional seq2seq with decoder self-attention and optional
pretrained-LM gating (counterpart of chimera_st_tpu/models/fconv_self_att.py;
fairseq ``fconv_self_att.py``, the stories model): the fconv encoder, a
conv decoder whose layers carry gated encoder attention and downsampled
multi-head self-attention where the per-layer flags say, and, with
``pretrained_lm``, an ``FConvLM`` (at ``FConvLMConfig``'s own widths but
the model's vocabulary and embedding width) whose states are gated into the
decoder's output.

The self-attention is causal over the original positions (key j stands for
position j * downsample) and runs the plain attention arithmetic, as the
JAX model's einsums.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from ..ops.attention import NEG_INF, dropout
from .embedding import Embed
from .fconv import (SQRT_HALF, FConvLM, FConvLMConfig, _layers, _stack, learned_positions,
                    multistep_attention, run_convs)
from .layers import linear
from .transformer_mt import _config, preset


def parse_flags(spec, n: int) -> Tuple[bool, ...]:
    """'True' | 'False' | bool | [bool, ...] -> one flag a layer."""
    if isinstance(spec, (list, tuple)):
        vals = list(spec)
    elif isinstance(spec, str):
        vals = [spec.strip().lower() == "true"]
    else:
        vals = [bool(spec)]
    if len(vals) == 1:
        vals = vals * n
    if len(vals) != n:
        raise ValueError(f"{len(vals)} attention flags for {n} decoder layers")
    return tuple(bool(v) for v in vals)


@dataclass(frozen=True)
class FConvSelfAttConfig:
    src_vocab_size: int = 8
    tgt_vocab_size: int = 8
    padding_idx: int = 1
    embed_dim: int = 512
    encoder_layers: Tuple[Tuple[int, int], ...] = ((512, 3),) * 3
    decoder_layers: Tuple[Tuple[int, int], ...] = ((512, 3),) * 8
    decoder_out_embed_dim: int = 256
    self_attention: Any = False  # bool or one flag a layer
    encoder_attention: Any = True
    self_attention_heads: int = 1
    downsample: int = 1  # key / value stride of the self-attention
    dropout: float = 0.1
    max_positions: int = 1024
    pretrained_lm: bool = False


class DownsampledSelfAttention(nn.Module):
    """Causal multi-head self-attention over every ``downsample``-th state."""

    def __init__(self, embed_dim: int, heads: int = 1, downsample: int = 1, device="cuda"):
        super().__init__()
        self.embed_dim, self.heads, self.downsample = embed_dim, heads, downsample
        self.q_proj = linear(embed_dim, embed_dim, device=device)
        self.k_proj = linear(embed_dim, embed_dim, device=device)
        self.v_proj = linear(embed_dim, embed_dim, device=device)
        self.out_proj = linear(embed_dim, embed_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        H = self.heads
        D = self.embed_dim // H
        kv_src = x[:, ::self.downsample] if self.downsample > 1 else x
        q = self.q_proj(x).reshape(B, T, H, D)
        k = self.k_proj(kv_src).reshape(B, -1, H, D)
        v = self.v_proj(kv_src).reshape(B, -1, H, D)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
        qi = torch.arange(T, device=x.device)[:, None]
        ki = torch.arange(k.shape[1], device=x.device)[None, :] * self.downsample
        probs = torch.softmax(logits.masked_fill(ki > qi, NEG_INF), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, C)
        return self.out_proj(out)


class FConvSelfAttModel(nn.Module):
    def __init__(self, cfg: FConvSelfAttConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        n_dec = len(c.decoder_layers)
        self.enc_attn_flags = parse_flags(c.encoder_attention, n_dec)
        self.self_attn_flags = parse_flags(c.self_attention, n_dec)
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

        def per_layer(flags, make):
            return nn.ModuleDict({str(i): make(ch) for i, ((ch, _), on)
                                  in enumerate(zip(c.decoder_layers, flags)) if on})

        self.attn_q = per_layer(self.enc_attn_flags, lambda ch: linear(ch, c.embed_dim,
                                                                       device=device))
        self.attn_o = per_layer(self.enc_attn_flags, lambda ch: linear(c.embed_dim, ch,
                                                                       device=device))
        self.attn_gate = per_layer(self.enc_attn_flags, lambda ch: linear(c.embed_dim, ch,
                                                                          device=device))
        self.self_attn = per_layer(self.self_attn_flags, lambda ch: DownsampledSelfAttention(
            ch, heads=c.self_attention_heads, downsample=c.downsample, device=device))
        self.dec_proj_out = linear(c.decoder_layers[-1][0], c.decoder_out_embed_dim,
                                   device=device)
        self.out_proj = linear(c.decoder_out_embed_dim, c.tgt_vocab_size, device=device)
        if c.pretrained_lm:
            self.pretrained = FConvLM(FConvLMConfig(vocab_size=c.tgt_vocab_size,
                                                    padding_idx=c.padding_idx,
                                                    embed_dim=c.embed_dim), device=device,
                                      output_layer=False)
            lm_dim = self.pretrained.cfg.out_embed_dim
            self.gate1 = linear(2 * c.decoder_out_embed_dim, c.decoder_out_embed_dim,
                                device=device)
            self.gate2 = linear(2 * c.decoder_out_embed_dim, c.decoder_out_embed_dim,
                                device=device)
            self.lm_proj = linear(lm_dim, c.decoder_out_embed_dim, device=device)

    def _p(self) -> float:
        return self.cfg.dropout if self.training else 0.0

    def encode_text(self, src_tokens: torch.Tensor, generator=None):
        c = self.cfg
        pad = src_tokens == c.padding_idx
        x = self.src_embed(src_tokens) + self.src_pos(learned_positions(src_tokens,
                                                                         c.padding_idx))
        input_embed = x = dropout(x, self._p(), generator)
        x = self.enc_proj_out(run_convs(self.enc_proj_in(x), self.enc_conv, pad))
        return (x, (x + input_embed) * SQRT_HALF), pad

    def decode(self, prev_output_tokens, keys, values, enc_pad, generator=None):
        c = self.cfg
        y = self.tgt_embed(prev_output_tokens) + self.tgt_pos(
            learned_positions(prev_output_tokens, c.padding_idx))
        target_embed = y = dropout(y, self._p(), generator)
        y = self.dec_proj_in(y)
        for i, conv in enumerate(self.dec_conv):
            residual = y
            y = conv(y)
            if self.enc_attn_flags[i]:
                q = (self.attn_q[str(i)](y) + target_embed) * SQRT_HALF
                ctx = multistep_attention(q, keys, values, enc_pad)
                y = y + torch.sigmoid(self.attn_gate[str(i)](ctx)) * self.attn_o[str(i)](ctx)
            if self.self_attn_flags[i]:
                y = y + self.self_attn[str(i)](y)
            if y.shape[-1] == residual.shape[-1]:
                y = (y + residual) * SQRT_HALF
        y = dropout(self.dec_proj_out(y), self._p(), generator)
        if c.pretrained_lm:
            lm_feat = self.lm_proj(self.pretrained.features(prev_output_tokens, generator))
            both = torch.cat([y, lm_feat], dim=-1)
            y = torch.sigmoid(self.gate1(both)) * y + torch.sigmoid(self.gate2(both)) * lm_feat
        return self.out_proj(y).float()

    def forward(self, src_tokens, prev_output_tokens, generator=None) -> torch.Tensor:
        (keys, values), enc_pad = self.encode_text(src_tokens, generator)
        return self.decode(prev_output_tokens, keys, values, enc_pad, generator)

    def forward_text_with_internal(self, src_tokens, prev_output_tokens, generator=None):
        (keys, values), enc_pad = self.encode_text(src_tokens, generator)
        return self.decode(prev_output_tokens, keys, values, enc_pad, generator), keys


def build_fconv_self_att(cfg_dict: Dict, device="cuda") -> FConvSelfAttModel:
    return FConvSelfAttModel(_config(FConvSelfAttConfig, _layers(
        dict(cfg_dict), "encoder_layers", "decoder_layers")), device=device)


MODEL_BUILDERS = {"fconv_self_att": build_fconv_self_att}
ARCHITECTURES = {
    "fconv_self_att": ("fconv_self_att", preset(self_attention=True)),
    # the writing-prompts preset (downsampled single-head attention)
    "fconv_self_att_wp": ("fconv_self_att", preset(
        embed_dim=256, encoder_layers=((128, 3),) * 2 + ((512, 3),),
        decoder_layers=((512, 4),) * 4 + ((768, 4),) * 2, decoder_out_embed_dim=256,
        self_attention=True, self_attention_heads=1, downsample=2)),
}
