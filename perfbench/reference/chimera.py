"""Plain reference of the Chimera interlingua model
(``s2t_transformer_w2v2_interlingua``), written from the published
description (Han et al., 2021; fairseq's wav2vec 2.0 and S2T Transformer)
and the quirks the port keeps from the reference code:

- the wav2vec 2.0 trunk: a conv extractor (layer 0 with a per-channel norm
  over the whole padded time axis, GELU after every layer, no conv bias), a
  LayerNorm and projection of the features, a grouped positional conv
  (SamePad trim, GELU), post-LN layers; a frame is padding where all of its
  block of samples is;
- the Conv1d subsampler with GLU; sqrt(D) scales the subsampled audio too;
  sinusoidal positions only on the text branch; pre-LN shared layers;
- M memory slots (slot 0 reads as zero) refined by the interlingua layers:
  each attends, with its own self-attention weights, from the slots to the
  encoder states, padded positions included;
- the pre-LN decoder over the memory bank (no mask), the output projection
  tied to the embeddings, the padding logit 0.

Weights come as {fairseq name: fp32 tensor}. ``drop`` draws the dropout
masks (``nn.seeded_dropout``) in the program's order of sites; the default
is none (evaluation).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .nn import Block, Dropout, Precision, channel_norm, embed, layer_norm, no_dropout, positions

PAD = 1


def downsample_mask(pad_mask: torch.Tensor, frames: int) -> torch.Tensor:
    """A frame is padding where every sample of its block is (the remainder
    of the samples dropped)."""
    B, T = pad_mask.shape
    extra = T % frames
    if extra:
        pad_mask = pad_mask[:, :-extra]
    return pad_mask.reshape(B, frames, -1).all(dim=-1)


def subsampled(lengths, layers: int):
    for _ in range(layers):
        lengths = torch.div(lengths - 1, 2, rounding_mode="floor") + 1
    return lengths


class ChimeraReference:
    def __init__(self, W: Dict[str, torch.Tensor], m: Dict, prec: Precision):
        self.W, self.m, self.prec = W, m, prec
        self.act = F.relu if m["activation"] == "relu" else F.gelu

    # ------------------------------------------------------------ trunk

    def trunk(self, wav, pad_mask, drop: Dropout):
        m, W, P = self.m, self.W, self.prec
        pre = "encoder.wav2vec_model"
        x = wav[:, None, :]
        for i, (_, k, s) in enumerate(m["w2v2_conv_spec"]):
            x = P.conv1d(x, W[f"{pre}.feature_extractor.conv_layers.{i}.0.weight"], stride=s)
            if i == 0:
                x = channel_norm(x, W[f"{pre}.feature_extractor.conv_layers.0.2.weight"],
                                 W[f"{pre}.feature_extractor.conv_layers.0.2.bias"])
            x = F.gelu(x)
        x = layer_norm(x.transpose(1, 2), W[f"{pre}.layer_norm.weight"],
                       W[f"{pre}.layer_norm.bias"])
        pad = downsample_mask(pad_mask, x.shape[1])
        x = P.linear(x, W[f"{pre}.post_extract_proj.weight"], W[f"{pre}.post_extract_proj.bias"])
        x = drop(x, m["w2v2_dropout"])
        x = x.masked_fill(pad[:, :, None], 0.0)
        k = m["w2v2_conv_pos"]
        pc = P.conv1d(x.transpose(1, 2), W[f"{pre}.encoder.pos_conv.0.weight"],
                      W[f"{pre}.encoder.pos_conv.0.bias"], padding=k // 2,
                      groups=m["w2v2_conv_pos_groups"])
        if k % 2 == 0:
            pc = pc[:, :, :-1]
        x = x + F.gelu(pc).transpose(1, 2)
        x = layer_norm(x, W[f"{pre}.encoder.layer_norm.weight"], W[f"{pre}.encoder.layer_norm.bias"])
        x = drop(x, m["w2v2_dropout"])
        for i in range(m["w2v2_layers"]):
            b = Block(W, f"{pre}.encoder.layers.{i}", m["w2v2_heads"], P)
            h = b.mha("self_attn", x, key_pad=pad, p=m["w2v2_attention_dropout"], drop=drop)
            x = b.ln("self_attn_layer_norm", x + drop(h, m["w2v2_dropout"]))
            h = b.ffn(x, F.gelu, m["w2v2_activation_dropout"], drop)
            x = b.ln("final_layer_norm", x + drop(h, m["w2v2_dropout"]))
        return x, pad

    # ---------------------------------------------------------- encoder

    def subsample(self, x, prefix="encoder.subsample"):
        x = x.transpose(1, 2)
        for i, k in enumerate(self.m["conv_kernel_sizes"]):
            x = F.glu(self.prec.conv1d(x, self.W[f"{prefix}.conv_layers.{i}.weight"],
                                       self.W[f"{prefix}.conv_layers.{i}.bias"], stride=2,
                                       padding=k // 2), dim=1)
        return x.transpose(1, 2)

    def pre_ln_layer(self, b: Block, x, key_pad, drop: Dropout):
        m = self.m
        h = b.mha("self_attn", b.ln("self_attn_layer_norm", x), key_pad=key_pad,
                  p=m["attention_dropout"], drop=drop)
        x = x + drop(h, m["dropout"])
        h = b.ffn(b.ln("final_layer_norm", x), self.act, m["activation_dropout"], drop)
        return x + drop(h, m["dropout"])

    def shared(self, x, pad, drop: Dropout):
        """The shared stack and the interlingua -> the memory bank [B, M, D]."""
        m, W = self.m, self.W
        x = drop(x, m["dropout"])
        for i in range(m["encoder_layers"]):
            x = self.pre_ln_layer(Block(W, f"encoder.transformer_layers.{i}", m["encoder_heads"],
                                        self.prec), x, pad, drop)
        x = layer_norm(x, W["encoder.layer_norm.weight"], W["encoder.layer_norm.bias"])
        table = W["encoder.interlingua_embedding.weight"].clone()
        table[0] = 0.0
        mem = table[None].expand(x.shape[0], -1, -1)
        for i in range(m["interlingua_layers"]):
            b = Block(W, f"encoder.interlingua_layers.{i}", m["encoder_heads"], self.prec)
            keys = b.ln("self_attn_layer_norm", x)
            h = b.mha("self_attn", b.ln("self_attn_layer_norm", mem), kv=keys,
                      p=m["attention_dropout"], drop=drop)
            mem = mem + drop(h, m["dropout"])
            h = b.ffn(b.ln("final_layer_norm", mem), self.act, m["activation_dropout"], drop)
            mem = mem + drop(h, m["dropout"])
        return mem

    def encode_audio(self, wav, pad_mask, drop: Dropout = no_dropout):
        """-> (the memory bank [B, M, D], None: no slot is padding)."""
        x, pad = self.trunk(wav, pad_mask, drop)
        x = self.subsample(x)
        lengths = subsampled((~pad).sum(dim=-1), len(self.m["conv_kernel_sizes"]))
        sub = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None]
        return self.shared(math.sqrt(self.m["encoder_embed_dim"]) * x, sub, drop), None

    def encode_text(self, src, drop: Dropout = no_dropout):
        """-> the memory bank of the text branch."""
        D = self.m["encoder_embed_dim"]
        pad = src == PAD
        x = math.sqrt(D) * embed(self.W["encoder.text_embed_tokens.weight"], src, PAD)
        return self.shared(x + positions(pad, D, PAD), pad, drop)

    # ---------------------------------------------------------- decoder

    def decode(self, prev, mem, mem_pad=None, drop: Dropout = no_dropout):
        """Teacher-forced: prev [B, U] -> fp32 logits [B, U, V]."""
        return decode(self.W, self.m, self.prec, self.act, prev, mem, mem_pad, drop)


def decode(W, m, prec: Precision, act, prev, mem, mem_pad, drop: Dropout):
    """The pre-LN decoder with tied output projection (shared by both
    references)."""
    D = m["decoder_embed_dim"]
    pad = prev == PAD
    table = W["decoder.embed_tokens.weight"]
    x = math.sqrt(D) * embed(table, prev, PAD) + positions(pad, D, PAD)
    x = drop(x, m.get("dropout", 0.0))
    for i in range(m["decoder_layers"]):
        b = Block(W, f"decoder.layers.{i}", m["decoder_heads"], prec)
        h = b.mha("self_attn", b.ln("self_attn_layer_norm", x), key_pad=pad, causal=True,
                  p=m.get("attention_dropout", 0.0), drop=drop)
        x = x + drop(h, m.get("dropout", 0.0))
        h = b.mha("encoder_attn", b.ln("encoder_attn_layer_norm", x), kv=mem, key_pad=mem_pad,
                  p=m.get("attention_dropout", 0.0), drop=drop)
        x = x + drop(h, m.get("dropout", 0.0))
        h = b.ffn(b.ln("final_layer_norm", x), act, m.get("activation_dropout", 0.0), drop)
        x = x + drop(h, m.get("dropout", 0.0))
    x = layer_norm(x, W["decoder.layer_norm.weight"], W["decoder.layer_norm.bias"])
    logits = prec.linear(x, table)
    logits[..., PAD] = 0.0
    return logits
