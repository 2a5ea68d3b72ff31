"""Chimera interlingua speech/text encoder-decoder (counterpart of
chimera_st_tpu/models/interlingua.py), for inference and the triplet
fine-tune: ``forward_audio_with_internal`` / ``forward_text_with_internal``
return the logits and the memory bank the criterion reads; in training
mode every dropout of the JAX model acts, its masks drawn from the
``generator`` the forward is given.

Audio: wav2vec2 trunk -> Conv1d subsampler -> shared encoder -> M memory
slots refined by the interlingua layers (each a ``cross_only`` pass of the
memory over the encoder states) -> the memory bank is the decoder's
cross-attention input. Kept from the reference:

- ``embed_scale = sqrt(encoder_embed_dim)`` multiplies the subsampled audio
  features too, not only text embeddings;
- memory slot 0 reads as zero (``Embed(M, D, padding_idx=0)``);
- the interlingua layers attend over PADDED encoder positions unless
  ``interlingua_mask_padding`` is set (the reference passes no mask);
- ``non_shared_encoder_layers`` audio-only layers replace the first shared
  layers on the audio path.

Module names follow the fairseq state dict (``encoder.*``, ``decoder.*``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from .embedding import Embed
from .layers import LayerNorm, TransformerEncoderLayer, dropout, positional_embedding_from_mask
from .subsampler import Conv1dSubsampler, subsampled_length
from .transformer_decoder import TransformerDecoder
from .wav2vec2 import DEFAULT_CONV_SPEC, Wav2Vec2Encoder


@dataclass(frozen=True)
class InterlinguaConfig:
    """The fields of the JAX package's InterlinguaConfig that the port
    reads; the defaults are the ``s2t_transformer_w2v2_interlingua_base``
    preset's and, for dropout, ``feature_grad_mult`` and ``w2v2_remat``, the
    JAX package's. ``share_decoder_input_output_embed=False`` gives the
    decoder an ``output_projection`` of its own."""

    # vocab
    tgt_vocab_size: int = 8
    src_vocab_size: Optional[int] = 8  # None: no text branch
    padding_idx: int = 1
    # shared encoder
    encoder_embed_dim: int = 512
    encoder_ffn_dim: int = 2048
    encoder_layers: int = 12
    encoder_heads: int = 8
    encoder_normalize_before: bool = True
    # decoder
    decoder_embed_dim: int = 512
    decoder_ffn_dim: int = 2048
    decoder_layers: int = 6
    decoder_heads: int = 8
    decoder_normalize_before: bool = True
    share_decoder_input_output_embed: bool = True
    max_target_positions: int = 1024
    # interlingua
    interlingua_length: int = 16
    interlingua_layers: int = 3
    non_shared_encoder_layers: int = 0
    no_interlingua: bool = False
    interlingua_mask_padding: bool = False  # True = fix the reference quirk
    modal_embedding: bool = False
    # subsampler
    conv_kernel_sizes: Tuple[int, ...] = (5, 5)
    conv_channels: int = 1024
    # wav2vec2 trunk (base/small)
    w2v2_embed_dim: int = 768
    w2v2_ffn_dim: int = 3072
    w2v2_layers: int = 12
    w2v2_heads: int = 8
    w2v2_conv_spec: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_SPEC
    w2v2_extractor_mode: str = "default"
    w2v2_conv_bias: bool = False
    w2v2_layer_norm_first: bool = False
    w2v2_conv_pos: int = 128
    w2v2_conv_pos_groups: int = 16
    w2v2_remat: bool = False  # recompute the trunk's layers in the backward
    # the trunk's own regularization (from the wav2vec2 checkpoint's args)
    w2v2_dropout: float = 0.1
    w2v2_attention_dropout: float = 0.1
    w2v2_activation_dropout: float = 0.0
    # gradient scale on the conv extractor's output (0: no extractor backward)
    feature_grad_mult: float = 1.0
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation: str = "relu"
    no_scale_embedding: bool = False


class _Encoder(nn.Module):
    """The fairseq ``encoder`` submodule."""

    def __init__(self, c: InterlinguaConfig, device):
        super().__init__()
        self.wav2vec_model = Wav2Vec2Encoder(
            c.w2v2_embed_dim, c.w2v2_ffn_dim, c.w2v2_layers, c.w2v2_heads, c.w2v2_conv_spec,
            c.w2v2_conv_bias, c.w2v2_conv_pos, c.w2v2_conv_pos_groups,
            layer_norm_first=c.w2v2_layer_norm_first, dropout=c.w2v2_dropout,
            attention_dropout=c.w2v2_attention_dropout,
            activation_dropout=c.w2v2_activation_dropout,
            feature_grad_mult=c.feature_grad_mult, remat=c.w2v2_remat,
            extractor_mode=c.w2v2_extractor_mode, device=device,
        )
        self.subsample = Conv1dSubsampler(c.w2v2_embed_dim, c.conv_channels, c.encoder_embed_dim,
                                          c.conv_kernel_sizes, device=device)
        if c.src_vocab_size is not None:
            self.text_embed_tokens = Embed(c.src_vocab_size, c.encoder_embed_dim,
                                           padding_idx=c.padding_idx, device=device)

        def mk_layers(n):
            return nn.ModuleList([
                TransformerEncoderLayer(c.encoder_embed_dim, c.encoder_ffn_dim, c.encoder_heads,
                                        c.activation, c.encoder_normalize_before, c.dropout,
                                        c.attention_dropout, c.activation_dropout, device=device)
                for _ in range(n)
            ])

        self.transformer_layers = mk_layers(c.encoder_layers)
        if c.non_shared_encoder_layers > 0:
            self.audio_exclusive_layers = mk_layers(c.non_shared_encoder_layers)
        if c.encoder_normalize_before:
            self.layer_norm = LayerNorm(c.encoder_embed_dim, device=device)
        if not c.no_interlingua:
            # reference quirk: slot 0 pinned to zero
            self.interlingua_embedding = Embed(c.interlingua_length, c.encoder_embed_dim,
                                               padding_idx=0, device=device)
            self.interlingua_layers = mk_layers(c.interlingua_layers)
        if c.modal_embedding:
            self.modal_embedding = Embed(3, c.encoder_embed_dim, padding_idx=2, device=device)


class ChimeraInterlinguaModel(nn.Module):
    def __init__(self, cfg: InterlinguaConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        self.encoder = _Encoder(cfg, device)
        self.decoder = TransformerDecoder(
            c.tgt_vocab_size, c.decoder_embed_dim, c.decoder_ffn_dim, c.decoder_layers,
            c.decoder_heads, c.activation, c.decoder_normalize_before, c.padding_idx,
            c.no_scale_embedding, c.max_target_positions, c.dropout, c.attention_dropout,
            c.activation_dropout, share_input_output_embed=c.share_decoder_input_output_embed,
            device=device,
        )
        self.embed_scale = 1.0 if c.no_scale_embedding else math.sqrt(c.encoder_embed_dim)

    def _shared_encode(self, feature: torch.Tensor, padding_mask: torch.Tensor, is_text: bool,
                       modal_id: int, generator: Optional[torch.Generator] = None):
        """Shared transformer stack + interlingua memory refinement ->
        (memory [B, M, C], None), or (states [B, T, C], padding_mask) with
        ``no_interlingua``."""
        c, enc = self.cfg, self.encoder
        x = self.embed_scale * feature
        if is_text:  # positions only on the text branch, as the reference
            x = x + positional_embedding_from_mask(padding_mask, c.encoder_embed_dim,
                                                   c.padding_idx).to(x.dtype)
        x = dropout(x, c.dropout if self.training else 0.0, generator)
        if is_text or c.non_shared_encoder_layers == 0:
            layers = list(enc.transformer_layers)
        else:
            layers = (list(enc.audio_exclusive_layers)
                      + list(enc.transformer_layers)[c.non_shared_encoder_layers:])
        for layer in layers:
            x = layer(x, padding_mask, generator)
        if c.encoder_normalize_before:
            x = enc.layer_norm(x)
        if c.no_interlingua:
            return x, padding_mask

        B = x.shape[0]
        mem = enc.interlingua_embedding.table()[None].expand(B, -1, -1)
        if c.modal_embedding:
            mem = mem + enc.modal_embedding.table()[modal_id]
        kp_mask = padding_mask if c.interlingua_mask_padding else None
        for layer in enc.interlingua_layers:
            mem = layer.cross_only(mem, x, kp_mask, generator)
        return mem, None  # fixed-length memory bank: nothing is padding

    def encode_audio(self, source: torch.Tensor, padding_mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None):
        """source [B, T] float waveform, padding_mask [B, T] True = pad."""
        feat, w2v_mask = self.encoder.wav2vec_model(source, padding_mask, generator)
        feat = self.encoder.subsample(feat)
        pos = torch.arange(feat.shape[1], device=feat.device)[None, :]
        if w2v_mask is None:
            sub_mask = torch.zeros(feat.shape[:2], dtype=torch.bool, device=feat.device)
        else:
            lengths = subsampled_length((~w2v_mask).sum(dim=-1),
                                        len(self.cfg.conv_kernel_sizes))
            sub_mask = pos >= lengths[:, None]
        return self._shared_encode(feat, sub_mask, is_text=False, modal_id=0,
                                   generator=generator)

    def encode_text(self, src_tokens: torch.Tensor,
                    generator: Optional[torch.Generator] = None):
        """src_tokens [B, T] int."""
        padding_mask = src_tokens == self.cfg.padding_idx
        feat = self.encoder.text_embed_tokens(src_tokens)
        return self._shared_encode(feat, padding_mask, is_text=True, modal_id=1,
                                   generator=generator)

    def decode(self, prev_output_tokens: torch.Tensor, encoder_out: torch.Tensor,
               encoder_padding_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decoder(prev_output_tokens, encoder_out, encoder_padding_mask, generator)

    def forward(self, source, padding_mask, prev_output_tokens,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Speech translation, teacher-forced: raw audio -> logits [B, T, V]."""
        return self.forward_audio_with_internal(source, padding_mask, prev_output_tokens,
                                                generator)[0]

    def forward_audio_with_internal(self, source, padding_mask, prev_output_tokens,
                                    generator: Optional[torch.Generator] = None):
        """-> (logits [B, T, V], memory bank [B, M, C]): the audio pass of
        the triplet criterion."""
        enc, enc_mask = self.encode_audio(source, padding_mask, generator)
        return self.decode(prev_output_tokens, enc, enc_mask, generator), enc

    def forward_text_with_internal(self, src_tokens, prev_output_tokens,
                                   generator: Optional[torch.Generator] = None):
        """-> (logits [B, T, V], memory bank [B, M, C]): the text pass."""
        enc, enc_mask = self.encode_text(src_tokens, generator)
        return self.decode(prev_output_tokens, enc, enc_mask, generator), enc


def init_params_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in the JAX package's initialisers' scales, drawn from
    ``generator`` (for runs without a checkpoint): xavier-uniform linears,
    he-normal convs, normal(0, d^-0.5) embeddings; norms ones/zeros."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
            elif isinstance(m, nn.Conv1d):
                fan_in = m.weight.shape[1] * m.weight.shape[2]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            elif isinstance(m, Embed):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=generator)
            else:
                continue
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        for m in model.modules():  # a module's own initialisers beside these
            if hasattr(m, "init_extra_"):
                m.init_extra_(generator)
    return model
