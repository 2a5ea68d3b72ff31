"""Fbank speech-to-text transformer, inference only (counterpart of
chimera_st_tpu/models/s2t_transformer.py; fairseq's S2TTransformerModel).

80-d log-mel features -> Conv1d+GLU subsampler -> ``sqrt(embed_dim)`` scale
and sinusoidal positions -> transformer encoder (+ final LayerNorm when
pre-LN) -> transformer decoder. With ``compute_fbank=True`` the input is raw
16 kHz wav and the log-mel runs on the device (K4, ``ops/logmel.py``);
frames past a row's last full frame of real samples are masked.

Module names follow the fairseq state dict: ``encoder.subsample.*``,
``encoder.transformer_layers.{i}``, ``encoder.layer_norm``, ``decoder.*``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.logmel import wave_features
from .layers import LayerNorm, TransformerEncoderLayer, positional_embedding_from_mask
from .subsampler import Conv1dSubsampler, subsampled_length
from .transformer_decoder import TransformerDecoder


@dataclass(frozen=True)
class S2TTransformerConfig:
    """The architecture fields of the JAX package's S2TTransformerConfig
    that inference reads (no dropout fields); the defaults are the
    ``s2t_transformer_s`` widths."""

    tgt_vocab_size: int = 8
    padding_idx: int = 1
    input_feat_per_channel: int = 80
    conv_kernel_sizes: Tuple[int, ...] = (5, 5)
    conv_channels: int = 1024
    encoder_embed_dim: int = 256
    encoder_ffn_dim: int = 2048
    encoder_layers: int = 12
    encoder_heads: int = 4
    encoder_normalize_before: bool = True
    decoder_embed_dim: int = 256
    decoder_ffn_dim: int = 2048
    decoder_layers: int = 6
    decoder_heads: int = 4
    decoder_normalize_before: bool = True
    share_decoder_input_output_embed: bool = True
    max_target_positions: int = 1024
    activation: str = "relu"
    no_scale_embedding: bool = False
    compute_fbank: bool = False  # True: input is raw wave, log-mel on the device


class _S2TEncoder(nn.Module):
    """The fairseq ``encoder`` submodule."""

    def __init__(self, c: S2TTransformerConfig, device):
        super().__init__()
        self.subsample = Conv1dSubsampler(c.input_feat_per_channel, c.conv_channels,
                                          c.encoder_embed_dim, c.conv_kernel_sizes, device=device)
        self.transformer_layers = nn.ModuleList([
            TransformerEncoderLayer(c.encoder_embed_dim, c.encoder_ffn_dim, c.encoder_heads,
                                    c.activation, c.encoder_normalize_before, device=device)
            for _ in range(c.encoder_layers)
        ])
        if c.encoder_normalize_before:
            self.layer_norm = LayerNorm(c.encoder_embed_dim, device=device)


class S2TTransformerModel(nn.Module):
    def __init__(self, cfg: S2TTransformerConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        self.encoder = _S2TEncoder(cfg, device)
        self.decoder = TransformerDecoder(
            c.tgt_vocab_size, c.decoder_embed_dim, c.decoder_ffn_dim, c.decoder_layers,
            c.decoder_heads, c.activation, c.decoder_normalize_before, c.padding_idx,
            c.no_scale_embedding, c.max_target_positions,
            share_input_output_embed=c.share_decoder_input_output_embed, device=device,
        )
        self.embed_scale = 1.0 if c.no_scale_embedding else math.sqrt(c.encoder_embed_dim)

    def encode_audio(self, source: torch.Tensor, padding_mask: torch.Tensor):
        """source [B, T, F] log-mel features, or [B, T] float waveform with
        ``compute_fbank``; padding_mask [B, T] True = pad. Returns the
        encoder states [B, T', C] and their padding mask [B, T']."""
        c, enc = self.cfg, self.encoder
        features = source
        if c.compute_fbank:
            features, padding_mask = wave_features(source, padding_mask,
                                                   c.input_feat_per_channel)
        x = enc.subsample(features.to(enc.subsample.conv_layers[0].weight.dtype))
        lengths = subsampled_length((~padding_mask).sum(dim=-1), len(c.conv_kernel_sizes))
        sub_mask = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None]

        x = self.embed_scale * x
        x = x + positional_embedding_from_mask(sub_mask, c.encoder_embed_dim,
                                               c.padding_idx).to(x.dtype)
        for layer in enc.transformer_layers:
            x = layer(x, sub_mask)
        if c.encoder_normalize_before:
            x = enc.layer_norm(x)
        return x, sub_mask

    def decode(self, prev_output_tokens: torch.Tensor, encoder_out: torch.Tensor,
               encoder_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(prev_output_tokens, encoder_out, encoder_padding_mask)

    def forward(self, source, padding_mask, prev_output_tokens) -> torch.Tensor:
        """Teacher-forced: features (or wav) -> fp32 logits [B, T, V]."""
        enc, enc_mask = self.encode_audio(source, padding_mask)
        return self.decode(prev_output_tokens, enc, enc_mask)


# ---- presets (reference s2t_transformer.py:392-478), as in the JAX package:
# each arch's defaults, which a given field overrides

_WIDTHS = ("encoder_embed_dim", "encoder_ffn_dim", "encoder_heads", "decoder_embed_dim",
           "decoder_heads")
_PRESETS: Dict[str, Dict] = {
    # base_architecture: 512-d, 2048 ffn, 12 + 6 layers, 8 heads
    "s2t_transformer": dict(zip(_WIDTHS, (512, 2048, 8, 512, 8)), decoder_ffn_dim=2048),
    "s2t_transformer_s": dict(zip(_WIDTHS, (256, 2048, 4, 256, 4)), decoder_ffn_dim=2048),
    "s2t_transformer_m": dict(zip(_WIDTHS, (512, 2048, 8, 512, 8))),
    "s2t_transformer_l": dict(zip(_WIDTHS, (1024, 4096, 16, 1024, 16))),
}
# the *p variants: 16 encoder layers
_PRESETS.update({f"{arch}p": dict(_PRESETS[arch], encoder_layers=16)
                 for arch in ("s2t_transformer_s", "s2t_transformer_m", "s2t_transformer_l")})


def _preset(defaults: Dict) -> Callable[[Dict], Dict]:
    return lambda cfg: {**defaults, **cfg}


ARCHITECTURES: Dict[str, Callable[[Dict], Dict]] = {
    arch: _preset(defaults) for arch, defaults in _PRESETS.items()
}


def s2t_config(arch: str, overrides: Optional[Dict] = None) -> S2TTransformerConfig:
    """The preset ``arch`` with ``overrides`` applied first (as in fairseq,
    a given field wins over the preset); fields inference does not read
    (dropout) are dropped."""
    d = ARCHITECTURES[arch](dict(overrides or {}))
    known = {f.name for f in dataclasses.fields(S2TTransformerConfig)}
    return S2TTransformerConfig(**{k: v for k, v in d.items() if k in known})


def build_s2t_transformer(arch: str, overrides: Optional[Dict] = None,
                          device="cuda") -> S2TTransformerModel:
    return S2TTransformerModel(s2t_config(arch, overrides), device=device)
