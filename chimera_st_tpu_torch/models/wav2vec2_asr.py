"""wav2vec 2.0 speech recognition models (counterpart of
chimera_st_tpu/models/wav2vec2_asr.py; fairseq ``wav2vec2_asr.py``):

- ``Wav2VecCtcModel``: the trunk, ``final_dropout`` and a linear projection
  to the letter vocabulary (``ctc_logits``: per-frame fp32 logits and the
  frame padding mask);
- ``Wav2VecSeq2SeqModel``: the same trunk under the incremental
  ``TransformerDecoder`` (``encode_audio`` / ``decode`` /
  ``forward_audio_with_internal`` / ``.decoder``, so the port's
  ``SequenceGenerator`` and the audio branch of the cross-entropy criterions
  serve it), with ``encoder.proj`` where the decoder is wider than the trunk.

The trunk (``_W2VEncoder``, fairseq's ``Wav2VecEncoder``) takes the
host-sampled span mask (``mask_indices``) in training when ``apply_mask``
is set, and the ``freeze_finetune_updates`` gate: before update N the
trunk's output is detached. The gate reads the update count as a device
tensor (``TrainStep.count``) and selects with ``torch.where``, so it costs
no host read. Module names follow fairseq's state dicts
(``w2v_encoder.w2v_model.*`` / ``w2v_encoder.proj`` for CTC,
``encoder.w2v_model.*`` / ``encoder.proj`` / ``decoder.*`` for seq2seq).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from .layers import dropout, linear
from .transformer_decoder import TransformerDecoder
from .wav2vec2 import DEFAULT_CONV_SPEC, Wav2Vec2Encoder


@dataclass(frozen=True)
class Wav2VecAsrConfig:
    """The JAX package's ``Wav2VecAsrConfig`` (``wav2vec2_asr.py:35-68``),
    its defaults included: ``w2v2_heads`` is 8 there, where fairseq's base
    has 12 (ROADMAP C)."""

    vocab_size: int = 8
    padding_idx: int = 1
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
    w2v2_dropout: float = 0.0
    w2v2_attention_dropout: float = 0.0
    w2v2_activation_dropout: float = 0.0
    layerdrop: float = 0.0
    feature_grad_mult: float = 0.0
    freeze_finetune_updates: int = 0
    apply_mask: bool = False
    final_dropout: float = 0.0
    decoder_embed_dim: int = 1024
    decoder_ffn_dim: int = 4096
    decoder_layers: int = 10
    decoder_heads: int = 16
    decoder_normalize_before: bool = False
    decoder_dropout: float = 0.0
    decoder_attention_dropout: float = 0.0
    decoder_activation_dropout: float = 0.0
    share_decoder_input_output_embed: bool = False
    max_target_positions: int = 2048


class _W2VEncoder(nn.Module):
    """The trunk (``w2v_model``), the fine-tune span mask and the freeze
    gate; ``proj`` (the vocabulary projection of CTC, or the seq2seq model's
    dimension bridge) where ``proj_dim`` is given."""

    def __init__(self, c: Wav2VecAsrConfig, proj_dim: Optional[int], device):
        super().__init__()
        self.cfg = c
        self.w2v_model = Wav2Vec2Encoder(
            c.w2v2_embed_dim, c.w2v2_ffn_dim, c.w2v2_layers, c.w2v2_heads, c.w2v2_conv_spec,
            c.w2v2_conv_bias, c.w2v2_conv_pos, c.w2v2_conv_pos_groups,
            layer_norm_first=c.w2v2_layer_norm_first, dropout=c.w2v2_dropout,
            attention_dropout=c.w2v2_attention_dropout,
            activation_dropout=c.w2v2_activation_dropout,
            feature_grad_mult=c.feature_grad_mult, extractor_mode=c.w2v2_extractor_mode,
            layerdrop=c.layerdrop, mask_emb=c.apply_mask, device=device)
        if proj_dim is not None:
            self.proj = linear(c.w2v2_embed_dim, proj_dim, device=device)

    def forward(self, source, padding_mask, generator=None, mask_indices=None,
                num_updates=None):
        c = self.cfg
        x, out_mask = self.w2v_model(
            source, padding_mask, generator,
            mask_indices=mask_indices if (c.apply_mask and self.training) else None)
        if c.freeze_finetune_updates > 0 and num_updates is not None:
            ft = torch.as_tensor(num_updates, device=x.device) >= c.freeze_finetune_updates
            x = torch.where(ft, x, x.detach())
        x = dropout(x, c.final_dropout if self.training else 0.0, generator)
        return x, out_mask


class Wav2VecCtcModel(nn.Module):
    """fairseq ``Wav2VecCtc`` (JAX ``wav2vec2_asr.py:125-160``)."""

    def __init__(self, cfg: Wav2VecAsrConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.w2v_encoder = _W2VEncoder(cfg, cfg.vocab_size, device)

    def ctc_logits(self, source, padding_mask, mask_indices=None, num_updates=None,
                   generator: Optional[torch.Generator] = None):
        """-> (per-frame vocabulary logits [B, T', V] in fp32, the frame
        padding mask [B, T'] or None)."""
        x, out_mask = self.w2v_encoder(source, padding_mask, generator, mask_indices,
                                       num_updates)
        return self.w2v_encoder.proj(x).float(), out_mask

    def forward(self, source, padding_mask=None, generator=None):
        return self.ctc_logits(source, padding_mask, generator=generator)


class Wav2VecSeq2SeqModel(nn.Module):
    """fairseq ``wav2vec_seq2seq`` (JAX ``wav2vec2_asr.py:163-260``)."""

    def __init__(self, cfg: Wav2VecAsrConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        bridge = c.decoder_embed_dim if c.decoder_embed_dim != c.w2v2_embed_dim else None
        self.encoder = _W2VEncoder(c, bridge, device)
        self.decoder = TransformerDecoder(
            c.vocab_size, c.decoder_embed_dim, c.decoder_ffn_dim, c.decoder_layers,
            c.decoder_heads, normalize_before=c.decoder_normalize_before,
            padding_idx=c.padding_idx, max_target_positions=c.max_target_positions,
            dropout=c.decoder_dropout, attention_dropout=c.decoder_attention_dropout,
            activation_dropout=c.decoder_activation_dropout,
            share_input_output_embed=c.share_decoder_input_output_embed, device=device)

    def encode_audio(self, source, padding_mask, generator: Optional[torch.Generator] = None,
                     mask_indices=None, num_updates=None):
        x, out_mask = self.encoder(source, padding_mask, generator, mask_indices, num_updates)
        if hasattr(self.encoder, "proj"):
            x = self.encoder.proj(x)
        return x, out_mask

    def decode(self, prev_output_tokens, encoder_out, encoder_padding_mask=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decoder(prev_output_tokens, encoder_out, encoder_padding_mask, generator)

    def forward_audio_with_internal(self, source, padding_mask, prev_output_tokens,
                                    generator: Optional[torch.Generator] = None):
        """-> (logits [B, T, V], the encoder output): what the audio branch
        of the cross-entropy criterions reads."""
        enc, enc_mask = self.encode_audio(source, padding_mask, generator)
        return self.decode(prev_output_tokens, enc, enc_mask, generator), enc

    def forward(self, source, padding_mask, prev_output_tokens, generator=None):
        return self.forward_audio_with_internal(source, padding_mask, prev_output_tokens,
                                                generator)[0]


def _config(cfg_dict: Dict) -> Wav2VecAsrConfig:
    """JAX ``_build``: the vocabulary from ``tgt_vocab_size``, the task's
    ``conv_spec`` as ``w2v2_conv_spec``, unknown keys dropped."""
    known = {f.name for f in dataclasses.fields(Wav2VecAsrConfig)}
    d = dict(cfg_dict)
    d.setdefault("vocab_size", d.pop("tgt_vocab_size", 8))
    if "conv_spec" in d:
        d.setdefault("w2v2_conv_spec", d.pop("conv_spec"))
    if d.get("w2v2_conv_spec") is not None:
        d["w2v2_conv_spec"] = tuple(map(tuple, d["w2v2_conv_spec"]))
    return Wav2VecAsrConfig(**{k: v for k, v in d.items() if k in known})


def build_wav2vec_ctc(cfg_dict: Dict, device="cuda") -> Wav2VecCtcModel:
    return Wav2VecCtcModel(_config(cfg_dict), device=device)


def build_wav2vec_seq2seq(cfg_dict: Dict, device="cuda") -> Wav2VecSeq2SeqModel:
    return Wav2VecSeq2SeqModel(_config(cfg_dict), device=device)


def wav2vec_ctc_arch(cfg: Dict) -> Dict:
    d = dict(cfg)
    d.setdefault("feature_grad_mult", 0.0)
    d.setdefault("final_dropout", 0.0)
    return d


def wav2vec_seq2seq_arch(cfg: Dict) -> Dict:
    d = dict(cfg)
    d.setdefault("decoder_embed_dim", 1024)
    d.setdefault("decoder_ffn_dim", 4096)
    d.setdefault("decoder_layers", 10)
    d.setdefault("decoder_heads", 16)
    return d


MODEL_BUILDERS = {"wav2vec_ctc": build_wav2vec_ctc, "wav2vec_seq2seq": build_wav2vec_seq2seq}
ARCHITECTURES = {"wav2vec_ctc": ("wav2vec_ctc", wav2vec_ctc_arch),
                 "wav2vec_seq2seq": ("wav2vec_seq2seq", wav2vec_seq2seq_arch)}
