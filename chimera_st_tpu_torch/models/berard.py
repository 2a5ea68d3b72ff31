"""Berard's RNN speech-translation model (counterpart of
chimera_st_tpu/models/berard.py; fairseq ``speech_to_text/berard.py``,
"End-to-End Automatic Speech Translation of Audiobooks"): two strided 2-D
convolutions (tanh) over fbank features, a stacked bidirectional LSTM
encoder, an LSTM decoder and MLP (Bahdanau) attention applied to the
decoder's whole state sequence after the recurrence, as in JAX.

The convolutions pad as flax ``padding="SAME"`` does at stride 2: the
output is ceil(in / stride) long and the extra padding goes at the end,
which ``F.conv2d``'s symmetric ``padding=`` cannot give, so the input is
padded explicitly. Lengths shrink to ceil(len / stride) a convolution. The
recurrences run unpacked over the padded batch (``lstm.py``).

With ``compute_fbank`` (a port option, as in the fbank
``s2t_transformer``) the input is the raw 16 kHz wave and the 80-bin
log-mel runs on the card as K4 (``ops/logmel.py``), once a batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import NEG_INF, dropout
from ..ops.logmel import wave_features
from .embedding import Embed
from .layers import conv2d, linear
from .lstm import LSTM, bidirectional_stack
from .transformer_mt import _config, preset


@dataclass(frozen=True)
class BerardConfig:
    tgt_vocab_size: int = 8
    padding_idx: int = 1
    input_feat_per_channel: int = 80
    conv_channels: Tuple[int, ...] = (16, 16)
    conv_kernel: int = 3
    conv_stride: int = 2
    lstm_size: int = 256
    encoder_layers: int = 3
    bidirectional: bool = True
    decoder_embed_dim: int = 128
    decoder_hidden: int = 512
    decoder_layers: int = 2
    attention_dim: int = 512
    dropout: float = 0.2
    compute_fbank: bool = False  # True: the input is the raw wave, log-mel on the device


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: (before, after), the odd one after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class MLPAttention(nn.Module):
    """Bahdanau additive attention."""

    def __init__(self, query_dim: int, context_dim: int, attention_dim: int, device="cuda"):
        super().__init__()
        self.query_proj = linear(query_dim, attention_dim, device=device)
        self.context_proj = linear(context_dim, attention_dim, bias=False, device=device)
        self.score_proj = linear(attention_dim, 1, bias=False, device=device)

    def forward(self, queries: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor
                ) -> torch.Tensor:
        q, k = self.query_proj(queries), self.context_proj(enc)
        e = torch.tanh(q[:, :, None, :] + k[:, None, :, :])  # [B, T, S, A]
        scores = self.score_proj(e)[..., 0].masked_fill(enc_mask[:, None, :], NEG_INF)
        w = torch.softmax(scores.float(), dim=-1).to(enc.dtype)
        return torch.einsum("bts,bsc->btc", w, enc)


class BerardModel(nn.Module):
    def __init__(self, cfg: BerardConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        chans = (1,) + tuple(c.conv_channels)
        self.conv = nn.ModuleList([
            conv2d(chans[i], chans[i + 1], c.conv_kernel, c.conv_stride, device=device)
            for i in range(len(c.conv_channels))])
        feat = c.input_feat_per_channel
        for _ in c.conv_channels:
            feat = -(-feat // c.conv_stride)
        enc_in = feat * chans[-1]
        enc_out = c.lstm_size * (2 if c.bidirectional else 1)
        self.enc_rnn = nn.ModuleList([LSTM(enc_in if i == 0 else enc_out, c.lstm_size,
                                           device=device) for i in range(c.encoder_layers)])
        self.enc_rnn_rev = nn.ModuleList(
            [LSTM(enc_in if i == 0 else enc_out, c.lstm_size, device=device)
             for i in range(c.encoder_layers)]) if c.bidirectional else None
        self.embed_tokens = Embed(c.tgt_vocab_size, c.decoder_embed_dim, c.padding_idx,
                                  device=device)
        self.dec_rnn = nn.ModuleList([
            LSTM(c.decoder_embed_dim if i == 0 else c.decoder_hidden, c.decoder_hidden,
                 device=device) for i in range(c.decoder_layers)])
        self.attention = MLPAttention(c.decoder_hidden, enc_out, c.attention_dim, device=device)
        self.output_projection = linear(c.decoder_hidden + enc_out, c.tgt_vocab_size,
                                        device=device)

    def _p(self) -> float:
        return self.cfg.dropout if self.training else 0.0

    def init_extra_(self, generator: torch.Generator) -> None:
        """He-normal 2-D convolutions (``init_params_`` covers the rest)."""
        for conv in self.conv:
            fan_in = conv.weight[0].numel()
            conv.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
            conv.bias.zero_()

    def encode_audio(self, source: torch.Tensor, padding_mask: torch.Tensor, generator=None):
        """source [B, T, F] fbank features (or [B, T] wave with
        ``compute_fbank``), padding_mask [B, T] True = pad -> (encoder states
        [B, T', 2 lstm_size], their padding mask)."""
        c = self.cfg
        if c.compute_fbank:
            source, padding_mask = wave_features(source, padding_mask, c.input_feat_per_channel)
        x = source[:, None]  # [B, 1, T, F]
        lengths = (~padding_mask).sum(dim=1)
        for conv in self.conv:
            k, s = c.conv_kernel, c.conv_stride
            t0, t1 = same_padding(x.shape[2], k, s)
            f0, f1 = same_padding(x.shape[3], k, s)
            w = conv.weight
            x = torch.tanh(F.conv2d(F.pad(x.to(w.dtype), (f0, f1, t0, t1)), w, conv.bias,
                                    stride=s))
            lengths = (lengths + s - 1) // s
        B, C2, T2, F2 = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T2, F2 * C2)  # flax's [B, T, F, C] flattened
        mask = torch.arange(T2, device=x.device)[None, :] >= lengths[:, None]
        x = bidirectional_stack(x, self.enc_rnn, self.enc_rnn_rev,
                                after=lambda h: dropout(h, self._p(), generator))
        return x, mask

    def decode(self, prev_output_tokens, enc, enc_mask, generator=None) -> torch.Tensor:
        y = dropout(self.embed_tokens(prev_output_tokens), self._p(), generator)
        for rnn in self.dec_rnn:
            y = rnn(y)
        y = torch.cat([y, self.attention(y, enc, enc_mask).to(y.dtype)], dim=-1)
        y = dropout(y, self._p(), generator)
        return self.output_projection(y).float()

    def forward(self, source, padding_mask, prev_output_tokens, generator=None) -> torch.Tensor:
        """Teacher-forced: features (or wave) -> fp32 logits [B, T, V]."""
        enc, enc_mask = self.encode_audio(source, padding_mask, generator)
        return self.decode(prev_output_tokens, enc, enc_mask, generator)

    def forward_audio_with_internal(self, source, padding_mask, prev_output_tokens,
                                    generator=None):
        """-> (logits [B, T, V] fp32, encoder states): the call of
        ``label_smoothed_cross_entropy`` on an ``audio`` batch."""
        enc, enc_mask = self.encode_audio(source, padding_mask, generator)
        return self.decode(prev_output_tokens, enc, enc_mask, generator), enc


def build_berard(cfg_dict: Dict, device="cuda") -> BerardModel:
    d = dict(cfg_dict)
    if "conv_channels" in d:
        d["conv_channels"] = tuple(d["conv_channels"])
    return BerardModel(_config(BerardConfig, d), device=device)


def _berard_512(encoder_layers: int, decoder_layers: int):
    """The 512-unit presets (lstm 512, dropout 0.3, decoder embed 256 /
    hidden 1,024, attention 512)."""
    return preset(lstm_size=512, dropout=0.3, decoder_embed_dim=256, decoder_hidden=1024,
                  attention_dim=512, encoder_layers=encoder_layers,
                  decoder_layers=decoder_layers)


# ---- presets (JAX berard.py:153-173)
MODEL_BUILDERS = {"s2t_berard": build_berard}
ARCHITECTURES = {
    "s2t_berard": ("s2t_berard", dict),
    "s2t_berard_256_3_3": ("s2t_berard", preset(lstm_size=256, encoder_layers=3,
                                                decoder_layers=3)),
    "s2t_berard_512_3_2": ("s2t_berard", _berard_512(3, 2)),
    "s2t_berard_512_5_3": ("s2t_berard", _berard_512(5, 3)),
}
