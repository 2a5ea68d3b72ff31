"""LSTM encoder-decoder with attention (counterpart of
chimera_st_tpu/models/lstm.py; fairseq ``lstm.py``).

As in the JAX model, attention (Luong "general", without input feeding) is
applied to the decoder's whole state sequence after the recurrence, and the
recurrences run over the padded batch, unpacked: flax ``nn.RNN`` gets no
``seq_lengths``, so a reverse direction (``reverse=True, keep_order=True``)
reads the trailing pads first. The port keeps that (no
``pack_padded_sequence``, which would give fairseq's answer and not the JAX
package's; ROADMAP C).

``LSTM`` is one flax ``nn.RNN(LSTMCell)`` / ``nn.RNN(OptimizedLSTMCell)``
layer (the two cells store the same parameters): its ``cell`` holds the
eight dense layers by their flax names, ``ii`` / ``if`` / ``ig`` / ``io``
without bias over the input and ``hi`` / ``hf`` / ``hg`` / ``ho`` with bias
over the state, so ``convert.py`` maps them one to one. A forward stacks
them in ``nn.LSTM``'s gate order (i, f, g, o; the input bias zero, the
state bias the ``h*`` biases) and runs ``torch.lstm`` (cuDNN on the card)
in the compute dtype (its ``train`` flag set where autograd records, which
cuDNN's backward needs). ``GRU`` is the same for flax's ``GRUCell``
(``ir`` / ``iz`` / ``in`` with bias, ``hr`` / ``hz`` without, ``hn`` with).
The gate layers stay separate parameters so that each is one flax leaf:
the converter, the optimizer states a JAX ``.ckpt`` holds and Adafactor's
factored moments all go leaf by leaf. What that costs, the concatenation
of a recurrence's weights in each forward and its backward, is what
``chip_smoke.py``'s ``zoo_steps`` reports as ``restack_ms``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..ops.attention import NEG_INF, dropout
from .embedding import Embed
from .layers import linear
from .transformer_mt import _config, preset

LSTM_GATES = ("i", "f", "g", "o")
GRU_GATES = ("r", "z", "n")


class _Recurrence(nn.Module):
    """A flax recurrent cell's dense layers, run as one fused recurrence."""

    GATES: tuple = ()
    INPUT_BIAS: bool = False
    STATE_BIAS: tuple = ()

    def __init__(self, in_dim: int, hidden: int, device="cuda"):
        super().__init__()
        self.hidden = hidden
        layers = {f"i{g}": linear(in_dim, hidden, bias=self.INPUT_BIAS, device=device)
                  for g in self.GATES}
        layers.update({f"h{g}": linear(hidden, hidden, bias=g in self.STATE_BIAS, device=device)
                       for g in self.GATES})
        self.cell = nn.ModuleDict(layers)

    def _bias(self, side: str, like: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.cell[f"{side}{g}"].bias if self.cell[f"{side}{g}"].bias is not None
                          else like.new_zeros(self.hidden) for g in self.GATES])

    def flat_weights(self):
        """[w_ih, w_hh, b_ih, b_hh] in ``nn.LSTM`` / ``nn.GRU``'s layout."""
        w_ih = torch.cat([self.cell[f"i{g}"].weight for g in self.GATES])
        w_hh = torch.cat([self.cell[f"h{g}"].weight for g in self.GATES])
        return [w_ih, w_hh, self._bias("i", w_ih), self._bias("h", w_ih)]

    def run(self, x: torch.Tensor, weights, h0) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """[B, T, in] -> states [B, T, hidden]; ``reverse`` runs from the last
        step (pads included) and returns the states in the input's order.
        Under ``torch.autocast`` the recurrence runs in the autocast dtype
        (autocast's own rule would run a cuDNN RNN in fp16), else in the
        parameters' dtype."""
        device = x.device.type
        weights = self.flat_weights()
        dtype = (torch.get_autocast_dtype(device) if torch.is_autocast_enabled(device)
                 else weights[0].dtype)
        with torch.autocast(device, enabled=False):
            weights = [w.to(dtype) for w in weights]
            x = x.to(dtype)
            if reverse:
                x = x.flip(1)
            h0 = x.new_zeros(1, x.shape[0], self.hidden)
            out = self.run(x, weights, h0)
        return out.flip(1) if reverse else out


class LSTM(_Recurrence):
    GATES = LSTM_GATES
    STATE_BIAS = LSTM_GATES

    def run(self, x, weights, h0):
        return torch.lstm(x, (h0, h0), weights, True, 1, 0.0, torch.is_grad_enabled(), False,
                          True)[0]


class GRU(_Recurrence):
    GATES = GRU_GATES
    INPUT_BIAS = True
    STATE_BIAS = ("n",)

    def run(self, x, weights, h0):
        return torch.gru(x, h0, weights, True, 1, 0.0, torch.is_grad_enabled(), False, True)[0]


def bidirectional_stack(x: torch.Tensor, fwd: nn.ModuleList, rev: Optional[nn.ModuleList],
                        after=None) -> torch.Tensor:
    """Layer i: the forward recurrence, concatenated with the reverse one
    where there is one; ``after`` (dropout) after each layer."""
    for i, rnn in enumerate(fwd):
        x = rnn(x) if rev is None else torch.cat([rnn(x), rev[i](x, reverse=True)], dim=-1)
        if after is not None:
            x = after(x)
    return x


@dataclass(frozen=True)
class LSTMConfig:
    src_vocab_size: int = 8
    tgt_vocab_size: int = 8
    padding_idx: int = 1
    embed_dim: int = 512
    hidden_size: int = 512
    encoder_layers: int = 1
    decoder_layers: int = 1
    bidirectional: bool = False
    dropout: float = 0.1
    share_decoder_input_output_embed: bool = False
    attention: bool = True


class AttentionLayer(nn.Module):
    """Luong general attention over the encoder states."""

    def __init__(self, hidden: int, src_dim: int, device="cuda"):
        super().__init__()
        self.input_proj = linear(hidden, src_dim, bias=False, device=device)
        self.output_proj = linear(src_dim + hidden, hidden, bias=False, device=device)

    def forward(self, query: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor
                ) -> torch.Tensor:
        scores = torch.einsum("btc,bsc->bts", self.input_proj(query), enc)
        scores = scores.masked_fill(enc_mask[:, None, :], NEG_INF)
        w = torch.softmax(scores.float(), dim=-1).to(enc.dtype)
        ctx = torch.einsum("bts,bsc->btc", w, enc)
        return torch.tanh(self.output_proj(torch.cat([ctx, query], dim=-1)))


class LSTMModel(nn.Module):
    def __init__(self, cfg: LSTMConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        H = c.hidden_size
        enc_out = H * (2 if c.bidirectional else 1)
        self.src_embed = Embed(c.src_vocab_size, c.embed_dim, c.padding_idx, device=device)
        self.tgt_embed = Embed(c.tgt_vocab_size, c.embed_dim, c.padding_idx, device=device)
        self.enc_rnn = nn.ModuleList([LSTM(c.embed_dim if i == 0 else enc_out, H, device=device)
                                      for i in range(c.encoder_layers)])
        self.enc_rnn_rev = nn.ModuleList(
            [LSTM(c.embed_dim if i == 0 else enc_out, H, device=device)
             for i in range(c.encoder_layers)]) if c.bidirectional else None
        self.dec_rnn = nn.ModuleList([LSTM(c.embed_dim if i == 0 else H, H, device=device)
                                      for i in range(c.decoder_layers)])
        self.attention = AttentionLayer(H, enc_out, device=device) if c.attention else None
        if not c.share_decoder_input_output_embed:
            self.output_projection = linear(H, c.tgt_vocab_size, bias=False, device=device)

    def _p(self) -> float:
        return self.cfg.dropout if self.training else 0.0

    def encode_text(self, src_tokens: torch.Tensor, generator=None):
        """-> (encoder states [B, S, H or 2H], padding mask [B, S])."""
        pad = src_tokens == self.cfg.padding_idx
        x = dropout(self.src_embed(src_tokens), self._p(), generator)
        return bidirectional_stack(x, self.enc_rnn, self.enc_rnn_rev), pad

    def decode(self, prev_output_tokens, enc, enc_mask, generator=None) -> torch.Tensor:
        h = dropout(self.tgt_embed(prev_output_tokens), self._p(), generator)
        for rnn in self.dec_rnn:
            h = rnn(h)
        if self.attention is not None:
            h = self.attention(h, enc, enc_mask)
        h = dropout(h, self._p(), generator)
        if self.cfg.share_decoder_input_output_embed:
            return self.tgt_embed.attend(h)
        return self.output_projection(h).float()

    def forward(self, src_tokens, prev_output_tokens, generator=None) -> torch.Tensor:
        enc, enc_mask = self.encode_text(src_tokens, generator)
        return self.decode(prev_output_tokens, enc, enc_mask, generator)

    def forward_text_with_internal(self, src_tokens, prev_output_tokens, generator=None):
        """-> (logits [B, T, V] fp32, encoder states)."""
        enc, enc_mask = self.encode_text(src_tokens, generator)
        return self.decode(prev_output_tokens, enc, enc_mask, generator), enc


def build_lstm(cfg_dict: Dict, device="cuda") -> LSTMModel:
    return LSTMModel(_config(LSTMConfig, cfg_dict), device=device)


def build_simple_lstm(cfg_dict: Dict, device="cuda") -> LSTMModel:
    """The tutorial encoder-decoder LSTM: the LSTM model without attention."""
    return LSTMModel(_config(LSTMConfig, {**cfg_dict, "attention": False}), device=device)



# ---- presets (JAX lstm.py:150-170, lm_extra.py:229-234, :371-374)

MODEL_BUILDERS = {"lstm": build_lstm, "simple_lstm": build_simple_lstm}
ARCHITECTURES = {
    "lstm": ("lstm", preset(embed_dim=512, hidden_size=512)),
    "lstm_wiseman_iwslt_de_en": ("lstm", preset(embed_dim=256, hidden_size=256, dropout=0.1)),
    "lstm_luong_wmt_en_de": ("lstm", preset(embed_dim=1000, hidden_size=1000, encoder_layers=4,
                                             decoder_layers=4)),
    "simple_lstm": ("simple_lstm", preset(embed_dim=256, hidden_size=256)),
    "tutorial_simple_lstm": ("simple_lstm", preset()),
}
