"""The zoo's decoder-only language models and tutorial models (counterpart
of chimera_st_tpu/models/lm_extra.py):

- ``LSTMLM`` (``lstm_lm``): the LSTM decoder alone;
- ``LightConvLM`` (``lightconv_lm``, ``dynamicconv_lm``,
  ``lightconv_lm_gbw``): causal lightweight / dynamic convolution blocks
  with an FFN, sinusoidal positions, a tied output;
- ``RNNClassifier`` (``rnn_classifier``, ``pytorch_tutorial_rnn``): a GRU
  over tokens, class log-probabilities from the last real step's state;
- ``DummyModel`` (``dummy_model``): fairseq's throughput benchmark model,
  Transformer-shaped products without attention.

``simple_lstm`` is in ``lstm.py``. Each LM maps ``[B, T]`` tokens to fp32
logits ``[B, T, V]``, the call the ``language_modeling`` task and the
``cross_entropy`` criterion make.

As in the JAX package, the three LM builders read ``vocab_size`` and not
the task's ``tgt_vocab_size``: through the train CLI their vocabulary is
``--vocab-size``. Where the task's dictionary is larger than that, the JAX
model indexes past its table and trains on NaN without end; the port
raises instead (ROADMAP C).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dropout
from .conv_attention import ConvAttentionLayer
from .embedding import Embed
from .layers import LayerNorm, linear, positional_embedding_from_mask
from .lstm import GRU, LSTM
from .transformer_mt import _config, preset


def _lm_vocab(cfg_dict: Dict, arch: str) -> Dict:
    """The JAX builders' vocabulary (``vocab_size``, default 8), refused
    where the task's dictionary does not fit in it."""
    d = dict(cfg_dict)
    task_vocab = d.get("tgt_vocab_size")
    if task_vocab is not None and task_vocab > d.get("vocab_size", 8):
        raise ValueError(
            f"{arch}: the dictionary has {task_vocab} symbols and the model's table "
            f"{d.get('vocab_size', 8)}: pass --vocab-size (the JAX model reads only "
            "vocab_size and trains on NaN here, ROADMAP C)")
    return d


# ------------------------------------------------------------------ lstm_lm


@dataclass(frozen=True)
class LSTMLMConfig:
    vocab_size: int = 8
    padding_idx: int = 1
    embed_dim: int = 512
    hidden_size: int = 512
    layers: int = 1
    dropout: float = 0.1
    share_input_output_embed: bool = False


class LSTMLM(nn.Module):
    def __init__(self, cfg: LSTMLMConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        self.embed = Embed(c.vocab_size, c.embed_dim, c.padding_idx, device=device)
        self.rnn = nn.ModuleList([LSTM(c.embed_dim if i == 0 else c.hidden_size, c.hidden_size,
                                       device=device) for i in range(c.layers)])
        self.out_proj_dim = (linear(c.hidden_size, c.embed_dim, device=device)
                             if c.share_input_output_embed and c.hidden_size != c.embed_dim
                             else None)
        if not c.share_input_output_embed:
            self.output_projection = linear(c.hidden_size, c.vocab_size, bias=False,
                                            device=device)

    def forward(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        """[B, T] -> logits [B, T, V] (fp32); causal by the recurrence."""
        c = self.cfg
        p = c.dropout if self.training else 0.0
        x = dropout(self.embed(tokens), p, generator)
        for rnn in self.rnn:
            x = rnn(x)
        x = dropout(x, p, generator)
        if c.share_input_output_embed:
            if self.out_proj_dim is not None:
                x = self.out_proj_dim(x)
            return self.embed.attend(x)
        return self.output_projection(x).float()


def build_lstm_lm(cfg_dict: Dict, device="cuda") -> LSTMLM:
    return LSTMLM(_config(LSTMLMConfig, _lm_vocab(cfg_dict, "lstm_lm")), device=device)


# -------------------------------------------------------------- lightconv_lm


@dataclass(frozen=True)
class LightConvLMConfig:
    vocab_size: int = 8
    padding_idx: int = 1
    embed_dim: int = 512
    ffn_dim: int = 2048
    layers: int = 6
    heads: int = 8
    kernel_sizes: Tuple[int, ...] = (3, 7, 15, 31, 31, 31)
    conv_type: str = "lightweight"  # or "dynamic"
    normalize_before: bool = True
    dropout: float = 0.1
    share_input_output_embed: bool = True


class LightConvLMLayer(ConvAttentionLayer):
    """Causal GLU-conv block + FFN: the decoder layer without encoder
    attention (fairseq ``lightconv_lm.py``'s ``no_encoder_attn``), the
    causal ``ConvAttentionLayer`` without a padding mask."""

    def __init__(self, dim: int, ffn_dim: int, kernel_size: int, heads: int, conv_type: str,
                 dropout: float = 0.1, normalize_before: bool = True, device="cuda"):
        super().__init__(dim, ffn_dim, kernel_size, heads, conv_type=conv_type, causal=True,
                         dropout=dropout, normalize_before=normalize_before, device=device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return super().forward(x, None, generator)


class LightConvLM(nn.Module):
    def __init__(self, cfg: LightConvLMConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        self.embed = Embed(c.vocab_size, c.embed_dim, c.padding_idx, device=device)
        ks = tuple(c.kernel_sizes)
        if len(ks) < c.layers:
            ks = ks + (ks[-1],) * (c.layers - len(ks))
        self.layers = nn.ModuleList([
            LightConvLMLayer(c.embed_dim, c.ffn_dim, ks[i], c.heads, c.conv_type,
                             dropout=c.dropout, normalize_before=c.normalize_before,
                             device=device) for i in range(c.layers)])
        if c.normalize_before:
            self.norm = LayerNorm(c.embed_dim, device=device)
        if not c.share_input_output_embed:
            self.output_projection = linear(c.embed_dim, c.vocab_size, bias=False,
                                            device=device)
        self.embed_scale = math.sqrt(c.embed_dim)

    def forward(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        c = self.cfg
        pad = tokens == c.padding_idx
        x = self.embed_scale * self.embed(tokens)
        x = x + positional_embedding_from_mask(pad, c.embed_dim, c.padding_idx).to(x.dtype)
        x = dropout(x, c.dropout if self.training else 0.0, generator)
        for layer in self.layers:
            x = layer(x, generator)
        if c.normalize_before:
            x = self.norm(x)
        if c.share_input_output_embed:
            return self.embed.attend(x)
        return self.output_projection(x).float()


def build_lightconv_lm(cfg_dict: Dict, device="cuda") -> LightConvLM:
    d = _lm_vocab(cfg_dict, "lightconv_lm")
    if "kernel_sizes" in d:
        d["kernel_sizes"] = tuple(d["kernel_sizes"])
    return LightConvLM(_config(LightConvLMConfig, d), device=device)


# ----------------------------------------------------------- rnn_classifier


@dataclass(frozen=True)
class RNNClassifierConfig:
    vocab_size: int = 8
    num_classes: int = 2
    padding_idx: int = 1
    embed_dim: int = 128
    hidden_size: int = 128
    dropout: float = 0.0


class RNNClassifier(nn.Module):
    """Tokens -> class log-probabilities [B, C] (fp32) from the GRU state at
    the last real token (a sequence's real tokens are counted, pads
    anywhere)."""

    def __init__(self, cfg: RNNClassifierConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        self.embed = Embed(c.vocab_size, c.embed_dim, c.padding_idx, device=device)
        self.rnn = GRU(c.embed_dim, c.hidden_size, device=device)
        self.classifier = linear(c.hidden_size, c.num_classes, device=device)

    def forward(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        c = self.cfg
        x = dropout(self.embed(tokens), c.dropout if self.training else 0.0, generator)
        h = self.rnn(x)
        lengths = (tokens != c.padding_idx).sum(dim=1)
        last = h[torch.arange(h.shape[0], device=h.device), torch.clamp(lengths - 1, min=0)]
        return torch.log_softmax(self.classifier(last).float(), dim=-1)


def build_rnn_classifier(cfg_dict: Dict, device="cuda") -> RNNClassifier:
    return RNNClassifier(_config(RNNClassifierConfig, cfg_dict), device=device)


# ------------------------------------------------------------- dummy_model


@dataclass(frozen=True)
class DummyModelConfig:
    vocab_size: int = 8
    padding_idx: int = 1
    embed_dim: int = 1024
    layers: int = 24
    dropout: float = 0.1


class DummyModel(nn.Module):
    """fairseq's ``benchmark/dummy_model.py``: a layer is a residual
    LayerNorm -> qkv -> skip -> out projection stack and a residual 4x ReLU
    FFN; module names ``attn_ln_{i}``, ``qkv_{i}`` ... as the JAX model's."""

    def __init__(self, cfg: DummyModelConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        E = c.embed_dim
        self.embed = Embed(c.vocab_size, E, c.padding_idx, device=device)
        self.attn_ln = nn.ModuleList([LayerNorm(E, device=device) for _ in range(c.layers)])
        self.qkv = nn.ModuleList([linear(E, 3 * E, device=device) for _ in range(c.layers)])
        self.attn_skip = nn.ModuleList([linear(3 * E, E, device=device)
                                        for _ in range(c.layers)])
        self.attn_out = nn.ModuleList([linear(E, E, device=device) for _ in range(c.layers)])
        self.ffn_ln = nn.ModuleList([LayerNorm(E, device=device) for _ in range(c.layers)])
        self.ffn_up = nn.ModuleList([linear(E, 4 * E, device=device) for _ in range(c.layers)])
        self.ffn_down = nn.ModuleList([linear(4 * E, E, device=device)
                                       for _ in range(c.layers)])
        self.out_proj = linear(E, c.vocab_size, device=device)

    def forward(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        p = self.cfg.dropout if self.training else 0.0
        x = self.embed(tokens)
        for i in range(self.cfg.layers):
            h = self.attn_out[i](self.attn_skip[i](self.qkv[i](self.attn_ln[i](x))))
            x = x + dropout(h, p, generator)
            h = self.ffn_down[i](F.relu(self.ffn_up[i](self.ffn_ln[i](x))))
            x = x + dropout(h, p, generator)
        return self.out_proj(x).float()


def build_dummy_model(cfg_dict: Dict, device="cuda") -> DummyModel:
    d = dict(cfg_dict)
    d.setdefault("vocab_size", d.pop("tgt_vocab_size", 8))
    return DummyModel(_config(DummyModelConfig, d), device=device)



def _dynamic(cfg: Dict) -> Dict:
    return {**cfg, "conv_type": "dynamic"}


# ---- presets (JAX lm_extra.py:90-96, :205-214, :315-359, :385-390)

MODEL_BUILDERS = {"lstm_lm": build_lstm_lm, "lightconv_lm": build_lightconv_lm,
                  "rnn_classifier": build_rnn_classifier, "dummy_model": build_dummy_model}
ARCHITECTURES = {
    "lstm_lm": ("lstm_lm", preset(embed_dim=512, hidden_size=512, layers=1)),
    "lightconv_lm": ("lightconv_lm", preset()),
    "dynamicconv_lm": ("lightconv_lm", _dynamic),
    "lightconv_lm_gbw": ("lightconv_lm", preset(embed_dim=512, ffn_dim=4096, heads=16,
                                                 dropout=0.1)),
    "rnn_classifier": ("rnn_classifier", preset()),
    "pytorch_tutorial_rnn": ("rnn_classifier", preset()),
    "dummy_model": ("dummy_model", preset()),
}
