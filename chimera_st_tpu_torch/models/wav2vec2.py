"""wav2vec 2.0 feature-extraction trunk (counterpart of
chimera_st_tpu/models/wav2vec2.py), for inference and fine-tuning.

- ``ConvFeatureExtractor``: in ``default`` mode layer 0 (``F.conv1d``) ->
  ``Fp32GroupNorm`` -> GELU, and layers 1-6 through the conv-tail kernel K2
  (ops/conv_tail.py) where they are the standard wav2vec2-base tail without
  conv bias (the JAX gate, ``wav2vec2.py:126-138``), else through a plain
  conv loop; in ``layer_norm`` mode (``wav2vec2_large``) every layer is conv
  (with ``conv_bias`` where set) -> LayerNorm over the channels -> GELU, all
  plain, as the JAX package runs it in XLA.
- ``ConvPositionalEmbedding``: grouped conv with the SamePad trim.
- ``W2V2EncoderLayer``: BERT-style, post-LN unless ``layer_norm_first``.
- ``Wav2Vec2Encoder.forward``: the ``extract_features`` path, with the
  training parts a fine-tune runs: the layers' dropouts, the two input
  dropouts and ``grad_multiply`` by ``feature_grad_mult`` on the extractor's
  output, span masking (``mask_emb``: the learned embedding replaces the
  frames of a host-sampled ``mask_indices``; the ASR models pass them in
  training only) and layerdrop
  (each layer skipped with probability ``layerdrop`` in training; the
  decisions come from a CPU generator keyed by the forward's ``generator``,
  so no device value is read a layer). With
  ``remat`` each context-network layer is recomputed in the backward
  (``remat_layer``), as the JAX ``nn.remat`` of the layer.

Module names follow the fairseq state dict (``feature_extractor.
conv_layers.{i}.0`` conv, ``conv_layers.0.2`` group norm, ``conv_layers.{i}.2.1``
the ``layer_norm`` mode's norms, ``mask_emb``, ``encoder.pos_conv.0``,
``encoder.layers.{i}``, ``encoder.layer_norm``); the positional conv holds
the plain (weight-norm folded) weight.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv_tail import CH, TAIL_SPEC, conv_tail
from .layers import (
    LayerNorm,
    MultiheadAttention,
    _Sublayers,
    _zeroed,
    conv1d,
    dropout,
    get_activation,
    linear,
)

# (dim, kernel, stride): the wav2vec2-base/small extractor
DEFAULT_CONV_SPEC: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


def extractor_output_length(length, conv_spec=DEFAULT_CONV_SPEC):
    """Frames of the conv extractor for ``length`` raw samples."""
    for _, k, s in conv_spec:
        length = (length - k) // s + 1
    return length


def grad_multiply(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward, gradient scaled by ``scale`` on the way back; 0
    detaches (the extractor then needs no backward)."""
    if scale == 1.0:
        return x
    if scale == 0.0:
        return x.detach()
    return scale * x + (1.0 - scale) * x.detach()


class Fp32GroupNorm(nn.Module):
    """GroupNorm with groups == channels (a per-channel instance norm over
    the whole time axis) in fp32. Input [B, C, T] (conv layout)."""

    def __init__(self, channels: int, eps: float = 1e-5, device="cuda"):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=2, keepdim=True)
        var = (xf - mean).square().mean(dim=2, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight[:, None] + self.bias[:, None]).to(x.dtype)


EXTRACTOR_MODES = ("default", "layer_norm")


class ConvFeatureExtractor(nn.Module):
    """Raw waveform [B, T] -> features [B, T', C]."""

    def __init__(self, conv_spec=DEFAULT_CONV_SPEC, conv_bias: bool = False,
                 mode: str = "default", device="cuda"):
        super().__init__()
        if mode not in EXTRACTOR_MODES:
            raise ValueError(f"extractor mode {mode!r}: one of {EXTRACTOR_MODES}")
        self.conv_spec, self.mode = tuple(conv_spec), mode
        layers = []
        in_ch = 1
        for i, (dim, k, stride) in enumerate(self.conv_spec):
            parts = {"0": conv1d(in_ch, dim, k, stride=stride, bias=conv_bias, device=device)}
            if mode == "layer_norm":
                # fairseq's Sequential(TransposeLast, Fp32LayerNorm, TransposeLast)
                parts["2"] = nn.ModuleDict({"1": LayerNorm(dim, device=device)})
            elif i == 0:
                parts["2"] = Fp32GroupNorm(dim, device=device)
            layers.append(nn.ModuleDict(parts))
            in_ch = dim
        self.conv_layers = nn.ModuleList(layers)
        tail = self.conv_spec[1:]
        self.kernel_tail = (
            mode == "default"
            and not conv_bias
            and self.conv_spec[0][0] == CH
            and tuple((k, s) for _, k, s in tail) == TAIL_SPEC
            and all(d == CH for d, _, _ in tail)
        )

    def forward(self, source: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv_layers[0]["0"]
        x = source.to(conv0.weight.dtype)[:, None, :]  # [B, 1, T]
        if self.mode == "layer_norm":
            for layer in self.conv_layers:
                y = layer["0"](x).transpose(1, 2)
                x = F.gelu(layer["2"]["1"](y)).transpose(1, 2)
            return x.transpose(1, 2)
        x = F.gelu(self.conv_layers[0]["2"](conv0(x)))
        if self.kernel_tail:
            # layers 1-6 channels-last through K2
            weights = [layer["0"].weight for layer in self.conv_layers[1:]]
            return conv_tail(x.transpose(1, 2).contiguous(), weights)
        for layer in self.conv_layers[1:]:
            x = F.gelu(layer["0"](x))
        return x.transpose(1, 2)


class ConvPositionalEmbedding(nn.Conv1d):
    """Grouped temporal conv positional encoding; input/output [B, T, C].
    A Conv1d itself, so its weight sits at the fairseq key
    ``encoder.pos_conv.0.weight``."""

    def __init__(self, dim: int, kernel: int = 128, groups: int = 16, device="cuda"):
        super().__init__(dim, dim, kernel, padding=kernel // 2, groups=groups, device="meta")
        _zeroed(self, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.transpose(1, 2))
        if self.kernel_size[0] % 2 == 0:  # SamePad: drop the trailing frame
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class W2V2EncoderLayer(_Sublayers):
    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int, activation: str = "gelu",
                 layer_norm_first: bool = False, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 device="cuda"):
        super().__init__()
        self.normalize_before = layer_norm_first
        self.dropout, self.activation_dropout = dropout, activation_dropout
        self.self_attn = MultiheadAttention(embed_dim, num_heads, attention_dropout,
                                            device=device)
        self.self_attn_layer_norm = LayerNorm(embed_dim, device=device)
        self.fc1 = linear(embed_dim, ffn_dim, device=device)
        self.fc2 = linear(ffn_dim, embed_dim, device=device)
        self.final_layer_norm = LayerNorm(embed_dim, device=device)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = self._sublayer(x, self.self_attn_layer_norm, lambda h: self.self_attn(
            h, key_padding_mask=padding_mask, generator=generator), generator)
        return self._ffn_sublayer(x, generator)


def downsample_padding_mask(padding_mask: torch.Tensor, out_len: int) -> torch.Tensor:
    """Reference rule: chop the remainder; a frame is padded iff ALL raw
    samples of its block are padded."""
    B, T = padding_mask.shape
    extra = T % out_len
    if extra > 0:
        padding_mask = padding_mask[:, :-extra]
    return padding_mask.reshape(B, out_len, -1).all(dim=-1)


class _ContextNetwork(nn.Module):
    """The fairseq ``encoder`` submodule: pos_conv, layers, layer_norm."""

    def __init__(self, embed_dim, ffn_dim, layers, heads, conv_pos, conv_pos_groups, activation,
                 layer_norm_first, dropouts, device):
        super().__init__()
        self.pos_conv = nn.ModuleList(
            [ConvPositionalEmbedding(embed_dim, conv_pos, conv_pos_groups, device=device)])
        self.layers = nn.ModuleList([
            W2V2EncoderLayer(embed_dim, ffn_dim, heads, activation, layer_norm_first, *dropouts,
                             device=device)
            for _ in range(layers)
        ])
        self.layer_norm = LayerNorm(embed_dim, device=device)


def remat_layer(layer: nn.Module, x: torch.Tensor, padding_mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """``layer(x, padding_mask, generator)`` whose activations are not kept:
    the backward recomputes them (``torch.utils.checkpoint``). The
    checkpoint restores the global random streams only, not an explicit
    ``generator``, so its state at the forward is saved here and put back
    for the recompute (and the state the recompute found is restored after
    it): the recomputed dropout masks are the forward's."""
    from torch.utils.checkpoint import checkpoint

    if generator is None:
        return checkpoint(layer, x, padding_mask, None, use_reentrant=False)
    at_forward = generator.get_state()
    calls = [0]

    def run(h):
        calls[0] += 1
        if calls[0] == 1:  # the forward
            return layer(h, padding_mask, generator)
        now = generator.get_state()
        generator.set_state(at_forward)
        try:
            return layer(h, padding_mask, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False)


def layerdrop_keep(n_layers: int, rate: float, generator: Optional[torch.Generator]):
    """Which of ``n_layers`` layers run under LayerDrop at ``rate`` (JAX
    ``layers.py:52-67``: each kept with probability 1 - rate): a host list
    drawn from a CPU generator seeded by ``generator``'s seed, so the
    decisions follow the forward's keying and read nothing from the card."""
    if generator is None:
        raise ValueError("layerdrop in training mode needs a torch.Generator")
    g = torch.Generator().manual_seed(generator.initial_seed() ^ 0x1AE4D409)
    return (torch.rand(n_layers, generator=g) < 1.0 - rate).tolist()


class Wav2Vec2Encoder(nn.Module):
    """Conv extractor + transformer context network (the ``extract_features``
    path), with fine-tune span masking where built with ``mask_emb``."""

    def __init__(self, encoder_embed_dim: int = 768, encoder_ffn_dim: int = 3072,
                 encoder_layers: int = 12, encoder_heads: int = 8,
                 conv_spec: Sequence[Tuple[int, int, int]] = DEFAULT_CONV_SPEC,
                 conv_bias: bool = False, conv_pos: int = 128, conv_pos_groups: int = 16,
                 activation: str = "gelu", layer_norm_first: bool = False,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0, feature_grad_mult: float = 1.0,
                 remat: bool = False, extractor_mode: str = "default",
                 layerdrop: float = 0.0, mask_emb: bool = False, device="cuda"):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.dropout, self.feature_grad_mult, self.remat = dropout, feature_grad_mult, remat
        self.layerdrop = layerdrop
        self.feature_extractor = ConvFeatureExtractor(conv_spec, conv_bias, extractor_mode,
                                                      device=device)
        feat_dim = conv_spec[-1][0]
        self.layer_norm = LayerNorm(feat_dim, device=device)
        self.post_extract_proj = (
            linear(feat_dim, encoder_embed_dim, device=device)
            if feat_dim != encoder_embed_dim else None
        )
        if mask_emb:
            self.mask_emb = nn.Parameter(torch.zeros(encoder_embed_dim, device=device))
        self.encoder = _ContextNetwork(encoder_embed_dim, encoder_ffn_dim, encoder_layers,
                                       encoder_heads, conv_pos, conv_pos_groups, activation,
                                       layer_norm_first,
                                       (dropout, attention_dropout, activation_dropout), device)

    def init_extra_(self, generator: torch.Generator) -> None:
        """``mask_emb`` uniform in [0, 1) (flax ``uniform(1.0)``)."""
        if hasattr(self, "mask_emb"):
            self.mask_emb.uniform_(0.0, 1.0, generator=generator)

    def forward(self, source: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mask_indices: Optional[torch.Tensor] = None):
        """source [B, T] raw waveform, padding_mask [B, T] True = pad,
        mask_indices [B, T'] (the frames that take ``mask_emb``; ignored
        without it) -> (features [B, T', C], padding_mask' [B, T'] or None)."""
        p = self.dropout if self.training else 0.0
        features = grad_multiply(self.feature_extractor(source), self.feature_grad_mult)
        features = self.layer_norm(features)
        if padding_mask is not None:
            padding_mask = downsample_padding_mask(padding_mask, features.shape[1])
        if self.post_extract_proj is not None:
            features = self.post_extract_proj(features)
        if mask_indices is not None and hasattr(self, "mask_emb"):
            m = mask_indices[:, : features.shape[1], None]
            features = torch.where(m, self.mask_emb.to(features.dtype), features)
        x = dropout(features, p, generator)
        if padding_mask is not None:
            x = x.masked_fill(padding_mask[:, :, None], 0.0)
        x = x + self.encoder.pos_conv[0](x)
        if not self.layer_norm_first:
            x = self.encoder.layer_norm(x)
        x = dropout(x, p, generator)
        remat = self.remat and self.training and torch.is_grad_enabled()
        layers = list(self.encoder.layers)
        if self.training and self.layerdrop > 0.0:
            keep = layerdrop_keep(len(layers), self.layerdrop, generator)
            layers = [layer for layer, k in zip(layers, keep) if k]
        for layer in layers:
            x = (remat_layer(layer, x, padding_mask, generator) if remat
                 else layer(x, padding_mask, generator))
        if self.layer_norm_first:
            x = self.encoder.layer_norm(x)
        return x, padding_mask
