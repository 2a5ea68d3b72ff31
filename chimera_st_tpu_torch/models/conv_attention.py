"""Lightweight and dynamic convolutions (counterpart of
chimera_st_tpu/models/conv_attention.py; fairseq ``lightconv_layer`` /
``dynamicconv_layer``, "Pay Less Attention with Lightweight and Dynamic
Convolutions").

The JAX package builds these in XLA, not Pallas, so the port runs them in
plain PyTorch: the depthwise banded convolution is K shifted views of the
input contracted against softmax-normalised head-shared weights. The views
are ``Tensor.unfold`` windows over the padded input, which copy nothing.
Causal (decoder) and same-padded (encoder) modes; a same-padded view pads
(K - 1) // 2 steps on the left and the rest on the right.

- ``LightweightConv``: weights learned per (head, tap), shared across time
  and the head's channels (its own parameter ``weight`` [H, K]).
- ``DynamicConv``: weights predicted per position by a bias-free linear
  ``weight_linear``; the softmax in fp32, weight dropout from the dropout
  stream.
- ``ConvAttentionLayer``: linear -> GLU -> conv -> linear with the usual
  residuals, LayerNorms and ReLU FFN (fairseq ``lightconv.py``'s encoder
  layer).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dropout
from .layers import LayerNorm, linear


def pad_for_views(x: torch.Tensor, kernel_size: int, causal: bool) -> torch.Tensor:
    """[B, T, C] -> [B, T + K - 1, C]: K - 1 zero steps on the left (causal),
    else (K - 1) // 2 on the left and the rest on the right."""
    left = kernel_size - 1 if causal else (kernel_size - 1) // 2
    return F.pad(x, (0, 0, left, kernel_size - 1 - left))


def shifted_views(x: torch.Tensor, kernel_size: int, causal: bool) -> torch.Tensor:
    """[B, T, C] -> [B, T, K, C]; view k holds x at offset (k - left pad)."""
    return pad_for_views(x, kernel_size, causal).unfold(1, kernel_size, 1).transpose(2, 3)


def apply_conv_weights(x: torch.Tensor, weights: torch.Tensor, num_heads: int,
                       causal: bool) -> torch.Tensor:
    """x [B, T, C]; weights [H, K] (lightweight) or [B, T, H, K] (dynamic)
    -> [B, T, C]: out[b, t, h, d] = sum_k w[.., h, k] x[b, t + k - pad, h, d]."""
    B, T, C = x.shape
    K = weights.shape[-1]
    # [B, T, C, K] windows, no copy; the channel axis splits into heads
    views = pad_for_views(x, K, causal).unfold(1, K, 1).reshape(B, T, num_heads,
                                                                C // num_heads, K)
    if weights.dim() == 2:
        out = torch.einsum("bthdk,hk->bthd", views, weights)
    else:
        out = torch.einsum("bthdk,bthk->bthd", views, weights)
    return out.reshape(B, T, C)


def _normalise(w: torch.Tensor, weight_softmax: bool, weight_dropout: float,
               generator) -> torch.Tensor:
    w = w.float()
    if weight_softmax:
        w = torch.softmax(w, dim=-1)
    return dropout(w, weight_dropout, generator)


class LightweightConv(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 3, num_heads: int = 8, causal: bool = False,
                 weight_softmax: bool = True, weight_dropout: float = 0.0, device="cuda"):
        super().__init__()
        self.kernel_size, self.num_heads, self.causal = kernel_size, num_heads, causal
        self.weight_softmax, self.weight_dropout = weight_softmax, weight_dropout
        self.weight = nn.Parameter(torch.zeros(num_heads, kernel_size, device=device))

    def init_extra_(self, generator: torch.Generator) -> None:
        """The JAX initialiser (xavier-uniform over [H, K])."""
        nn.init.xavier_uniform_(self.weight, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        w = _normalise(self.weight, self.weight_softmax,
                       self.weight_dropout if self.training else 0.0, generator)
        return apply_conv_weights(x, w.to(x.dtype), self.num_heads, self.causal)


class DynamicConv(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 3, num_heads: int = 8, causal: bool = False,
                 weight_softmax: bool = True, weight_dropout: float = 0.0, device="cuda"):
        super().__init__()
        self.kernel_size, self.num_heads, self.causal = kernel_size, num_heads, causal
        self.weight_softmax, self.weight_dropout = weight_softmax, weight_dropout
        self.weight_linear = linear(dim, num_heads * kernel_size, bias=False, device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B, T, _ = x.shape
        w = self.weight_linear(x).reshape(B, T, self.num_heads, self.kernel_size)
        w = _normalise(w, self.weight_softmax, self.weight_dropout if self.training else 0.0,
                       generator)
        return apply_conv_weights(x, w.to(x.dtype), self.num_heads, self.causal)


def conv_module(conv_type: str, dim: int, kernel_size: int, num_heads: int, causal: bool,
                device) -> nn.Module:
    cls = LightweightConv if conv_type == "lightweight" else DynamicConv
    return cls(dim, kernel_size, num_heads, causal=causal, device=device)


class ConvAttentionLayer(nn.Module):
    """A lightconv / dynamicconv block in place of self-attention:
    [pre-norm] linear1 -> GLU -> (pads zeroed) conv -> linear2 -> dropout ->
    residual, then the ReLU FFN sublayer; ``normalize_before`` False puts the
    norms after the residuals."""

    def __init__(self, dim: int, ffn_dim: int, kernel_size: int = 3, num_heads: int = 8,
                 conv_type: str = "lightweight", causal: bool = False, dropout: float = 0.1,
                 normalize_before: bool = True, device="cuda"):
        super().__init__()
        self.dropout, self.normalize_before = dropout, normalize_before
        self.conv_layer_norm = LayerNorm(dim, device=device)
        self.final_layer_norm = LayerNorm(dim, device=device)
        self.linear1 = linear(dim, 2 * dim, device=device)
        self.conv = conv_module(conv_type, dim, kernel_size, num_heads, causal, device)
        self.linear2 = linear(dim, dim, device=device)
        self.fc1 = linear(dim, ffn_dim, device=device)
        self.fc2 = linear(ffn_dim, dim, device=device)

    def _p(self) -> float:
        return self.dropout if self.training else 0.0

    def conv_block(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor],
                   generator) -> torch.Tensor:
        residual = x
        if self.normalize_before:
            x = self.conv_layer_norm(x)
        x = F.glu(self.linear1(x), dim=-1)
        if padding_mask is not None:
            x = x.masked_fill(padding_mask[:, :, None], 0.0)
        x = self.linear2(self.conv(x, generator))
        x = residual + dropout(x, self._p(), generator)
        return x if self.normalize_before else self.conv_layer_norm(x)

    def ffn_block(self, x: torch.Tensor, generator) -> torch.Tensor:
        residual = x
        if self.normalize_before:
            x = self.final_layer_norm(x)
        x = self.fc2(F.relu(self.fc1(x)))
        x = residual + dropout(x, self._p(), generator)
        return x if self.normalize_before else self.final_layer_norm(x)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.ffn_block(self.conv_block(x, padding_mask, generator), generator)
