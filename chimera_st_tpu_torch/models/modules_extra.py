"""Auxiliary modules (counterpart of chimera_st_tpu/models/modules_extra.py;
fairseq ``modules/vggblock.py``, ``adaptive_input.py``,
``sparse_multihead_attention.py``): VGG convolution blocks, adaptive input
embeddings and the fixed factorised sparse-attention mask.

Layouts are the JAX package's: ``VGGBlock`` maps [B, T, F, C] to [B, T',
F', C']; its convolutions pad as flax ``padding="SAME"`` (stride 1: (k - 1)
/ 2 each side for an odd kernel, the odd step after for an even one).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import NEG_INF
from .berard import same_padding
from .embedding import Embed
from .layers import LayerNorm, conv2d, linear


class VGGBlock(nn.Module):
    """Conv2D (+ LayerNorm over channels) + ReLU, ``num_conv_layers`` times,
    then a max-pool of ``pooling_kernel_size`` over (time, frequency)."""

    def __init__(self, in_channels: int, out_channels: int, conv_kernel_size: int = 3,
                 num_conv_layers: int = 2, pooling_kernel_size: int = 2,
                 layer_norm: bool = False, device="cuda"):
        super().__init__()
        self.kernel, self.pool = conv_kernel_size, pooling_kernel_size
        chans = [in_channels] + [out_channels] * num_conv_layers
        self.conv = nn.ModuleList([conv2d(chans[i], out_channels, conv_kernel_size, device=device)
                                   for i in range(num_conv_layers)])
        self.ln = nn.ModuleList([LayerNorm(out_channels, eps=1e-6, device=device)
                                 for _ in range(num_conv_layers)]) if layer_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # [B, C, T, F]
        for i, conv in enumerate(self.conv):
            t0, t1 = same_padding(x.shape[2], self.kernel, 1)
            f0, f1 = same_padding(x.shape[3], self.kernel, 1)
            x = F.conv2d(F.pad(x, (f0, f1, t0, t1)), conv.weight, conv.bias)
            if self.ln is not None:
                x = self.ln[i](x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = F.relu(x)
        p = self.pool
        if p and p > 1:
            x = F.max_pool2d(x, p, p)
        return x.permute(0, 2, 3, 1)

    @staticmethod
    def output_length(t: int, pooling_kernel_size: int, num_blocks: int) -> int:
        for _ in range(num_blocks):
            t = t // pooling_kernel_size
        return t


class AdaptiveInput(nn.Module):
    """Clustered input embeddings (Baevski & Auli): cluster i embeds at
    ``initial_dim / factor ** i`` and is projected to ``output_dim``; as in
    JAX every cluster embeds every position (ids clamped into its range)
    and a position keeps its own cluster's vector; a pad is zero."""

    def __init__(self, vocab_size: int, initial_dim: int, output_dim: int, factor: float = 4.0,
                 cutoff: Sequence[int] = (5000, 20000), padding_idx: int = 1, device="cuda"):
        super().__init__()
        cutoff = list(cutoff)
        if vocab_size > cutoff[-1]:
            cutoff = cutoff + [vocab_size]
        if vocab_size != cutoff[-1]:
            raise ValueError("cutoff must end at the vocabulary size")
        self.cutoff, self.padding_idx = cutoff, padding_idx
        sizes = [hi - lo for lo, hi in zip([0] + cutoff[:-1], cutoff)]
        dims = [int(initial_dim // (factor ** i)) for i in range(len(cutoff))]
        self.embed = nn.ModuleList([Embed(n, d, device=device) for n, d in zip(sizes, dims)])
        self.proj = nn.ModuleList([linear(d, output_dim, bias=False, device=device)
                                   for d in dims])

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out, lo = None, 0
        for table, proj, hi in zip(self.embed, self.proj, self.cutoff):
            local = torch.clamp(ids - lo, 0, hi - lo - 1)
            vec = proj(table(local)).masked_fill(~((ids >= lo) & (ids < hi))[..., None], 0.0)
            out = vec if out is None else out + vec
            lo = hi
        return out.masked_fill((ids == self.padding_idx)[..., None], 0.0)


def sparse_attention_mask(seq_len: int, stride: int = 32, expressivity: int = 8,
                          bidirectional: bool = True, device=None) -> torch.Tensor:
    """Additive [T, T] fp32 mask of fixed factorised sparse attention
    ("Generating Long Sequences with Sparse Transformers"): a query sees its
    own stride window and the last ``expressivity`` positions of every
    earlier window (and, bidirectional, every later one); 0 where allowed,
    -1e8 elsewhere."""
    q = torch.arange(seq_len, device=device)[:, None]
    k = torch.arange(seq_len, device=device)[None, :]
    same_window = (q // stride) == (k // stride)
    is_summary = (k % stride) >= (stride - expressivity)
    allowed = same_window | (((k // stride) < (q // stride)) & is_summary)
    if bidirectional:
        allowed = allowed | (((k // stride) > (q // stride)) & is_summary)
    else:
        allowed = allowed & (k <= q)
    return torch.where(allowed, 0.0, NEG_INF).to(torch.float32)
