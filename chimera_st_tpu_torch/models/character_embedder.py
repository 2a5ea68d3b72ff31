"""Character-aware token embeddings (counterpart of
chimera_st_tpu/models/character_embedder.py; reference
fairseq/modules/character_token_embedder.py), the input embedding of
``transformer_lm --character-embeddings``.

Each word of the dictionary is spelled as its UTF-8 bytes + 1 (0 pads)
into a [V, max_char_len] table (``build_word_to_char``, built by the task
from the dictionary at every build, never saved). A token's embedding is:
character embeddings (char pad -> 0), one 1-D convolution per filter width
over the characters, max over time, ReLU, the highway layers, the
projection; pad -> 0, eos and unk -> two learned symbol vectors.

Module names follow the flax tree: ``char_embeddings``, ``convs.conv_w{w}``
(flax ``conv_w{w}``), ``highway.layers.{i}`` (``highway/layer_{i}``),
``projection``, and the parameter ``symbol_embeddings``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .embedding import Embed
from .layers import conv1d, linear

CHAR_PAD_IDX = 0
N_CHARS = 257  # bytes shifted by +1, 0 reserved for pad
DEFAULT_FILTERS: Tuple[Tuple[int, int], ...] = ((1, 64), (2, 128), (3, 192), (4, 256))


def build_word_to_char(dictionary, max_char_len: int = 50) -> np.ndarray:
    """[V, max_char_len] int32 spelling table: byte values + 1,
    zero-padded; the special symbols spell as all-pad."""
    table = np.zeros((len(dictionary), max_char_len), np.int32)
    for i in range(dictionary.nspecial, len(dictionary)):
        chars = dictionary[i].encode()[:max_char_len]
        table[i, : len(chars)] = np.frombuffer(chars, np.uint8).astype(np.int32) + 1
    return table


class Highway(nn.Module):
    """Highway layers: each one Linear to 2 dim, the second half the carry
    gate (its bias starts at 1, so that the stack starts as the identity)."""

    def __init__(self, dim: int, num_layers: int, device="cuda"):
        super().__init__()
        self.dim = dim
        self.layers = nn.ModuleList([linear(dim, 2 * dim, device=device)
                                     for _ in range(num_layers)])

    def reset_gate_bias_(self) -> None:
        with torch.no_grad():
            for layer in self.layers:
                layer.bias.zero_()
                layer.bias[self.dim:] = 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            proj_x, gate = layer(x).chunk(2, dim=-1)
            gate = torch.sigmoid(gate)
            x = gate * x + (1.0 - gate) * torch.relu(proj_x)
        return x


class CharacterTokenEmbedder(nn.Module):
    """The decoder's token embedding from characters: tokens [...] ->
    [..., word_embed_dim]."""

    def __init__(self, word_to_char: np.ndarray, word_embed_dim: int, char_embed_dim: int = 4,
                 filters: Sequence[Tuple[int, int]] = DEFAULT_FILTERS, highway_layers: int = 2,
                 pad_idx: int = 1, eos_idx: int = 2, unk_idx: int = 3, device="cuda"):
        super().__init__()
        self.pad_idx, self.eos_idx, self.unk_idx = pad_idx, eos_idx, unk_idx
        self.register_buffer("word_to_char",
                             torch.as_tensor(np.asarray(word_to_char), dtype=torch.long,
                                             device=device), persistent=False)
        self.char_embeddings = Embed(N_CHARS, char_embed_dim, device=device)
        self.convs = nn.ModuleDict({f"conv_w{w}": conv1d(char_embed_dim, c, w, device=device)
                                    for w, c in filters})
        width = sum(c for _, c in filters)
        self.highway = Highway(width, highway_layers, device) if highway_layers > 0 else None
        self.projection = linear(width, word_embed_dim, device=device)
        self.symbol_embeddings = nn.Parameter(torch.zeros(2, word_embed_dim, device=device))

    def init_extra_(self, generator: torch.Generator) -> None:
        """The JAX initialisers ``init_params_`` does not cover: xavier-normal
        symbol vectors, the highway's carry-gate bias 1."""
        with torch.no_grad():
            fan = self.symbol_embeddings.shape
            self.symbol_embeddings.normal_(0.0, math.sqrt(2.0 / (fan[0] + fan[1])),
                                           generator=generator)
        if self.highway is not None:
            self.highway.reset_gate_bias_()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        chars = self.word_to_char[tokens]  # [..., M]
        lead, M = chars.shape[:-1], chars.shape[-1]
        emb = self.char_embeddings(chars).masked_fill((chars == CHAR_PAD_IDX)[..., None], 0.0)
        x = emb.reshape(-1, M, emb.shape[-1]).transpose(1, 2)  # [N, cd, M]
        pooled = [torch.relu(conv(x).amax(dim=-1)) for conv in self.convs.values()]
        h = torch.cat(pooled, dim=-1)
        if self.highway is not None:
            h = self.highway(h)
        h = self.projection(h).reshape(*lead, -1)
        symbol = self.symbol_embeddings.to(h.dtype)
        h = torch.where((tokens == self.eos_idx)[..., None], symbol[0], h)
        h = torch.where((tokens == self.unk_idx)[..., None], symbol[1], h)
        return h.masked_fill((tokens == self.pad_idx)[..., None], 0.0)
