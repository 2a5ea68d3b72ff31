"""Transformer decoder with tied embeddings (counterpart of
chimera_st_tpu/models/transformer_decoder.py): the teacher-forced forward
and the incremental ``step`` of the lazy-reorder beam search, whose
self-attention caches are ``[N, H, L, D]`` per layer (N = sentences * beam;
int8 with per-row scales under ``--kv-cache-int8``) and are updated in
place, and ``cross_attention_weights`` for alignments. In training the
forward drops the embeddings (JAX ``transformer_decoder.py:176``) and each
layer's sublayers.

The options of the Transformer family (JAX ``transformer_decoder.py:50-52``,
``:104-117``): learned positions (``embed_positions``, ids ``padding_idx + 1
+ t`` over the non-pad steps), a LayerNorm over the scaled embeddings
(``layernorm_embedding``), an untied ``output_projection``, and the
decoder-only form of the language model (``cross_attention=False``: layers
without cross-attention, no encoder input in ``forward`` or ``step``), and
a given token embedder (``embed_tokens``: the character embedder, which
forces the untied projection), no output layer (``output_layer``
False: a language model's adaptive softmax reads the features), and a
bidirectional self-attention (``causal`` False: the non-autoregressive
models' decoder over a canvas, JAX ``transformer_decoder.py:50``; no
``step``)."""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from .embedding import Embed
from .layers import (
    LayerNorm,
    TransformerDecoderLayer,
    dropout,
    linear,
    position_at_step,
    positional_embedding_from_mask,
    sinusoidal_positions,
)


def learned_positions(embed_positions: Embed, pad_mask: torch.Tensor,
                      padding_idx: int) -> torch.Tensor:
    """[B, T, C] learned positions of a padded batch: non-pad step t takes
    row ``padding_idx + 1 + t`` (counting only non-pad steps), a pad the
    padding row; an id past the table takes its last row, as the JAX gather
    clamps."""
    nonpad = (~pad_mask).long()
    ids = torch.cumsum(nonpad, dim=1) * nonpad + padding_idx
    return embed_positions(ids.clamp(max=embed_positions.weight.shape[0] - 1))


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 512, ffn_dim: int = 2048,
                 num_layers: int = 6, num_heads: int = 8, activation: str = "relu",
                 normalize_before: bool = True, padding_idx: int = 1,
                 no_scale_embedding: bool = False, max_target_positions: int = 1024,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0, learned_pos: bool = False,
                 layernorm_embedding: bool = False, share_input_output_embed: bool = True,
                 cross_attention: bool = True, embed_tokens: Optional[nn.Module] = None,
                 output_layer: bool = True, causal: bool = True, pipeline=None, device="cuda"):
        super().__init__()
        self.causal = causal
        self.pipeline = pipeline  # parallel/pipeline.py pipeline_config, or None
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.padding_idx = padding_idx
        self.dropout = dropout
        # a given embedder (the character embedder) has no table to tie
        self.embed_tokens = embed_tokens if embed_tokens is not None else Embed(
            vocab_size, embed_dim, padding_idx=padding_idx, device=device)
        share_input_output_embed = share_input_output_embed and embed_tokens is None
        if learned_pos:
            self.embed_positions = Embed(max_target_positions + padding_idx + 1, embed_dim,
                                         padding_idx=padding_idx, device=device)
        if layernorm_embedding:
            self.layernorm_embedding = LayerNorm(embed_dim, device=device)
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(embed_dim, ffn_dim, num_heads, activation, normalize_before,
                                    dropout, attention_dropout, activation_dropout,
                                    cross_attention, causal, device=device)
            for _ in range(num_layers)
        ])
        self.layer_norm = LayerNorm(embed_dim, device=device) if normalize_before else None
        if output_layer and not share_input_output_embed:
            self.output_projection = linear(embed_dim, vocab_size, bias=False, device=device)
        self.embed_scale = 1.0 if no_scale_embedding else math.sqrt(embed_dim)
        self.register_buffer(
            "positions",
            sinusoidal_positions(max_target_positions, embed_dim, padding_idx, device=device),
            persistent=False,
        )

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.layer_norm is None else self.layer_norm(x)

    def _output(self, x: torch.Tensor) -> torch.Tensor:
        x = self._features(x)
        if hasattr(self, "output_projection"):
            # products of the compute-dtype values summed in fp32, as ``attend``
            return torch.matmul(x.float(), self.output_projection.weight.float().t())
        return self.embed_tokens.attend(x)

    def _embed(self, tokens: torch.Tensor, pad_mask: Optional[torch.Tensor],
               step_index: Optional[int] = None) -> torch.Tensor:
        """Scaled token embeddings plus positions (of ``pad_mask``, or of
        decode step ``step_index``), through ``layernorm_embedding``."""
        x = self.embed_scale * self.embed_tokens(tokens)
        learned = hasattr(self, "embed_positions")
        if step_index is not None:
            if learned:
                table = self.embed_positions.weight
                pos = table[min(self.padding_idx + 1 + step_index, table.shape[0] - 1)]
            else:
                pos = position_at_step(self.positions, step_index, self.padding_idx)
        elif learned:
            pos = learned_positions(self.embed_positions, pad_mask, self.padding_idx)
        else:
            pos = positional_embedding_from_mask(pad_mask, self.embed_dim, self.padding_idx)
        x = x + pos.to(x.dtype)
        if hasattr(self, "layernorm_embedding"):
            x = self.layernorm_embedding(x)
        return x

    def forward(self, prev_output_tokens: torch.Tensor, encoder_out: Optional[torch.Tensor],
                encoder_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                features_only: bool = False) -> torch.Tensor:
        """Teacher-forced forward: [B, T] tokens -> fp32 logits [B, T, V]
        (``encoder_out`` None: the language model); ``features_only`` ->
        the final states [B, T, C] before the output projection."""
        pad_mask = prev_output_tokens == self.padding_idx
        x = self._embed(prev_output_tokens, pad_mask)
        x = dropout(x, self.dropout if self.training else 0.0, generator)
        piped = self._pipelined(x, pad_mask, encoder_out, encoder_padding_mask)
        if piped is not None:
            x = piped
        else:  # no pipeline, or a batch that does not divide into its chunks
            for layer in self.layers:
                x = layer(x, encoder_out, encoder_padding_mask, pad_mask, generator)
        return self._features(x) if features_only else self._output(x)

    def _pipelined(self, x, pad_mask, encoder_out, encoder_padding_mask):
        """The layer stack through the GPipe schedule (JAX
        ``transformer_decoder.py:222-260``): the encoder states and their
        mask ride along as each micro-batch's side inputs."""
        if self.pipeline is None:
            return None
        from ..parallel.pipeline import pipelined_modules

        if encoder_out is None:
            return pipelined_modules(self.layers, lambda layer, h, m: layer(h, None, None, m),
                                     x, (pad_mask,), self.pipeline)
        if encoder_padding_mask is None:
            encoder_padding_mask = torch.zeros(encoder_out.shape[:2], dtype=torch.bool,
                                               device=encoder_out.device)
        return pipelined_modules(
            self.layers, lambda layer, h, m, enc, enc_mask: layer(h, enc, enc_mask, m),
            x, (pad_mask, encoder_out, encoder_padding_mask), self.pipeline)

    def precompute_encoder_kv(self, encoder_out: torch.Tensor):
        """Per layer (k, v) [B, S, H, D] of the cross-attention, projected
        once per sentence and shared by its beams."""
        return [layer.encoder_attn.compute_kv(encoder_out) for layer in self.layers]

    def init_cache(self, columns: int, max_len: int, int8: bool = False
                   ) -> List[Tuple[torch.Tensor, ...]]:
        """Zeroed self-attention caches, one per layer: (k, v) [columns, H,
        max_len, D] in the compute dtype, or with ``int8`` (k, v) in int8
        and their fp32 scales (k_scale, v_scale) [columns, max_len]."""
        # the compute dtype: a projection's weight
        w = self.layers[0].self_attn.q_proj.weight
        shape = (columns, self.num_heads, max_len, self.embed_dim // self.num_heads)
        if int8:
            return [(torch.zeros(shape, dtype=torch.int8, device=w.device),
                     torch.zeros(shape, dtype=torch.int8, device=w.device),
                     torch.zeros(shape[::2], dtype=torch.float32, device=w.device),
                     torch.zeros(shape[::2], dtype=torch.float32, device=w.device))
                    for _ in self.layers]
        return [(torch.zeros(shape, dtype=w.dtype, device=w.device),
                 torch.zeros(shape, dtype=w.dtype, device=w.device)) for _ in self.layers]

    def step(self, tokens: torch.Tensor, step_index: int,
             caches: List[Tuple[torch.Tensor, ...]],
             encoder_kv, encoder_padding_mask: Optional[torch.Tensor],
             ancestry: torch.Tensor, groups: int,
             generator: Optional[torch.Generator] = None,
             cross_attention_dropout: bool = False, features_only: bool = False
             ) -> torch.Tensor:
        """One decode step: tokens [N, 1] -> fp32 logits [N, V]. ``caches``
        are written in place at ``step_index``; ``ancestry`` [>L, N] int32 is
        the lazy-reorder map, ``groups`` the beam size; ``encoder_kv`` None
        for the language model. In training mode
        (``--retain-dropout``) the embedding and each layer's residual and
        activation dropouts draw their masks from ``generator``, and with
        ``cross_attention_dropout`` the cross-attention probabilities too.
        ``features_only`` -> the final states [N, C] (what a language
        model's adaptive softmax reads). A bidirectional decoder
        (``causal`` False) has no incremental step and raises."""
        if not self.causal:
            raise ValueError("a bidirectional decoder (decoder_causal=False) has no "
                             "incremental decode step")
        x = self._embed(tokens, None, step_index)
        x = dropout(x, self.dropout if self.training else 0.0, generator)
        if encoder_kv is None:  # the language model
            encoder_kv = [None] * len(self.layers)
        for layer, cache, ekv in zip(self.layers, caches, encoder_kv):
            x = layer.step(x, ekv, encoder_padding_mask, cache, ancestry, step_index, groups,
                           generator, cross_attention_dropout)
        if features_only:
            return self._features(x)[:, 0, :]
        return self._output(x)[:, 0, :]

    def cross_attention_weights(self, prev_output_tokens: torch.Tensor,
                                encoder_out: torch.Tensor,
                                encoder_padding_mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
        """[B, T, S] head-averaged cross-attention of the last layer over a
        teacher-forced pass (for ``--print-alignment`` / ``--replace-unk``),
        without dropout."""
        pad_mask = prev_output_tokens == self.padding_idx
        x = self._embed(prev_output_tokens, pad_mask)
        for layer in self.layers[:-1]:
            x = layer(x, encoder_out, encoder_padding_mask, pad_mask)
        return self.layers[-1].encoder_attn_weights(x, encoder_out, encoder_padding_mask,
                                                    pad_mask)
