"""The fairseq Transformer family (counterpart of
chimera_st_tpu/models/transformer_mt.py): the encoder-decoder MT
``TransformerModel`` (fairseq ``transformer``) and the decoder-only
``TransformerLM`` (fairseq ``transformer_lm``), with their 23 presets.

Both reuse the shared layers. The MT encoder's self-attention is
bidirectional, so on the card it runs K1; the MT decoder's and the LM's
cached self-attention in the beam search run K3. The LM's full forward is
causal and runs no kernel (K1 covers bidirectional attention only, as the
Pallas kernel's gate ``flash_attention_applicable``). With
``decoder_causal`` False (the backbone of the non-autoregressive models,
``models/nat_*.py``) the decoder's self-attention is bidirectional over
the canvas and runs K1 too; such a decoder has no incremental step.

Module names follow the fairseq state dict: ``encoder.embed_tokens``,
``encoder.embed_positions``, ``encoder.layernorm_embedding``,
``encoder.layers.{i}``, ``encoder.layer_norm``, ``decoder.*``.

The language model's ``adaptive_softmax_cutoffs`` put an
``AdaptiveSoftmax`` on its features (``transformer_lm_wiki103``): its
forward then returns normalized log-probabilities, ``adaptive_nll`` the
clustered NLL of ``adaptive_loss``, and ``step_log_probs`` the beam step's
log-probabilities either way. ``character_embeddings`` builds the decoder's
input embedding from characters (``CharacterTokenEmbedder``, its spelling
table ``word_to_char`` injected by the task, never saved) with an untied
output projection.

With ``pipeline_stages`` above 1 (``--pipeline-stages``, given the rank
grid as ``pipeline_mesh``) the encoder's and the decoder's layer stacks
run the GPipe schedule of ``parallel/pipeline.py`` in the teacher-forced
forward, as the JAX models do; the decode steps run the layers in turn.
``share_all_embeddings`` is declared and not honoured, in the JAX package
as here: the source and target embeddings stay two tables (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from .embedding import Embed
from .layers import LayerNorm, TransformerEncoderLayer, dropout, positional_embedding_from_mask
from .transformer_decoder import TransformerDecoder, learned_positions


@dataclass(frozen=True)
class TransformerMTConfig:
    """The JAX package's TransformerMTConfig (``transformer_mt.py:35-70``)."""

    src_vocab_size: int = 8
    tgt_vocab_size: int = 8
    padding_idx: int = 1
    encoder_embed_dim: int = 512
    encoder_ffn_dim: int = 2048
    encoder_layers: int = 6
    encoder_heads: int = 8
    encoder_normalize_before: bool = False
    decoder_embed_dim: int = 512
    decoder_ffn_dim: int = 2048
    decoder_layers: int = 6
    decoder_heads: int = 8
    decoder_normalize_before: bool = False
    share_decoder_input_output_embed: bool = True
    share_all_embeddings: bool = False  # declared, not honoured (as in the JAX package)
    max_target_positions: int = 1024
    decoder_causal: bool = True
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    activation: str = "relu"
    no_scale_embedding: bool = False
    learned_pos: bool = False
    layernorm_embedding: bool = False
    pipeline_stages: int = 0
    pipeline_chunks: int = 0
    pipeline_remat: bool = False


@dataclass(frozen=True)
class TransformerLMConfig:
    """The JAX package's TransformerLMConfig (``transformer_mt.py:221-252``)."""

    vocab_size: int = 8
    padding_idx: int = 1
    embed_dim: int = 512
    ffn_dim: int = 2048
    layers: int = 6
    heads: int = 8
    normalize_before: bool = True
    max_target_positions: int = 1024
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation: str = "relu"
    adaptive_softmax_cutoffs: Optional[Tuple[int, ...]] = None
    character_embeddings: bool = False
    character_filters: Optional[Tuple[Tuple[int, int], ...]] = None
    character_embedding_dim: int = 4
    char_embedder_highway_layers: int = 2
    max_char_len: int = 50
    pipeline_stages: int = 0
    pipeline_chunks: int = 0
    pipeline_remat: bool = False


class TextEncoder(nn.Module):
    """The fairseq ``encoder`` submodule, and its forward: the MT
    transformer's encoder, and one language group of the multilingual
    model's (JAX ``multilingual_transformer.py:63``)."""

    def __init__(self, c: TransformerMTConfig, device, pipeline=None):
        super().__init__()
        self.cfg = c
        self.pipeline = pipeline
        self.embed_tokens = Embed(c.src_vocab_size, c.encoder_embed_dim,
                                  padding_idx=c.padding_idx, device=device)
        if c.learned_pos:  # the JAX model sizes it by max_target_positions
            self.embed_positions = Embed(c.max_target_positions + c.padding_idx + 1,
                                         c.encoder_embed_dim, padding_idx=c.padding_idx,
                                         device=device)
        if c.layernorm_embedding:
            self.layernorm_embedding = LayerNorm(c.encoder_embed_dim, device=device)
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(c.encoder_embed_dim, c.encoder_ffn_dim, c.encoder_heads,
                                    c.activation, c.encoder_normalize_before, c.dropout,
                                    c.attention_dropout, c.activation_dropout, device=device)
            for _ in range(c.encoder_layers)
        ])
        if c.encoder_normalize_before:
            self.layer_norm = LayerNorm(c.encoder_embed_dim, device=device)
        self.embed_scale = 1.0 if c.no_scale_embedding else math.sqrt(c.encoder_embed_dim)

    def forward(self, src_tokens: torch.Tensor, generator: Optional[torch.Generator] = None):
        """src_tokens [B, S] int -> (encoder states [B, S, C], padding mask
        [B, S])."""
        c = self.cfg
        pad_mask = src_tokens == c.padding_idx
        x = self.embed_scale * self.embed_tokens(src_tokens)
        if c.learned_pos:
            pos = learned_positions(self.embed_positions, pad_mask, c.padding_idx)
        else:
            pos = positional_embedding_from_mask(pad_mask, c.encoder_embed_dim, c.padding_idx)
        x = x + pos.to(x.dtype)
        if c.layernorm_embedding:
            x = self.layernorm_embedding(x)
        x = dropout(x, c.dropout if self.training else 0.0, generator)
        piped = None
        if self.pipeline is not None:
            from ..parallel.pipeline import pipelined_modules

            piped = pipelined_modules(self.layers, lambda layer, h, m: layer(h, m), x,
                                      (pad_mask,), self.pipeline)
        if piped is not None:
            x = piped
        else:  # no pipeline, or a batch that does not divide into its chunks
            for layer in self.layers:
                x = layer(x, pad_mask, generator)
        if c.encoder_normalize_before:
            x = self.layer_norm(x)
        return x, pad_mask


class TransformerModel(nn.Module):
    """Encoder-decoder MT transformer. In training mode (``--retain-dropout``)
    every dropout of the JAX model acts, its masks drawn from the
    ``generator`` each forward takes."""

    def __init__(self, cfg: TransformerMTConfig, device="cuda", pipeline_mesh=None):
        super().__init__()
        from ..parallel.pipeline import pipeline_config

        self.cfg = c = cfg
        pipeline = pipeline_config(c, pipeline_mesh)
        self.encoder = TextEncoder(cfg, device, pipeline)
        self.decoder = TransformerDecoder(
            c.tgt_vocab_size, c.decoder_embed_dim, c.decoder_ffn_dim, c.decoder_layers,
            c.decoder_heads, c.activation, c.decoder_normalize_before, c.padding_idx,
            c.no_scale_embedding, c.max_target_positions, c.dropout, c.attention_dropout,
            c.activation_dropout, learned_pos=c.learned_pos,
            layernorm_embedding=c.layernorm_embedding,
            share_input_output_embed=c.share_decoder_input_output_embed, causal=c.decoder_causal,
            pipeline=pipeline, device=device,
        )

    def encode(self, src_tokens: torch.Tensor, generator: Optional[torch.Generator] = None):
        """src_tokens [B, S] int -> (encoder states [B, S, C], padding mask
        [B, S])."""
        return self.encoder(src_tokens, generator)

    def encode_text(self, src_tokens: torch.Tensor,
                    generator: Optional[torch.Generator] = None):
        """The text API of the interlingua model (what the generator, the
        scorer and the criterions call)."""
        return self.encode(src_tokens, generator)

    def decode(self, prev_output_tokens: torch.Tensor, encoder_out: torch.Tensor,
               encoder_padding_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decoder(prev_output_tokens, encoder_out, encoder_padding_mask, generator)

    def forward(self, src_tokens, prev_output_tokens,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced: -> fp32 logits [B, T, V]."""
        return self.forward_text_with_internal(src_tokens, prev_output_tokens, generator)[0]

    def forward_text_with_internal(self, src_tokens, prev_output_tokens,
                                   generator: Optional[torch.Generator] = None):
        """-> (logits [B, T, V], encoder states [B, S, C])."""
        enc, enc_mask = self.encode(src_tokens, generator)
        return self.decode(prev_output_tokens, enc, enc_mask, generator), enc


class TransformerLM(nn.Module):
    """Decoder-only language model: the shared decoder without
    cross-attention. ``forward`` is causal (no kernel); ``step_log_probs``
    is the cached beam step of shallow fusion (K3 once a layer)."""

    def __init__(self, cfg: TransformerLMConfig, device="cuda", word_to_char=None,
                 pipeline_mesh=None):
        super().__init__()
        from ..parallel.pipeline import pipeline_config

        self.cfg = c = cfg
        embed_tokens = None
        if c.character_embeddings:
            from .character_embedder import DEFAULT_FILTERS, CharacterTokenEmbedder

            if word_to_char is None:
                raise ValueError("character_embeddings needs a task with a target dictionary "
                                 "(the word -> char table is built from it)")
            embed_tokens = CharacterTokenEmbedder(
                word_to_char, c.embed_dim, c.character_embedding_dim,
                tuple(c.character_filters or DEFAULT_FILTERS), c.char_embedder_highway_layers,
                pad_idx=c.padding_idx, device=device)
        self.decoder = TransformerDecoder(
            c.vocab_size, c.embed_dim, c.ffn_dim, c.layers, c.heads, c.activation,
            c.normalize_before, c.padding_idx, False, c.max_target_positions, c.dropout,
            c.attention_dropout, c.activation_dropout, cross_attention=False,
            embed_tokens=embed_tokens, output_layer=not c.adaptive_softmax_cutoffs,
            pipeline=pipeline_config(c, pipeline_mesh), device=device,
        )
        if c.adaptive_softmax_cutoffs:
            from .adaptive_softmax import AdaptiveSoftmax

            self.adaptive_softmax = AdaptiveSoftmax(c.vocab_size, c.embed_dim,
                                                    tuple(c.adaptive_softmax_cutoffs),
                                                    device=device)
        else:
            self.adaptive_softmax = None

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T] tokens -> fp32 logits [B, T, V] (causal); with an adaptive
        softmax its log-probabilities."""
        if self.adaptive_softmax is not None:
            return self.adaptive_softmax.log_prob(
                self.decoder(tokens, None, None, generator, features_only=True))
        return self.decoder(tokens, None, None, generator)

    def adaptive_nll(self, tokens: torch.Tensor, target: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The per-position clustered NLL [B, T] (``adaptive_loss``)."""
        if self.adaptive_softmax is None:
            raise ValueError("adaptive_loss needs a language model with "
                             "adaptive_softmax_cutoffs")
        return self.adaptive_softmax.nll(
            self.decoder(tokens, None, None, generator, features_only=True), target)

    def step_log_probs(self, tokens: torch.Tensor, step_index: int, caches,
                       ancestry: torch.Tensor, groups: int) -> torch.Tensor:
        """One cached decode step of shallow fusion: tokens [N, 1] -> the
        normalized fp32 log-probabilities [N, V]: the adaptive softmax's
        where the model has one, else the log-softmax of the output layer."""
        if self.adaptive_softmax is not None:
            feats = self.decoder.step(tokens, step_index, caches, None, None, ancestry, groups,
                                      features_only=True)
            return self.adaptive_softmax.log_prob(feats)
        logits = self.decoder.step(tokens, step_index, caches, None, None, ancestry, groups)
        return torch.log_softmax(logits.float(), dim=-1)


def _config(config_cls, cfg_dict: Dict):
    names = {f.name for f in dataclasses.fields(config_cls)}
    return config_cls(**{k: v for k, v in cfg_dict.items() if k in names})


def preset(**defaults):
    """An architecture preset: fills ``defaults`` into a config, a given
    field winning (the JAX presets' ``setdefault``)."""
    def fill(cfg: Dict) -> Dict:
        return {**defaults, **cfg}
    return fill


def build_transformer(cfg_dict: Dict, device="cuda") -> TransformerModel:
    d = dict(cfg_dict)
    mesh = d.pop("pipeline_mesh", None)  # the run's rank grid, never saved
    cfg = _config(TransformerMTConfig, d)
    if cfg.pipeline_stages > 1 and (cfg.encoder_layers % cfg.pipeline_stages
                                    or cfg.decoder_layers % cfg.pipeline_stages):
        raise ValueError("encoder_layers and decoder_layers must divide into pipeline_stages "
                         "(uniform balance)")
    return TransformerModel(cfg, device=device, pipeline_mesh=mesh)


def build_transformer_lm(cfg_dict: Dict, device="cuda") -> TransformerLM:
    d = dict(cfg_dict)
    d.setdefault("vocab_size", d.pop("tgt_vocab_size", 8))
    mesh = d.pop("pipeline_mesh", None)
    word_to_char = d.pop("word_to_char", None)  # injected by the task, never saved
    cfg = _config(TransformerLMConfig, d)
    if cfg.pipeline_stages > 1 and cfg.layers % cfg.pipeline_stages:
        raise ValueError("layers must divide into pipeline_stages (uniform balance)")
    return TransformerLM(cfg, device=device, word_to_char=word_to_char, pipeline_mesh=mesh)


# ---- presets (JAX transformer_mt.py:392-566; reference fairseq
# models/transformer.py:988-1025, transformer_align.py:89-93,
# transformer_lm.py:310-393): each fills its defaults, a given field wins

def transformer_base(cfg: Dict) -> Dict:
    d = dict(cfg)
    d.setdefault("encoder_embed_dim", 512)
    d.setdefault("encoder_ffn_dim", 2048)
    d.setdefault("encoder_layers", 6)
    d.setdefault("encoder_heads", 8)
    d.setdefault("decoder_embed_dim", d["encoder_embed_dim"])
    d.setdefault("decoder_ffn_dim", d["encoder_ffn_dim"])
    d.setdefault("decoder_layers", 6)
    d.setdefault("decoder_heads", 8)
    return d


def transformer_iwslt(cfg: Dict) -> Dict:
    d = dict(cfg)
    d.setdefault("encoder_embed_dim", 512)
    d.setdefault("encoder_ffn_dim", 1024)
    d.setdefault("encoder_heads", 4)
    d.setdefault("decoder_ffn_dim", 1024)
    d.setdefault("decoder_heads", 4)
    return transformer_base(d)


def transformer_vaswani_big(cfg: Dict) -> Dict:
    d = dict(cfg)
    d.setdefault("encoder_embed_dim", 1024)
    d.setdefault("encoder_ffn_dim", 4096)
    d.setdefault("encoder_heads", 16)
    d.setdefault("decoder_heads", 16)
    d.setdefault("dropout", 0.3)
    return transformer_base(d)


def transformer_big(cfg: Dict) -> Dict:
    return transformer_vaswani_big({"attention_dropout": 0.1, **cfg})


def transformer_vaswani_fr_big(cfg: Dict) -> Dict:
    return transformer_vaswani_big({"dropout": 0.1, **cfg})


def transformer_big_t2t(cfg: Dict) -> Dict:
    return transformer_vaswani_big({"encoder_normalize_before": True,
                                    "decoder_normalize_before": True,
                                    "attention_dropout": 0.1, "activation_dropout": 0.1, **cfg})


def transformer_lm_base(cfg: Dict) -> Dict:
    return dict(cfg)


def transformer_lm_big(cfg: Dict) -> Dict:
    return {"layers": 12, "embed_dim": 1024, "ffn_dim": 4096, "heads": 16, **cfg}


def transformer_lm_wiki103(cfg: Dict) -> Dict:
    return transformer_lm_big({"layers": 16, "heads": 8, "dropout": 0.3,
                               "attention_dropout": 0.1, "activation_dropout": 0.1,
                               "adaptive_softmax_cutoffs": (20000, 60000), **cfg})


def transformer_lm_gbw(cfg: Dict) -> Dict:
    return transformer_lm_big({"embed_dim": 512, "dropout": 0.1, "attention_dropout": 0.1,
                               **cfg})


def _gpt_preset(embed: int, ffn: int, layers: int, heads: int):
    return lambda cfg: {"embed_dim": embed, "ffn_dim": ffn, "layers": layers, "heads": heads,
                        "dropout": 0.1, "attention_dropout": 0.1, "activation": "gelu", **cfg}


# arch name -> (model name, preset)
ARCHITECTURES = {
    "transformer": ("transformer", transformer_base),
    "transformer_iwslt_de_en": ("transformer", transformer_iwslt),
    "transformer_wmt_en_de_big": ("transformer", transformer_big),
    "transformer_align": ("transformer_align", transformer_base),
    "transformer_wmt_en_de": ("transformer", transformer_base),
    "transformer_vaswani_wmt_en_de_big": ("transformer", transformer_vaswani_big),
    "transformer_vaswani_wmt_en_fr_big": ("transformer", transformer_vaswani_fr_big),
    "transformer_wmt_en_de_big_t2t": ("transformer", transformer_big_t2t),
    # the reference pins alignment_layer / alignment_heads; the A- lines here
    # always head-average the last layer (as the JAX package)
    "transformer_wmt_en_de_big_align": ("transformer", transformer_big),
    "transformer_iwslt_de_en_pipeline_parallel": ("transformer", transformer_iwslt),
    "transformer_wmt_en_de_big_pipeline_parallel": ("transformer", transformer_big),
    "transformer_lm": ("transformer_lm", transformer_lm_base),
    "transformer_lm_big": ("transformer_lm", transformer_lm_big),
    "transformer_lm_wiki103": ("transformer_lm", transformer_lm_wiki103),
    "transformer_lm_baevski_wiki103": ("transformer_lm", transformer_lm_wiki103),
    "transformer_lm_gbw": ("transformer_lm", transformer_lm_gbw),
    "transformer_lm_baevski_gbw": ("transformer_lm", transformer_lm_gbw),
    "transformer_lm_gpt": ("transformer_lm", _gpt_preset(768, 3072, 12, 12)),
    "transformer_lm_gpt2_small": ("transformer_lm", _gpt_preset(1024, 4096, 24, 16)),
    "transformer_lm_gpt2_medium": ("transformer_lm", _gpt_preset(1280, 5120, 36, 20)),
    "transformer_lm_gpt2_big": ("transformer_lm", _gpt_preset(1600, 6400, 48, 25)),
    "transformer_lm_megatron": ("transformer_lm", _gpt_preset(3072, 3072 * 4, 72, 32)),
    "transformer_lm_megatron_11b": ("transformer_lm", _gpt_preset(3072, 3072 * 6, 72, 32)),
}

# the model names of the family (the registry's and the task's)
MODEL_BUILDERS = {"transformer": build_transformer, "transformer_align": build_transformer,
                  "transformer_lm": build_transformer_lm}
