"""BART / mBART (counterpart of chimera_st_tpu/models/bart.py; fairseq
``bart``): the MT ``TransformerModel`` as ``backbone`` with learned
positions, ``layernorm_embedding``, GELU and post-norm, and a sentence
classification head over the decoder's state at the eos positions.

The encoder is bidirectional, so on the card each of its layers runs K1;
each decoder step of the beam search runs K3. The text API (``encode_text``,
``decoder``, ``decode``, ``forward_text_with_internal``) is the backbone's,
so the generator, the scorer and the criterions take the model unchanged.

The presets set ``share_all_embeddings``, which neither package honours
(``transformer_mt.py``): the source and target tables stay two. Module
names: ``backbone.*`` (the ``transformer`` table) and
``classification_dense`` / ``classification_out`` where ``num_classes`` >
0.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..ops.attention import dropout
from .layers import linear
from .transformer_mt import TransformerMTConfig, TransformerModel, _config


@dataclass(frozen=True)
class BARTConfig(TransformerMTConfig):
    """The JAX package's BARTConfig (``bart.py:27-31``)."""

    num_classes: int = 0  # > 0: the sentence-prediction head
    pooler_dropout: float = 0.0
    eos_idx: int = 2


class BARTModel(nn.Module):
    def __init__(self, cfg: BARTConfig, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        mt = {f.name: getattr(c, f.name) for f in dataclasses.fields(TransformerMTConfig)}
        self.backbone = TransformerModel(TransformerMTConfig(**mt), device=device)
        if c.num_classes > 0:
            self.classification_dense = linear(c.decoder_embed_dim, c.decoder_embed_dim,
                                               device=device)
            self.classification_out = linear(c.decoder_embed_dim, c.num_classes, device=device)

    @property
    def decoder(self):
        return self.backbone.decoder

    def encode_text(self, src_tokens, generator: Optional[torch.Generator] = None):
        return self.backbone.encode(src_tokens, generator)

    def decode(self, prev_output_tokens, encoder_out, encoder_padding_mask=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.backbone.decode(prev_output_tokens, encoder_out, encoder_padding_mask,
                                    generator)

    def forward(self, src_tokens, prev_output_tokens,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.backbone(src_tokens, prev_output_tokens, generator)

    def forward_text_with_internal(self, src_tokens, prev_output_tokens,
                                   generator: Optional[torch.Generator] = None):
        return self.backbone.forward_text_with_internal(src_tokens, prev_output_tokens,
                                                        generator)

    def classify(self, src_tokens, prev_output_tokens,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sentence prediction -> fp32 [B, num_classes]: the decoder's final
        states averaged over the eos positions of ``prev_output_tokens``
        (a row without one pools nothing), then dropout, dense, tanh,
        dropout and the output layer (JAX ``bart.py:82-97``)."""
        c = self.cfg
        enc, enc_mask = self.backbone.encode(src_tokens, generator)
        feats = self.backbone.decoder(prev_output_tokens, enc, enc_mask, generator,
                                      features_only=True)
        is_eos = (prev_output_tokens == c.eos_idx).to(feats.dtype)
        denom = torch.clamp(is_eos.sum(dim=1, keepdim=True), min=1.0)
        pooled = torch.einsum("btc,bt->bc", feats, is_eos / denom)
        p = c.pooler_dropout if self.training else 0.0
        x = torch.tanh(self.classification_dense(dropout(pooled, p, generator)))
        return self.classification_out(dropout(x, p, generator)).float()


def build_bart(cfg_dict: Dict, device="cuda") -> BARTModel:
    return BARTModel(_config(BARTConfig, cfg_dict), device=device)


# ---- presets (JAX bart.py:106-168; reference fairseq models/bart/model.py)

def _bart_common(cfg: Dict) -> Dict:
    d = dict(cfg)
    d.setdefault("learned_pos", True)
    d.setdefault("layernorm_embedding", True)
    d.setdefault("share_all_embeddings", True)
    d.setdefault("share_decoder_input_output_embed", True)
    d.setdefault("activation", "gelu")
    d.setdefault("encoder_normalize_before", False)
    d.setdefault("decoder_normalize_before", False)
    return d


def _widths(embed: int, ffn: int, layers: int, heads: int):
    def preset(cfg: Dict) -> Dict:
        d = _bart_common(cfg)
        for side in ("encoder", "decoder"):
            d.setdefault(f"{side}_embed_dim", embed)
            d.setdefault(f"{side}_ffn_dim", ffn)
            d.setdefault(f"{side}_layers", layers)
            d.setdefault(f"{side}_heads", heads)
        return d
    return preset


bart_base = _widths(768, 3072, 6, 12)
bart_large = _widths(1024, 4096, 12, 16)


def mbart_base(cfg: Dict) -> Dict:
    return bart_base({"no_scale_embedding": False, **cfg})


def mbart_large(cfg: Dict) -> Dict:
    return bart_large({"no_scale_embedding": False, **cfg})


def mbart_base_wmt20(cfg: Dict) -> Dict:
    return mbart_base({"layernorm_embedding": False, **cfg})


# arch name -> (model name, preset)
ARCHITECTURES = {
    "bart_base": ("bart", bart_base),
    "bart_large": ("bart", bart_large),
    "mbart_base": ("bart", mbart_base),
    "mbart_large": ("bart", mbart_large),
    "mbart_base_wmt20": ("bart", mbart_base_wmt20),
}
