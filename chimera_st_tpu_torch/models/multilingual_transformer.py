"""The multilingual transformer (counterpart of
chimera_st_tpu/models/multilingual_transformer.py; fairseq
``multilingual_transformer``): one encoder per source language and one
decoder per target language over ``lang_pairs``, or one ``shared`` encoder
(``share_encoders``) / decoder (``share_decoders``). A pair routes through
its source's encoder and its target's decoder; pairs with a side in common
share that module.

Each encoder group is the JAX package's ``TransformerModel`` ``enc_<lang>``
of which only the encoder is traversed, so its tree holds no decoder: here
it is a ``TextEncoder`` alone, the same parameters and the same Adam state.
The JAX decoders take only part of the config (``multilingual_transformer.py:72-88``):
the decoder's own defaults stand for ``activation`` (relu),
``attention_dropout`` and ``activation_dropout`` (0.1), the embedding
scale, sinusoidal positions and no ``layernorm_embedding``, whatever the
config says. The port builds them the same way (fairseq passes the whole
config: ROADMAP C). On the card every encoder layer runs K1. Neither
package decodes this model (it has no ``encode_text``; ROADMAP C): it is
trained and validated.

Module names: ``encoders.<lang|shared>.*`` (the ``transformer`` table's
encoder) and ``decoders.<lang|shared>.*``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from .transformer_decoder import TransformerDecoder
from .transformer_mt import TextEncoder, TransformerMTConfig, _config


@dataclass(frozen=True)
class MultilingualConfig(TransformerMTConfig):
    """The JAX package's MultilingualConfig (``multilingual_transformer.py:27-31``)."""

    lang_pairs: Tuple[str, ...] = ("de-en",)
    share_encoders: bool = False
    share_decoders: bool = False


class MultilingualTransformer(nn.Module):
    def __init__(self, cfg: MultilingualConfig, device="cuda"):
        super().__init__()
        # the pipeline fields reach no mesh here, as in JAX: the stacks run in turn
        self.cfg = c = cfg
        mt = TransformerMTConfig(**{f.name: getattr(c, f.name)
                                    for f in dataclasses.fields(TransformerMTConfig)})
        self.src_key = {p: "shared" if c.share_encoders else p.split("-")[0]
                        for p in c.lang_pairs}
        self.tgt_key = {p: "shared" if c.share_decoders else p.split("-")[1]
                        for p in c.lang_pairs}
        self.encoders = nn.ModuleDict({s: TextEncoder(mt, device)
                                       for s in sorted(set(self.src_key.values()))})
        self.decoders = nn.ModuleDict({
            t: TransformerDecoder(
                c.tgt_vocab_size, c.decoder_embed_dim, c.decoder_ffn_dim, c.decoder_layers,
                c.decoder_heads, normalize_before=c.decoder_normalize_before,
                padding_idx=c.padding_idx, max_target_positions=c.max_target_positions,
                dropout=c.dropout, attention_dropout=0.1, activation_dropout=0.1,
                share_input_output_embed=c.share_decoder_input_output_embed, device=device)
            for t in sorted(set(self.tgt_key.values()))})

    def encode_pair(self, pair: str, src_tokens, generator: Optional[torch.Generator] = None):
        return self.encoders[self.src_key[pair]](src_tokens, generator)

    def forward_pair(self, pair: str, src_tokens, prev_output_tokens,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced through the pair's encoder and decoder -> fp32
        logits [B, T, V]."""
        enc, enc_mask = self.encode_pair(pair, src_tokens, generator)
        return self.decoders[self.tgt_key[pair]](prev_output_tokens, enc, enc_mask, generator)

    def forward(self, src_tokens, prev_output_tokens, pair: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.forward_pair(pair or self.cfg.lang_pairs[0], src_tokens,
                                 prev_output_tokens, generator)


def build_multilingual(cfg_dict: Dict, device="cuda") -> MultilingualTransformer:
    d = dict(cfg_dict)
    lp = d.get("lang_pairs")
    if lp is not None:
        d["lang_pairs"] = tuple(lp.split(",") if isinstance(lp, str) else lp)
    return MultilingualTransformer(_config(MultilingualConfig, d), device=device)


def _widths(ffn: int, heads: int):
    def preset(cfg: Dict) -> Dict:
        d = dict(cfg)
        for side in ("encoder", "decoder"):
            d.setdefault(f"{side}_embed_dim", 512)
            d.setdefault(f"{side}_ffn_dim", ffn)
            d.setdefault(f"{side}_layers", 6)
            d.setdefault(f"{side}_heads", heads)
        return d
    return preset


# arch name -> (model name, preset) (JAX multilingual_transformer.py:126-152)
ARCHITECTURES = {
    "multilingual_transformer": ("multilingual_transformer", _widths(2048, 8)),
    "multilingual_transformer_iwslt_de_en": ("multilingual_transformer", _widths(1024, 4)),
}
