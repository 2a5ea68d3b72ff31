"""Non-autoregressive CMLM transformer with mask-predict decoding
(counterpart of chimera_st_tpu/models/nat_cmlm.py; fairseq
``cmlm_transformer``, "Mask-Predict", Ghazvininejad et al. 2019).

The backbone is the MT ``TransformerModel`` with a bidirectional decoder
(``decoder_causal`` False): on the card every decoder pass over the canvas
runs K1 in each layer, as the encoder does. The target length comes from a
length head over the mean-pooled encoder states. Mask-predict runs a fixed
number of iterations over a static ``[B, L]`` canvas; iteration i re-masks
the floor(len * (1 - (i + 1) / N)) least confident tokens, as in JAX.

``nat_backbone`` and ``LengthPredictor`` are shared by the vanilla /
iterative NAT and the NAT-CRF (``nat_vanilla.py``); the Levenshtein and
insertion models (``nat_levenshtein.py``, ``nat_insertion.py``) take the
backbone only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from .layers import linear
from .transformer_mt import TransformerMTConfig, TransformerModel, _config


def nat_backbone(cfg: TransformerMTConfig, device) -> TransformerModel:
    """The MT transformer of ``cfg``'s fields, its decoder bidirectional
    (the JAX NAT models' ``backbone``)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(TransformerMTConfig)}
    return TransformerModel(TransformerMTConfig(**{**fields, "decoder_causal": False}),
                            device=device)


class NATDecoderMixin:
    """``encode`` / ``decode_tokens`` / ``features`` over ``self.backbone``."""

    backbone: TransformerModel

    def encode(self, src_tokens: torch.Tensor, generator: Optional[torch.Generator] = None):
        return self.backbone.encode(src_tokens, generator)

    def decode_tokens(self, tokens, enc, enc_mask, generator=None) -> torch.Tensor:
        """Bidirectional decode: [B, T] canvas -> fp32 logits [B, T, V]."""
        return self.backbone.decoder(tokens, enc, enc_mask, generator)

    def features(self, tokens, enc, enc_mask, generator=None) -> torch.Tensor:
        """The decoder's final states [B, T, C] over the canvas."""
        return self.backbone.decoder(tokens, enc, enc_mask, generator, features_only=True)


class LengthPredictor(NATDecoderMixin):
    """The length head over the mean-pooled encoder states."""

    length_head: nn.Linear

    def predict_length_logits(self, enc: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
        """-> fp32 [B, max_predicted_length]."""
        valid = (~enc_mask)[..., None].to(enc.dtype)
        pooled = (enc * valid).sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1.0)
        return self.length_head(pooled).float()


def remask_factor(i: int, iterations: int) -> float:
    """1 - (i + 1) / iterations, rounded as the JAX loop computes it in
    float32."""
    f32 = np.float32
    return float(f32(1.0) - (f32(i) + f32(1.0)) / f32(iterations))


def length_beam(len_logits: torch.Tensor, beam: int, lo: int, hi: int) -> torch.Tensor:
    """The top-``beam`` predicted lengths of each sentence, beam-minor
    [B * beam], clipped to [lo, hi]."""
    return torch.clamp(torch.topk(len_logits, beam, dim=-1).indices.reshape(-1), lo, hi)


@dataclass(frozen=True)
class CMLMConfig(TransformerMTConfig):
    max_predicted_length: int = 256
    mask_idx: Optional[int] = None  # default: unk (3)


class CMLMTransformer(LengthPredictor, nn.Module):
    def __init__(self, cfg: CMLMConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.backbone = nat_backbone(cfg, device)
        self.length_head = linear(cfg.encoder_embed_dim, cfg.max_predicted_length,
                                  device=device)

    @property
    def mask_idx(self) -> int:
        return 3 if self.cfg.mask_idx is None else self.cfg.mask_idx

    def forward(self, src_tokens, masked_target, generator=None):
        """Training forward -> (token logits [B, T, V], length logits)."""
        enc, enc_mask = self.encode(src_tokens, generator)
        logits = self.decode_tokens(masked_target, enc, enc_mask, generator)
        return logits, self.predict_length_logits(enc, enc_mask)

    def mask_predict(self, src_tokens: torch.Tensor, iterations: int = 10,
                     max_len: Optional[int] = None, pad: int = 1, eos: int = 2,
                     return_history: bool = False):
        """Iterative refinement -> (tokens [B, L], lengths [B]), with
        ``return_history`` also the fully predicted canvas of every round
        [iterations, B, L]."""
        L = max_len or self.cfg.max_predicted_length
        enc, enc_mask = self.encode(src_tokens)
        lengths = torch.clamp(self.predict_length_logits(enc, enc_mask).argmax(dim=-1), 1, L)
        tokens, _, hist = self._mask_predict_from(lengths, enc, enc_mask, iterations, L, pad,
                                                  return_history)
        return (tokens, lengths, hist) if return_history else (tokens, lengths)

    def _mask_predict_from(self, lengths, enc, enc_mask, iterations: int, L: int, pad: int = 1,
                           return_history: bool = False):
        """The mask-predict loop from given lengths -> (tokens, scores,
        history or None)."""
        B = lengths.shape[0]
        pos = torch.arange(L, device=lengths.device)[None, :]
        tgt_pad_mask = pos >= lengths[:, None]
        mask_tok = self.mask_idx
        tokens = torch.where(tgt_pad_mask, pad, mask_tok).long()
        scores = torch.zeros(B, L, device=lengths.device)
        hist = []
        for i in range(iterations):
            lp = torch.log_softmax(self.decode_tokens(tokens, enc, enc_mask).float(), dim=-1)
            pred, conf = lp.argmax(dim=-1), lp.amax(dim=-1)
            # only the masked positions are re-predicted
            is_masked = tokens == mask_tok
            tokens = torch.where(is_masked, pred, tokens)
            scores = torch.where(is_masked, conf, scores)
            if return_history:
                hist.append(torch.where(tgt_pad_mask, pad, tokens))
            # re-mask the least confident for the next round
            n_remask = (lengths.float() * remask_factor(i, iterations)).to(torch.int32)
            ranked = torch.argsort(torch.where(tgt_pad_mask, float("inf"), scores), dim=1,
                                   stable=True)
            rank_of = torch.argsort(ranked, dim=1, stable=True)
            remask = (rank_of < n_remask[:, None]) & ~tgt_pad_mask
            tokens = torch.where(remask, mask_tok, tokens)
        tokens = torch.where(tgt_pad_mask, pad, tokens)
        return tokens, scores, (torch.stack(hist) if return_history else None)

    def mask_predict_with_length_beam(self, src_tokens: torch.Tensor, beam: int = 5,
                                      iterations: int = 10, max_len: Optional[int] = None,
                                      pad: int = 1, eos: int = 2,
                                      return_candidates: bool = False):
        """Mask-predict for the top-``beam`` predicted lengths in one batch,
        keeping the candidate whose final confidences average highest ->
        (tokens [B, L], lengths [B]); with ``return_candidates`` every
        candidate beam-minor (tokens [B*beam, L], lengths, mean confidence)."""
        L = max_len or self.cfg.max_predicted_length
        B = src_tokens.shape[0]
        enc, enc_mask = self.encode(src_tokens)
        lengths = length_beam(self.predict_length_logits(enc, enc_mask), beam, 1, L)
        enc_t = torch.repeat_interleave(enc, beam, dim=0)
        enc_mask_t = torch.repeat_interleave(enc_mask, beam, dim=0)
        tokens, scores, _ = self._mask_predict_from(lengths, enc_t, enc_mask_t, iterations, L,
                                                    pad)
        valid = torch.arange(L, device=tokens.device)[None, :] < lengths[:, None]
        denom = torch.clamp(valid.sum(dim=1), min=1)
        mean_conf = torch.where(valid, scores, 0.0).sum(dim=1) / denom
        if return_candidates:
            return tokens, lengths, mean_conf
        flat = torch.arange(B, device=tokens.device) * beam + mean_conf.reshape(B, beam).argmax(1)
        return tokens[flat], lengths[flat]


def build_cmlm(cfg_dict: Dict, device="cuda") -> CMLMTransformer:
    return CMLMTransformer(_config(CMLMConfig, cfg_dict), device=device)


def cmlm_base(cfg: Dict) -> Dict:
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


# arch name -> (model name, preset); ``cmlm_transformer_wmt_en_de`` is the
# base arch (reference nat/cmlm_transformer.py:160-162)
ARCHITECTURES = {
    "cmlm_transformer": ("cmlm_transformer", cmlm_base),
    "cmlm_transformer_wmt_en_de": ("cmlm_transformer", cmlm_base),
}
