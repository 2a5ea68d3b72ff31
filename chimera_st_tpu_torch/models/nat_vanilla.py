"""Vanilla and iterative non-autoregressive transformers, and NAT-CRF
(counterpart of chimera_st_tpu/models/nat_vanilla.py; fairseq
``nonautoregressive_transformer``, ``iterative_nonautoregressive_transformer``
and ``nacrf_transformer``).

One model: the bidirectional backbone (``nat_cmlm.nat_backbone``, K1 in
every decoder layer on the card) over ``[bos, unk, ..., unk, eos]`` canvases
of the predicted length, a length head, and with ``crf_lowrank`` > 0 a
``DynamicCRF`` whose Viterbi pass decodes the last refinement pass. The
iterative variant's training forward (``forward_iterative``) feeds back the
model's own predictions, each kept with probability ``dae_ratio``: the
keep-masks are drawn from a ``torch.Generator`` (the JAX model draws them
from its key; ``keep_masks`` passes given ones).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from .crf import DynamicCRF
from .layers import linear
from .nat_cmlm import LengthPredictor, length_beam, nat_backbone
from .transformer_mt import TransformerMTConfig, _config


@dataclass(frozen=True)
class NATConfig(TransformerMTConfig):
    max_predicted_length: int = 256
    unk_idx: int = 3
    bos_idx: int = 0
    eos_idx: int = 2
    # the iterative variant (--train-step / --dae-ratio)
    train_steps: int = 1
    dae_ratio: float = 0.5
    # NAT-CRF (--crf-lowrank-approx / --crf-beam-approx); 0: no CRF
    crf_lowrank: int = 0
    crf_beam: int = 64


class NATransformer(LengthPredictor, nn.Module):
    def __init__(self, cfg: NATConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.backbone = nat_backbone(cfg, device)
        self.length_head = linear(cfg.encoder_embed_dim, cfg.max_predicted_length,
                                  device=device)
        self.crf = (DynamicCRF(cfg.tgt_vocab_size, cfg.crf_lowrank, cfg.crf_beam, device=device)
                    if cfg.crf_lowrank > 0 else None)

    def initial_output_tokens(self, lengths: torch.Tensor, max_len: int) -> torch.Tensor:
        """[bos, unk * (len - 2), eos] rows padded to ``max_len``."""
        c = self.cfg
        pos = torch.arange(max_len, device=lengths.device)[None, :]
        toks = torch.full((lengths.shape[0], max_len), c.unk_idx, device=lengths.device)
        toks = torch.where(pos == 0, c.bos_idx, toks)
        toks = torch.where(pos == (lengths - 1)[:, None], c.eos_idx, toks)
        return torch.where(pos >= lengths[:, None], c.padding_idx, toks)

    def forward(self, src_tokens, prev_output_tokens, generator=None):
        """Training forward -> (token logits [B, T, V], length logits)."""
        enc, enc_mask = self.encode(src_tokens, generator)
        logits = self.decode_tokens(prev_output_tokens, enc, enc_mask, generator)
        return logits, self.predict_length_logits(enc, enc_mask)

    def forward_iterative(self, src_tokens, prev_output_tokens,
                          generator: Optional[torch.Generator] = None,
                          keep_masks: Optional[List[torch.Tensor]] = None):
        """The iterative NAT's training forward: after each pass but the
        last, the (gradient-free) argmax predictions are fed back, each kept
        with probability ``dae_ratio`` (``keep_masks[s]`` if given, else
        drawn from ``generator``), the rest reverted to unk; bos, eos and
        pads survive. -> (per-step logits [S, B, T, V], length logits)."""
        c = self.cfg
        enc, enc_mask = self.encode(src_tokens, generator)
        pad = prev_output_tokens == c.padding_idx
        anchors = (prev_output_tokens == c.bos_idx) | (prev_output_tokens == c.eos_idx)
        steps = max(1, c.train_steps)
        logits_steps, toks = [], prev_output_tokens
        for s in range(steps):
            logits = self.decode_tokens(toks, enc, enc_mask, generator)
            logits_steps.append(logits)
            if s + 1 < steps:
                pred = logits.detach().argmax(dim=-1)
                if keep_masks is not None:
                    keep = keep_masks[s]
                else:
                    keep = torch.empty(pred.shape, dtype=torch.bool, device=pred.device
                                       ).bernoulli_(c.dae_ratio, generator=generator)
                toks = torch.where(keep, pred, c.unk_idx)
                toks = torch.where(anchors, prev_output_tokens, toks)
                toks = torch.where(pad, c.padding_idx, toks)
        return torch.stack(logits_steps), self.predict_length_logits(enc, enc_mask)

    def crf_loglikelihood(self, src_tokens, prev_output_tokens, targets, generator=None):
        """NAT-CRF training: -> (per-sentence CRF log-likelihood of
        ``targets`` [B], length logits)."""
        if self.crf is None:
            raise ValueError("crf_loglikelihood needs a model built with crf_lowrank > 0")
        enc, enc_mask = self.encode(src_tokens, generator)
        emissions = self.decode_tokens(prev_output_tokens, enc, enc_mask, generator)
        llh = self.crf.loglikelihood(emissions, targets,
                                     prev_output_tokens != self.cfg.padding_idx)
        return llh, self.predict_length_logits(enc, enc_mask)

    def _refine(self, toks, lengths, enc, enc_mask, iterations: int, history=None):
        """``iterations`` full re-prediction passes over the interior of
        the canvas; with a CRF the last one decodes by Viterbi. -> (tokens,
        the last pass's emissions)."""
        L = toks.shape[1]
        pos = torch.arange(L, device=toks.device)[None, :]
        interior = (pos > 0) & (pos < (lengths - 1)[:, None])
        emissions = None
        for it in range(max(1, iterations)):
            emissions = self.decode_tokens(toks, enc, enc_mask)
            if self.crf is not None and it == max(1, iterations) - 1:
                pred = self.crf.decode(emissions, pos < lengths[:, None])
            else:
                pred = emissions.argmax(dim=-1)
            toks = torch.where(interior, pred, toks)
            if history is not None:
                history.append(toks)
        return toks, emissions, interior

    def translate(self, src_tokens: torch.Tensor, max_len: Optional[int] = None,
                  iterations: int = 1, return_history: bool = False):
        """Predicted lengths, then ``iterations`` passes -> (tokens [B, L],
        lengths [B]); with ``return_history`` also the canvas after each
        pass [iterations, B, L]."""
        L = max_len or self.cfg.max_predicted_length
        enc, enc_mask = self.encode(src_tokens)
        lengths = torch.clamp(self.predict_length_logits(enc, enc_mask).argmax(dim=-1), 2, L)
        history = [] if return_history else None
        toks, _, _ = self._refine(self.initial_output_tokens(lengths, L), lengths, enc, enc_mask,
                                  iterations, history)
        if return_history:
            return toks, lengths, torch.stack(history)
        return toks, lengths

    def translate_with_length_beam(self, src_tokens: torch.Tensor, beam: int = 5,
                                   max_len: Optional[int] = None, iterations: int = 1,
                                   return_candidates: bool = False):
        """The top-``beam`` predicted lengths decoded in one batch, keeping
        the candidate with the best mean log-probability over its interior
        -> (tokens [B, L], lengths [B]); with ``return_candidates`` every
        candidate beam-minor (tokens [B*beam, L], lengths, score)."""
        L = max_len or self.cfg.max_predicted_length
        B = src_tokens.shape[0]
        enc, enc_mask = self.encode(src_tokens)
        lengths = length_beam(self.predict_length_logits(enc, enc_mask), beam, 2, L)
        enc_t = torch.repeat_interleave(enc, beam, dim=0)
        enc_mask_t = torch.repeat_interleave(enc_mask, beam, dim=0)
        toks, emissions, interior = self._refine(self.initial_output_tokens(lengths, L), lengths,
                                                 enc_t, enc_mask_t, iterations)
        lp = torch.log_softmax(emissions.float(), dim=-1)
        tok_lp = lp.gather(-1, toks[..., None])[..., 0]
        denom = torch.clamp(interior.sum(dim=1), min=1)
        score = torch.where(interior, tok_lp, 0.0).sum(dim=1) / denom
        if return_candidates:
            return toks, lengths, score
        flat = torch.arange(B, device=toks.device) * beam + score.reshape(B, beam).argmax(dim=1)
        return toks[flat], lengths[flat]


def _build(cfg_dict: Dict, device, **over) -> NATransformer:
    return NATransformer(_config(NATConfig, {**cfg_dict, **over}), device=device)


def build_nat(cfg_dict: Dict, device="cuda") -> NATransformer:
    return _build(cfg_dict, device, crf_lowrank=0, train_steps=1)


def build_inat(cfg_dict: Dict, device="cuda") -> NATransformer:
    return _build({"train_steps": 2, **cfg_dict}, device, crf_lowrank=0)


def build_nacrf(cfg_dict: Dict, device="cuda") -> NATransformer:
    return _build({"crf_lowrank": 32, "crf_beam": 64, **cfg_dict}, device)


def _same(cfg: Dict) -> Dict:
    """The presets of this family add nothing to the config's defaults."""
    return cfg


# arch name -> (model name, preset) (reference nat/nonautoregressive_transformer.py:437-440,
# iterative_nonautoregressive_transformer.py:223-228: the wmt_en_de names are the base)
ARCHITECTURES = {
    "nonautoregressive_transformer": ("nonautoregressive_transformer", _same),
    "nonautoregressive_transformer_wmt_en_de": ("nonautoregressive_transformer", _same),
    "iterative_nonautoregressive_transformer": ("iterative_nonautoregressive_transformer",
                                                _same),
    "iterative_nonautoregressive_transformer_wmt_en_de": (
        "iterative_nonautoregressive_transformer", _same),
    "nacrf_transformer": ("nacrf_transformer", _same),
}
