"""Scoring of given targets, the ``--score-reference`` path (counterpart of
chimera_st_tpu/generation/scorer.py): eos-rotated teacher forcing, each
target token's log-prob, their mean and sum per sentence."""

from __future__ import annotations

from typing import Dict

import torch

from .generator import dropout_mode, seeded_generator


class SequenceScorer:
    """Scores gold targets under a model with ``encode_audio`` /
    ``encode_text`` and ``decode(prev_tokens, encoder_out, mask)``. With
    ``retain_dropout`` the whole model runs in training mode, its masks from
    a generator seeded by ``seed`` and the call's number."""

    def __init__(self, model, pad: int = 1, eos: int = 2, retain_dropout: bool = False,
                 seed: int = 0):
        self.model = model
        self.pad, self.eos = pad, eos
        self.retain_dropout = retain_dropout
        self.seed = seed
        self._calls = 0
        if retain_dropout and not hasattr(getattr(model, "cfg", None), "dropout"):
            raise NotImplementedError(
                f"--retain-dropout is not ported for {type(model).__name__}, whose config "
                "has no dropout field (ROADMAP A14)")

    def _score(self, encode, target: torch.Tensor) -> Dict[str, torch.Tensor]:
        self._calls += 1
        gen = (seeded_generator(self.seed, self._calls, target.device, stream=1)
               if self.retain_dropout else None)
        extra = () if gen is None else (gen,)
        with dropout_mode(self.model, self.retain_dropout):
            enc, enc_mask = encode(*extra)
            prev = torch.cat([torch.full_like(target[:, :1], self.eos), target[:, :-1]], dim=1)
            prev = torch.where(target == self.pad, self.pad, prev)
            logits = self.model.decode(prev, enc, enc_mask, *extra)
        lp = torch.log_softmax(logits.float(), dim=-1)
        tok_lp = torch.gather(lp, 2, target[..., None].long())[..., 0]
        keep = target != self.pad
        tok_lp = torch.where(keep, tok_lp, 0.0)
        total = tok_lp.sum(dim=1)
        count = keep.sum(dim=1)
        return {"positional_scores": tok_lp, "score": total / torch.clamp(count, min=1),
                "total_logprob": total, "length": count}

    @torch.inference_mode()
    def score_audio(self, audio: torch.Tensor, padding_mask: torch.Tensor,
                    target: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._score(lambda *g: self.model.encode_audio(audio, padding_mask, *g), target)

    @torch.inference_mode()
    def score_text(self, src_tokens: torch.Tensor, target: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        return self._score(lambda *g: self.model.encode_text(src_tokens, *g), target)
