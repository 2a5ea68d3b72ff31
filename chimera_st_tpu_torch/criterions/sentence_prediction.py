"""Sentence prediction, sentence ranking and the composite loss
(counterpart of chimera_st_tpu/criterions/sentence_prediction.py; fairseq
``criterions/sentence_prediction.py``, ``sentence_ranking.py``,
``composite_loss.py``), over BART's ``classify`` head.

- ``sentence_prediction``: the summed cross entropy of the classes
  (``ncorrect`` the argmax hits), or with ``regression_target`` the summed
  squared error of the first output; the sample size is the number of
  sentences.
- ``sentence_ranking``: one ``classify`` score a candidate of
  ``candidate_tokens [B, N, T]`` (each candidate its own source and decoder
  input), the cross entropy over the N scores.
- ``composite_loss``: the weighted sum of ``underlying`` criterions, their
  sample sizes added and their logged values as ``sub{i}_<key>``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config.registry import CRITERIONS, register_criterion


def _class_loss(logits: torch.Tensor, targets: torch.Tensor):
    """-> (the summed cross entropy, the argmax hits)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    loss = -lp.gather(-1, targets[:, None].long()).sum()
    ncorrect = (logits.argmax(dim=-1) == targets).float().sum()
    return loss, ncorrect


def _logging(batch, loss, ncorrect, n: int):
    return {"loss": loss, "nll_loss": loss, "ncorrect": ncorrect,
            "ntokens": batch.get("ntokens", float(n)), "nsentences": n, "sample_size": float(n)}


@register_criterion("sentence_prediction")
def make_sentence_prediction(cfg: Dict):
    regression = bool(cfg.get("regression_target", False))

    def criterion(model, batch, generator=None, num_updates=None):
        logits = model.classify(batch["src_tokens"], batch["prev_output_tokens"], generator)
        targets = batch["target_labels"]
        n = targets.shape[0]
        if regression:
            loss = ((logits[:, 0] - targets.float()) ** 2).sum()
            ncorrect = torch.zeros((), device=logits.device)
        else:
            loss, ncorrect = _class_loss(logits, targets)
        return loss, float(n), _logging(batch, loss, ncorrect, n)

    return criterion


@register_criterion("sentence_ranking")
def make_sentence_ranking(cfg: Dict):
    def criterion(model, batch, generator=None, num_updates=None):
        cands = batch["candidate_tokens"]  # [B, N, T]
        scores = torch.stack([model.classify(cands[:, k], cands[:, k], generator)[:, 0]
                              for k in range(cands.shape[1])], dim=1)
        targets = batch["target_labels"]
        loss, ncorrect = _class_loss(scores, targets)
        n = targets.shape[0]
        return loss, float(n), _logging(batch, loss, ncorrect, n)

    return criterion


@register_criterion("composite_loss")
def make_composite_loss(cfg: Dict):
    """cfg ``underlying``: [{"_name": ..., "weight": w, ...}, ...], each
    built from the config with its own entries over it."""
    subs = [(float(sub.get("weight", 1.0)), CRITERIONS.get(sub["_name"])({**cfg, **sub}))
            for sub in cfg.get("underlying", [])]
    if not subs:
        raise ValueError("composite_loss needs at least one underlying criterion")

    def criterion(model, batch, generator=None, num_updates=None):
        total, total_ss, logging = 0.0, 0.0, {}
        for i, (w, sub) in enumerate(subs):
            loss, ss, lg = sub(model, batch, generator, num_updates)
            total = total + w * loss
            total_ss = total_ss + ss
            logging.update({f"sub{i}_{k}": v for k, v in lg.items()})
        logging["loss"] = total
        logging["sample_size"] = total_ss
        logging.setdefault("ntokens", batch.get("ntokens", total_ss))
        logging.setdefault("nsentences", next(iter(batch.values())).shape[0] if batch else 1)
        return total, total_ss, logging

    return criterion
