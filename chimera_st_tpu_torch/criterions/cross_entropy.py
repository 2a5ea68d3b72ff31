"""Plain cross entropy (counterpart of chimera_st_tpu/criterions/cross_entropy.py):
no label smoothing, pad positions ignored. A language-model batch
(``net_tokens``) goes through the decoder-only model; a text batch
(``src_tokens``) through ``forward_text_with_internal``. The body is
``token_cross_entropy``, which ``lm_cross_entropy`` shares with its label
smoothing."""

from __future__ import annotations

from typing import Dict

from ..config.registry import register_criterion
from .label_smoothed_ce import ce_loss_from_logits


def token_cross_entropy(cfg: Dict, eps: float):
    """Cross entropy label-smoothed by ``eps``; the sample size is the token
    count, or the sentence count under ``sentence_avg``."""
    sentence_avg = bool(cfg.get("sentence_avg", False))
    ignore_index = int(cfg.get("padding_idx", 1))

    def criterion(model, batch, generator=None, num_updates=None):
        if "net_tokens" in batch:
            logits = model(batch["net_tokens"], generator)
        else:
            logits, _ = model.forward_text_with_internal(
                batch["src_tokens"], batch["prev_output_tokens"], generator)
        loss, nll = ce_loss_from_logits(logits, batch["target"], eps, ignore_index)
        ntokens = batch["ntokens"]
        nsentences = batch["target"].shape[0]
        sample_size = nsentences if sentence_avg else ntokens
        return loss, sample_size, {"loss": loss, "nll_loss": nll, "ntokens": ntokens,
                                   "nsentences": nsentences, "sample_size": sample_size}

    return criterion


@register_criterion("cross_entropy")
def make_cross_entropy(cfg: Dict):
    return token_cross_entropy(cfg, 0.0)
