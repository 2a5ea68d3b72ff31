"""Adaptive-softmax LM loss (counterpart of
chimera_st_tpu/criterions/adaptive_loss.py; reference
fairseq/criterions/adaptive_loss.py): the clustered NLL of a language model
with an adaptive softmax (``TransformerLM.adaptive_nll``), summed over the
non-pad targets; the sample size is ``ntokens``."""

from __future__ import annotations

from typing import Dict

from ..config.registry import register_criterion


@register_criterion("adaptive_loss")
def make_adaptive_loss(cfg: Dict):
    pad_idx = int(cfg.get("padding_idx", 1))

    def criterion(model, batch, generator=None, num_updates=None):
        nll = model.adaptive_nll(batch["net_tokens"], batch["target"], generator)
        loss = nll.masked_fill(batch["target"] == pad_idx, 0.0).sum()
        ntokens = batch["ntokens"]
        return loss, ntokens, {"loss": loss, "nll_loss": loss, "ntokens": ntokens,
                               "nsentences": batch["target"].shape[0], "sample_size": ntokens}

    return criterion
