"""Training criterions (counterpart of chimera_st_tpu/criterions/, the ones
the triplet fine-tune, the Transformer family, the non-autoregressive
models and BART's sentence classification run, ``adaptive_loss``,
``nat_loss``'s four and ``sentence_prediction``'s three among them;
``lm_cross_entropy`` and ``multilingual_label_smoothed_cross_entropy`` are
registered by their tasks, as in JAX). Importing the package registers
them."""

from . import adaptive_loss, cross_entropy, nat_loss, sentence_prediction  # noqa: F401
from .label_smoothed_ce import ce_loss_from_logits, label_smoothed_nll_loss
from .triplet import memory_contrastive_loss, sample_contrastive_loss

__all__ = ["ce_loss_from_logits", "label_smoothed_nll_loss", "memory_contrastive_loss",
           "sample_contrastive_loss"]
