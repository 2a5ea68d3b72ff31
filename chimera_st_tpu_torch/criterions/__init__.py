"""Training criterions (counterpart of chimera_st_tpu/criterions/, the ones
the triplet fine-tune, the Transformer family and the non-autoregressive
models run, ``adaptive_loss`` and ``nat_loss``'s four among them;
``lm_cross_entropy`` is registered by ``tasks/language_modeling.py``, as in
JAX). Importing the package registers them."""

from . import adaptive_loss, cross_entropy, nat_loss  # noqa: F401 — registration
from .label_smoothed_ce import ce_loss_from_logits, label_smoothed_nll_loss
from .triplet import memory_contrastive_loss, sample_contrastive_loss

__all__ = ["ce_loss_from_logits", "label_smoothed_nll_loss", "memory_contrastive_loss",
           "sample_contrastive_loss"]
