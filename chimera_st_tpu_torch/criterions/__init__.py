"""Training criterions (counterpart of chimera_st_tpu/criterions/, the ones
the triplet fine-tune, the Transformer family, the non-autoregressive
models and BART's sentence classification run, ``adaptive_loss``,
``nat_loss``'s four and ``sentence_prediction``'s three among them, and the
wav2vec family's: ``ctc`` / ``ctc_chi``, ``wav2vec``, ``wav2vec_bimodal``,
``aligning_loss_bimodal`` and ``wav2vec_v1``, and the masked LM's
``masked_lm``; ``lm_cross_entropy``,
``multilingual_label_smoothed_cross_entropy`` and ``legacy_masked_lm`` (also
``legacy_masked_lm_loss``) are registered by their tasks, as in JAX).
Importing the package registers them."""

from . import (  # noqa: F401
    adaptive_loss, cross_entropy, ctc, masked_lm, nat_loss, sentence_prediction,
    wav2vec_pretraining)
from .label_smoothed_ce import ce_loss_from_logits, label_smoothed_nll_loss
from .triplet import memory_contrastive_loss, sample_contrastive_loss

__all__ = ["ce_loss_from_logits", "label_smoothed_nll_loss", "memory_contrastive_loss",
           "sample_contrastive_loss"]
