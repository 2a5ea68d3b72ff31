"""Training criterions (counterpart of chimera_st_tpu/criterions/, the ones
the triplet fine-tune runs). Importing the package registers them."""

from .label_smoothed_ce import ce_loss_from_logits, label_smoothed_nll_loss
from .triplet import memory_contrastive_loss, sample_contrastive_loss

__all__ = ["ce_loss_from_logits", "label_smoothed_nll_loss", "memory_contrastive_loss",
           "sample_contrastive_loss"]
