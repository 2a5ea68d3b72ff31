"""Label-smoothed cross entropy (counterpart of
chimera_st_tpu/criterions/label_smoothed_ce.py): loss = (1 - eps) * nll +
(eps / V) * sum_v(-lprobs_v), pad positions zeroed, log-softmax in fp32.

A criterion is ``criterion(model, batch, generator=None, num_updates=None)
-> (loss, sample_size, logging)``; it trains or evaluates as the model's
mode says, and draws its dropout masks from ``generator``. ``num_updates``
is an int, or the train step's count as an integer tensor on the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config.registry import register_criterion


def label_smoothed_nll_loss(lprobs: torch.Tensor, target: torch.Tensor, epsilon: float,
                            ignore_index: Optional[int] = 1,
                            reduce: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """lprobs [..., V] fp32 log-probabilities, target [...] int -> (loss,
    nll_loss), summed over the non-pad positions when ``reduce``."""
    nll = -lprobs.gather(-1, target[..., None].long())[..., 0]
    smooth = -lprobs.sum(dim=-1)
    if ignore_index is not None:
        keep = target != ignore_index
        nll = torch.where(keep, nll, 0.0)
        smooth = torch.where(keep, smooth, 0.0)
    if reduce:
        nll, smooth = nll.sum(), smooth.sum()
    loss = (1.0 - epsilon) * nll + (epsilon / lprobs.shape[-1]) * smooth
    return loss, nll


def ce_loss_from_logits(logits: torch.Tensor, target: torch.Tensor, epsilon: float = 0.0,
                        ignore_index: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    lprobs = torch.log_softmax(logits.float(), dim=-1)
    return label_smoothed_nll_loss(lprobs, target, epsilon, ignore_index)


@register_criterion("label_smoothed_cross_entropy")
def make_label_smoothed_ce(cfg: Dict):
    """Speech translation from ``audio`` or translation from ``src_tokens``."""
    eps = float(cfg.get("label_smoothing", 0.1))
    sentence_avg = bool(cfg.get("sentence_avg", False))
    ignore_index = int(cfg.get("padding_idx", 1))

    def criterion(model, batch, generator=None, num_updates=None):
        if "audio" in batch:
            logits, _ = model.forward_audio_with_internal(
                batch["audio"], batch["audio_padding_mask"], batch["prev_output_tokens"],
                generator)
        else:
            logits, _ = model.forward_text_with_internal(
                batch["src_tokens"], batch["prev_output_tokens"], generator)
        loss, nll = ce_loss_from_logits(logits, batch["target"], eps, ignore_index)
        ntokens = batch["ntokens"]
        nsentences = batch["target"].shape[0]
        sample_size = nsentences if sentence_avg else ntokens
        logging = {"loss": loss, "nll_loss": nll, "ntokens": ntokens, "nsentences": nsentences,
                   "sample_size": sample_size}
        return loss, sample_size, logging

    return criterion
