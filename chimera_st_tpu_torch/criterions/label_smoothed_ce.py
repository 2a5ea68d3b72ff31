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


def accuracy_counts(logits: torch.Tensor, target: torch.Tensor, ignore_index: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmax predictions equal to the target, non-pad targets), counted
    over the positions whose target is not ``ignore_index``."""
    keep = target != ignore_index
    return ((logits.argmax(-1) == target) & keep).sum(), keep.sum()


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


@register_criterion("label_smoothed_cross_entropy_with_alignment")
def make_label_smoothed_ce_with_alignment(cfg: Dict):
    """Label-smoothed CE plus ``alignment_lambda`` (0.05) times the
    supervised-attention loss (fairseq
    ``label_smoothed_cross_entropy_with_alignment.py``): the NLL of the last
    decoder layer's head-averaged cross-attention at the gold (target,
    source) links of ``alignment_tgt`` / ``alignment_src`` ([B, A], -1 pads),
    each link weighted by one over the links that share its target
    position. As in JAX, the attention comes from a second, dropout-free
    pass (``decoder.cross_attention_weights``, the Transformer's)."""
    base = make_label_smoothed_ce(cfg)
    align_lambda = float(cfg.get("alignment_lambda", 0.05))

    def criterion(model, batch, generator=None, num_updates=None):
        loss, sample_size, logging = base(model, batch, generator, num_updates)
        if "alignment_tgt" not in batch:
            return loss, sample_size, logging
        training = model.training
        model.eval()
        try:
            attn = model.decoder.cross_attention_weights(
                batch["prev_output_tokens"], *model.encode_text(batch["src_tokens"]))
        finally:
            model.train(training)
        at, asrc = batch["alignment_tgt"].long(), batch["alignment_src"].long()
        valid = (at >= 0) & (asrc >= 0)
        rows = attn.gather(1, at.clamp(min=0)[:, :, None].expand(-1, -1, attn.shape[2]))
        p = rows.gather(2, asrc.clamp(min=0)[:, :, None])[..., 0]
        align_nll = -torch.log(torch.clamp(p.float(), 1e-9, 1.0))
        same_tgt = (at[:, :, None] == at[:, None, :]) & valid[:, :, None] & valid[:, None, :]
        align_nll = align_nll / torch.clamp(same_tgt.sum(dim=-1), min=1).to(align_nll.dtype)
        align_loss = torch.where(valid, align_nll, 0.0).sum()
        loss = loss + align_lambda * align_loss
        return loss, sample_size, {**logging, "alignment_loss": align_loss, "loss": loss}

    return criterion
