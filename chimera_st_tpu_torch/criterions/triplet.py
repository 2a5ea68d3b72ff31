"""Tri-modal Chimera loss (counterpart of chimera_st_tpu/criterions/
triplet.py): ST cross entropy + MT cross entropy + memory contrastive term.

The model runs twice with shared parameters, the audio pass then the text
pass, so their gradients add up in one backward. The contrastive term is a
per-slot InfoNCE over the cosines of the audio and text memory banks
(temperature 0.1, softmax over the audio-slot axis); the sample variant
contrasts mean-pooled memories across the batch. ``loss_ratio`` weighs the
three terms, the contrastive weight ramps linearly up to
``contrastive_increase_until`` updates, and ``kd_ratio`` reweighs the ST
term per sample by the parity of its id.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config.registry import register_criterion
from .label_smoothed_ce import ce_loss_from_logits, label_smoothed_nll_loss


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def memory_contrastive_loss(audio_mem: torch.Tensor, text_mem: torch.Tensor,
                            temperature: float = 0.1) -> torch.Tensor:
    """[B, M, D] each -> per-memory-slot InfoNCE, summed: for each text slot
    j, classify audio slot i == j."""
    a, t = _unit(audio_mem.float()), _unit(text_mem.float())
    logits = torch.einsum("bid,bjd->bij", a, t) / temperature
    lsm = torch.log_softmax(logits, dim=1)
    return -torch.diagonal(lsm, dim1=1, dim2=2).sum()


def sample_contrastive_loss(audio_mem: torch.Tensor, text_mem: torch.Tensor,
                            temperature: float = 0.1) -> torch.Tensor:
    """Across-batch InfoNCE of the mean-pooled memories: classify the
    matching sample."""
    a, t = _unit(audio_mem.float().mean(dim=1)), _unit(text_mem.float().mean(dim=1))
    lsm = torch.log_softmax((a @ t.T) / temperature, dim=0)
    return -torch.diagonal(lsm).sum()


def _make_triplet(cfg: Dict, contrastive_fn):
    eps = float(cfg.get("label_smoothing", 0.1))
    ratios = tuple(float(r) for r in cfg.get("loss_ratio", (1.0, 1.0, 1.0)))
    temp = float(cfg.get("contrastive_temp", 0.1))
    ramp_until = cfg.get("contrastive_increase_until", None)
    sentence_avg = bool(cfg.get("sentence_avg", False))
    ignore_index = int(cfg.get("padding_idx", 1))
    kd_ratio = cfg.get("kd_ratio", None)
    if kd_ratio is not None and tuple(kd_ratio) == (None, None):
        kd_ratio = None
    if kd_ratio is not None and ratios != (1.0, 0.0, 0.0):
        raise ValueError("--kd-ratio requires --loss-ratio 1 0 0")

    def criterion(model, batch, generator=None, num_updates=None):
        st_logits, audio_mem = model.forward_audio_with_internal(
            batch["audio"], batch["audio_padding_mask"], batch["prev_output_tokens"], generator)
        if kd_ratio is None:
            st_loss, st_nll = ce_loss_from_logits(st_logits, batch["target"], eps, ignore_index)
        else:
            # even ids weigh kd_ratio[0], odd ("teacher") ids kd_ratio[1]
            lprobs = torch.log_softmax(st_logits.float(), dim=-1)
            per_tok, per_tok_nll = label_smoothed_nll_loss(lprobs, batch["target"], eps,
                                                           ignore_index, reduce=False)
            is_teacher = (batch["id"] % 2).float()
            w = (is_teacher * kd_ratio[1] + (1.0 - is_teacher) * kd_ratio[0])[:, None]
            st_loss, st_nll = (per_tok * w).sum(), (per_tok_nll * w).sum()

        zero = st_loss.new_zeros(())
        mt_loss = mt_nll = contrastive = zero
        if ratios[1] != 0.0 or ratios[2] != 0.0:
            mt_logits, text_mem = model.forward_text_with_internal(
                batch["src_text"], batch["prev_output_tokens"], generator)
            mt_loss, mt_nll = ce_loss_from_logits(mt_logits, batch["target"], eps, ignore_index)
            if ratios[2] != 0.0:
                contrastive = contrastive_fn(audio_mem, text_mem, temp)

        r2 = ratios[2]
        if ramp_until and num_updates is not None:
            frac = num_updates / ramp_until  # a tensor for the train step's device count
            r2 = r2 * (frac.clamp(max=1.0) if torch.is_tensor(frac) else min(1.0, frac))
        loss = ratios[0] * st_loss + ratios[1] * mt_loss + r2 * contrastive
        nll = ratios[0] * st_nll + ratios[1] * mt_nll

        ntokens = batch["ntokens"]
        nsentences = batch["target"].shape[0]
        sample_size = nsentences if sentence_avg else ntokens
        logging = {"loss": loss, "nll_loss": nll, "st_loss": st_loss, "st_nll_loss": st_nll,
                   "mt_loss": mt_loss, "mt_nll_loss": mt_nll, "contrastive_loss": contrastive,
                   "ntokens": ntokens, "nsentences": nsentences, "sample_size": sample_size}
        return loss, sample_size, logging

    return criterion


@register_criterion("triplet_st_mt_contrastive")
def make_triplet_contrastive(cfg: Dict):
    return _make_triplet(cfg, memory_contrastive_loss)


@register_criterion("triplet_st_mt_samplecontrastive")
def make_triplet_sample_contrastive(cfg: Dict):
    return _make_triplet(cfg, sample_contrastive_loss)
