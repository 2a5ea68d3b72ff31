"""wav2vec pre-training criterions (counterpart of
chimera_st_tpu/criterions/wav2vec_pretraining.py and the ``wav2vec_v1``
criterion of chimera_st_tpu/models/wav2vec_v1.py):

- ``infonce_from_outputs``: InfoNCE over the masked frames, plus the
  diversity penalty (num_vars - prob_perplexity) / num_vars and the feature
  L2 penalty, both scaled by the sample size, and the k-means quantizer's
  loss where it gives one; the weights are ``loss_weights`` (0.1, 10.0[, 1.0]);
- ``wav2vec``: one modality; the Gumbel temperature is the batch's
  ``gumbel_temp``, which nothing sets, so it stays 2.0 (ROADMAP C);
- ``wav2vec_bimodal``: Chimera's cross-modal objective, the two directions'
  losses summed (logged as ``d0_*`` / ``d1_*``);
- ``aligning_loss_bimodal``: the cosine or L2 distance of the two
  modalities' unmasked context features, with ``fix_side`` a detached
  target of the current parameters (as JAX: no start-of-training snapshot);
- ``wav2vec_v1``: binary cross entropy of the positives and negatives.

The sample size is the count of valid frames. Pre-training batches carry no
padding, so it is known on the host (the batch's ``ntokens``, or B x T'),
and the step reads nothing from the card for it; with padding it is a
device value.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..config.registry import register_criterion


def infonce_from_outputs(out, loss_weights=(0.1, 10.0), host_sample_size=None):
    """(loss, sample size, logging) of a pre-training output dict; the
    sample size is ``host_sample_size`` where the caller knows it."""
    logits = out["logits"].float()
    mask = out["mask"]
    nll = -torch.log_softmax(logits, dim=-1)[..., 0]
    ss = mask.sum().float()
    contrastive = torch.where(mask, nll, 0.0).sum()
    div_w, pen_w = loss_weights[:2]
    kmeans_w = loss_weights[2] if len(loss_weights) > 2 else 1.0
    diversity = ((out["num_vars"] - out["prob_perplexity"]) / out["num_vars"]) * ss
    features_pen = out["features_pen"] * ss
    kmeans = out.get("kmeans_loss", torch.zeros((), device=logits.device)) * ss
    loss = contrastive + div_w * diversity + pen_w * features_pen + kmeans_w * kmeans
    correct = (mask & (logits.argmax(dim=-1) == 0)).sum().float()
    sample_size = ss if host_sample_size is None else float(host_sample_size)
    logging = {"loss": loss, "contrastive_loss": contrastive, "diversity_loss": diversity,
               "features_pen": features_pen, "kmeans_loss": kmeans,
               "prob_perplexity": out["prob_perplexity"], "n_correct": correct,
               "total": sample_size, "sample_size": sample_size, "ntokens": sample_size,
               "nsentences": logits.shape[0]}
    return loss, sample_size, logging


def _unpadded(batch, *keys) -> bool:
    return all(batch.get(k) is None for k in keys)


@register_criterion("wav2vec")
def make_wav2vec_criterion(cfg: Dict):
    loss_weights = tuple(cfg.get("loss_weights", (0.1, 10.0)))

    def criterion(model, batch, generator=None, num_updates=None):
        out = model(batch["audio"], batch.get("audio_padding_mask"), batch["mask_indices"],
                    batch["negative_indices"], gumbel_temp=batch.get("gumbel_temp", 2.0),
                    generator=generator)
        host = batch["ntokens"] if _unpadded(batch, "audio_padding_mask") else None
        return infonce_from_outputs(out, loss_weights, host)

    return criterion


@register_criterion("wav2vec_bimodal")
def make_wav2vec_bimodal_criterion(cfg: Dict):
    loss_weights = tuple(cfg.get("loss_weights", (0.1, 10.0)))

    def criterion(model, batch, generator=None, num_updates=None):
        outs = model.bimodal_forward(
            batch["audio"], batch["audio2"], batch.get("audio_padding_mask"),
            batch.get("audio2_padding_mask"), batch["mask_indices"],
            batch["negative_indices"], gumbel_temp=batch.get("gumbel_temp", 2.0),
            generator=generator)
        host = (batch["ntokens"] if _unpadded(batch, "audio_padding_mask", "audio2_padding_mask")
                else None)
        total_loss, total_ss, logging = 0.0, 0.0, {}
        for direction, out in enumerate(outs):
            loss, ss, lg = infonce_from_outputs(out, loss_weights, host)
            total_loss, total_ss = total_loss + loss, total_ss + ss
            logging.update({f"d{direction}_{k}": v for k, v in lg.items()})
        logging.update(loss=total_loss, sample_size=total_ss, ntokens=total_ss,
                       nsentences=batch["audio"].shape[0])
        return total_loss, total_ss, logging

    return criterion


@register_criterion("aligning_loss_bimodal")
def make_aligning_loss_bimodal(cfg: Dict):
    loss_kind = cfg.get("loss", "cosine")
    if loss_kind not in ("cosine", "l2"):
        raise ValueError(f"aligning loss must be cosine|l2, got {loss_kind!r}")
    fix_side = cfg.get("fix_side")
    if fix_side not in (None, "audio", "text"):
        raise ValueError(f"fix_side must be audio|text, got {fix_side!r}")

    def pair_loss(x1, x2, valid):
        x1, x2 = x1.float(), x2.float()
        if loss_kind == "cosine":
            n1 = torch.linalg.vector_norm(x1, dim=-1).clamp(min=1e-8)
            n2 = torch.linalg.vector_norm(x2, dim=-1).clamp(min=1e-8)
            per_frame = 1.0 - (x1 * x2).sum(dim=-1) / (n1 * n2)
        else:
            per_frame = (x1 - x2).square().mean(dim=-1)
        return torch.where(valid, per_frame, 0.0).sum()

    def criterion(model, batch, generator=None, num_updates=None):
        a, a_mask = model.aligned_features(batch["audio"], batch.get("audio_padding_mask"),
                                           generator)
        t, t_mask = model.aligned_features(batch["audio2"], batch.get("audio2_padding_mask"),
                                           generator)
        T = min(a.shape[1], t.shape[1])
        a, t = a[:, :T], t[:, :T]
        valid = torch.ones(a.shape[:2], dtype=torch.bool, device=a.device)
        if a_mask is not None:
            valid = valid & ~a_mask[:, :T]
        if t_mask is not None:
            valid = valid & ~t_mask[:, :T]
        if fix_side is None:
            loss = pair_loss(a, t, valid)
        else:
            fixed = (a if fix_side == "audio" else t).detach()
            loss = pair_loss(t if fix_side == "audio" else a, fixed, valid)
        sample_size = (float(a.shape[0] * T) if a_mask is None and t_mask is None
                       else valid.sum().float())
        return loss, sample_size, {"loss": loss, "sample_size": sample_size,
                                   "ntokens": sample_size, "nsentences": a.shape[0]}

    return criterion


@register_criterion("wav2vec_v1")
def make_wav2vec_v1_criterion(cfg: Dict):
    def criterion(model, batch, generator=None, num_updates=None):
        pos, neg = model(batch["audio"], batch["negative_indices"])
        pos_loss = F.softplus(-pos).sum()
        neg_loss = F.softplus(neg).sum()
        loss = pos_loss + neg_loss
        sample_size = float(pos.numel())
        return loss, sample_size, {"loss": loss, "pos_loss": pos_loss, "neg_loss": neg_loss,
                                   "ntokens": sample_size, "nsentences": batch["audio"].shape[0],
                                   "sample_size": sample_size}

    return criterion
