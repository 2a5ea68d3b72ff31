"""The non-autoregressive models' training losses (counterpart of
chimera_st_tpu/criterions/nat_loss.py and of ``insertion_loss`` in
chimera_st_tpu/models/nat_insertion.py): ``nat_loss`` (CMLM and the vanilla
/ iterative NAT: label-smoothed CE at the masked positions plus the length
CE), ``nacrf_loss`` (minus the CRF log-likelihood plus the length CE),
``levenshtein_loss`` (the insertion-count, word and keep / delete CEs) and
``insertion_loss`` (the slots' tree-weighted CE). Their batch fields come
from ``tasks/translation_lev.py``.

``cmlm_mask_target`` masks a target on the host with a numpy
``Generator``, drawing what the JAX function draws, so that the masked
targets equal the JAX package's array for array.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config.registry import register_criterion
from .label_smoothed_ce import label_smoothed_nll_loss


def cmlm_mask_target(target: np.ndarray, mask_idx: int, pad_idx: int = 1,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Replaces n ~ U(1, len) of the non-pad positions, drawn without
    replacement, with ``mask_idx``."""
    rng = rng or np.random.default_rng()
    out = target.copy()
    valid = np.nonzero(target != pad_idx)[0]
    if len(valid) == 0:
        return out
    n = rng.integers(1, len(valid) + 1)
    out[rng.choice(valid, size=n, replace=False)] = mask_idx
    return out


def _nll_at(lprobs: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return -lprobs.gather(-1, index[..., None])[..., 0]


def length_loss(length_logits: torch.Tensor, target_lengths: torch.Tensor) -> torch.Tensor:
    """The summed CE of the true lengths (clipped to the head's range)."""
    tgt_len = torch.clamp(target_lengths, 0, length_logits.shape[-1] - 1)
    return _nll_at(torch.log_softmax(length_logits.float(), dim=-1), tgt_len).sum()


@register_criterion("levenshtein_loss")
def make_levenshtein_loss(cfg: Dict):
    pad_idx = int(cfg.get("padding_idx", 1))
    unk_idx = int(cfg.get("unk_idx", 3))
    eps = float(cfg.get("label_smoothing", 0.1))

    def criterion(model, batch, generator=None, num_updates=None):
        ins_logits, word_logits, del_logits = model(
            batch["src_tokens"], batch["ins_input"], batch["masked_tgt"], batch["del_input"],
            generator)
        # insertion counts over the slots whose two inputs are real
        slot_valid = batch["ins_input"][:, 1:] != pad_idx
        ins_nll = _nll_at(torch.log_softmax(ins_logits.float(), dim=-1), batch["ins_targets"])
        ins_loss = torch.where(slot_valid, ins_nll, 0.0).sum()
        # words at the placeholders, label-smoothed
        masked = batch["masked_tgt"] == unk_idx
        tgt = torch.where(masked, batch["lev_target"], pad_idx)
        word_loss, nll = label_smoothed_nll_loss(
            torch.log_softmax(word_logits.float(), dim=-1), tgt, eps, pad_idx)
        # keep / delete over the real del_input positions
        del_valid = batch["del_input"] != pad_idx
        del_nll = _nll_at(torch.log_softmax(del_logits.float(), dim=-1), batch["del_targets"])
        del_loss = torch.where(del_valid, del_nll, 0.0).sum()
        loss = word_loss + ins_loss + del_loss
        sample_size = (masked.sum() + slot_valid.sum() + del_valid.sum()).float()
        return loss, sample_size, {
            "loss": loss, "nll_loss": nll, "ins_loss": ins_loss, "del_loss": del_loss,
            "ntokens": batch["ntokens"], "nsentences": batch["lev_target"].shape[0],
            "sample_size": sample_size}

    return criterion


@register_criterion("nat_loss")
def make_nat_loss(cfg: Dict):
    pad_idx = int(cfg.get("padding_idx", 1))
    mask_idx = int(cfg.get("mask_idx", 3))
    eps = float(cfg.get("label_smoothing", 0.1))
    length_weight = float(cfg.get("length_loss_factor", 0.1))

    def criterion(model, batch, generator=None, num_updates=None):
        logits, length_logits = model(batch["src_tokens"], batch["masked_target"], generator)
        masked = batch["masked_target"] == mask_idx
        tgt = torch.where(masked, batch["target"], pad_idx)
        loss_tok, nll = label_smoothed_nll_loss(torch.log_softmax(logits.float(), dim=-1), tgt,
                                                eps, pad_idx)
        len_loss = length_loss(length_logits, batch["target_lengths"])
        sample_size = masked.sum().float()
        loss = loss_tok + length_weight * len_loss
        return loss, sample_size, {
            "loss": loss, "nll_loss": nll, "length_loss": len_loss,
            "ntokens": batch["ntokens"], "nsentences": batch["target"].shape[0],
            "sample_size": sample_size}

    return criterion


@register_criterion("nacrf_loss")
def make_nacrf_loss(cfg: Dict):
    length_weight = float(cfg.get("length_loss_factor", 0.1))

    def criterion(model, batch, generator=None, num_updates=None):
        llh, length_logits = model.crf_loglikelihood(batch["src_tokens"], batch["masked_target"],
                                                     batch["target"], generator)
        crf_loss = -llh.sum()
        len_loss = length_loss(length_logits, batch["target_lengths"])
        sample_size = float(batch["ntokens"])
        loss = crf_loss + length_weight * len_loss
        return loss, sample_size, {
            "loss": loss, "crf_loss": crf_loss, "length_loss": len_loss,
            "ntokens": batch["ntokens"], "nsentences": batch["target"].shape[0],
            "sample_size": sample_size}

    return criterion


@register_criterion("insertion_loss")
def make_insertion_loss(cfg: Dict):
    pad_idx = int(cfg.get("padding_idx", 1))

    def criterion(model, batch, generator=None, num_updates=None):
        logits = model(batch["src_tokens"], batch["ins_input"], generator)
        lp = torch.log_softmax(logits.float(), dim=-1)  # [B, L-1, V]
        slot_valid = (batch["ins_input"][:, 1:] != pad_idx)[..., None]
        nll = -lp.gather(-1, batch["slot_tokens"])
        loss = torch.where(slot_valid, batch["slot_weights"] * nll, 0.0).sum()
        sample_size = torch.clamp(slot_valid.sum(), min=1).float()
        return loss, sample_size, {
            "loss": loss, "nll_loss": loss, "ntokens": batch["ntokens"],
            "nsentences": batch["ins_input"].shape[0], "sample_size": sample_size}

    return criterion
