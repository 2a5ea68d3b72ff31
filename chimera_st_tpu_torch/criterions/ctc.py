"""CTC criterion (counterpart of chimera_st_tpu/criterions/ctc.py): ``ctc``
and Chimera's ``ctc_chi``, the same function.

The loss of each utterance is optax's ``ctc_loss`` recursion, copied in
plain PyTorch (``ctc_loss``) with its ``log_epsilon`` of -1e5 standing for
log(0): a target longer than its frames costs about 1e5, not ``inf`` as in
``torch.nn.functional.ctc_loss``, so ``zero_infinity`` never fires and such
an utterance stays in the loss (fairseq zeroes it; ROADMAP C). eos ends a
seq2seq target but is no CTC label, and pad is none either: both are label
padding. A model with a CTC head (``wav2vec_ctc``) gives its
``ctc_logits`` (span mask and freeze gate included); another speech model
has its encoder states projected through the tied decoder embedding.
``ctc_greedy_decode`` collapses the per-frame argmax for the WER.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..config.registry import register_criterion


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0,
             log_epsilon: float = -1e5) -> torch.Tensor:
    """optax ``ctc_loss``: logits [B, T, K], paddings as 1.0 / 0.0 (labels
    right-padded) -> the per-sequence loss [B], in fp32."""
    B, T, _ = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    logit_paddings, label_paddings = logit_paddings.float(), label_paddings.float()
    labellens = N - label_paddings.sum(dim=1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    lp_phi = logprobs[:, :, blank_id]  # [B, T]
    lp_emit = logprobs.gather(2, labels[:, None, :].long().expand(B, T, N))  # [B, T, N]
    phi = torch.full((B, N + 1), log_epsilon, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=-1)

    for t in range(T):
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        e = lp_emit[:, t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e, emit + e)
        b = lp_phi[:, t: t + 1]
        next_phi = update_phi(prev_phi + b, emit + b + log_epsilon * (1.0 - repeat))
        pad = logit_paddings[:, t: t + 1]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -last.gather(1, labellens[:, None])[:, 0]


@register_criterion("ctc")
@register_criterion("ctc_chi")
def make_ctc_criterion(cfg: Dict):
    blank_idx = int(cfg.get("blank_idx", 0))
    pad_idx = int(cfg.get("padding_idx", 1))
    eos_idx = int(cfg.get("eos_idx", 2))
    zero_infinity = bool(cfg.get("zero_infinity", True))
    sentence_avg = bool(cfg.get("sentence_avg", False))

    def criterion(model, batch, generator=None, num_updates=None):
        if hasattr(model, "ctc_logits"):
            logits, enc_mask = model.ctc_logits(
                batch["audio"], batch["audio_padding_mask"],
                mask_indices=batch.get("mask_indices"), num_updates=num_updates,
                generator=generator)
        else:
            enc, enc_mask = model.encode_audio(batch["audio"], batch["audio_padding_mask"],
                                               generator)
            logits = model.decoder.embed_tokens.attend(enc).float()
        B, T, _ = logits.shape
        logit_paddings = (torch.zeros((B, T), device=logits.device) if enc_mask is None
                          else enc_mask.float())
        labels = batch["target"]
        per_seq = ctc_loss(logits, logit_paddings, labels,
                           (labels == pad_idx) | (labels == eos_idx), blank_id=blank_idx)
        if zero_infinity:
            per_seq = torch.where(torch.isfinite(per_seq), per_seq, 0.0)
        loss = per_seq.sum()
        ntokens = batch["ntokens"]
        sample_size = B if sentence_avg else ntokens
        return loss, sample_size, {"loss": loss, "nll_loss": loss, "ntokens": ntokens,
                                   "nsentences": B, "sample_size": sample_size}

    return criterion


def ctc_greedy_decode(logits: np.ndarray, blank_idx: int = 0) -> list:
    """[T, V] -> the collapsed token list (repeats merged, blanks dropped)."""
    out, prev = [], None
    for t in np.argmax(logits, axis=-1):
        if t != blank_idx and t != prev:
            out.append(int(t))
        prev = t
    return out
