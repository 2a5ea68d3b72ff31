"""Masked-LM criterion and the host-side BERT masking (counterpart of
chimera_st_tpu/criterions/masked_lm.py; fairseq ``criterions/masked_lm.py``
and ``data/mask_tokens_dataset.py``'s 80 / 10 / 10 split).

``apply_bert_masking`` is a numpy copy of the JAX function, drawn call for
call from the same ``np.random.Generator`` stream, so that the batches of
both packages are equal array for array. The ``masked_lm`` criterion is
the summed cross entropy of the masked positions (the target is pad
elsewhere); the sample size is their count.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config.registry import register_criterion


def apply_bert_masking(
    tokens: np.ndarray,  # [T] token ids
    mask_idx: int,
    vocab_size: int,
    mask_prob: float = 0.15,
    leave_unmasked_prob: float = 0.1,
    random_token_prob: float = 0.1,
    rng: Optional[np.random.Generator] = None,
    nspecial: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (masked tokens, target): the target is pad (1) at the positions
    not chosen, so the loss counts only the chosen ones; of those, 80 % read
    ``mask_idx``, 10 % a random non-special token and 10 % keep theirs."""
    rng = rng or np.random.default_rng()
    T = len(tokens)
    mask = rng.random(T) < mask_prob
    if not mask.any():
        mask[rng.integers(T)] = True
    target = np.where(mask, tokens, 1).astype(np.int32)
    out = tokens.copy()
    u = rng.random(T)
    use_mask = mask & (u < 1.0 - leave_unmasked_prob - random_token_prob)
    use_rand = mask & (u >= 1.0 - random_token_prob)
    out[use_mask] = mask_idx
    out[use_rand] = rng.integers(nspecial, vocab_size, size=int(use_rand.sum()))
    return out.astype(np.int32), target


def masked_nll(logits: torch.Tensor, target: torch.Tensor, pad: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (summed cross entropy of the non-pad targets, their mask)."""
    keep = target != pad
    lprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -lprobs.gather(-1, target.long()[..., None])[..., 0]
    return torch.where(keep, nll, torch.zeros_like(nll)).sum(), keep


@register_criterion("masked_lm")
def make_masked_lm(cfg: Dict):
    pad = int(cfg.get("padding_idx", 1))

    def criterion(model, batch, generator=None, num_updates=None):
        target = batch["target"]
        loss, keep = masked_nll(model(batch["net_tokens"], generator), target, pad)
        sample_size = keep.sum().float()
        return loss, sample_size, {"loss": loss, "nll_loss": loss, "ntokens": sample_size,
                                   "nsentences": target.shape[0], "sample_size": sample_size}

    return criterion
