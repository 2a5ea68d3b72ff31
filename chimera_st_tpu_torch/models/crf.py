"""Low-rank, beam-approximated CRF output layer (counterpart of
chimera_st_tpu/models/crf.py; fairseq ``DynamicCRF``, Sun et al. 2019):
the |V| x |V| transition matrix is factored as E1 @ E2^T, and the partition
function and the Viterbi pass run over the top-``beam`` emissions of each
position.

The JAX scans over time are Python loops over [B, K, K] blocks here; every
tensor stays on the device (no host read inside a loop). The parameters
stay fp32 whatever the compute dtype (``cast_compute_dtype_`` leaves them),
as the JAX layer casts them to fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

NEG_INF = -1e9


class DynamicCRF(nn.Module):
    def __init__(self, vocab_size: int, low_rank: int = 32, beam: int = 64, device="cuda"):
        super().__init__()
        self.beam = beam
        self.E1 = nn.Parameter(torch.zeros(vocab_size, low_rank, device=device))
        self.E2 = nn.Parameter(torch.zeros(vocab_size, low_rank, device=device))

    def init_extra_(self, generator: torch.Generator) -> None:
        """N(0, 0.02^2), the JAX layer's initialiser."""
        for p in (self.E1, self.E2):
            p.normal_(0.0, 0.02, generator=generator)

    def _beam_view(self, emissions: torch.Tensor, targets: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-``beam`` emission scores and tokens per position ([B, T, K]
        each); ``targets`` are boosted into the beam."""
        k = min(self.beam, emissions.shape[-1])
        if targets is None:
            return torch.topk(emissions, k, dim=-1)
        boosted = emissions.scatter_add(2, targets[..., None],
                                        torch.full_like(emissions[..., :1], -NEG_INF))
        beam_targets = torch.topk(boosted, k, dim=-1).indices
        return emissions.gather(2, beam_targets), beam_targets

    def _transitions(self, beam_targets: torch.Tensor) -> torch.Tensor:
        """[B, T-1, K, K] transition blocks t(prev_k -> next_l)."""
        e1 = self.E1.float()[beam_targets[:, :-1]]
        e2 = self.E2.float()[beam_targets[:, 1:]]
        return torch.einsum("btkd,btld->btkl", e1, e2)

    def loglikelihood(self, emissions: torch.Tensor, targets: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
        """Per-sentence approximate log-likelihood [B]: the gold path's score
        minus the beam forward algorithm's log-partition."""
        emissions = emissions.float()
        targets = targets.long()
        fmask = mask.float()
        emit = emissions.gather(2, targets[..., None])[..., 0]
        trans = (self.E1.float()[targets[:, :-1]] * self.E2.float()[targets[:, 1:]]).sum(-1)
        numerator = (emit * fmask).sum(1) + (trans * fmask[:, :-1] * fmask[:, 1:]).sum(1)

        beam_scores, beam_targets = self._beam_view(emissions, targets)
        trans_blocks = self._transitions(beam_targets)
        alpha = beam_scores[:, 0]
        for t in range(1, emissions.shape[1]):
            nxt = torch.logsumexp(alpha[:, :, None] + trans_blocks[:, t - 1]
                                  + beam_scores[:, t, None, :], dim=1)
            alpha = torch.where(mask[:, t, None], nxt, alpha)
        return numerator - torch.logsumexp(alpha, dim=1)

    def decode(self, emissions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Viterbi over the emission beam -> tokens [B, T]."""
        emissions = emissions.float()
        beam_scores, beam_targets = self._beam_view(emissions, None)
        trans_blocks = self._transitions(beam_targets)
        K = beam_scores.shape[-1]
        stay = torch.arange(K, device=emissions.device).expand(emissions.shape[0], K)
        alpha, backs = beam_scores[:, 0], []
        for t in range(1, emissions.shape[1]):
            scores = alpha[:, :, None] + trans_blocks[:, t - 1] + beam_scores[:, t, None, :]
            m = mask[:, t, None]
            # a masked position carries alpha and points back to its own slot
            backs.append(torch.where(m, scores.argmax(dim=1), stay))
            alpha = torch.where(m, scores.amax(dim=1), alpha)
        k = alpha.argmax(dim=1)
        idx = [k]
        for back in reversed(backs):
            k = back.gather(1, k[:, None])[:, 0]
            idx.append(k)
        beam_idx = torch.stack(idx[::-1], dim=1)  # [B, T]
        return beam_targets.gather(2, beam_idx[..., None])[..., 0]
