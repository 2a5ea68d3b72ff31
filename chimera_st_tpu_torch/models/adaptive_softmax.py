"""Adaptive softmax (counterpart of chimera_st_tpu/models/adaptive_softmax.py;
reference fairseq/modules/adaptive_softmax.py, Grave et al., "Efficient
softmax approximation for GPUs").

The vocabulary is split at ``cutoffs`` into a frequent head and tail
clusters. The head predicts the head words and one logit per cluster; tail
cluster i predicts its words from a projection of the input down to
``input_dim // factor ** (i + 1)`` (at least 8). ``log_prob`` gives the
full normalized log-probabilities [..., V]; ``nll`` the per-position
negative log-likelihood of a target, every cluster's logits computed for
every position as the JAX module does. Logits go to fp32 before their
softmax.

Module names follow the flax tree: ``head``, ``tail_proj.{i}`` (flax
``tail_{i}_proj``), ``tail_out.{i}`` (``tail_{i}_out``), all without bias.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import linear


class AdaptiveSoftmax(nn.Module):
    def __init__(self, vocab_size: int, input_dim: int, cutoffs: Sequence[int] = (2000, 10000),
                 factor: float = 4.0, device="cuda"):
        super().__init__()
        cuts = [int(c) for c in cutoffs if c < vocab_size]
        self.bounds = tuple(cuts) + (int(vocab_size),)
        self.n_clusters = len(self.bounds) - 1
        self.head = linear(input_dim, self.bounds[0] + self.n_clusters, bias=False,
                           device=device)
        dims = [max(int(input_dim // (factor ** (i + 1))), 8) for i in range(self.n_clusters)]
        self.tail_proj = nn.ModuleList([linear(input_dim, d, bias=False, device=device)
                                        for d in dims])
        self.tail_out = nn.ModuleList([
            linear(d, self.bounds[i + 1] - self.bounds[i], bias=False, device=device)
            for i, d in enumerate(dims)])

    def _tail_logits(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return self.tail_out[i](self.tail_proj[i](x)).float()

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """[..., D] -> fp32 log-probabilities [..., V]."""
        head_lp = torch.log_softmax(self.head(x).float(), dim=-1)
        b0 = self.bounds[0]
        parts = [head_lp[..., :b0]]
        for i in range(self.n_clusters):
            gate = head_lp[..., b0 + i: b0 + i + 1]
            parts.append(gate + torch.log_softmax(self._tail_logits(x, i), dim=-1))
        return torch.cat(parts, dim=-1)

    def nll(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """[..., D], targets [...] -> fp32 NLL [...]: a head word's from the
        head; a cluster word's from its cluster's gate and its tail."""
        b0 = self.bounds[0]
        head_logits = self.head(x).float()
        head_lse = torch.logsumexp(head_logits, dim=-1)
        pick = lambda logits, idx: logits.gather(-1, idx.unsqueeze(-1)).squeeze(-1)  # noqa: E731
        nll = head_lse - pick(head_logits, target.clamp(0, b0 - 1))
        for i in range(self.n_clusters):
            lo, hi = self.bounds[i], self.bounds[i + 1]
            in_cluster = (target >= lo) & (target < hi)
            tail = self._tail_logits(x, i)
            local = (target - lo).clamp(0, hi - lo - 1)
            cluster_nll = (head_lse - head_logits[..., b0 + i]) \
                + (torch.logsumexp(tail, dim=-1) - pick(tail, local))
            nll = torch.where(in_cluster, cluster_nll, nll)
        return nll
