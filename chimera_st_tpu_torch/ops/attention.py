"""Plain softmax attention (counterpart of chimera_st_tpu/ops/attention.py).

Layout [B, T, H, D]. Logits and softmax run in fp32 whatever the compute
type; masked logits are SET to the finite ``NEG_INF`` (-1e8, the reference's
value) rather than added or set to -inf, so a fully masked query gets
uniform weights instead of NaN; the probabilities are cast back to the
compute type before P.V, as the reference does under reduced precision.
In training, attention dropout acts on those probabilities (after the cast).

``dropout`` is the one dropout of the port: every site of the models calls
it (``models/layers.py`` re-exports it).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e8


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax ``nn.Dropout``: each element is kept with
    probability 1 - p and then divided by 1 - p, the rest set to zero. The
    mask is drawn from ``generator`` (``F.dropout`` takes none). ``p`` 0 is
    the identity; a positive ``p`` without a generator raises, so a module
    left in training mode cannot draw masks from the global seed unnoticed."""
    if p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    keep = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(
        1.0 - p, generator=generator)
    return torch.where(keep, x / (1.0 - p), 0.0)


def dot_product_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,  # [B, Tk, H, D]
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, Tk] True = pad
    causal: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Returns [B, Tq, H, D] in q's dtype; logits scaled by D ** -0.5.
    ``dropout_rate`` > 0 drops attention probabilities (training only)."""
    dtype = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        # offset so the last query attends to all keys (cached decode)
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, NEG_INF)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    probs = dropout(torch.softmax(logits, dim=-1).to(dtype), dropout_rate, generator)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(dtype)
