"""Chimera's length dropout (own copy of chimera_st_tpu/models/chi_utils.py;
fairseq ``models/chimera/chi_utils.py`` ``LengthDropout``): at training time a
random share of the valid time steps joins the padding mask and is zeroed,
so shapes stay as they are and masked attention drops the steps."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def length_dropout(
    x: torch.Tensor,  # [B, T, C]
    padding_mask: torch.Tensor,  # [B, T] True = pad
    rate: float,
    generator: Optional[torch.Generator],
    deterministic: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x, padding_mask) with each step dropped with probability
    ``rate`` (drawn from ``generator``), frame 0 always kept, and every step
    of the new mask zeroed in ``x`` (the dropped ones and the pads, as in
    JAX). The identity when ``deterministic``, ``rate`` is
    0 or there is no generator."""
    if deterministic or rate <= 0.0 or generator is None:
        return x, padding_mask
    drop = torch.rand(padding_mask.shape, generator=generator,
                      device=padding_mask.device) < rate
    drop[:, 0] = False  # never drop every frame of an utterance
    new_mask = padding_mask | drop
    return x.masked_fill(new_mask[:, :, None], 0.0), new_mask
