"""Padding-mask helpers (counterpart of chimera_st_tpu/utils/masking.py;
fairseq ``data_utils.lengths_to_padding_mask``). ``True`` marks a padded
position."""

from __future__ import annotations

import torch


def lengths_to_padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask, True at padded positions."""
    return torch.arange(max_len, device=lengths.device)[None, :] >= lengths[:, None]


def padding_mask_to_lengths(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool padding mask -> [B] int32 lengths."""
    return (~mask).sum(dim=-1).to(torch.int32)
