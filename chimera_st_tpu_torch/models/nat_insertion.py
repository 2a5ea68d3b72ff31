"""Insertion transformer (counterpart of
chimera_st_tpu/models/nat_insertion.py; fairseq ``insertion_transformer``,
Stern et al. 2019): for every adjacent slot of the canvas the bidirectional
decoder (K1 in each layer on the card) scores the vocabulary to insert,
pad meaning "insert nothing"; a round inserts at most one token a slot, in
parallel, until every slot says pad (``nat_levenshtein.refine_rounds``:
the host reads once a round whether any slot inserted).

``insertion_slot_targets`` builds the training targets on the host from
the edit operations (``data/edit_ops.py``): each slot's span of tokens to
insert, weighted center-first by a balanced-binary-tree schedule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import linear
from .nat_cmlm import NATDecoderMixin, cmlm_base, nat_backbone
from .nat_levenshtein import apply_ins_placeholders, initial_canvas, refine_rounds
from .transformer_mt import TransformerMTConfig, _config


def insertion_slot_targets(ins_input: np.ndarray, target: np.ndarray, ins_counts: np.ndarray,
                           ins_masks: np.ndarray, pad: int = 1, max_span: int = 8,
                           tau: float = 1.0):
    """Per-slot insertable tokens and their weights ([B, Lx-1, max_span]
    each): the span's tokens weighted exp(-|i - center| / tau), normalised
    over the kept ones; an empty slot is (pad, weight 1), the no-insert
    class."""
    B, Lxm1 = ins_counts.shape
    toks = np.full((B, Lxm1, max_span), pad, np.int32)
    wts = np.zeros((B, Lxm1, max_span), np.float32)
    for b in range(B):
        span_tokens = target[b][ins_masks[b].astype(bool)]
        pos = 0
        for s in range(Lxm1):
            n = int(ins_counts[b, s])
            if n == 0:
                toks[b, s, 0] = pad
                wts[b, s, 0] = 1.0
                continue
            span = span_tokens[pos: pos + n]
            pos += n
            n_keep = min(n, max_span)
            raw = np.exp(-np.abs(np.arange(n) - (n - 1) / 2.0) / max(tau, 1e-6))
            raw = raw / raw.sum()
            toks[b, s, :n_keep] = span[:n_keep]
            wts[b, s, :n_keep] = raw[:n_keep] / max(raw[:n_keep].sum(), 1e-6)
    return toks, wts


@dataclass(frozen=True)
class InsertionConfig(TransformerMTConfig):
    pass


def compact_picks(pick: torch.Tensor, do_insert: torch.Tensor) -> torch.Tensor:
    """The picked tokens of the inserting slots, left-compacted in slot
    order (the order of their placeholders)."""
    order = torch.sort((~do_insert).to(torch.int32), dim=1, stable=True).indices
    return pick.gather(1, order)


class InsertionTransformer(NATDecoderMixin, nn.Module):
    def __init__(self, cfg: InsertionConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.backbone = nat_backbone(cfg, device)
        C = cfg.decoder_embed_dim
        self.slot_proj = linear(2 * C, C, device=device)

    def slot_logits(self, tokens, enc, enc_mask, generator=None) -> torch.Tensor:
        """[B, L-1, V] fp32 insertion scores per adjacent slot, against the
        tied output embedding (tanh GELU, as ``jax.nn.gelu``)."""
        f = self.features(tokens, enc, enc_mask, generator)
        h = F.gelu(self.slot_proj(torch.cat([f[:, :-1], f[:, 1:]], dim=-1)), approximate="tanh")
        return self.backbone.decoder.embed_tokens.attend(h).float()

    def forward(self, src_tokens, slot_input, generator=None) -> torch.Tensor:
        enc, enc_mask = self.encode(src_tokens, generator)
        return self.slot_logits(slot_input, enc, enc_mask, generator)

    def refine(self, src_tokens: torch.Tensor, iterations: int = 8, max_len: int = 64,
               pad: int = 1, bos: int = 0, eos: int = 2, unk: int = 3,
               force_iterations: bool = False, return_history: bool = False):
        """Parallel insertion from ``[bos, eos]`` canvases -> (tokens [B, L],
        lengths [B]); with ``return_history`` also the canvases of every
        round and each sentence's step count. The loop stops after the
        first round in which no slot inserted, unless ``force_iterations``."""
        enc, enc_mask = self.encode(src_tokens)

        def one_round(tokens):
            pick = self.slot_logits(tokens, enc, enc_mask).argmax(dim=-1)  # [B, L-1]
            do_insert = (pick != pad) & (tokens[:, 1:] != pad)
            new = apply_ins_placeholders(tokens, do_insert.long(), pad, unk, eos)
            fill = torch.cumsum((new == unk).long(), dim=1) - 1
            picked = compact_picks(pick, do_insert).gather(
                1, torch.clamp(fill, 0, pick.shape[1] - 1))
            return torch.where(new == unk, picked, new), do_insert.any()

        tokens, hist, steps, _ = refine_rounds(
            one_round, initial_canvas(src_tokens.shape[0], max_len, pad, bos, eos,
                                      src_tokens.device),
            iterations, force_iterations, return_history)
        lengths = (tokens != pad).sum(dim=1)
        if return_history:
            return tokens, lengths, hist, steps
        return tokens, lengths


def build_insertion(cfg_dict: Dict, device="cuda") -> InsertionTransformer:
    return InsertionTransformer(_config(InsertionConfig, cfg_dict), device=device)


ARCHITECTURES = {"insertion_transformer": ("insertion_transformer", cmlm_base)}
