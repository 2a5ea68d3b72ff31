"""Batched beam search, default path (counterpart of
chimera_st_tpu/generation/beam_search.py ``beam_search``).

A Python loop over decode steps; every sentence keeps K alive and K
finished hypotheses on the device. Kept from the reference:

- flat top-2K candidates over [B, K*V], so eos candidates cannot starve the
  alive set;
- eos banned while a hypothesis is at or below ``min_len``; eos forced once
  ``max_lens`` real tokens were emitted (per sentence); pad never chosen;
  the unk penalty;
- a forced prefix keeps the model's own log-prob of the forced token (pad
  in the prefix forces nothing); an n-gram ban bans every token that would
  complete an n-gram the hypothesis already holds, the bos seed included,
  and none while fewer than n-1 tokens stand;
- ``NEG_INF = -1e7``; a candidate whose score carries a NEG_INF ban is not
  finalised (the ``0.5 * NEG_INF`` guard);
- score = sum of token log-probs (incl. eos) / length ** len_penalty;
- the early stop: a sentence is done once it holds K finished hypotheses
  and no alive one can beat its worst at the longest reachable length;
- a sentence with no finished hypothesis falls back to its alive ones.

Two ways to pick candidates besides the flat top-2K:

- diverse beam groups (``diverse_beam_groups`` G > 1): the beams split into
  G groups that search on their own, each group's first beam live at the
  start; group g's log-probs are lowered by ``diverse_beam_strength`` times
  the count of each token that groups before it picked this step (all 2K/G
  candidates of each), and each group keeps its best K/G alive;
- a ``SearchStrategy`` (``search_strategies.py``): hooks that adjust the
  log-probs, pick the 2K candidates and carry per-beam state on the device.
  Its candidates are consumed in the order it gives them, not by score, so
  the alive set (and the ancestry that ``reorder_fn`` builds from it) is not
  score-sorted.

``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk`` does
not promise an order, so every top-k here is a stable descending sort.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

NEG_INF = -1.0e7


class SearchStrategy:
    """Candidate-selection hooks of the beam search (the JAX package's
    ``SearchStrategy``). Every hook runs on the device and reads nothing
    back to the host."""

    def init_state(self, batch_size: int, beam_size: int, device):
        """Per-beam strategy state (tensors, or None)."""
        return None

    def adjust(self, logprobs, state, step: int, alive_seq):
        """Modify the log-probs [B, K, V] before candidates are scored."""
        return logprobs

    def select(self, alive_scores, logprobs, state, step: int):
        """(scores, beam, token), each [B, 2K], or None for the flat top-2K."""
        return None

    def update(self, state, topk_beam, topk_tok, alive_pick, step: int):
        """Re-align the state with the chosen alive set (alive_pick [B, K])."""
        return state


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken toward the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K_src, ...] gathered along dim 1 by idx [B, K_out]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _ngram_bans(alive_seq: torch.Tensor, i: int, n: int, vocab: int) -> torch.Tensor:
    """[B, K, V] True where a token would complete an n-gram already in
    ``alive_seq[..., :i + 1]``: the trailing n-1 tokens are compared with
    every window j .. j+n-2 that ends before position i, and the token after
    a matching window is banned. Needs ``i >= n - 1``."""
    B, K = alive_seq.shape[:2]
    followers = alive_seq[:, :, n - 1:i + 1]  # token after window j, j = 0 .. i-n+1
    if n == 1:
        match = torch.ones_like(followers, dtype=torch.bool)
    else:
        tail = alive_seq[:, :, i - (n - 2):i + 1]  # [B, K, n-1]
        windows = alive_seq[:, :, :i].unfold(2, n - 1, 1)  # [B, K, i-n+2, n-1]
        match = (windows == tail[:, :, None, :]).all(dim=-1)
    bans = torch.zeros((B, K, vocab), dtype=torch.int32, device=alive_seq.device)
    bans.scatter_add_(2, followers, match.to(torch.int32))
    return bans > 0


def _diverse_top2k(alive_scores, logprobs, groups: int, strength: float):
    """Diverse beam search's candidates: each group's top 2K/G over its own
    beams, its log-probs lowered by ``strength`` times the count of each
    token that the groups before it picked (every one of their 2K/G
    candidates) -> (scores, global beam, token), each [B, 2K]."""
    B, K, V = logprobs.shape
    kp = K // groups
    counts = torch.zeros((B, V), dtype=torch.float32, device=logprobs.device)
    parts = []
    for g in range(groups):
        lp_g = logprobs[:, g * kp:(g + 1) * kp, :] - strength * counts[:, None, :]
        cand_g = alive_scores[:, g * kp:(g + 1) * kp, None] + lp_g
        sc, idx = _top_k(cand_g.reshape(B, kp * V), 2 * kp)
        tok = idx % V
        counts = counts.scatter_add(1, tok, torch.ones_like(sc))
        parts.append((sc, idx // V + g * kp, tok))
    return tuple(torch.cat([p[j] for p in parts], dim=1) for j in range(3))


def beam_search(
    step_fn: Callable,  # (tokens [B*K, 1], index, caches) -> (logprobs [B*K, V] fp32, caches)
    init_caches: Any,
    batch_size: int,
    beam_size: int,
    max_len: int,  # decode-length bound (positions incl. eos)
    eos: int,
    pad: int,
    reorder_fn: Callable,  # (caches, picked_beam [B, K], index) -> caches
    device,
    bos: Optional[int] = None,  # first input token; defaults to eos (fairseq)
    min_len: int = 1,
    len_penalty: float = 1.0,
    unk: Optional[int] = None,
    unk_penalty: float = 0.0,
    max_lens: Optional[torch.Tensor] = None,  # [B] per-sentence max real tokens
    min_lens: Optional[torch.Tensor] = None,  # [B] per-sentence min length
    prefix_tokens: Optional[torch.Tensor] = None,  # [B, P] forced prefix (pad = none)
    no_repeat_ngram_size: int = 0,
    diverse_beam_groups: int = 0,  # > 1: diverse beam search
    diverse_beam_strength: float = 0.5,
    strategy: Optional[SearchStrategy] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, K, max_len], scores [B, K], lengths [B, K]),
    best first along K. Tokens exclude the bos seed, include eos, and are
    ``pad`` past each length."""
    B, K = batch_size, beam_size
    if bos is None:
        bos = eos
    if max_lens is None:
        max_lens = torch.full((B,), max_len, dtype=torch.int32, device=device)
    # a hypothesis may carry max_lens REAL tokens, eos forced after them
    max_lens = torch.clamp(max_lens, max=max_len - 1).to(torch.int32)
    max_steps = int(max_lens.max()) + 1  # the eos-forcing step included

    G = diverse_beam_groups if diverse_beam_groups > 1 else 1
    if K % G:
        raise ValueError(f"beam size {K} is not divisible by {G} diverse beam groups")
    kp = K // G

    alive_seq = torch.full((B, K, max_len + 1), pad, dtype=torch.long, device=device)
    alive_seq[:, :, 0] = bos
    # only the first beam (of each group) is live at first, so the first
    # expansion is not K copies
    alive_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    alive_scores[:, ::kp] = 0.0
    fin_seq = torch.full((B, K, max_len + 1), pad, dtype=torch.long, device=device)
    fin_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    fin_lens = torch.zeros((B, K), dtype=torch.int32, device=device)
    fin_flags = torch.zeros((B, K), dtype=torch.bool, device=device)
    caches = init_caches
    search_state = strategy.init_state(B, K, device) if strategy is not None else None

    def length_norm(length):
        return torch.clamp(length, min=1).to(torch.float32) ** len_penalty

    norm_at_max = length_norm(max_lens + 1)  # longest finished length, incl. eos
    i = 0
    while i < max_steps:
        # early stop (the reference's stop criterion), one host sync a step
        best_possible = alive_scores.max(dim=1).values / norm_at_max
        worst_finished = torch.where(fin_flags, fin_scores, NEG_INF).min(dim=1).values
        improvable = ~fin_flags.all(dim=1) | (best_possible > worst_finished)
        if not bool(improvable.any()):
            break

        tokens_t = alive_seq[:, :, i].reshape(B * K, 1)
        logprobs, caches = step_fn(tokens_t, i, caches)
        V = logprobs.shape[-1]
        logprobs = logprobs.float().reshape(B, K, V)

        gen_len = i + 1  # length if eos is emitted now (incl. eos)
        if min_lens is None:
            if gen_len <= min_len:
                logprobs[:, :, eos] = NEG_INF
        else:
            below = gen_len <= torch.clamp(min_lens, min=min_len)  # [B]
            logprobs[:, :, eos] = torch.where(below[:, None], NEG_INF, logprobs[:, :, eos])
        if unk is not None and unk_penalty != 0.0:
            logprobs[:, :, unk] -= unk_penalty
        logprobs[:, :, pad] = NEG_INF
        at_max = (gen_len > max_lens)[:, None, None]
        eos_only = torch.full_like(logprobs, NEG_INF)
        eos_only[:, :, eos] = logprobs[:, :, eos]
        logprobs = torch.where(at_max, eos_only, logprobs)
        if prefix_tokens is not None and i < prefix_tokens.shape[1]:
            forced = prefix_tokens[:, i].long()  # [B]
            is_forced_tok = torch.arange(V, device=device)[None, :] == forced[:, None]
            forced_rows = torch.where(is_forced_tok[:, None, :], logprobs, NEG_INF)
            logprobs = torch.where((forced != pad)[:, None, None], forced_rows, logprobs)
        if no_repeat_ngram_size > 0 and i >= no_repeat_ngram_size - 1:
            logprobs = torch.where(_ngram_bans(alive_seq, i, no_repeat_ngram_size, V),
                                   NEG_INF, logprobs)

        if strategy is not None:
            logprobs = strategy.adjust(logprobs, search_state, i, alive_seq)
        selected = (strategy.select(alive_scores, logprobs, search_state, i)
                    if strategy is not None else None)
        if selected is not None:
            topk_scores, topk_beam, topk_tok = selected
        elif G > 1:
            topk_scores, topk_beam, topk_tok = _diverse_top2k(
                alive_scores, logprobs, G, diverse_beam_strength)
        else:
            # flat top-2K over [B, K*V]
            cand = (alive_scores[:, :, None] + logprobs).reshape(B, K * V)
            topk_scores, topk_idx = _top_k(cand, 2 * K)
            topk_beam, topk_tok = topk_idx // V, topk_idx % V

        cand_seq = _gather_beams(alive_seq, topk_beam)
        cand_seq[:, :, i + 1] = topk_tok
        is_eos = (topk_tok == eos) & (topk_scores > 0.5 * NEG_INF)

        alive_rank = torch.where(is_eos, NEG_INF, topk_scores)
        if selected is not None:
            # a strategy's candidates are taken in the order it gave them
            # (the order encodes its bank allocation), eos ones skipped
            n_cand = topk_scores.shape[1]
            order = -torch.arange(n_cand, dtype=torch.float32, device=device)
            _, alive_pick = _top_k(torch.where(is_eos, NEG_INF, order[None, :]), K)
            new_alive_scores = torch.gather(topk_scores, 1, alive_pick)
        elif G > 1:
            # each group keeps its best K/G of its own 2K/G candidates
            picks = [_top_k(alive_rank[:, 2 * kp * g:2 * kp * (g + 1)], kp) for g in range(G)]
            new_alive_scores = torch.cat([sc for sc, _ in picks], dim=1)
            alive_pick = torch.cat([ix + 2 * kp * g for g, (_, ix) in enumerate(picks)], dim=1)
        else:
            # alive set: the best K non-eos candidates
            new_alive_scores, alive_pick = _top_k(alive_rank, K)
        alive_scores = new_alive_scores
        alive_seq = _gather_beams(cand_seq, alive_pick)
        picked_beam = torch.gather(topk_beam, 1, alive_pick)
        caches = reorder_fn(caches, picked_beam, i)
        if strategy is not None:
            search_state = strategy.update(search_state, topk_beam, topk_tok, alive_pick, i)

        # finished set: eos candidates merged with the previous finished
        fin_cand = torch.where(is_eos, topk_scores / length_norm(torch.tensor(gen_len)),
                               NEG_INF)
        all_scores = torch.cat([fin_scores, fin_cand], dim=1)
        all_seq = torch.cat([fin_seq, cand_seq], dim=1)
        all_lens = torch.cat([fin_lens, torch.full((B, 2 * K), gen_len, dtype=torch.int32,
                                                   device=device)], dim=1)
        all_flags = torch.cat([fin_flags, is_eos], dim=1)
        fin_scores, fin_pick = _top_k(all_scores, K)
        fin_seq = _gather_beams(all_seq, fin_pick)
        fin_lens = torch.gather(all_lens, 1, fin_pick)
        fin_flags = torch.gather(all_flags, 1, fin_pick)
        i += 1

    # sentences that finished nothing report their alive hypotheses
    none_finished = ~fin_flags.any(dim=1)
    own_max = (max_lens + 1).to(torch.int32)  # [B], incl. the eos slot
    alive_norm = alive_scores / length_norm(own_max)[:, None]
    out_seq = torch.where(none_finished[:, None, None], alive_seq, fin_seq)
    out_scores = torch.where(none_finished[:, None], alive_norm, fin_scores)
    out_lens = torch.where(none_finished[:, None], own_max[:, None].expand(B, K), fin_lens)
    tokens = out_seq[:, :, 1:]  # strip the bos seed
    pos = torch.arange(tokens.shape[-1], device=device)[None, None, :]
    tokens = torch.where(pos < out_lens[:, :, None], tokens, pad)
    return tokens, out_scores, out_lens
